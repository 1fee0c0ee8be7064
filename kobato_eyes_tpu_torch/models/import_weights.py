"""Carry ViT weights into the port's ``models/vit.ViT``.

The port's ViT uses timm's parameter names, so weights arrive two ways:

* ``vit_state_from_jax_params`` turns the JAX package's flax tree (as numpy,
  the layout of ``kobato_eyes_tpu/models/vit.py``'s ``init_params``, with the
  scanned ``blocks/block/...`` leaves carrying a leading depth axis) into the
  port's state dict. It is the exact inverse of the JAX package's
  ``vit_params_from_torch_state``, so one set of weights runs in both.
* ``vit_params_from_torch_state`` checks a timm ``VisionTransformer`` state
  dict against the config and returns it as the port's state dict.

The SwinV2 and CLIP importers come with their slices of the port.
"""

from __future__ import annotations

import logging
from typing import Any, Mapping

import numpy as np
import torch

from kobato_eyes_tpu_torch.models.vit import ViTConfig

logger = logging.getLogger(__name__)


def _np(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x)


def _tensor(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(_np(x), dtype=np.float32))


def vit_state_from_jax_params(params: Mapping[str, Any], cfg: ViTConfig) -> dict[str, torch.Tensor]:
    """flax param tree of the JAX ViT -> the port's (timm-named) state dict."""
    d = cfg.hidden_dim
    p = cfg.patch_size
    pe = params["patch_embed"]
    # dense kernel (P*P*C, D), rows (py, px, c) -> conv weight (D, C, P, P)
    state: dict[str, torch.Tensor] = {
        "patch_embed.proj.weight": _tensor(_np(pe["kernel"]).reshape(p, p, 3, d).transpose(3, 2, 0, 1)),
        "cls_token": _tensor(params["cls"]),
        "pos_embed": _tensor(params["pos_embed"]),
    }
    if cfg.patch_bias:
        state["patch_embed.proj.bias"] = _tensor(pe["bias"])
    if cfg.ln_pre:
        state["norm_pre.weight"] = _tensor(params["ln_pre"]["scale"])
        state["norm_pre.bias"] = _tensor(params["ln_pre"]["bias"])
    blk = params["blocks"]["block"]
    for i in range(cfg.depth):
        pre = f"blocks.{i}."

        def leaf(*path: str) -> np.ndarray:
            node: Any = blk
            for key in path:
                node = node[key]
            return _np(node)[i]

        state[pre + "norm1.weight"] = _tensor(leaf("ln1", "scale"))
        state[pre + "norm1.bias"] = _tensor(leaf("ln1", "bias"))
        state[pre + "attn.qkv.weight"] = _tensor(leaf("attn", "qkv", "kernel").reshape(d, 3 * d).T)
        state[pre + "attn.qkv.bias"] = _tensor(leaf("attn", "qkv", "bias").reshape(3 * d))
        state[pre + "attn.proj.weight"] = _tensor(leaf("attn", "proj", "kernel").reshape(d, d).T)
        state[pre + "attn.proj.bias"] = _tensor(leaf("attn", "proj", "bias"))
        state[pre + "norm2.weight"] = _tensor(leaf("ln2", "scale"))
        state[pre + "norm2.bias"] = _tensor(leaf("ln2", "bias"))
        state[pre + "mlp.fc1.weight"] = _tensor(leaf("fc1", "kernel").T)
        state[pre + "mlp.fc1.bias"] = _tensor(leaf("fc1", "bias"))
        state[pre + "mlp.fc2.weight"] = _tensor(leaf("fc2", "kernel").T)
        state[pre + "mlp.fc2.bias"] = _tensor(leaf("fc2", "bias"))
    state["norm.weight"] = _tensor(params["ln_final"]["scale"])
    state["norm.bias"] = _tensor(params["ln_final"]["bias"])
    if "head" in params:
        state["head.weight"] = _tensor(_np(params["head"]["kernel"]).T)
        state["head.bias"] = _tensor(params["head"]["bias"])
    return state


def vit_params_from_torch_state(
    state: Mapping[str, Any], cfg: ViTConfig
) -> dict[str, torch.Tensor]:
    """timm-style ViT state dict -> the port's state dict (f32 tensors).

    Expected keys (timm ``VisionTransformer``):
      patch_embed.proj.{weight,bias}, cls_token, pos_embed,
      blocks.N.norm1.{weight,bias}, blocks.N.attn.qkv.{weight,bias},
      blocks.N.attn.proj.{weight,bias}, blocks.N.norm2.{weight,bias},
      blocks.N.mlp.fc1.{weight,bias}, blocks.N.mlp.fc2.{weight,bias},
      norm.{weight,bias}, head.{weight,bias}
    A state dict without the head loads with the head left as it was.
    """
    d, p = cfg.hidden_dim, cfg.patch_size
    shapes: dict[str, tuple[int, ...]] = {
        "patch_embed.proj.weight": (d, 3, p, p),
        "cls_token": (1, 1, d),
        "pos_embed": (1, cfg.num_patches + 1, d),
        "norm.weight": (d,),
        "norm.bias": (d,),
    }
    if cfg.patch_bias:
        shapes["patch_embed.proj.bias"] = (d,)
    if cfg.ln_pre:
        shapes["norm_pre.weight"] = (d,)
        shapes["norm_pre.bias"] = (d,)
    for i in range(cfg.depth):
        pre = f"blocks.{i}."
        for name, shape in (
            ("norm1.weight", (d,)), ("norm1.bias", (d,)),
            ("attn.qkv.weight", (3 * d, d)), ("attn.qkv.bias", (3 * d,)),
            ("attn.proj.weight", (d, d)), ("attn.proj.bias", (d,)),
            ("norm2.weight", (d,)), ("norm2.bias", (d,)),
            ("mlp.fc1.weight", (cfg.mlp_dim, d)), ("mlp.fc1.bias", (cfg.mlp_dim,)),
            ("mlp.fc2.weight", (d, cfg.mlp_dim)), ("mlp.fc2.bias", (d,)),
        ):
            shapes[pre + name] = shape
    if "head.weight" in state:
        shapes["head.weight"] = (cfg.num_classes, d)
        shapes["head.bias"] = (cfg.num_classes,)
    else:
        logger.warning("state dict has no classifier head; head left random")

    out: dict[str, torch.Tensor] = {}
    for key, want in shapes.items():
        if key not in state:
            raise KeyError(f"missing weight {key!r}")
        arr = _np(state[key])
        if key == "cls_token":
            arr = arr.reshape(1, 1, d)
        if key == "pos_embed" and arr.shape[1] != want[1]:
            raise ValueError(
                f"pos_embed has {arr.shape[1]} tokens, model expects {want[1]} "
                f"(interpolation not implemented)"
            )
        if tuple(arr.shape) != want:
            raise ValueError(f"{key}: shape {tuple(arr.shape)} != expected {want}")
        out[key] = _tensor(arr)
    return out
