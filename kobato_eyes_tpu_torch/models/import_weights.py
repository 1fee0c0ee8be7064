"""Carry ViT and SwinV2 weights into the port's models.

The port's ``models/vit.ViT`` and ``models/swin.SwinV2`` use timm's parameter
names, so weights arrive two ways:

* ``vit_state_from_jax_params`` / ``swin_state_from_jax_params`` turn the JAX
  package's flax tree (as numpy, the layout of its ``init_params`` /
  ``init_swin_params``) into the port's state dict. Each is the exact
  inverse of the JAX package's ``*_params_from_torch_state``, so one set of
  weights runs in both.
* ``vit_params_from_torch_state`` / ``swin_params_from_torch_state`` check a
  timm state dict against the config and return it as the port's state dict.

``import_torch_checkpoint`` reads a ``.pt``/``.pth`` or ``.safetensors``
file, validates it strictly against the config's key/shape manifest
(``StateDictMismatch`` names every drifted key) and converts it. The CLIP
importer comes with the ANN slice, ``.onnx`` files with the ONNX import
slice and orbax directories with the checkpoint IO slice.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from kobato_eyes_tpu_torch.models.swin import CPB_HIDDEN, SwinConfig
from kobato_eyes_tpu_torch.models.vit import ViTConfig

logger = logging.getLogger(__name__)


def _np(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x)


def _tensor(x: Any) -> torch.Tensor:
    """A contiguous f32 copy (transposed kernels included)."""
    return torch.from_numpy(np.array(_np(x), dtype=np.float32, order="C"))


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
    d = cfg.hidden_dim
    has_head = "head.weight" in state
    if not has_head:
        logger.warning("state dict has no classifier head; head left random")
    shapes = vit_state_manifest(cfg, head=has_head)
    if not cfg.patch_bias:
        del shapes["patch_embed.proj.bias"]
    if cfg.ln_pre:
        shapes["norm_pre.weight"] = (d,)
        shapes["norm_pre.bias"] = (d,)

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


# ---------------------------------------------------------------------------
# SwinV2
# ---------------------------------------------------------------------------

# Patch merging: timm concatenates the 2x2 blocks as (dy, dx) = (0,0), (1,0),
# (0,1), (1,1); the JAX package's reshape gives (0,0), (0,1), (1,0), (1,1).
# The permutation between the two is its own inverse.
_MERGE_ORDER = (0, 2, 1, 3)


def swin_state_from_jax_params(params: Mapping[str, Any], cfg: SwinConfig) -> dict[str, torch.Tensor]:
    """flax param tree of the JAX SwinV2 -> the port's (timm-named) state dict.

    The JAX tree holds a full (3, H, hd) qkv bias; SwinV2 learns only q's
    and v's, so a non-zero k slice raises.
    """
    d0, p = cfg.embed_dim, cfg.patch_size
    pe = params["patch_embed"]
    state: dict[str, torch.Tensor] = {
        "patch_embed.proj.weight": _tensor(_np(pe["kernel"]).reshape(p, p, 3, d0).transpose(3, 2, 0, 1)),
        "patch_embed.proj.bias": _tensor(pe["bias"]),
        "patch_embed.norm.weight": _tensor(params["patch_norm"]["scale"]),
        "patch_embed.norm.bias": _tensor(params["patch_norm"]["bias"]),
    }
    for stage, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
        c = d0 * 2**stage
        if stage > 0:
            merge = params[f"merge{stage - 1}"]
            c_in = c // 2
            kernel = _np(merge["reduction"]["kernel"])  # (4C, 2C), rows in JAX order
            red = kernel.T.reshape(2 * c_in, 4, c_in)[:, _MERGE_ORDER, :].reshape(2 * c_in, 4 * c_in)
            ds = f"layers.{stage}.downsample."
            state[ds + "reduction.weight"] = _tensor(red)
            state[ds + "norm.weight"] = _tensor(merge["norm"]["scale"])
            state[ds + "norm.bias"] = _tensor(merge["norm"]["bias"])
        for blk in range(depth):
            bp = params[f"stage{stage}_block{blk}"]
            attn = bp["attn"]
            pre = f"layers.{stage}.blocks.{blk}."
            qkv_bias = _np(attn["qkv"]["bias"]).reshape(3, c)
            if np.any(qkv_bias[1] != 0):
                raise ValueError(f"{pre}attn: the k bias is not zero; SwinV2 has no k bias")
            state[pre + "attn.qkv.weight"] = _tensor(_np(attn["qkv"]["kernel"]).reshape(c, 3 * c).T)
            state[pre + "attn.q_bias"] = _tensor(qkv_bias[0])
            state[pre + "attn.v_bias"] = _tensor(qkv_bias[2])
            state[pre + "attn.logit_scale"] = _tensor(_np(attn["logit_scale"]).reshape(heads, 1, 1))
            state[pre + "attn.cpb_mlp.0.weight"] = _tensor(_np(attn["cpb_fc1"]["kernel"]).T)
            state[pre + "attn.cpb_mlp.0.bias"] = _tensor(attn["cpb_fc1"]["bias"])
            state[pre + "attn.cpb_mlp.2.weight"] = _tensor(_np(attn["cpb_fc2"]["kernel"]).T)
            state[pre + "attn.proj.weight"] = _tensor(_np(attn["proj"]["kernel"]).reshape(c, c).T)
            state[pre + "attn.proj.bias"] = _tensor(attn["proj"]["bias"])
            for norm in ("norm1", "norm2"):
                state[pre + f"{norm}.weight"] = _tensor(bp[norm]["scale"])
                state[pre + f"{norm}.bias"] = _tensor(bp[norm]["bias"])
            for fc in ("fc1", "fc2"):
                state[pre + f"mlp.{fc}.weight"] = _tensor(_np(bp[fc]["kernel"]).T)
                state[pre + f"mlp.{fc}.bias"] = _tensor(bp[fc]["bias"])
    state["norm.weight"] = _tensor(params["norm_final"]["scale"])
    state["norm.bias"] = _tensor(params["norm_final"]["bias"])
    if "head" in params:
        state["head.fc.weight"] = _tensor(_np(params["head"]["kernel"]).T)
        state["head.fc.bias"] = _tensor(params["head"]["bias"])
    return state


def swin_params_from_torch_state(
    state: Mapping[str, Any], cfg: SwinConfig
) -> dict[str, torch.Tensor]:
    """timm ``SwinTransformerV2`` state dict -> the port's state dict (f32).

    Takes the q/v biases as ``attn.q_bias``/``attn.v_bias`` or a full
    ``attn.qkv.bias`` (whose k slice must be zero), and the classifier as
    ``head.fc.*`` or a flat ``head.*``. Derived buffers (CPB tables, index,
    masks) are ignored: the port builds its own. A state dict without the
    head loads with the head left as it was.
    """

    def get(key: str) -> np.ndarray:
        if key not in state:
            raise KeyError(f"missing weight {key!r}")
        return _np(state[key])

    has_head = any(k in state for k in ("head.fc.weight", "head.weight"))
    if not has_head:
        logger.warning("state dict has no classifier head; head left random")
    out: dict[str, torch.Tensor] = {}
    for key, want in swin_state_manifest(cfg).items():
        if key.startswith("head.fc."):
            if not has_head:
                continue
            arr = get(key if key in state else key.replace("head.fc.", "head."))
        elif key.endswith(("attn.q_bias", "attn.v_bias")) and key not in state:
            pre = key.rsplit("attn.", 1)[0]
            qkv_bias = get(pre + "attn.qkv.bias").reshape(3, -1)
            if np.any(qkv_bias[1] != 0):
                raise ValueError(f"{pre}attn.qkv.bias: the k slice is not zero; SwinV2 has no k bias")
            arr = qkv_bias[0] if key.endswith("q_bias") else qkv_bias[2]
        else:
            arr = get(key)
        if tuple(arr.shape) != tuple(want):
            raise ValueError(f"{key}: shape {tuple(arr.shape)} != expected {tuple(want)}")
        out[key] = _tensor(arr)
    return out


# ---------------------------------------------------------------------------
# Checkpoint key/shape manifests: the exact key -> shape inventory a timm
# state dict carries for a config, so drifted naming fails with every
# offending key named instead of a deep KeyError mid-conversion.
# ---------------------------------------------------------------------------

# Derived (non-learned) entries that some torch state dicts carry and that
# the port recomputes from the config; never required, never "unexpected".
_DERIVED_KEY_SUFFIXES = (
    "relative_coords_table",
    "relative_position_index",
    "attn_mask",
    "k_bias",  # SwinV2 keeps the k bias fixed at zero (a buffer in timm)
)


def swin_state_manifest(cfg: SwinConfig, *, head_style: str = "fc") -> dict[str, tuple[int, ...]]:
    """Expected timm ``SwinTransformerV2`` weight keys -> shapes for ``cfg``:
    per-stage ``layers.{s}``, the downsample at the start of stages 1..,
    q/v biases, the CPB MLP (512 hidden) and a ``head.fc`` classifier
    (``head_style="flat"``: the older ``head.weight``). The window size
    changes only derived buffers, which are left out."""
    d0, p = cfg.embed_dim, cfg.patch_size
    m: dict[str, tuple[int, ...]] = {
        "patch_embed.proj.weight": (d0, 3, p, p),
        "patch_embed.proj.bias": (d0,),
        "patch_embed.norm.weight": (d0,),
        "patch_embed.norm.bias": (d0,),
    }
    for s, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
        c = d0 * (2**s)
        mlp = int(cfg.mlp_ratio * c)
        if s > 0:
            c_in = d0 * (2 ** (s - 1))
            m[f"layers.{s}.downsample.reduction.weight"] = (2 * c_in, 4 * c_in)
            m[f"layers.{s}.downsample.norm.weight"] = (2 * c_in,)
            m[f"layers.{s}.downsample.norm.bias"] = (2 * c_in,)
        for b in range(depth):
            pre = f"layers.{s}.blocks.{b}."
            m[pre + "norm1.weight"] = (c,)
            m[pre + "norm1.bias"] = (c,)
            m[pre + "attn.qkv.weight"] = (3 * c, c)
            m[pre + "attn.q_bias"] = (c,)
            m[pre + "attn.v_bias"] = (c,)
            m[pre + "attn.logit_scale"] = (heads, 1, 1)
            m[pre + "attn.cpb_mlp.0.weight"] = (CPB_HIDDEN, 2)
            m[pre + "attn.cpb_mlp.0.bias"] = (CPB_HIDDEN,)
            m[pre + "attn.cpb_mlp.2.weight"] = (heads, CPB_HIDDEN)
            m[pre + "attn.proj.weight"] = (c, c)
            m[pre + "attn.proj.bias"] = (c,)
            m[pre + "norm2.weight"] = (c,)
            m[pre + "norm2.bias"] = (c,)
            m[pre + "mlp.fc1.weight"] = (mlp, c)
            m[pre + "mlp.fc1.bias"] = (mlp,)
            m[pre + "mlp.fc2.weight"] = (c, mlp)
            m[pre + "mlp.fc2.bias"] = (c,)
    d_final = d0 * (2 ** (cfg.num_stages - 1))
    m["norm.weight"] = (d_final,)
    m["norm.bias"] = (d_final,)
    head = "head.fc" if head_style == "fc" else "head"
    m[f"{head}.weight"] = (cfg.num_classes, d_final)
    m[f"{head}.bias"] = (cfg.num_classes,)
    return m


def vit_state_manifest(cfg: ViTConfig, *, head: bool = True) -> dict[str, tuple[int, ...]]:
    """Expected timm ``VisionTransformer`` weight keys -> shapes for ``cfg``
    (cls token, flat ``head`` classifier; ``head=False`` for a headless
    tower)."""
    d, p = cfg.hidden_dim, cfg.patch_size
    m: dict[str, tuple[int, ...]] = {
        "patch_embed.proj.weight": (d, 3, p, p),
        "patch_embed.proj.bias": (d,),
        "cls_token": (1, 1, d),
        "pos_embed": (1, cfg.num_patches + 1, d),
        "norm.weight": (d,),
        "norm.bias": (d,),
    }
    for i in range(cfg.depth):
        pre = f"blocks.{i}."
        m[pre + "norm1.weight"] = (d,)
        m[pre + "norm1.bias"] = (d,)
        m[pre + "attn.qkv.weight"] = (3 * d, d)
        m[pre + "attn.qkv.bias"] = (3 * d,)
        m[pre + "attn.proj.weight"] = (d, d)
        m[pre + "attn.proj.bias"] = (d,)
        m[pre + "norm2.weight"] = (d,)
        m[pre + "norm2.bias"] = (d,)
        m[pre + "mlp.fc1.weight"] = (cfg.mlp_dim, d)
        m[pre + "mlp.fc1.bias"] = (cfg.mlp_dim,)
        m[pre + "mlp.fc2.weight"] = (d, cfg.mlp_dim)
        m[pre + "mlp.fc2.bias"] = (d,)
    if head:
        m["head.weight"] = (cfg.num_classes, d)
        m["head.bias"] = (cfg.num_classes,)
    return m


class StateDictMismatch(ValueError):
    """Importer/checkpoint naming drift, with the offending keys named."""


def validate_state_against_manifest(
    state: Mapping[str, Any],
    manifest: Mapping[str, Sequence[int]],
    *,
    name: str = "checkpoint",
) -> None:
    """Strict key/shape check of ``state`` against a manifest: raises
    :class:`StateDictMismatch` listing every missing key, unexpected key
    (derived buffers excluded) and shape mismatch."""
    missing = [k for k in manifest if k not in state]
    unexpected = [
        k for k in state
        if k not in manifest and not k.endswith(_DERIVED_KEY_SUFFIXES)
    ]
    bad_shapes = []
    for k, want in manifest.items():
        if k in state:
            got = tuple(_np(state[k]).shape)
            if got != tuple(want):
                bad_shapes.append(f"{k}: state {got} != manifest {tuple(want)}")
    if missing or unexpected or bad_shapes:
        parts = []
        if missing:
            parts.append(f"missing keys ({len(missing)}): " + ", ".join(sorted(missing)[:20]))
        if unexpected:
            parts.append(
                f"unexpected keys ({len(unexpected)}): " + ", ".join(sorted(unexpected)[:20])
            )
        if bad_shapes:
            parts.append(f"shape mismatches ({len(bad_shapes)}): " + "; ".join(bad_shapes[:20]))
        raise StateDictMismatch(f"{name} does not match manifest — " + "; ".join(parts))


def load_state_file(path: str | Path) -> Mapping[str, Any]:
    """A state dict from a ``.pt``/``.pth`` file (``torch.load`` with
    ``weights_only=True``; a ``state_dict`` key is unwrapped) or a
    ``.safetensors`` file."""
    path = Path(path)
    if path.is_dir():
        raise NotImplementedError(
            f"{path} is a directory: orbax checkpoints come with the checkpoint IO slice of the port"
        )
    if path.suffix == ".onnx":
        raise NotImplementedError(f"{path}: .onnx import comes with the ONNX import slice of the port")
    if path.suffix == ".safetensors":
        from safetensors.torch import load_file

        return load_file(str(path))
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return state


def import_torch_checkpoint(
    path: str | Path, cfg: ViTConfig | SwinConfig, *, strict: bool = True
) -> dict[str, torch.Tensor]:
    """Load a ``.pt``/``.pth`` or ``.safetensors`` state dict and convert it to
    the port's state dict for ``cfg``. ``strict`` validates it against the
    config's manifest first, so drift fails with every offending key named."""
    state = load_state_file(path)
    if isinstance(cfg, SwinConfig):
        if strict:
            style = "fc" if "head.fc.weight" in state or "head.fc.bias" in state else "flat"
            validate_state_against_manifest(state, swin_state_manifest(cfg, head_style=style), name=str(path))
        return swin_params_from_torch_state(state, cfg)
    if any(k.endswith("conv1.weight") or ".resblocks." in k for k in state):
        raise NotImplementedError("CLIP visual towers come with the ANN slice of the port")
    if strict:
        has_head = "head.weight" in state or "head.bias" in state
        validate_state_against_manifest(state, vit_state_manifest(cfg, head=has_head), name=str(path))
    return vit_params_from_torch_state(state, cfg)
