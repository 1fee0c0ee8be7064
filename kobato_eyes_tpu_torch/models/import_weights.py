"""Carry ViT, SwinV2, EVA02 and CLIP weights into the port's models.

The port's ``models/vit.ViT``, ``models/swin.SwinV2`` and
``models/eva02.EVA02`` use timm's parameter names, so weights arrive two
ways (EVA02, which the JAX package lacks, only the second):

* ``vit_state_from_jax_params`` / ``swin_state_from_jax_params`` /
  ``clip_state_from_jax_params`` turn the JAX package's flax tree (as numpy,
  the layout of its ``init_params`` / ``init_swin_params`` / the embedder's
  ``{"vit", "proj"}`` tree) into the port's state dict. Each is the exact
  inverse of the JAX package's ``*_params_from_torch_state``, so one set of
  weights runs in both.
* ``vit_params_from_torch_state`` / ``swin_params_from_torch_state`` check a
  timm state dict against the config and return it as the port's state dict;
  ``eva02_params_from_torch_state`` does the same for timm's ``Eva``
  (separate q, k, v projections, SwiGLU, ``fc_norm``);
  ``clip_vit_params_from_torch_state`` turns an OpenAI / open_clip visual
  tower into the state dict of ``index/embedder.ClipImageEncoder`` (the
  timm-named ViT under ``vit.`` plus a bias-free ``proj``).

``import_torch_checkpoint`` reads a ``.pt``/``.pth``, ``.safetensors`` or
``.onnx`` file (the reference's release format, read by the numpy protobuf
reader of ``models/onnx_import.py``) or the port's own checkpoint directory
(``models/tagger.save_checkpoint``), validates it strictly against the
config's key/shape manifest (``StateDictMismatch`` names every drifted key;
an ``.onnx`` file gets one retry after its constant-folded initializer
names are recovered) and converts it.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from kobato_eyes_tpu_torch.models.eva02 import EVA02Config
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


def _get(state: Mapping[str, Any], key: str) -> np.ndarray:
    if key not in state:
        raise KeyError(f"missing weight {key!r}")
    return _np(state[key])


def _at(key: str, arr: np.ndarray, want: Sequence[int]) -> torch.Tensor:
    """``arr`` as an f32 tensor, held to the manifest's shape ``want``."""
    if tuple(arr.shape) != tuple(want):
        raise ValueError(f"{key}: shape {tuple(arr.shape)} != expected {tuple(want)}")
    return _tensor(arr)


def _has_head(state: Mapping[str, Any], *keys: str) -> bool:
    """``state`` holds one of the head's ``keys``; a state without loads
    with the head left as it was."""
    if any(k in state for k in keys):
        return True
    logger.warning("state dict has no classifier head; head left random")
    return False


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


def clip_state_from_jax_params(params: Mapping[str, Any], cfg: ViTConfig) -> dict[str, torch.Tensor]:
    """flax tree of the JAX ``ClipImageEncoder`` (``{"vit": ..., "proj":
    {"kernel"}}``) -> the state dict of the port's ``ClipImageEncoder``."""
    state = {f"vit.{k}": v for k, v in vit_state_from_jax_params(params["vit"], cfg).items()}
    state["proj.weight"] = _tensor(_np(params["proj"]["kernel"]).T)
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
    out: dict[str, torch.Tensor] = {}
    for key, want in _vit_tower_manifest(cfg, head=_has_head(state, "head.weight")).items():
        arr = _get(state, key)
        if key == "cls_token":
            arr = arr.reshape(1, 1, cfg.hidden_dim)
        if key == "pos_embed" and arr.shape[1] != want[1]:
            raise ValueError(
                f"pos_embed has {arr.shape[1]} tokens, model expects {want[1]} "
                f"(interpolation not implemented)"
            )
        out[key] = _at(key, arr, want)
    return out


def eva02_params_from_torch_state(state: Mapping[str, Any], cfg: EVA02Config) -> dict[str, torch.Tensor]:
    """timm ``Eva`` state dict (``eva02_*`` with ``qkv_fused=False``, the
    wd-eva02 tagger's) -> the port's state dict (f32 tensors), every key of
    :func:`eva02_state_manifest` at its shape. A state dict without the head
    loads with the head left as it was."""
    manifest = eva02_state_manifest(cfg, head=_has_head(state, "head.weight"))
    return {key: _at(key, _get(state, key), want) for key, want in manifest.items()}


def clip_vit_params_from_torch_state(
    state: Mapping[str, Any], cfg: ViTConfig
) -> dict[str, torch.Tensor]:
    """OpenAI/open_clip CLIP *visual tower* state dict -> the state dict of
    ``index/embedder.ClipImageEncoder`` (timm names under ``vit.``, ``proj``).

    Accepts keys with or without the ``visual.`` prefix (a full CLIP state
    dict or an extracted tower). Expected naming (OpenAI CLIP / open_clip):
      conv1.weight (no bias), class_embedding, positional_embedding,
      ln_pre.{weight,bias},
      transformer.resblocks.N.{ln_1,ln_2}.{weight,bias},
      transformer.resblocks.N.attn.{in_proj_weight,in_proj_bias,
                                     out_proj.weight,out_proj.bias},
      transformer.resblocks.N.mlp.{c_fc,c_proj}.{weight,bias},
      ln_post.{weight,bias}, proj

    cfg must be built with ``ln_pre=True, patch_bias=False`` and
    ``act="quick_gelu"`` for OpenAI checkpoints (open_clip LAION models use
    plain GELU). ``in_proj_weight`` stacks q, k, v with the heads contiguous,
    the row order of timm's ``attn.qkv.weight``, so it carries over as it is.
    """
    d = cfg.hidden_dim
    prefix = "visual." if any(k.startswith("visual.") for k in state) else ""

    def get(key: str) -> np.ndarray:
        return _get(state, prefix + key).astype(np.float32)

    pos = get("positional_embedding")  # (T, D)
    want_tokens = cfg.num_patches + 1
    if pos.shape[0] != want_tokens:
        raise ValueError(
            f"positional_embedding has {pos.shape[0]} tokens, model expects "
            f"{want_tokens} (interpolation not implemented)"
        )
    out: dict[str, torch.Tensor] = {
        "vit.patch_embed.proj.weight": _tensor(get("conv1.weight")),  # (D, 3, P, P)
        "vit.cls_token": _tensor(get("class_embedding").reshape(1, 1, d)),
        "vit.pos_embed": _tensor(pos[None]),
        "vit.norm_pre.weight": _tensor(get("ln_pre.weight")),
        "vit.norm_pre.bias": _tensor(get("ln_pre.bias")),
    }
    names = (
        ("norm1", "ln_1"), ("attn.qkv", "attn.in_proj"), ("attn.proj", "attn.out_proj"),
        ("norm2", "ln_2"), ("mlp.fc1", "mlp.c_fc"), ("mlp.fc2", "mlp.c_proj"),
    )
    for i in range(cfg.depth):
        for ours, theirs in names:
            src = f"transformer.resblocks.{i}.{theirs}"
            if theirs == "attn.in_proj":
                weight, bias = get(src + "_weight"), get(src + "_bias")
            else:
                weight, bias = get(src + ".weight"), get(src + ".bias")
            out[f"vit.blocks.{i}.{ours}.weight"] = _tensor(weight)
            out[f"vit.blocks.{i}.{ours}.bias"] = _tensor(bias)
    out["vit.norm.weight"] = _tensor(get("ln_post.weight"))
    out["vit.norm.bias"] = _tensor(get("ln_post.bias"))
    out["proj.weight"] = _tensor(get("proj").T)  # (D, E) -> Linear's (E, D)
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

    The JAX tree holds a full (3, H, hd) qkv bias, whose thirds become
    ``attn.q_bias``, ``attn.k_bias`` and ``attn.v_bias`` (timm's SwinV2
    holds no k bias; the JAX step trains one, and so does the port's).
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
            state[pre + "attn.qkv.weight"] = _tensor(_np(attn["qkv"]["kernel"]).reshape(c, 3 * c).T)
            state[pre + "attn.q_bias"] = _tensor(qkv_bias[0])
            state[pre + "attn.k_bias"] = _tensor(qkv_bias[1])
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
    ``head.fc.*`` or a flat ``head.*``. The port's ``attn.k_bias`` is taken
    where the state has one (the port's own state) and is zero elsewhere
    (timm saves none). Derived buffers (CPB tables, index, masks) are
    ignored: the port builds its own. A state dict without the head loads
    with the head left as it was.
    """
    has_head = _has_head(state, "head.fc.weight", "head.weight")
    out: dict[str, torch.Tensor] = {}
    for key, want in swin_state_manifest(cfg).items():
        if key.startswith("head.fc."):
            if not has_head:
                continue
            arr = _get(state, key if key in state else key.replace("head.fc.", "head."))
        elif key.endswith(("attn.q_bias", "attn.v_bias")) and key not in state:
            pre = key.rsplit("attn.", 1)[0]
            qkv_bias = _get(state, pre + "attn.qkv.bias").reshape(3, -1)
            if np.any(qkv_bias[1] != 0):
                raise ValueError(f"{pre}attn.qkv.bias: the k slice is not zero; SwinV2 has no k bias")
            arr = qkv_bias[0] if key.endswith("q_bias") else qkv_bias[2]
        else:
            arr = _get(state, key)
        out[key] = _at(key, arr, want)
        if key.endswith("attn.q_bias"):
            k_key = key.replace("q_bias", "k_bias")
            out[k_key] = _at(k_key, _get(state, k_key) if k_key in state else np.zeros(want, np.float32), want)
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
    "k_bias",  # timm's SwinV2 fixes it at zero (a buffer); the port's trains it
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


def eva02_state_manifest(cfg: EVA02Config, *, head: bool = True) -> dict[str, tuple[int, ...]]:
    """Expected timm ``Eva`` weight keys -> shapes for ``cfg``: q and v
    projections with a bias, k without, SwiGLU's ``fc1_g`` / ``fc1_x`` /
    ``norm`` / ``fc2``, the mean pool's ``fc_norm`` and a flat ``head``. The
    RoPE table is derived (timm keeps it out of the state too)."""
    d, p, hidden = cfg.hidden_dim, cfg.patch_size, cfg.mlp_hidden
    m: dict[str, tuple[int, ...]] = {
        "cls_token": (1, 1, d),
        "pos_embed": (1, cfg.num_patches + 1, d),
        "patch_embed.proj.weight": (d, 3, p, p),
        "patch_embed.proj.bias": (d,),
    }
    for i in range(cfg.depth):
        pre = f"blocks.{i}."
        m[pre + "norm1.weight"] = (d,)
        m[pre + "norm1.bias"] = (d,)
        m[pre + "attn.q_proj.weight"] = (d, d)
        m[pre + "attn.q_proj.bias"] = (d,)
        m[pre + "attn.k_proj.weight"] = (d, d)
        m[pre + "attn.v_proj.weight"] = (d, d)
        m[pre + "attn.v_proj.bias"] = (d,)
        m[pre + "attn.proj.weight"] = (d, d)
        m[pre + "attn.proj.bias"] = (d,)
        m[pre + "norm2.weight"] = (d,)
        m[pre + "norm2.bias"] = (d,)
        for name in ("fc1_g", "fc1_x"):
            m[pre + f"mlp.{name}.weight"] = (hidden, d)
            m[pre + f"mlp.{name}.bias"] = (hidden,)
        m[pre + "mlp.norm.weight"] = (hidden,)
        m[pre + "mlp.norm.bias"] = (hidden,)
        m[pre + "mlp.fc2.weight"] = (d, hidden)
        m[pre + "mlp.fc2.bias"] = (d,)
    m["fc_norm.weight"] = (d,)
    m["fc_norm.bias"] = (d,)
    if head:
        m["head.weight"] = (cfg.num_classes, d)
        m["head.bias"] = (cfg.num_classes,)
    return m


def clip_vit_state_manifest(
    cfg: ViTConfig, *, embed_out: int = 512, prefix: str = "visual."
) -> dict[str, tuple[int, ...]]:
    """Expected OpenAI/open_clip CLIP visual-tower keys -> shapes for ``cfg``."""
    d, p = cfg.hidden_dim, cfg.patch_size
    mlp = cfg.mlp_dim
    tokens = cfg.num_patches + 1
    m: dict[str, tuple[int, ...]] = {
        prefix + "conv1.weight": (d, 3, p, p),
        prefix + "class_embedding": (d,),
        prefix + "positional_embedding": (tokens, d),
        prefix + "ln_pre.weight": (d,),
        prefix + "ln_pre.bias": (d,),
        prefix + "ln_post.weight": (d,),
        prefix + "ln_post.bias": (d,),
        prefix + "proj": (d, embed_out),
    }
    for i in range(cfg.depth):
        pre = f"{prefix}transformer.resblocks.{i}."
        m[pre + "ln_1.weight"] = (d,)
        m[pre + "ln_1.bias"] = (d,)
        m[pre + "attn.in_proj_weight"] = (3 * d, d)
        m[pre + "attn.in_proj_bias"] = (3 * d,)
        m[pre + "attn.out_proj.weight"] = (d, d)
        m[pre + "attn.out_proj.bias"] = (d,)
        m[pre + "ln_2.weight"] = (d,)
        m[pre + "ln_2.bias"] = (d,)
        m[pre + "mlp.c_fc.weight"] = (mlp, d)
        m[pre + "mlp.c_fc.bias"] = (mlp,)
        m[pre + "mlp.c_proj.weight"] = (d, mlp)
        m[pre + "mlp.c_proj.bias"] = (d,)
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


def _vit_tower_manifest(cfg: ViTConfig, *, head: bool) -> dict[str, tuple[int, ...]]:
    """:func:`vit_state_manifest` for the config's patch bias and ``norm_pre``."""
    m = vit_state_manifest(cfg, head=head)
    if not cfg.patch_bias:
        del m["patch_embed.proj.bias"]
    if cfg.ln_pre:
        m["norm_pre.weight"] = m["norm_pre.bias"] = (cfg.hidden_dim,)
    return m


def clip_encoder_state_manifest(cfg: ViTConfig, embed_dim: int) -> dict[str, tuple[int, ...]]:
    """Keys -> shapes of the port's own ``index/embedder.ClipImageEncoder``
    state dict: the headless timm-named ViT under ``vit.`` and ``proj``."""
    out = {f"vit.{k}": v for k, v in _vit_tower_manifest(cfg, head=False).items()}
    out["proj.weight"] = (embed_dim, cfg.hidden_dim)
    return out


def load_state_file(path: str | Path) -> Mapping[str, Any]:
    """A state dict from a ``.pt``/``.pth`` file (``torch.load`` with
    ``weights_only=True``; a ``state_dict`` key is unwrapped), a
    ``.safetensors`` file or an ``.onnx`` file (its initializers, as numpy)."""
    path = Path(path)
    if path.suffix == ".onnx":
        from kobato_eyes_tpu_torch.models.onnx_import import read_onnx_initializers

        return read_onnx_initializers(path)
    if path.suffix == ".safetensors":
        from safetensors.torch import load_file

        return load_file(str(path))
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return state


def import_torch_checkpoint(
    path: str | Path, cfg: ViTConfig | SwinConfig | EVA02Config, *, strict: bool = True
) -> dict[str, torch.Tensor]:
    """Load a ``.pt``/``.pth``, ``.safetensors`` or ``.onnx`` state dict and
    convert it to the port's state dict for ``cfg`` (a CLIP visual tower,
    recognised by its names, to ``index/embedder.ClipImageEncoder``'s).
    ``strict`` validates it against the config's manifest first, so drift
    fails with every offending key named; for ``.onnx`` a failed validation
    is retried once on the state with its constant-folded initializers
    recovered (``onnx_import.remap_folded_initializers``, corroborated by the
    graph's nodes), which must then validate strictly. A port checkpoint
    directory is validated against its own arch's manifest."""
    from kobato_eyes_tpu_torch.models.archs import arch_of

    path = Path(path)
    if path.is_dir():
        return _checkpoint_dir_state(path, cfg)
    is_onnx = path.suffix == ".onnx"
    state = load_state_file(path)

    def check(manifest: Mapping[str, Sequence[int]], st: Mapping[str, Any]) -> Mapping[str, Any]:
        try:
            validate_state_against_manifest(st, manifest, name=str(path))
            return st
        except StateDictMismatch:
            if not is_onnx:
                raise
            from kobato_eyes_tpu_torch.models.onnx_import import read_onnx_nodes, remap_folded_initializers

            try:
                # the graph's MatMul -> Add chains pair a folded weight with
                # its named bias exactly, where order alone could swap them
                nodes = read_onnx_nodes(path)
            except Exception:  # noqa: BLE001 - order pairing still applies
                nodes = None
            remapped, mapping = remap_folded_initializers(st, manifest, nodes)
            if not mapping:
                raise
            validate_state_against_manifest(remapped, manifest, name=str(path))
            return remapped

    arch = arch_of(cfg)
    # the naming family: a CLIP visual tower (conv1 / transformer.resblocks),
    # else the arch's timm names (patch_embed / blocks)
    if arch.clip and any(k.endswith("conv1.weight") or ".resblocks." in k for k in state):
        if strict:
            prefix = "visual." if any(k.startswith("visual.") for k in state) else ""
            proj = state.get(prefix + "proj")
            embed_out = int(_np(proj).shape[1]) if proj is not None else 512
            # a full CLIP state dict also carries the text tower; validate
            # the visual keys only (the importer reads only those)
            visual = {k: v for k, v in state.items() if not prefix or k.startswith(prefix)}
            visual = check(clip_vit_state_manifest(cfg, embed_out=embed_out, prefix=prefix), visual)
            state = {**state, **visual}
        return clip_vit_params_from_torch_state(state, cfg)
    if strict:
        state = check(arch.timm_manifest(cfg, state), state)
    return arch.from_timm(state, cfg)


def _checkpoint_dir_state(path: Path, cfg: ViTConfig | SwinConfig | EVA02Config) -> dict[str, torch.Tensor]:
    """The port's checkpoint directory, held to ``cfg``: its image size, an
    arch that fits the config, and that arch's key/shape manifest (a tagger
    checkpoint's state is already timm-named, a ``clip`` one the embedder's
    own)."""
    from kobato_eyes_tpu_torch.models.archs import arch_of
    from kobato_eyes_tpu_torch.models.tagger import checkpoint_state

    arch = arch_of(cfg)
    fits = (arch.name, "clip") if arch.clip else (arch.name,)

    def key_manifest(meta: dict[str, Any]) -> dict[str, tuple[int, ...]]:
        held = meta.get("arch")
        if held not in fits:
            raise ValueError(f"{path} holds a {held!r} checkpoint, not a {arch.module.__name__} one")
        if held == "clip":
            return clip_encoder_state_manifest(cfg, int(meta["embed_dim"]))
        return arch.state_manifest(cfg)

    state, _ = checkpoint_state(path, expect={"image_size": cfg.image_size}, key_manifest=key_manifest)
    return {k: v.float() for k, v in state.items()}
