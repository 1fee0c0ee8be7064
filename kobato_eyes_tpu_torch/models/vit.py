"""Vision Transformer backbone as a torch ``nn.Module``.

Counterpart of ``kobato_eyes_tpu/models/vit.py``, with the same config knobs
and values so that a config carries across unchanged. Parameter names are
timm's (``VisionTransformer``), so a timm state dict loads as it is and
``models/import_weights.py`` maps the JAX package's flax tree onto them.

Numerics follow the JAX module's ``dtype`` / ``param_dtype`` split, written
out rather than left to ``torch.autocast``: parameters are kept in
``param_dtype`` (f32) and cast to ``dtype`` (bf16) at each use, activations
run in ``dtype``, LayerNorm statistics and the attention softmax in f32. A
float32 comparison needs TF32 off on the card
(``torch.backends.cuda.matmul.allow_tf32 = False``, the default); the patch
embedding is a reshape then a matmul, not a cuDNN convolution, so cuDNN's
TF32 default never applies.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from kobato_eyes_tpu_torch.ops import layernorm, xla_math
from kobato_eyes_tpu_torch.ops.gelu import gelu


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Architecture hyperparameters.

    Defaults are ViT-B/16 at 448 px — the WD14-class operating point.
    """

    image_size: int = 448
    patch_size: int = 16
    hidden_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    num_classes: int = 8192
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = False  # training knob of the JAX package; no effect on inference
    pool: str = "cls"  # "cls" | "gap"
    # CLIP-visual variants: pre-transformer LayerNorm, bias-less patch
    # embedding, QuickGELU activation.
    ln_pre: bool = False
    patch_bias: bool = True
    act: str = "gelu"  # "gelu" | "quick_gelu" | "gelu_tanh"
    # lax.scan unroll factor in the JAX package; the layers here are a
    # Python loop, so it has no effect (kept so configs carry across)
    unroll: int = 1
    # attn_impl: "einsum" (explicit f32 logits / softmax / weighted sum, the
    # exact path), "fused" (XLA's library attention in the JAX package: here
    # F.scaled_dot_product_attention), "flash" (the JAX package's Pallas
    # flash attention, forward and backward: here the hand-written CUDA
    # kernels of ops/flash_attention.py, which train), "pallas" (the
    # hand-written CUDA kernel of ops/attention.py, forward only).
    attn_impl: str = "einsum"

    def __post_init__(self) -> None:
        if self.attn_impl not in ("einsum", "fused", "flash", "pallas"):
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
        if self.act not in ("gelu", "quick_gelu", "gelu_tanh"):
            raise ValueError(f"unknown act {self.act!r}")
        if self.pool not in ("cls", "gap"):
            raise ValueError(f"unknown pool {self.pool!r}")

    @property
    def num_patches(self) -> int:
        side = self.image_size // self.patch_size
        return side * side


_PRESETS: dict[str, dict[str, int]] = {
    # name: hidden, depth, heads, mlp
    "tiny": dict(hidden_dim=192, depth=4, num_heads=3, mlp_dim=512),
    "small": dict(hidden_dim=384, depth=12, num_heads=6, mlp_dim=1536),
    "base": dict(hidden_dim=768, depth=12, num_heads=12, mlp_dim=3072),
    "large": dict(hidden_dim=1024, depth=24, num_heads=16, mlp_dim=4096),
}


def vit_config(preset: str = "base", **overrides: Any) -> ViTConfig:
    if preset not in _PRESETS:
        raise ValueError(f"unknown ViT preset {preset!r}; have {sorted(_PRESETS)}")
    kw: dict[str, Any] = dict(_PRESETS[preset])
    kw.update(overrides)
    return ViTConfig(**kw)


def vit_forward_flops(cfg: ViTConfig, batch_size: int, *, with_head: bool = True) -> float:
    """Analytic matmul FLOPs of one forward pass (2 FLOPs per MAC)."""
    d, t = cfg.hidden_dim, cfg.num_patches + 1
    patch = 2 * cfg.num_patches * (cfg.patch_size**2 * 3) * d
    per_layer = (
        2 * t * d * 3 * d  # qkv projection
        + 2 * 2 * t * t * d  # attention logits + weighted sum
        + 2 * t * d * d  # output projection
        + 2 * 2 * t * d * cfg.mlp_dim  # fc1 + fc2
    )
    head = 2 * d * cfg.num_classes if with_head else 0
    return float(batch_size) * (patch + cfg.depth * per_layer + head)


# ---------------------------------------------------------------------------
# Layers (flax Dense / LayerNorm semantics on f32 parameters)
# ---------------------------------------------------------------------------


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP's ``x * sigmoid(1.702 x)`` as XLA evaluates the JAX
    package's ``h * jax.nn.sigmoid(1.702 * h)``: 1.702 rounded to x's dtype,
    then ``1 / (1 + exp(-z))`` with every step rounded to the dtype.

    ``x * torch.sigmoid(1.702 * x)`` (an f32 constant, the sigmoid in f32
    with one rounding) differs from XLA's CPU result on 30.6% of 200 000
    bf16 values of N(0, 9); this form on none
    (``tests/test_torch_ann_embedder.py``)."""
    c = _dtype_constant(1.702, x.dtype)
    return x * (1.0 / (1.0 + torch.exp(-(c * x))))


@functools.lru_cache(maxsize=None)
def _dtype_constant(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float (exact in the dtype,
    so it multiplies as the dtype's own constant would)."""
    return float(torch.tensor(value, dtype=dtype))


class Linear(nn.Module):
    """``y = x @ W^T + b`` in ``dtype``: W and b are cast at use, and the bias
    is added after the product is rounded, as flax's Dense does."""

    def __init__(self, d_in: int, d_out: int, cfg: Any, *, bias: bool = True, dtype: Any = None) -> None:
        super().__init__()
        self.dtype = cfg.dtype if dtype is None else dtype
        self.weight = nn.Parameter(torch.empty(d_out, d_in, dtype=cfg.param_dtype))
        self.bias = nn.Parameter(torch.zeros(d_out, dtype=cfg.param_dtype)) if bias else None

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ W^T`` in ``dtype``, without the bias (a tensor-parallel
        partial: the bias is added once, after the partials are summed)."""
        return torch.matmul(x.to(self.dtype), self.weight.to(self.dtype).t())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.product(x)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class LayerNorm(nn.Module):
    """flax LayerNorm: f32 statistics with the fast variance
    ``max(E[x^2] - E[x]^2, 0)``, eps inside the rsqrt (XLA's CPU rsqrt, which
    flax's ``lax.rsqrt`` is there: ``xla_math.rsqrt``), output in ``dtype``.
    On a CUDA tensor while autograd does not record (``layernorm.takes_kernel``)
    one pass of the LayerNorm kernel computes the same (``ops/layernorm.py``:
    the statistics summed in its own order)."""

    def __init__(self, dim: int, cfg: Any, eps: float = 1e-5) -> None:
        super().__init__()
        self.dtype = cfg.dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=cfg.param_dtype))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=cfg.param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if layernorm.takes_kernel(x, self.weight, self.bias):
            return layernorm.layernorm(x, self.weight, self.bias, eps=self.eps, dtype=self.dtype)
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        mu2 = (xf * xf).mean(dim=-1, keepdim=True)
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        # f32 times the weight's own dtype computes in f32 with no cast pass:
        # bf16 parameters (``bf16_params``) are read as they are stored
        mul = xla_math.rsqrt(var + self.eps) * self.weight
        return ((xf - mu) * mul + self.bias).to(self.dtype)


class Attention(nn.Module):
    """``heads``: how many of the config's heads this module holds (all by
    default; a tensor-parallel shard holds a contiguous run of them)."""

    def __init__(self, cfg: ViTConfig, heads: int | None = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.heads = cfg.num_heads if heads is None else heads
        inner = self.heads * (cfg.hidden_dim // cfg.num_heads)
        self.qkv = Linear(cfg.hidden_dim, 3 * inner, cfg)
        self.proj = Linear(inner, cfg.hidden_dim, cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(self.heads_out(x))

    def heads_out(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, heads * head_dim): the attention of this module's heads,
        before the output projection."""
        cfg = self.cfg
        b, t, _ = x.shape
        heads = self.heads
        head_dim = cfg.hidden_dim // cfg.num_heads
        scale = head_dim**-0.5
        qkv = self.qkv(x).view(b, t, 3, heads, head_dim)  # timm's (3, H, D) row order
        if cfg.attn_impl == "pallas":
            from kobato_eyes_tpu_torch.ops.attention import head_resident_attention_packed

            out = head_resident_attention_packed(qkv, scale=scale)
        elif cfg.attn_impl == "flash":
            from kobato_eyes_tpu_torch.ops.flash_attention import flash_attention_packed

            out = flash_attention_packed(qkv, scale)
        else:
            q, k, v = qkv.unbind(dim=2)  # (B, T, H, D)
            if cfg.attn_impl == "fused":
                out = F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale
                ).transpose(1, 2)
            else:
                logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
                weights = torch.softmax(logits * scale, dim=-1).to(cfg.dtype)
                out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return out.reshape(b, t, heads * head_dim)


class Mlp(nn.Module):
    """fc1 -> activation -> fc2; SwinV2's blocks use it too."""

    def __init__(self, dim: int, hidden: int, cfg: Any) -> None:
        super().__init__()
        self.act = cfg.act
        self.fc1 = Linear(dim, hidden, cfg)
        self.fc2 = Linear(hidden, dim, cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.hidden(x))

    def hidden(self, x: torch.Tensor) -> torch.Tensor:
        """The activation of fc1, before fc2."""
        h = self.fc1(x)
        if self.act == "quick_gelu":  # OpenAI CLIP: x * sigmoid(1.702 x)
            return quick_gelu(h)
        # XLA's erf or tanh sequence (ops/gelu.py): F.gelu rounds once
        return gelu(h, approximate=self.act == "gelu_tanh")


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, split: tuple[int, int, int] = (1, 1, 1)) -> None:
        super().__init__()
        self.norm1 = LayerNorm(cfg.hidden_dim, cfg)
        self.attn = Attention(cfg, cfg.num_heads // split[0])
        self.norm2 = LayerNorm(cfg.hidden_dim, cfg)
        self.mlp = Mlp(cfg.hidden_dim, cfg.mlp_dim // split[1], cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = attention_residual(x, self.attn(self.norm1(x)))
        return s.to(x.dtype) + self.mlp(self.norm2(s))


def attention_residual(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``x + a`` in f32, not rounded to the block's dtype: XLA's compiled JAX
    block keeps this sum in f32 where ``ln2`` reads it (its excess precision
    drops the bf16 round trip inside the fusion) and rounds it only where
    the MLP's output is added. Rounding it before ``ln2`` as well put 5-7% of
    a bf16 block's outputs one bf16 step apart from the JAX package's."""
    return x.float() + a


class PatchEmbed(nn.Module):
    """timm's ``patch_embed.proj`` conv weight (D, C, P, P), applied as one
    matmul over patches flattened in (py, px, c) order."""

    def __init__(self, cfg: ViTConfig) -> None:
        super().__init__()
        self.proj = nn.Module()
        p = cfg.patch_size
        self.proj.weight = nn.Parameter(torch.empty(cfg.hidden_dim, 3, p, p, dtype=cfg.param_dtype))
        self.proj.bias = (
            nn.Parameter(torch.zeros(cfg.hidden_dim, dtype=cfg.param_dtype)) if cfg.patch_bias else None
        )
        self.cfg = cfg

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, h, w, c = images.shape
        p = cfg.patch_size
        x = images.to(cfg.dtype).reshape(b, h // p, p, w // p, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, cfg.num_patches, p * p * c)
        kernel = self.proj.weight.permute(2, 3, 1, 0).reshape(p * p * c, cfg.hidden_dim)
        x = torch.matmul(x, kernel.to(cfg.dtype))
        if self.proj.bias is not None:
            x = x + self.proj.bias.to(cfg.dtype)
        return x


class ViT(nn.Module):
    """ViT image encoder with a classifier head.

    Input is NHWC float (preprocessed; see models/preprocess.py); the
    forward returns f32 logits, or the pooled features with
    ``features_only=True``.

    ``split``: into how many tensor-parallel shards the attention heads, the
    MLP width and the classes are cut; the module then holds one shard of
    each (``models/mesh_forward.py`` runs them), under timm's names.
    """

    def __init__(self, cfg: ViTConfig, split: tuple[int, int, int] = (1, 1, 1)) -> None:
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_dim
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, dtype=cfg.param_dtype))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, d, dtype=cfg.param_dtype))
        self.norm_pre = LayerNorm(d, cfg) if cfg.ln_pre else None
        self.blocks = nn.ModuleList(Block(cfg, split) for _ in range(cfg.depth))
        self.norm = LayerNorm(d, cfg)
        self.head = Linear(d, cfg.num_classes // split[2], cfg)

    def forward(self, images: torch.Tensor, *, features_only: bool = False) -> torch.Tensor:
        cfg = self.cfg
        b, h, w, _ = images.shape
        if h != cfg.image_size or w != cfg.image_size:
            raise ValueError(f"expected {cfg.image_size}px input, got {h}x{w}")
        x = self.embed(images)
        for block in self.blocks:
            x = block(x)
        feat = self.pool(x)
        if features_only:
            return feat
        return self.head(feat).float()

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """Patch embedding, cls token, position embedding (and ln_pre)."""
        cfg = self.cfg
        x = self.patch_embed(images)
        cls = self.cls_token.to(cfg.dtype).expand(x.shape[0], 1, cfg.hidden_dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(cfg.dtype)
        return x if self.norm_pre is None else self.norm_pre(x)

    def pool(self, x: torch.Tensor) -> torch.Tensor:
        """The final norm and the pooled feature."""
        x = self.norm(x)
        return x[:, 0] if self.cfg.pool == "cls" else x[:, 1:].mean(dim=1)


@torch.no_grad()
def init_vit_(model: ViT, generator: torch.Generator) -> ViT:
    """Random init in place from a seeded generator (flax's defaults:
    lecun-normal kernels, zero biases, unit LayerNorm scales, zero cls, pos
    normal(0.02)). Draws on the CPU, so the numbers do not depend on the
    device the model lives on."""
    for name, param in model.named_parameters():
        if name == "pos_embed":
            values = torch.randn(param.shape, generator=generator) * 0.02
        elif name.endswith("weight") and param.dim() >= 2:
            fan_in = math.prod(param.shape[1:])
            values = torch.randn(param.shape, generator=generator) / math.sqrt(fan_in)
        else:
            continue  # biases, LayerNorm and cls keep their constant init
        param.copy_(values.to(param.dtype))
    return model
