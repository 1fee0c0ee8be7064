"""SwinV2 backbone as a torch ``nn.Module``.

Counterpart of ``kobato_eyes_tpu/models/swin.py``: cosine attention with a
learnable clamped logit scale, log-CPB relative position bias, post-norm
residuals, shifted windows and patch merging, with the same config knobs
and values. Parameter names are timm's (``SwinTransformerV2``), so a timm
state dict loads as it is and ``models/import_weights.py`` maps the JAX
package's flax tree onto them.

Numerics follow the JAX module: parameters in ``param_dtype`` (f32) cast to
``dtype`` (bf16) at use, activations in ``dtype``, cosine logits, the CPB
MLP and the softmax in f32. ``attn_impl="pallas"`` sends every block's
attention to the CUDA window kernel (``ops/window_attention.py``) and
``ln_impl="pallas_residual"`` the post-norm residuals to the CUDA LayerNorm
kernel (``ops/layernorm_residual.py``); on the CPU both take their plain
versions. The shift mask and the relative coordinates are constants of each
block, built once as buffers that move with the module to its device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch import nn

from kobato_eyes_tpu_torch.models.vit import LayerNorm, Linear, Mlp
from kobato_eyes_tpu_torch.ops import layernorm, xla_math
from kobato_eyes_tpu_torch.ops.layernorm_residual import layernorm_residual
from kobato_eyes_tpu_torch.ops.window_attention import windowed_cosine_attention_packed

CPB_HIDDEN = 512


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    image_size: int = 448
    patch_size: int = 4
    embed_dim: int = 96
    depths: tuple[int, ...] = (2, 2, 6, 2)
    num_heads: tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    # window size the checkpoint was pretrained at (0 = window_size): the
    # CPB coordinate normalisation denominator, as SwinV2's
    # pretrained_window_sizes
    pretrained_window_size: int = 0
    mlp_ratio: float = 4.0
    num_classes: int = 8192
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    # "einsum" (explicit f32 cosine logits and softmax) | "pallas" (in this
    # package: the hand-written CUDA window kernel of ops/window_attention.py)
    attn_impl: str = "einsum"
    act: str = "gelu"  # "gelu" | "gelu_tanh"
    # operands of the window kernel's QK products: "default" and "highest"
    # f32, "bf16" rounded to bf16 (see ops/window_attention.py)
    qk_precision: str = "default"
    # post-norm residuals: "xla" (the JAX package's formulation, written out
    # in torch) | "pallas_residual" (the CUDA kernel of
    # ops/layernorm_residual.py; off by default, as in the JAX package)
    ln_impl: str = "xla"

    def __post_init__(self) -> None:
        if self.attn_impl not in ("einsum", "pallas"):
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
        if self.act not in ("gelu", "gelu_tanh"):
            raise ValueError(f"unknown act {self.act!r}")
        if self.qk_precision not in ("default", "bf16", "highest"):
            raise ValueError(f"unknown qk_precision {self.qk_precision!r}")
        if self.ln_impl not in ("xla", "pallas_residual"):
            raise ValueError(f"unknown ln_impl {self.ln_impl!r}")

    @property
    def num_stages(self) -> int:
        return len(self.depths)

    def grid(self, stage: int) -> int:
        return self.image_size // self.patch_size // (2**stage)


_PRESETS: dict[str, dict[str, Any]] = {
    "tiny": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    "small": dict(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)),
    "base": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
}


def swin_config(preset: str = "base", **overrides: Any) -> SwinConfig:
    if preset not in _PRESETS:
        raise ValueError(f"unknown Swin preset {preset!r}; have {sorted(_PRESETS)}")
    kw: dict[str, Any] = dict(_PRESETS[preset])
    kw.update(overrides)
    cfg = SwinConfig(**kw)
    for s in range(cfg.num_stages):
        if cfg.grid(s) % cfg.window_size != 0:
            raise ValueError(
                f"stage {s} grid {cfg.grid(s)} not divisible by window {cfg.window_size}"
            )
    return cfg


def _window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, w*w, C)."""
    b, h, wd, c = x.shape
    x = x.reshape(b, h // w, w, wd // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def _window_reverse(x: torch.Tensor, w: int, h: int, wd: int) -> torch.Tensor:
    """(B*nW, w*w, C) -> (B, H, W, C)."""
    c = x.shape[-1]
    b = x.shape[0] // ((h // w) * (wd // w))
    x = x.reshape(b, h // w, wd // w, w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, wd, c)


def _relative_log_coords(w: int, pretrained_w: int = 0) -> np.ndarray:
    """(w*w, w*w, 2) log-spaced continuous relative coordinates (SwinV2 CPB):
    normalised by (window - 1) of the pretraining window, scaled to [-8, 8],
    then sign(x) * log2(|x| + 1) / log2(8)."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"), axis=-1)
    flat = coords.reshape(-1, 2)
    rel = (flat[:, None, :] - flat[None, :, :]).astype(np.float32)
    denom = max((pretrained_w if pretrained_w > 0 else w) - 1, 1)
    rel = rel / denom * 8.0
    return np.sign(rel) * np.log2(np.abs(rel) + 1.0) / np.log2(8.0)


def _shift_attn_mask(grid: int, w: int, shift: int) -> np.ndarray:
    """(nW, w*w, w*w) additive mask for shifted windows: -100.0 (SwinV2's soft
    mask, not -inf) between tokens of different regions."""
    img = np.zeros((grid, grid), dtype=np.int32)
    cnt = 0
    slices = (slice(0, -w), slice(-w, -shift), slice(-shift, None))
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    windows = img.reshape(grid // w, w, grid // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    diff = windows[:, :, None] != windows[:, None, :]
    return np.where(diff, -100.0, 0.0).astype(np.float32)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


class WindowAttention(nn.Module):
    """SwinV2 window attention: qkv with q, k and v biases, the clamped logit
    scale, the log-CPB bias MLP and the output projection.

    timm's SwinV2 fixes the k bias at zero (a buffer it does not save); the
    JAX package's qkv bias spans q, k and v and trains all three, so here
    ``k_bias`` is a parameter, zero-initialised. A state without it (timm
    names) loads it as zero, and the forward is then timm's."""

    def __init__(self, cfg: SwinConfig, dim: int, num_heads: int, num_windows: int) -> None:
        super().__init__()
        self.cfg = cfg
        self.num_heads = num_heads
        self.num_windows = num_windows
        self.qkv = Linear(dim, 3 * dim, cfg, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim, dtype=cfg.param_dtype))
        self.k_bias = nn.Parameter(torch.zeros(dim, dtype=cfg.param_dtype))
        self.v_bias = nn.Parameter(torch.zeros(dim, dtype=cfg.param_dtype))
        self.logit_scale = nn.Parameter(
            torch.full((num_heads, 1, 1), math.log(10.0), dtype=torch.float32)
        )
        self.cpb_mlp = nn.Sequential(
            Linear(2, CPB_HIDDEN, cfg, dtype=torch.float32),
            nn.ReLU(),
            Linear(CPB_HIDDEN, num_heads, cfg, bias=False, dtype=torch.float32),
        )
        self.proj = Linear(dim, dim, cfg)
        rel = _relative_log_coords(cfg.window_size, cfg.pretrained_window_size)
        self.register_buffer("relative_coords", torch.from_numpy(rel.astype(np.float32)), persistent=False)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # a timm-named state holds no k bias: it loads as zero
        state_dict.setdefault(prefix + "k_bias", torch.zeros_like(self.k_bias))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def cpb_bias(self) -> torch.Tensor:
        """(H, n, n) f32: 16 * sigmoid(MLP(relative coordinates))."""
        return (16.0 * torch.sigmoid(self.cpb_mlp(self.relative_coords))).permute(2, 0, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        cfg = self.cfg
        bnw, n, c = x.shape
        heads = self.num_heads
        hd = c // heads
        # in f32 even from bf16 parameters: the JAX module's minimum against an
        # f32 constant promotes a bf16 logit scale before the exp
        scale = torch.exp(torch.clamp(self.logit_scale.float(), max=math.log(100.0)))
        bias = self.cpb_bias()
        qkv_bias = torch.cat([self.q_bias, self.k_bias, self.v_bias])
        if cfg.attn_impl == "pallas":
            # the window axis stays unflattened through qkv, and the output
            # projection reads the kernel's (B, nW, n, H, hd) buffer as is
            xw = x.reshape(-1, self.num_windows, n, c)
            qkv = self.qkv(xw) + qkv_bias.to(cfg.dtype)
            qkv = qkv.reshape(*xw.shape[:3], 3, heads, hd)
            out = windowed_cosine_attention_packed(
                qkv, scale.reshape(heads), bias, mask, qk_precision=cfg.qk_precision
            )  # (B, H, nW, n, hd)
            return self.proj(out.permute(0, 2, 3, 1, 4).reshape(bnw, n, c))
        qkv = (self.qkv(x) + qkv_bias.to(cfg.dtype)).reshape(bnw, n, 3, heads, hd)
        q, k, v = qkv.unbind(dim=2)
        qf, kf = q.float(), k.float()
        q = qf / torch.clamp(torch.sqrt((qf * qf).sum(-1, keepdim=True)), min=1e-6)
        k = kf / torch.clamp(torch.sqrt((kf * kf).sum(-1, keepdim=True)), min=1e-6)
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k)
        attn = attn * scale[None] + bias[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(-1, nw, heads, n, n) + mask[None, :, None]
            attn = attn.reshape(-1, heads, n, n)
        attn = torch.softmax(attn, dim=-1).to(cfg.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v)
        return self.proj(out.reshape(bnw, n, c))


class ResidualPostNorm(nn.Module):
    """``shortcut + LayerNorm(x)`` with timm's ``normN.{weight,bias}``.

    ``ln_impl="xla"`` is the JAX package's formulation: f32 statistics with
    E[x^2] - E[x]^2 and no clamp (unlike flax's ``nn.LayerNorm``, which
    ``vit.LayerNorm`` copies), XLA's CPU rsqrt (``xla_math.rsqrt``, as
    ``jax.lax.rsqrt`` there), the normalised value rounded to ``dtype``, then
    added to the shortcut in ``dtype``; on a CUDA tensor while autograd does
    not record (``layernorm.takes_kernel``) one pass of the LayerNorm kernel
    computes the same (``ops/layernorm.py``: the statistics summed in its own
    order). ``"pallas_residual"`` goes to the residual LayerNorm kernel,
    which adds in f32 and rounds once.
    """

    def __init__(self, dim: int, cfg: SwinConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.weight = nn.Parameter(torch.ones(dim, dtype=cfg.param_dtype))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=cfg.param_dtype))

    def forward(self, x: torch.Tensor, shortcut: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.ln_impl == "pallas_residual":
            return layernorm_residual(x, shortcut.to(cfg.dtype), self.weight, self.bias, eps=1e-5)
        if layernorm.takes_kernel(x, self.weight, self.bias, shortcut):
            return layernorm.layernorm(x, self.weight, self.bias, eps=1e-5, dtype=cfg.dtype, shortcut=shortcut)
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
        y = (xf - mean) * xla_math.rsqrt(var + 1e-5)
        y = y * self.weight + self.bias  # in f32, bf16 parameters read as stored
        return shortcut.to(cfg.dtype) + y.to(cfg.dtype)


class SwinBlock(nn.Module):
    def __init__(self, cfg: SwinConfig, dim: int, num_heads: int, grid: int, shift: int) -> None:
        super().__init__()
        self.window = cfg.window_size
        self.shift = shift
        self.attn = WindowAttention(cfg, dim, num_heads, (grid // cfg.window_size) ** 2)
        self.norm1 = ResidualPostNorm(dim, cfg)
        self.mlp = Mlp(dim, int(dim * cfg.mlp_ratio), cfg)
        self.norm2 = ResidualPostNorm(dim, cfg)
        mask = torch.from_numpy(_shift_attn_mask(grid, cfg.window_size, shift)) if shift > 0 else None
        self.register_buffer("attn_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, wd, c = x.shape
        shortcut = x
        if self.shift > 0:
            x = torch.roll(x, shifts=(-self.shift, -self.shift), dims=(1, 2))
        attn = self.attn(_window_partition(x, self.window), self.attn_mask)
        x = _window_reverse(attn, self.window, h, wd)
        if self.shift > 0:
            x = torch.roll(x, shifts=(self.shift, self.shift), dims=(1, 2))
        x = self.norm1(x, shortcut)
        return self.norm2(self.mlp(x), x)


class PatchMerging(nn.Module):
    """2x2 neighbourhoods concatenated in timm's order (0,0), (1,0), (0,1),
    (1,1) as (dy, dx), then ``reduction`` and ``norm``."""

    def __init__(self, dim: int, cfg: SwinConfig) -> None:
        super().__init__()
        self.reduction = Linear(4 * dim, 2 * dim, cfg, bias=False)
        self.norm = LayerNorm(2 * dim, cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 4, 2, 5)
        x = x.reshape(b, h // 2, w // 2, 4 * c)
        return self.norm(self.reduction(x))


class PatchEmbed(nn.Module):
    """timm's ``patch_embed.proj`` conv weight (D, C, P, P), applied as one
    matmul over patches flattened in (py, px, c) order, then ``norm``."""

    def __init__(self, cfg: SwinConfig) -> None:
        super().__init__()
        self.cfg = cfg
        p, d = cfg.patch_size, cfg.embed_dim
        self.proj = nn.Module()
        self.proj.weight = nn.Parameter(torch.empty(d, 3, p, p, dtype=cfg.param_dtype))
        self.proj.bias = nn.Parameter(torch.zeros(d, dtype=cfg.param_dtype))
        self.norm = LayerNorm(d, cfg)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, h, w, c = images.shape
        p = cfg.patch_size
        x = images.to(cfg.dtype).reshape(b, h // p, p, w // p, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // p, w // p, p * p * c)
        kernel = self.proj.weight.permute(2, 3, 1, 0).reshape(p * p * c, cfg.embed_dim)
        x = torch.matmul(x, kernel.to(cfg.dtype)) + self.proj.bias.to(cfg.dtype)
        return self.norm(x)


class SwinStage(nn.Module):
    """timm's ``layers.S``: the downsample of stage S-1's output (S >= 1),
    then the stage's blocks, odd ones shifted by half a window."""

    def __init__(self, cfg: SwinConfig, stage: int) -> None:
        super().__init__()
        dim = cfg.embed_dim * 2**stage
        self.downsample = PatchMerging(dim // 2, cfg) if stage > 0 else None
        grid = cfg.grid(stage)
        self.blocks = nn.ModuleList(
            SwinBlock(cfg, dim, cfg.num_heads[stage], grid, 0 if i % 2 == 0 else cfg.window_size // 2)
            for i in range(cfg.depths[stage])
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample is not None:
            x = self.downsample(x)
        for block in self.blocks:
            x = block(x)
        return x


class SwinV2(nn.Module):
    """SwinV2 image classifier. Input is NHWC float (preprocessed); the
    forward returns f32 logits, or the pooled features with
    ``features_only=True``."""

    def __init__(self, cfg: SwinConfig) -> None:
        super().__init__()
        self.cfg = cfg
        d_final = cfg.embed_dim * 2 ** (cfg.num_stages - 1)
        self.patch_embed = PatchEmbed(cfg)
        self.layers = nn.ModuleList(SwinStage(cfg, s) for s in range(cfg.num_stages))
        self.norm = LayerNorm(d_final, cfg)
        self.head = nn.Module()
        self.head.fc = Linear(d_final, cfg.num_classes, cfg)

    def forward(self, images: torch.Tensor, *, features_only: bool = False) -> torch.Tensor:
        cfg = self.cfg
        _, h, w, _ = images.shape
        if h != cfg.image_size or w != cfg.image_size:
            raise ValueError(f"expected {cfg.image_size}px input, got {h}x{w}")
        x = self.patch_embed(images)
        for layer in self.layers:
            x = layer(x)
        x = self.norm(x)
        # jnp.mean over bf16 sums in f32 and rounds once
        feat = x.float().mean(dim=(1, 2)).to(cfg.dtype)
        if features_only:
            return feat
        return self.head.fc(feat).float()


@torch.no_grad()
def init_swin_(model: SwinV2, generator: torch.Generator) -> SwinV2:
    """Random init in place from a seeded generator (flax's defaults:
    lecun-normal kernels, zero biases, unit norm scales, logit scale
    log 10). Draws on the CPU, so the numbers do not depend on the device
    the model lives on."""
    for name, param in model.named_parameters():
        if name.endswith("weight") and param.dim() >= 2:
            fan_in = math.prod(param.shape[1:])
            values = torch.randn(param.shape, generator=generator) / math.sqrt(fan_in)
            param.copy_(values.to(param.dtype))
    return model


def swin_forward_flops(cfg: SwinConfig, batch_size: int, *, with_head: bool = True) -> float:
    """Analytic matmul FLOPs of one forward pass (2 FLOPs per MAC): qkv, proj
    and MLP projections, windowed QK and PV, patch embed, patch merging and
    the head; norms and the CPB MLP left out (under 1%)."""
    p = cfg.patch_size
    t0 = (cfg.image_size // p) ** 2
    total = 2.0 * t0 * (p * p * 3) * cfg.embed_dim
    for s, depth in enumerate(cfg.depths):
        c = cfg.embed_dim * (2**s)
        t = cfg.grid(s) ** 2
        mlp = cfg.mlp_ratio * c
        per_block = (
            2 * t * c * 3 * c
            + 4 * t * (cfg.window_size**2) * c
            + 2 * t * c * c
            + 2 * 2 * t * c * mlp
        )
        total += depth * per_block
        if s < cfg.num_stages - 1:
            total += 2 * (t / 4) * (4 * c) * (2 * c)
    if with_head:
        total += 2 * cfg.embed_dim * (2 ** (cfg.num_stages - 1)) * cfg.num_classes
    return float(batch_size) * total
