"""EVA02 backbone as a torch ``nn.Module``: the encoder of the PixAI tagger.

PixAI Tagger v0.9 (``pixai-labs/pixai-tagger-v0.9``) builds its encoder with
timm as ``hf_hub:SmilingWolf/wd-eva02-large-tagger-v3``, which is timm's
``eva02_large_patch14_448``, and puts a linear head of 13 461 outputs on the
pooled feature. The JAX package has no EVA02; this module is the port's own.
Parameter names are timm's (``Eva``), so a timm state dict loads as it is.

Per image (published widths, the defaults of :class:`EVA02Config`):

* patch embedding: a 14x14 stride-14 conv (3 -> 1024, with bias) over the
  normalised RGB picture, 32x32 = 1024 patches; the class token, then the
  absolute position embedding (1, 1025, 1024);
* 24 pre-norm blocks (LayerNorm eps 1e-6, no layer scale):
  ``x = x + Attn(LN1(x)); x = x + SwiGLU(LN2(x))``;
* attention: 16 heads of 64, separate projections, q and v with a bias and k
  without; 2D RoPE rotates q and k of the patch tokens (not the class
  token); ``softmax(q k^T / 8) v``, then ``proj`` with a bias;
* RoPE (timm's ``RotaryEmbeddingCat`` with ``in_pixels=False``,
  ``ref_feat_shape`` 16, temperature 10 000): bands ``10000^(-m/16)``; the
  patch at row i and column j sits at ``y = i * 16 / 32``, ``x = j * 16 / 32``;
  its 32 angles are ``[y b_0 .. y b_15, x b_0 .. x b_15]``, angle m turning
  the pair (2m, 2m+1) of a head's 64 columns (:func:`rope_table`);
* SwiGLU with a sub-LayerNorm (timm's ``SwiGLU``, ``scale_mlp=True``), hidden
  ``int(1024 * 4 * 2/3)`` = 2730:
  ``h = LN_h(SiLU(x W_g^T + b_g) * (x W_x^T + b_x)); out = h W_2^T + b_2``.
  Where the LayerNorm kernel runs (``layernorm.takes_kernel``) and the hidden
  width is not a multiple of 8, the hidden activations lie at a pitch that
  is a multiple of 64 (:func:`swiglu_pitch`: 2752 columns): the three
  products' operands are then 16-byte aligned and cuBLAS takes its Hopper
  kernels, where at 2730 it falls back to a 2-element-aligned sm80 one (a
  SwiGLU at B = 32 on one H100: 1.75 ms against 3.31; 1.78 at the 16-byte
  minimum of 2736, where two of the three products take another tile, and
  the PixAI tagger ran 1.6-1.9% fewer images/s). The pad columns are exact zeros
  (zero weight rows and biases, SiLU(0) * 0, the LayerNorm kernel writing 0
  past its 2730 columns, zero columns of ``W_2``), so the result is the
  chain's but for the products' order of accumulation
  (:meth:`SwiGLU.forward_padded`; ``padded_swiglu`` counts its forwards);
* head: the mean over the patch tokens, ``fc_norm`` (LayerNorm), a linear
  head.

Numerics follow ``models/vit.py``: f32 parameters cast to the activation
dtype (bf16) at each use, LayerNorm statistics and the softmax in f32. The
residual stream is the activation dtype. ``attn_impl="pallas"`` writes the
q, k and v projections into one packed (B, T, 3, H, D) buffer (one product
with the three weights stacked), rotates q and k in place there with the
hand-written kernel of ``ops/rope.py`` and runs kernel 1's packed entry
(``ops/attention.py``); ``"einsum"`` is the same projection, the rotation's
plain version and the explicit f32 attention.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from kobato_eyes_tpu_torch.models.vit import LayerNorm, Linear, PatchEmbed
from kobato_eyes_tpu_torch.ops import layernorm

EPS = 1e-6  # every LayerNorm's
ROPE_TEMPERATURE = 10000.0
ROPE_REF_GRID = 16  # the pre-training grid (224 / 14) the RoPE positions are scaled to
HIDDEN_ALIGN = 8  # bf16 values in 16 bytes: a SwiGLU hidden width that is a multiple of it keeps its rows
PITCH_ALIGN = 64  # the padded pitch's multiple otherwise (2730 -> 2752: module docstring)

padded_swiglu = 0  # SwiGLU forwards run at the padded pitch in this process
_count_lock = threading.Lock()


def swiglu_pitch(hidden: int) -> int:
    """The row pitch of the SwiGLU's hidden activations where the LayerNorm
    kernel runs: ``hidden`` where it is a multiple of ``HIDDEN_ALIGN``, else
    rounded up to a multiple of ``PITCH_ALIGN``."""
    return hidden if hidden % HIDDEN_ALIGN == 0 else -(-hidden // PITCH_ALIGN) * PITCH_ALIGN


@dataclasses.dataclass(frozen=True)
class EVA02Config:
    """Architecture hyperparameters; defaults are EVA02-L/14 at 448 px."""

    image_size: int = 448
    patch_size: int = 14
    hidden_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_hidden: int = 2730  # int(1024 * 4 * 2 / 3)
    num_classes: int = 13461
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    # "einsum": the rotation's plain version and explicit f32 attention;
    # "pallas": the rotation kernel (ops/rope.py) and kernel 1's packed entry
    attn_impl: str = "einsum"

    def __post_init__(self) -> None:
        if self.attn_impl not in ("einsum", "pallas"):
            raise ValueError(f"unknown EVA02 attn_impl {self.attn_impl!r} (einsum | pallas)")
        if self.hidden_dim % self.num_heads or (self.hidden_dim // self.num_heads) % 4:
            raise ValueError("EVA02's head width must be a multiple of 4 (two RoPE axes of pairs)")

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    @property
    def patch_bias(self) -> bool:  # read by ``vit.PatchEmbed``
        return True


_PRESETS: dict[str, dict[str, int]] = {
    # name: hidden, depth, heads, SwiGLU hidden (int(hidden * 8 / 3))
    "tiny": dict(hidden_dim=64, depth=2, num_heads=4, mlp_hidden=170),
    "large": dict(hidden_dim=1024, depth=24, num_heads=16, mlp_hidden=2730),
}


def eva02_config(preset: str = "large", **overrides: Any) -> EVA02Config:
    if preset not in _PRESETS:
        raise ValueError(f"unknown EVA02 preset {preset!r}; have {sorted(_PRESETS)}")
    return EVA02Config(**{**_PRESETS[preset], **overrides})


def eva02_forward_flops(cfg: EVA02Config, batch_size: int, *, with_head: bool = True) -> float:
    """Analytic matmul FLOPs of one forward pass (2 FLOPs per MAC); the
    rotation, norms and elementwise work left out."""
    d, n = cfg.hidden_dim, cfg.num_patches
    t = n + 1
    patch = 2 * n * (cfg.patch_size**2 * 3) * d
    per_layer = (
        2 * t * d * 3 * d  # q, k, v projections
        + 2 * 2 * t * t * d  # attention logits + weighted sum
        + 2 * t * d * d  # output projection
        + 2 * 2 * t * d * cfg.mlp_hidden  # fc1_g + fc1_x
        + 2 * t * cfg.mlp_hidden * d  # fc2
    )
    head = 2 * d * cfg.num_classes if with_head else 0
    return float(batch_size) * (patch + cfg.depth * per_layer + head)


def rope_table(cfg: EVA02Config, device: Any = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos), each (num_patches, head_dim // 2) float32: the angle that
    turns the pair (2m, 2m+1) of a patch token's head, patches in row-major
    order. Evaluated in float64 on ``device``, rounded once to float32."""
    bands_n = cfg.head_dim // 4
    exp = torch.arange(bands_n, dtype=torch.float64, device=device) / bands_n
    bands = 1.0 / ROPE_TEMPERATURE**exp
    pos = torch.arange(cfg.grid, dtype=torch.float64, device=device) / cfg.grid * ROPE_REF_GRID
    y = pos[:, None].expand(cfg.grid, cfg.grid).reshape(-1)
    x = pos[None, :].expand(cfg.grid, cfg.grid).reshape(-1)
    angles = torch.cat([y[:, None] * bands, x[:, None] * bands], dim=1)
    return angles.sin().float(), angles.cos().float()


class EVA02Attention(nn.Module):
    def __init__(self, cfg: EVA02Config) -> None:
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_dim
        self.q_proj = Linear(d, d, cfg)
        self.k_proj = Linear(d, d, cfg, bias=False)
        self.v_proj = Linear(d, d, cfg)
        self.proj = Linear(d, d, cfg)

    def packed_qkv(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, 3, H, D) q, k, v in the activation dtype: one product with
        the three weights stacked (timm's row order), the q and v biases added
        after it is rounded (k's slot adds zero)."""
        cfg = self.cfg
        b, t, _ = x.shape
        weight = torch.cat((self.q_proj.weight, self.k_proj.weight, self.v_proj.weight)).to(cfg.dtype)
        bias = torch.cat((self.q_proj.bias, torch.zeros_like(self.q_proj.bias), self.v_proj.bias)).to(cfg.dtype)
        qkv = torch.matmul(x.to(cfg.dtype), weight.t()) + bias
        return qkv.view(b, t, 3, cfg.num_heads, cfg.head_dim)

    def forward(self, x: torch.Tensor, rope_sin: torch.Tensor, rope_cos: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, t, _ = x.shape
        scale = cfg.head_dim**-0.5
        qkv = self.packed_qkv(x)
        if cfg.attn_impl == "pallas":
            from kobato_eyes_tpu_torch.ops.attention import head_resident_attention_packed
            from kobato_eyes_tpu_torch.ops.rope import rope_packed

            out = head_resident_attention_packed(rope_packed(qkv, rope_sin, rope_cos), scale=scale)
        else:
            from kobato_eyes_tpu_torch.ops.rope import rope_packed_plain

            q, k, v = rope_packed_plain(qkv, rope_sin, rope_cos).unbind(dim=2)
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
            weights = torch.softmax(logits * scale, dim=-1).to(cfg.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.proj(out.reshape(b, t, cfg.hidden_dim))


class SwiGLU(nn.Module):
    """timm's ``SwiGLU`` with its sub-LayerNorm over the hidden columns."""

    def __init__(self, cfg: EVA02Config) -> None:
        super().__init__()
        d, hidden = cfg.hidden_dim, cfg.mlp_hidden
        self.hidden = hidden
        self.fc1_g = Linear(d, hidden, cfg)
        self.fc1_x = Linear(d, hidden, cfg)
        self.norm = LayerNorm(hidden, cfg, eps=EPS)
        self.fc2 = Linear(hidden, d, cfg)

    @property
    def pitch(self) -> int:
        """The hidden activations' row pitch on the padded path."""
        return swiglu_pitch(self.hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pitch != self.hidden and layernorm.takes_kernel(x, *self.parameters()):
            return self.forward_padded(x)
        return self.fc2(self.norm(F.silu(self.fc1_g(x)) * self.fc1_x(x)))

    def padded_operands(self) -> tuple[torch.Tensor, ...]:
        """(W_g, W_x, b_g, b_x, W_2) in the activation dtype with the hidden
        axis at ``pitch``, made from the parameters at each call as ``Linear``
        casts them at each use (the pad filled with zeros, then the parameter
        copied in with its cast): a captured graph, ``load_state_dict`` or a
        training step never meet a stale copy."""
        dtype, hidden, pitch = self.fc2.dtype, self.hidden, self.pitch

        def padded(p: torch.Tensor, axis: int) -> torch.Tensor:
            out = p.new_empty((*p.shape[:axis], pitch, *p.shape[axis + 1:]), dtype=dtype)
            out.narrow(axis, hidden, pitch - hidden).zero_()
            out.narrow(axis, 0, hidden).copy_(p)
            return out

        return (padded(self.fc1_g.weight, 0), padded(self.fc1_x.weight, 0), padded(self.fc1_g.bias, 0),
                padded(self.fc1_x.bias, 0), padded(self.fc2.weight, 1))

    def forward_padded(self, x: torch.Tensor) -> torch.Tensor:
        """The chain with the hidden activations at ``pitch`` columns: g and
        u zero past ``hidden``, so SiLU(g) * u is too; the sub-LayerNorm's
        statistics over the ``hidden`` real columns, written at the pitch with
        zeros after them; ``W_2``'s zero columns meet those zeros. Each bias is
        added after its product is rounded, as ``Linear`` adds it."""
        global padded_swiglu
        w_g, w_x, b_g, b_x, w_2 = self.padded_operands()
        xb = x.to(self.fc2.dtype)
        g = torch.matmul(xb, w_g.t()) + b_g
        u = torch.matmul(xb, w_x.t()) + b_x
        h = (F.silu(g) * u)[..., : self.hidden]
        h = layernorm.layernorm(h, self.norm.weight, self.norm.bias, eps=self.norm.eps, dtype=self.norm.dtype,
                                out_pitch=self.pitch)
        with _count_lock:
            padded_swiglu += 1
        return torch.matmul(h, w_2.t()) + self.fc2.bias.to(self.fc2.dtype)


class EVA02Block(nn.Module):
    def __init__(self, cfg: EVA02Config) -> None:
        super().__init__()
        self.norm1 = LayerNorm(cfg.hidden_dim, cfg, eps=EPS)
        self.attn = EVA02Attention(cfg)
        self.norm2 = LayerNorm(cfg.hidden_dim, cfg, eps=EPS)
        self.mlp = SwiGLU(cfg)

    def forward(self, x: torch.Tensor, rope_sin: torch.Tensor, rope_cos: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), rope_sin, rope_cos)
        return x + self.mlp(self.norm2(x))


class EVA02(nn.Module):
    """EVA02 image encoder with a classifier head: NHWC float input
    (normalised; ``models/preprocess.py``), f32 logits out."""

    def __init__(self, cfg: EVA02Config) -> None:
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_dim
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, dtype=cfg.param_dtype))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, d, dtype=cfg.param_dtype))
        self.blocks = nn.ModuleList(EVA02Block(cfg) for _ in range(cfg.depth))
        self.fc_norm = LayerNorm(d, cfg, eps=EPS)
        self.head = Linear(d, cfg.num_classes, cfg)
        sin, cos = rope_table(cfg, device=self.pos_embed.device)
        self.register_buffer("rope_sin", sin, persistent=False)
        self.register_buffer("rope_cos", cos, persistent=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        _, h, w, _ = images.shape
        if h != cfg.image_size or w != cfg.image_size:
            raise ValueError(f"expected {cfg.image_size}px input, got {h}x{w}")
        x = self.patch_embed(images)
        cls = self.cls_token.to(cfg.dtype).expand(x.shape[0], 1, cfg.hidden_dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(cfg.dtype)
        for block in self.blocks:
            x = block(x, self.rope_sin, self.rope_cos)
        return self.head(self.fc_norm(x[:, 1:].mean(dim=1))).float()


@torch.no_grad()
def init_eva02_(model: EVA02, generator: torch.Generator) -> EVA02:
    """Random init in place from a seeded generator, as ``vit.init_vit_``:
    lecun-normal matrices (and the patch conv), zero biases and cls token,
    unit LayerNorm scales, position embedding normal(0.02). Draws on the
    CPU, so the numbers do not depend on the model's device."""
    for name, param in model.named_parameters():
        if name == "pos_embed":
            values = torch.randn(param.shape, generator=generator) * 0.02
        elif name.endswith("weight") and param.dim() >= 2:
            values = torch.randn(param.shape, generator=generator) / math.sqrt(math.prod(param.shape[1:]))
        else:
            continue
        param.copy_(values.to(param.dtype))
    return model
