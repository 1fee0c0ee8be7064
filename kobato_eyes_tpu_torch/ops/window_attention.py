"""SwinV2 window cosine attention: the hand-written CUDA kernel and its plain version.

Replaces the JAX package's window-resident Pallas kernel
(``kobato_eyes_tpu/ops/pallas_window_attention.py``: ``_win_attn_kernel``
through ``_win_attn_call`` / ``windowed_cosine_attention_packed``). Per
window and head: q and k L2-normalised in f32 with
``rsqrt(max(sum(x^2), 1e-12))`` (XLA's CPU rsqrt, ``xla_math.rsqrt_plain``;
the kernels take the same estimate table and Newton steps), logits times
the exp-clamped per-head scale plus the CPB bias (H, n, n) plus the shift
mask (nW, n, n), a row-max softmax whose ``exp`` is rounded to v's dtype and
summed in f32, PV in f32, then the division.

``qk_precision``: ``"default"`` and ``"highest"`` take the products on f32
operands, which is what the JAX function computes on the CPU (on the TPU,
``"default"`` rounds the operands to bf16 on its matrix unit); ``"bf16"``
rounds the normalised q and k to bf16 first, as the JAX kernel does.

On the card the bound is bytes: the qkv projection is read once and the
output written once (411 MB at SwinV2-B/448 stage 0, batch 32, 0.12 ms at
the card's memory rate); the f32-operand q k^T products (half of the
operations) cost 0.075 ms on the FMA units at their peak, so the kernel has
to keep those fed and its loads wide. ``csrc/window_cosine_attention.cu``
holds two kernels and ``kernel_variant`` says which one a call runs:

* ``"mma"``: bfloat16 qkv with hd 16 or 32 and n <= 64, or hd 64 and
  n <= 56: every SwinV2 stage at window 7 or 8. One block an SM, bound to
  four neighbouring heads whose bias tables stay in shared memory, walks
  over the (batch, window)s, a warp a head; 16-byte ``cp.async`` loads a
  window ahead; q and k normalised in f32 into shared memory; the logits
  accumulated by f32 FMAs in the mma fragment layout and kept in registers
  through scale, bias, mask, max and exp; the bf16 weights times V on the
  tensor cores (``mma.sync``).
* ``"rows"``: everything else the wrapper takes (float32 qkv, n up to 256,
  any hd that is a multiple of 8 up to 64, unaligned views). One block per
  (batch, window, head), one query row per warp at a time, all f32 FMAs.

Both read q, k and v through strides from the packed (B, nW, n, 3, H, hd)
projection and write a (B, nW, n, H, hd) buffer. The public functions
return it as a (B, H, nW, n, hd) view, the JAX layout, so the caller can
read the buffer as (B*nW, n, C) with no copy.

A wrapper launches the kernel for a CUDA tensor and raises if the launch
fails; it takes the plain version only for a CPU tensor. ``launches`` counts
the kernel launches in this process.
"""

from __future__ import annotations

import ctypes

import torch

from kobato_eyes_tpu_torch.ops.xla_math import rsqrt_estimate_table, rsqrt_plain

launches = 0

_SOURCE = "window_cosine_attention.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
QK_PRECISIONS = ("default", "bf16", "highest")
MAX_TOKENS = 256  # window 16
MAX_HEAD_DIM = 64
MMA_MAX_TOKENS = 64  # window 8: the logits of a head fit a warp's registers
MMA_HEAD_DIMS = (16, 32, 64)
_VARIANT_CODES = {"rows": 0, "mma": 1}


def kernel_variant(dtype: torch.dtype, n: int, head_dim: int, *, aligned: bool = True) -> str:
    """Which kernel of ``csrc/window_cosine_attention.cu`` a CUDA call runs.

    ``"mma"`` (a warp a head, logits in registers, P V on the tensor cores)
    takes bfloat16 qkv with head_dim 16 or 32 and n <= 64 tokens, or
    head_dim 64 and n <= 56 (what a block's shared memory holds), and qkv
    whose address is a multiple of 16 bytes and whose strides are multiples
    of 8 elements (``aligned``); ``"rows"`` takes the rest.
    """
    if dtype != torch.bfloat16 or head_dim not in MMA_HEAD_DIMS or not aligned:
        return "rows"
    return "mma" if n <= (56 if head_dim == 64 else MMA_MAX_TOKENS) else "rows"


def aligned_for_mma(qkv: torch.Tensor) -> bool:
    """Whether a qkv tensor meets the ``"mma"`` kernel's 16-byte loads."""
    return qkv.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in qkv.stride()[:-1])


def _check_precision(qk_precision: str) -> None:
    if qk_precision not in QK_PRECISIONS:
        raise ValueError(f"unknown qk_precision {qk_precision!r}; have {QK_PRECISIONS}")


def _check_shapes(qkv: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  mask: torch.Tensor | None) -> None:
    if qkv.dim() != 6 or qkv.shape[3] != 3:
        raise ValueError(f"expected (B, nW, n, 3, H, hd) qkv, got shape {tuple(qkv.shape)}")
    _, nw, n, _, h, _ = qkv.shape
    if tuple(scale.shape) != (h,):
        raise ValueError(f"scale must be ({h},), got {tuple(scale.shape)}")
    if tuple(bias.shape) != (h, n, n):
        raise ValueError(f"bias must be ({h}, {n}, {n}), got {tuple(bias.shape)}")
    if mask is not None and tuple(mask.shape) != (nw, n, n):
        raise ValueError(f"mask must be ({nw}, {n}, {n}), got {tuple(mask.shape)}")


# ---------------------------------------------------------------------------
# Plain version (the CPU path, and what the kernel is held against)
# ---------------------------------------------------------------------------


def windowed_cosine_attention_packed_plain(
    qkv: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    mask: torch.Tensor | None,
    *,
    qk_precision: str = "default",
) -> torch.Tensor:
    """(B, nW, n, 3, H, hd) -> (B, H, nW, n, hd), step for step as
    ``_win_attn_kernel``; the result is a view of a (B, nW, n, H, hd) tensor,
    as the kernel's is."""
    _check_precision(qk_precision)
    _check_shapes(qkv, scale, bias, mask)
    q, k, v = qkv.unbind(dim=3)  # (B, nW, n, H, hd)
    qf, kf = q.float(), k.float()
    qn = qf * rsqrt_plain(torch.clamp((qf * qf).sum(-1, keepdim=True), min=1e-12))
    kn = kf * rsqrt_plain(torch.clamp((kf * kf).sum(-1, keepdim=True), min=1e-12))
    if qk_precision == "bf16":
        qn, kn = qn.bfloat16().float(), kn.bfloat16().float()
    logits = torch.einsum("bwnhd,bwmhd->bwhnm", qn, kn)
    logits = logits * scale.float()[:, None, None] + bias.float()
    if mask is not None:
        logits = logits + mask.float()[:, None]
    m = logits.amax(dim=-1, keepdim=True)
    w = torch.exp(logits - m).to(v.dtype)
    s = w.float().sum(dim=-1)  # (B, nW, H, n)
    o = torch.einsum("bwhnm,bwmhd->bwnhd", w.float(), v.float())
    o = o / s.transpose(2, 3).unsqueeze(-1)
    return o.to(qkv.dtype).contiguous().permute(0, 3, 1, 2, 4)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def _library() -> ctypes.CDLL:
    from kobato_eyes_tpu_torch.ops.build import load

    lib = load(_SOURCE)
    fn = lib.window_cosine_attention_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 8
            + [ctypes.c_longlong] * 9
            + [ctypes.c_void_p] * 2
        )
        fn.restype = ctypes.c_int
    return lib


def check_inputs(qkv: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 mask: torch.Tensor | None) -> None:
    """Raise on what the kernel does not take: CUDA tensors on one device,
    qkv float32 or bfloat16 with unit head_dim stride, hd a multiple of 8 up
    to 64, and n up to 256."""
    _check_shapes(qkv, scale, bias, mask)
    for x in (qkv, scale, bias) + ((mask,) if mask is not None else ()):
        if x.device != qkv.device or x.device.type != "cuda":
            raise ValueError(f"window attention kernel needs CUDA tensors on one device, got {x.device}")
    if qkv.dtype not in _DTYPE_CODES:
        raise ValueError(f"window attention kernel takes float32 or bfloat16, got {qkv.dtype}")
    n, hd = qkv.shape[2], qkv.shape[-1]
    if n > MAX_TOKENS:
        raise ValueError(f"window attention kernel takes n <= {MAX_TOKENS} tokens, got {n}")
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"window attention kernel takes head_dim a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}, got {hd}")
    if qkv.stride(-1) != 1:
        raise ValueError(f"head_dim stride must be 1, got strides {qkv.stride()}")


def _launch(qkv: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            mask: torch.Tensor | None, qk_precision: str) -> torch.Tensor:
    global launches
    _check_precision(qk_precision)
    check_inputs(qkv, scale, bias, mask)
    b, nw, n, _, h, hd = qkv.shape
    out = torch.empty((b, nw, n, h, hd), dtype=qkv.dtype, device=qkv.device)
    scale32 = scale.float().contiguous()
    bias32 = bias.float().contiguous()
    mask32 = mask.float().contiguous() if mask is not None else None
    variant = kernel_variant(qkv.dtype, n, hd, aligned=aligned_for_mma(qkv))
    lib = _library()
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = lib.window_cosine_attention_launch(
        qkv.data_ptr(), out.data_ptr(), scale32.data_ptr(), bias32.data_ptr(),
        mask32.data_ptr() if mask32 is not None else None,
        b, nw, n, h, hd, _DTYPE_CODES[qkv.dtype], int(qk_precision == "bf16"),
        _VARIANT_CODES[variant],
        qkv.stride(0), qkv.stride(1), qkv.stride(2), qkv.stride(3), qkv.stride(4),
        out.stride(0), out.stride(1), out.stride(2), out.stride(3),
        rsqrt_estimate_table().ctypes.data, stream,
    )
    if err != 0:
        raise RuntimeError(f"window_cosine_attention launch failed: cudaError_t {err}")
    launches += 1
    return out.permute(0, 3, 1, 2, 4)


def windowed_cosine_attention_packed(
    qkv: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    mask: torch.Tensor | None,
    *,
    qk_precision: str = "default",
) -> torch.Tensor:
    """SwinV2 window attention, head-major out as in the JAX package.

    Args:
      qkv: (B, nW, n, 3, H, hd), the qkv projection of the unflattened
        window tensor.
      scale: (H,) exp-clamped per-head logit scale.
      bias: (H, n, n) CPB relative-position bias (the 16*sigmoid form).
      mask: (nW, n, n) additive shift mask, or None.

    Returns (B, H, nW, n, hd): a view of a (B, nW, n, H, hd) tensor.
    """
    if qkv.device.type == "cpu":
        return windowed_cosine_attention_packed_plain(
            qkv, scale, bias, mask, qk_precision=qk_precision
        )
    return _launch(qkv, scale, bias, mask, qk_precision)


def windowed_cosine_attention(
    qkv: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    mask: torch.Tensor | None,
    *,
    n_windows: int,
    qk_precision: str = "default",
) -> torch.Tensor:
    """Flat layout: (B*nW, n, 3, H, hd) in, (B*nW, n, H, hd) out."""
    bnw, n, three, h, hd = qkv.shape
    b = bnw // n_windows
    out = windowed_cosine_attention_packed(
        qkv.reshape(b, n_windows, n, three, h, hd), scale, bias, mask,
        qk_precision=qk_precision,
    )  # (B, H, nW, n, hd) view of (B, nW, n, H, hd)
    return out.permute(0, 2, 3, 1, 4).reshape(bnw, n, h, hd)
