"""Flash attention for ``attn_impl="flash"``: the hand-written CUDA kernels
(``csrc/flash_attention.cu``), their plain versions and the autograd
function over them.

Replaces what the JAX package's ``models/vit.py:_flash_attention_padded``
runs: JAX's Pallas TPU flash attention (``flash_attention.py`` of jax 0.9.0),
whose forward ``pallas_call`` saves the row max ``m`` and row sum ``l``, and
whose ``custom_vjp`` backward computes ``di = rowsum(o * dO)`` in plain JAX
and runs two more ``pallas_call``\\ s, dK/dV and dQ. The functions here are
the same:

* forward: f32 logits ``q k^T`` scaled after the product, the online row
  max ``m`` and row sum ``l`` in f32, ``p = exp(s - m)`` rounded to v's
  dtype for ``p v`` (f32 accumulation), then divided by ``l``;
* backward: ``p = exp(s - m) * (1 / l)``, ``dV = p^T dO`` (p rounded to
  dO's dtype), ``dP = dO v^T``, ``dS = ((dP - di) * p) * scale``,
  ``dK = dS^T q`` and ``dQ = dS k`` (dS rounded to dO's dtype), every
  product accumulated in f32.

The JAX version pads T to a multiple of 128 with segment-masked tokens; the
padded keys get ``exp(mask - m) = 0``, so attention over the real T is the
same function, which the kernels compute with bounds checks instead.

On the card the bound is operations (about 60.6 GFLOP for the forward at
ViT-B/448 batch 32 against 154 MB moved; 106 GFLOP for the backward's seven
products at batch 16). The kernels read q, k and v through strides straight
from the packed (B, T, 3, H, D) projection, and the two backward kernels
write dq, dk and dv straight into one packed gradient of it. Three designs
(see the source):

* ``"fma"``: every product as f32 FMAs out of shared memory, for bfloat16
  as for float32, the head width padded to 32, 64 or 128
  (``kernel_variant`` names the padded width). Any view with a unit last
  stride is taken, aligned or not: it reads one element at a time. The
  forward and the backward run it for float32 (no TF32) and for bfloat16
  views ``aligned_for_wgmma`` refuses.
* the ``"wgmma"`` forward: bfloat16 whose q, k and v are 16-byte aligned
  with strides that are multiples of 8, at any head width (rounded up to
  16): two warpgroups a block share each K/V tile, ``S`` by ``wgmma`` into
  registers, the online softmax there, ``P`` rounded to bf16 as the
  register operand of ``O += P V``; the arithmetic above (no bf16
  pre-scale of q, ``l`` of the unrounded ``p``), ``m`` and ``l`` written.
  ``forward_variant`` says which body a forward call runs.
* the ``"wgmma"`` backward: bfloat16 whose q, k, v and dO are aligned so:
  one warpgroup a block, ``S`` and ``dP`` by ``wgmma`` into registers,
  ``P`` and ``dS`` formed there and rounded to bf16 as the register
  operand of ``dV``, ``dK`` and ``dQ``'s ``wgmma``. ``backward_variant``
  says which body a backward call runs.

A wrapper launches its kernel for a CUDA tensor and raises if the launch
fails or the shape or dtype is not taken (float32 or bfloat16, head width up
to 128); it takes the plain version only for a CPU tensor, and it never
falls back from one body to the other. ``launches``,
``backward_dkv_launches`` and ``backward_dq_launches`` count each kernel's
launches in this process, under a lock; ``forward_variant_launches`` counts
the forward launches by body, ``{variant: n}``, and
``backward_variant_launches`` the backward launches, ``{(kernel, variant):
n}`` with kernel ``"dkv"`` or ``"dq"``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

launches = 0
backward_dkv_launches = 0
backward_dq_launches = 0
forward_variant_launches = {"wgmma": 0, "fma": 0}
backward_variant_launches = {(kernel, variant): 0 for kernel in ("dkv", "dq") for variant in ("wgmma", "fma")}
_count_lock = threading.Lock()

_SOURCE = "flash_attention.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANT_CODES = {"fma": 0, "wgmma": 1}
MAX_HEAD_DIM = 128


def kernel_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The body of ``csrc/flash_attention.cu`` a CUDA call runs: ``"fma"``
    and the head width it is padded to (``"fma32"``, ``"fma64"``,
    ``"fma128"``)."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"flash attention kernel takes float32 or bfloat16, got {dtype}")
    if not 1 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"flash attention kernel takes head_dim 1 .. {MAX_HEAD_DIM}, got {head_dim}")
    return f"fma{32 if head_dim <= 32 else 64 if head_dim <= 64 else 128}"


def forward_variant(dtype: torch.dtype, head_dim: int, *, aligned: bool = True) -> str:
    """The body the forward kernel runs: ``"wgmma"`` (tensor cores) for
    bfloat16 whose q, k and v are ``aligned`` (``aligned_for_wgmma``),
    ``"fma"`` for float32 and for bfloat16 views that are not."""
    kernel_variant(dtype, head_dim)
    return "wgmma" if dtype == torch.bfloat16 and aligned else "fma"


def backward_variant(dtype: torch.dtype, head_dim: int, *, aligned: bool = True) -> str:
    """The body the dK/dV and dQ kernels run: as :func:`forward_variant`,
    with dO among the views that must be ``aligned``."""
    return forward_variant(dtype, head_dim, aligned=aligned)


def aligned_for_wgmma(*tensors: torch.Tensor) -> bool:
    """Whether the ``"wgmma"`` bodies can copy these views 16 bytes at a
    time: addresses multiples of 16 bytes, strides (but the last) multiples
    of 8 elements."""
    return all(x.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in x.stride()[:-1]) for x in tensors)


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def flash_forward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, T, H, D) q, k, v -> (o (B, T, H, D) in q's dtype, m, l (B, H, T)
    in f32), as the JAX forward body computes them. float64 inputs compute
    in float64 (the exact function, for gradcheck and as a yardstick)."""
    acc = _compute_dtype(q)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(acc), v.to(acc))
    o = o / l.permute(0, 2, 1)[..., None]
    return o.to(q.dtype), m, l


def flash_backward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    m: torch.Tensor, l: torch.Tensor, do: torch.Tensor, scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv), each (B, T, H, D) in q's dtype, as the JAX backward
    computes them from the forward's ``o``, ``m`` and ``l`` (B, H, T)."""
    acc = _compute_dtype(q)
    di = row_dot(o, do)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    p = torch.exp(s - m.to(acc)[..., None]) * (1.0 / l.to(acc))[..., None]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).to(acc), do.to(acc))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(acc), v.to(acc))
    ds = ((dp - di.to(acc)[..., None]) * p) * scale
    ds = ds.to(do.dtype).to(acc)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(acc))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(acc))
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def row_dot(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``di = rowsum(o * dO)`` in f32 (float64 for float64), (B, H, T): the
    one step of the backward the JAX package leaves to plain JAX."""
    acc = _compute_dtype(o)
    return (o.to(acc) * do.to(acc)).sum(dim=-1).permute(0, 2, 1).contiguous()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _library() -> ctypes.CDLL:
    from kobato_eyes_tpu_torch.ops.build import load

    lib = load(_SOURCE)
    if lib.flash_attention_forward.argtypes is None:
        lib.flash_attention_forward.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 6
            + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.flash_attention_forward.restype = ctypes.c_int
        lib.flash_attention_backward_dkv.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
            + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.flash_attention_backward_dkv.restype = ctypes.c_int
        lib.flash_attention_backward_dq.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
            + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.flash_attention_backward_dq.restype = ctypes.c_int
    return lib


def check_inputs(qkv: torch.Tensor, do: torch.Tensor | None = None) -> None:
    """Raise on what the kernels do not take: a CUDA (B, T, 3, H, D) tensor
    of float32 or bfloat16 with D up to 128 and a unit last stride, and a
    (B, T, H, D) dO of the same dtype and device with a unit last stride."""
    if qkv.device.type != "cuda":
        raise ValueError(f"flash attention kernel needs CUDA tensors, got {qkv.device}")
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"expected (B, T, 3, H, D) qkv, got shape {tuple(qkv.shape)}")
    kernel_variant(qkv.dtype, qkv.shape[-1])
    if qkv.stride(-1) != 1:
        raise ValueError(f"head_dim stride must be 1, got strides {qkv.stride()}")
    if do is not None:
        b, t, _, h, d = qkv.shape
        if do.shape != (b, t, h, d) or do.dtype != qkv.dtype or do.device != qkv.device:
            raise ValueError(f"dO must be ({b}, {t}, {h}, {d}) {qkv.dtype} on {qkv.device}, "
                             f"got {tuple(do.shape)} {do.dtype} on {do.device}")
        if do.stride(-1) != 1:
            raise ValueError(f"dO's head_dim stride must be 1, got strides {do.stride()}")


def _strides(x: torch.Tensor) -> tuple[int, int, int]:
    """(batch, token, head) strides of a (B, T, [3,] H, D) tensor."""
    return x.stride(0), x.stride(1), x.stride(-2)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_variant(variant: str | None) -> None:
    if variant is not None and variant not in _VARIANT_CODES:
        raise ValueError(f"variant {variant!r} is none of {sorted(_VARIANT_CODES)}")


def flash_forward(
    qkv: torch.Tensor, scale: float, *, variant: str | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Packed (B, T, 3, H, D) -> (o (B, T, H, D), m, l (B, H, T) f32): the
    forward kernel on a CUDA tensor, the plain version on a CPU one.
    ``variant`` (``"wgmma"``, ``"fma"``) runs that body, to check or time
    it; by default ``forward_variant`` chooses."""
    global launches
    _check_variant(variant)
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"expected (B, T, 3, H, D) qkv, got shape {tuple(qkv.shape)}")
    q, k, v = qkv.unbind(dim=2)
    if qkv.device.type == "cpu":
        return flash_forward_plain(q, k, v, scale)
    check_inputs(qkv)
    b, t, _, h, d = qkv.shape
    if variant is None:
        variant = forward_variant(qkv.dtype, d, aligned=aligned_for_wgmma(q, k, v))
    o = torch.empty((b, t, h, d), dtype=qkv.dtype, device=qkv.device)
    m = torch.empty((b, h, t), dtype=torch.float32, device=qkv.device)
    l = torch.empty_like(m)
    err = _library().flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(),
        b, t, h, d, _DTYPE_CODES[qkv.dtype], _VARIANT_CODES[variant], *_strides(qkv), *_strides(o), float(scale),
        _stream(qkv),
    )
    if err != 0:
        raise RuntimeError(f"flash attention forward ({variant}) launch failed: cudaError_t {err}")
    with _count_lock:
        launches += 1
        forward_variant_launches[variant] += 1
    return o, m, l


def _backward_launch(kernel: str, qkv: torch.Tensor, do: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                     di: torch.Tensor, grad: torch.Tensor, scale: float, variant: str | None) -> str:
    global backward_dkv_launches, backward_dq_launches
    check_inputs(qkv, do)
    b, t, _, h, d = qkv.shape
    q, k, v = qkv.unbind(dim=2)
    _check_variant(variant)
    if variant is None:
        variant = backward_variant(qkv.dtype, d, aligned=aligned_for_wgmma(q, k, v, do))
    dq, dk, dv = grad.unbind(dim=2)
    outs = (dk.data_ptr(), dv.data_ptr()) if kernel == "dkv" else (dq.data_ptr(),)
    fn = getattr(_library(), f"flash_attention_backward_{kernel}")
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), m.data_ptr(), l.data_ptr(), di.data_ptr(),
        *outs, b, t, h, d, _DTYPE_CODES[qkv.dtype], _VARIANT_CODES[variant],
        *_strides(qkv), *_strides(do), *_strides(grad), float(scale), _stream(qkv),
    )
    if err != 0:
        raise RuntimeError(f"flash attention {kernel} ({variant}) launch failed: cudaError_t {err}")
    with _count_lock:
        if kernel == "dkv":
            backward_dkv_launches += 1
        else:
            backward_dq_launches += 1
        backward_variant_launches[kernel, variant] += 1
    return variant


def flash_backward_dkv(
    qkv: torch.Tensor, do: torch.Tensor, m: torch.Tensor, l: torch.Tensor, di: torch.Tensor,
    grad: torch.Tensor, scale: float, *, variant: str | None = None,
) -> str:
    """The dK/dV kernel: writes dk and dv into ``grad[:, :, 1]`` and
    ``grad[:, :, 2]`` of the packed (B, T, 3, H, D) gradient (CUDA only).
    ``variant`` (``"wgmma"``, ``"fma"``) runs that body, to check or time it;
    by default ``backward_variant`` chooses. Returns the body that ran."""
    return _backward_launch("dkv", qkv, do, m, l, di, grad, scale, variant)


def flash_backward_dq(
    qkv: torch.Tensor, do: torch.Tensor, m: torch.Tensor, l: torch.Tensor, di: torch.Tensor,
    grad: torch.Tensor, scale: float, *, variant: str | None = None,
) -> str:
    """The dQ kernel: writes dq into ``grad[:, :, 0]`` (CUDA only);
    ``variant`` as :func:`flash_backward_dkv`'s."""
    return _backward_launch("dq", qkv, do, m, l, di, grad, scale, variant)


def flash_backward(
    qkv: torch.Tensor, o: torch.Tensor, m: torch.Tensor, l: torch.Tensor, do: torch.Tensor, scale: float
) -> torch.Tensor:
    """The packed (B, T, 3, H, D) gradient of qkv from the forward's ``o``,
    ``m``, ``l`` and dO: ``di`` in torch, then the dK/dV and the dQ kernels,
    which write their thirds of the one gradient tensor (the plain version
    on a CPU tensor)."""
    if qkv.device.type == "cpu":
        return torch.stack(flash_backward_plain(*qkv.unbind(dim=2), o, m, l, do, scale), dim=2)
    check_inputs(qkv, do)
    di = row_dot(o, do)
    m, l = m.contiguous(), l.contiguous()
    grad = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
    flash_backward_dkv(qkv, do, m, l, di, grad, scale)
    flash_backward_dq(qkv, do, m, l, di, grad, scale)
    return grad


class FlashAttention(torch.autograd.Function):
    """``o = attention(qkv)`` with the flash kernels forward and backward.
    Saves q, k, v (the packed tensor), o, m and l."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, scale: float) -> torch.Tensor:
        o, m, l = flash_forward(qkv, scale)
        ctx.save_for_backward(qkv, o, m, l)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        qkv, o, m, l = ctx.saved_tensors
        if do.stride(-1) != 1:  # e.g. the expanded gradient of a sum
            do = do.contiguous()
        return flash_backward(qkv, o, m, l, do, ctx.scale), None


def flash_attention_packed(qkv: torch.Tensor, scale: float) -> torch.Tensor:
    """Packed (B, T, 3, H, D) qkv projection -> (B, T, H, D) attention, with
    a backward through the dK/dV and dQ kernels."""
    return FlashAttention.apply(qkv, scale)
