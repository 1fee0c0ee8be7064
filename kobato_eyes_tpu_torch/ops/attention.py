"""Head-resident attention: the hand-written CUDA kernel and its plain version.

Replaces the JAX package's head-resident Pallas kernel
(``kobato_eyes_tpu/ops/pallas_attention.py``: ``_attn_body`` through
``_attn_call_packed`` / ``head_resident_attention_packed`` and ``_attn_call``
/ ``head_resident_attention``). Exact ``softmax(scale * q k^T) v`` per
(batch, head): q scaled in its own dtype, f32 logits, ``exp(l - rowmax)``
rounded to v's dtype, f32 row sums, f32 PV accumulation divided after.

On the card the bound is operations: about 60.6 GFLOP per call at the
ViT-B/448 batch-32 shape (4*T^2*D*B*H with T=785, H=12, D=64) against 154 MB
of qkv read and output written, so the products belong on the tensor cores.
The TPU kernel held a head's whole (T, T) logits on chip, which does not fit
a Hopper block's 227 KB of shared memory, so the CUDA kernels
(``csrc/head_resident_attention.cu``) tile the keys with an online softmax
and never write the logits to device memory. They read q, k and v through
strides straight from the packed (B, T, 3, H, D) projection and write
(B, T, H, D), so no transpose copies surround them. ``kernel_variant`` says
which kernel a call runs:

* ``"wgmma"``: bfloat16, D in (32, 64). A q tile of 128 rows a block, 64
  per warpgroup; K and V in 64-key tiles through a three-stage ``cp.async``
  ring in swizzled shared memory; ``S = Q K^T`` and ``O += P V`` by
  ``wgmma`` with f32 accumulation, the next tile's S started together with
  this tile's P V; the online softmax on the accumulator fragment and P
  rounded to bf16 in registers (the register operand of the second
  product). It copies 16 bytes at a time, so a bfloat16 view that is not
  16-byte aligned, or whose strides are not multiples of 8, raises.
* ``"fma"``: float32, D in (32, 64). f32 FMAs out of shared memory: tensor
  cores would mean TF32 operands, which the port does not use.

A wrapper launches the kernel for a CUDA tensor and raises if the launch
fails; it takes the plain version only for a CPU tensor. ``launches`` counts
the kernel launches through the packed entry in this process,
``launches_separate`` those through the entry with separate q, k, v.
"""

from __future__ import annotations

import ctypes

import torch

launches = 0
launches_separate = 0

_SOURCE = "head_resident_attention.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)


def kernel_variant(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel of ``csrc/head_resident_attention.cu`` a CUDA call runs:
    ``"wgmma"`` (tensor cores) for bfloat16, ``"fma"`` for float32."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"attention kernel takes float32 or bfloat16, got {dtype}")
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"attention kernel takes head_dim in {_HEAD_DIMS}, got {head_dim}")
    return "wgmma" if dtype == torch.bfloat16 else "fma"


# ---------------------------------------------------------------------------
# Plain version (the CPU path, and what the kernel is held against)
# ---------------------------------------------------------------------------


def head_resident_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float
) -> torch.Tensor:
    """(B, T, H, D) q, k, v -> (B, T, H, D), step for step as ``_attn_body``.

    Products run in f32 on upcast inputs, which reproduces
    ``preferred_element_type=float32`` for bf16 inputs.
    """
    q = q * torch.tensor(scale, dtype=q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    m = logits.amax(dim=-1, keepdim=True)
    w = torch.exp(logits - m).to(v.dtype)
    s = w.float().sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", w.float(), v.float())
    return (o / s).to(q.dtype).permute(0, 2, 1, 3)


def head_resident_attention_packed_plain(qkv: torch.Tensor, *, scale: float) -> torch.Tensor:
    """Packed (B, T, 3, H, D) -> (B, T, H, D), plain version."""
    q, k, v = qkv.unbind(dim=2)
    return head_resident_attention_plain(q, k, v, scale=scale)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _library() -> ctypes.CDLL:
    from kobato_eyes_tpu_torch.ops.build import load

    lib = load(_SOURCE)
    fn = lib.head_resident_attention_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 6
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def check_alignment(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on bfloat16 views the ``"wgmma"`` kernel cannot copy 16 bytes at
    a time: addresses must be multiples of 16 bytes and strides multiples of
    8 elements. No other bfloat16 kernel takes such a view (the window
    wrapper, unlike this one, has its ``"rows"`` kernel for it): make it
    contiguous first. float32 tensors are read one element at a time."""
    if q.dtype != torch.bfloat16:
        return
    for x in (q, k, v):
        if x.data_ptr() % 16 or any(s % 8 for s in x.stride()[:-1]):
            raise ValueError("the bfloat16 attention kernel needs 16-byte aligned q, k, v "
                             f"with strides that are multiples of 8, got strides {x.stride()}")


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on what the kernel does not take: it needs CUDA tensors of one
    dtype (float32 or bfloat16), D in (32, 64) with unit stride, q, k, v
    sharing their shape and strides (the packed views do), and bfloat16
    views aligned as ``check_alignment`` says."""
    for x in (q, k, v):
        if x.device.type != "cuda":
            raise ValueError(f"attention kernel needs CUDA tensors, got {x.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"attention kernel takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"expected (B, T, H, D) tensors, got shape {tuple(q.shape)}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"attention kernel takes head_dim in {_HEAD_DIMS}, got {q.shape[-1]}")
    for x in (k, v):
        if x.dtype != q.dtype or x.shape != q.shape or x.stride() != q.stride():
            raise ValueError("q, k and v must share dtype, shape and strides")
        if x.device != q.device:
            raise ValueError("q, k and v must be on one device")
    if q.stride(-1) != 1:
        raise ValueError(f"head_dim stride must be 1, got strides {q.stride()}")
    check_alignment(q, k, v)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, *, packed: bool) -> torch.Tensor:
    global launches, launches_separate
    check_inputs(q, k, v)
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.head_resident_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, t, h, d, _DTYPE_CODES[q.dtype],
        q.stride(0), q.stride(1), q.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        float(scale), stream,
    )
    if err != 0:
        raise RuntimeError(f"head_resident_attention launch failed: cudaError_t {err}")
    if packed:
        launches += 1
    else:
        launches_separate += 1
    return out


def head_resident_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float
) -> torch.Tensor:
    """(B, T, H, D) attention; exact softmax, no (T, T) intermediate in
    device memory on the card."""
    if q.device.type == "cpu":
        return head_resident_attention_plain(q, k, v, scale=scale)
    return _launch(q, k, v, scale, packed=False)


def head_resident_attention_packed(qkv: torch.Tensor, *, scale: float) -> torch.Tensor:
    """Packed (B, T, 3, H, D) qkv projection output -> (B, T, H, D).

    The kernel reads q, k and v as three strided views of the one tensor.
    """
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"expected (B, T, 3, H, D) qkv, got shape {tuple(qkv.shape)}")
    if qkv.device.type == "cpu":
        return head_resident_attention_packed_plain(qkv, scale=scale)
    q, k, v = qkv.unbind(dim=2)
    return _launch(q, k, v, scale, packed=True)
