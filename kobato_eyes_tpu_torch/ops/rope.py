"""EVA02's 2D rotary position embedding, in place inside the packed q, k, v:
the hand-written CUDA kernel and its plain version.

Not a port of a TPU kernel: the JAX package has no EVA02. The PixAI tagger's
backbone (``models/eva02.py``) rotates q and k of every patch token at every
layer: the pair (2m, 2m+1) of a head's columns turns by the token's angle m,

    o[2m]   = q[2m]   cos - q[2m+1] sin
    o[2m+1] = q[2m+1] cos + q[2m]   sin

in f32 from the stored values, rounded once to the buffer's dtype. The
tables hold one row a rotated token: the last N = len(sin) tokens turn, the
T - N before them (EVA02's class token) and v are left as they are. In
plain torch that is some eight passes over q and k a layer plus a copy out
of the packed layout, which kernel 1 (``ops/attention.py``) reads through
its strides; the kernel (``csrc/rope_2d.cu``) rewrites the q and k planes of
the (B, T, 3, H, D) projection in place in one pass, so kernel 1's packed
entry reads the result as it is.

Bound on the card: bytes. At EVA02-L/448, batch 32, bf16: q and k of 1024
patch tokens read and written, 268.4 MB, and the (1024, 32) f32 sin and cos
tables, 0.26 MB: 0.080 ms at 3.35 TB/s; the 0.2 GFLOP of f32 products and
sums are 0.003 ms at 67 TFLOP/s. Each thread moves 16 bytes (8 bf16 or 4 f32
values: 4 or 2 pairs) of one head's row, neighbouring threads on
neighbouring columns, then heads, then q and k, then tokens; the tables
(re-read for every batch row, head and plane) stay in L2.

A wrapper launches the kernel for a CUDA tensor and raises if the launch
fails; it takes the plain version only for a CPU tensor. ``launches`` counts
the kernel's launches in this process, under a lock (the watcher's tag jobs
run the tagger on worker threads). The library builds at the first EVA02
forward on the card, never at import.
"""

from __future__ import annotations

import ctypes
import threading

import torch

launches = 0
_count_lock = threading.Lock()

_SOURCE = "rope_2d.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
VECTOR_BYTES = 16


def _prefix(qkv: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> int:
    """The tokens before the rotated ones; raises on shapes that do not fit."""
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"expected a packed (B, T, 3, H, D) qkv, got shape {tuple(qkv.shape)}")
    t, d = qkv.shape[1], qkv.shape[4]
    n = sin.shape[0] if sin.dim() == 2 else -1
    if d % 2 or not 0 < n <= t:
        raise ValueError(f"rope needs an even head width and 1 to T rows of angles, got D={d}, T={t}, "
                         f"sin {tuple(sin.shape)}")
    for name, table in (("sin", sin), ("cos", cos)):
        if table.shape != (n, d // 2) or table.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 of shape ({n}, {d // 2}), got {table.dtype} {tuple(table.shape)}")
    return t - n


# ---------------------------------------------------------------------------
# Plain version (the CPU path, and what the kernel is held against)
# ---------------------------------------------------------------------------


def rope_packed_plain(qkv: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Rotate q and k of the last N tokens of a packed (B, T, 3, H, D)
    tensor in place by the (N, D / 2) angle tables; returns ``qkv``. Each
    product and sum is one f32 operation, as the kernel's."""
    prefix = _prefix(qkv, sin, cos)
    planes = qkv[:, prefix:, :2]  # (B, N, 2, H, D)
    x = planes.float()
    even, odd = x[..., 0::2], x[..., 1::2]
    s = sin.to(x.device)[None, :, None, None, :]
    c = cos.to(x.device)[None, :, None, None, :]
    out = torch.empty_like(x)
    out[..., 0::2] = even * c - odd * s
    out[..., 1::2] = odd * c + even * s
    planes.copy_(out)
    return qkv


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def _library() -> ctypes.CDLL:
    from kobato_eyes_tpu_torch.ops.build import load

    lib = load(_SOURCE)
    fn = lib.rope2d_packed_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 3
            + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 4
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def check_inputs(qkv: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> int:
    """Raise on what the kernel does not take: CUDA tensors on one device, a
    float32 or bfloat16 packed view with a unit last stride whose address is
    a multiple of 16 bytes and whose other strides and D are multiples of
    16 bytes' worth of elements (the projection's own buffer is), and
    contiguous float32 tables. Returns the tokens before the rotated ones."""
    prefix = _prefix(qkv, sin, cos)
    if qkv.dtype not in _DTYPE_CODES:
        raise ValueError(f"rope kernel takes float32 or bfloat16, got {qkv.dtype}")
    for x in (qkv, sin, cos):
        if x.device != qkv.device or x.device.type != "cuda":
            raise ValueError(f"rope kernel needs CUDA tensors on one device, got {x.device}")
    if not (sin.is_contiguous() and cos.is_contiguous()):
        raise ValueError("rope kernel needs contiguous sin and cos tables")
    vec = VECTOR_BYTES // qkv.element_size()
    if qkv.stride(-1) != 1 or qkv.shape[-1] % vec or qkv.data_ptr() % VECTOR_BYTES or any(
        s % vec for s in qkv.stride()[:-1]
    ):
        raise ValueError(f"rope kernel reads {VECTOR_BYTES} bytes at a time: needs a unit last stride, D and strides "
                         f"multiples of {vec} and a 16-byte aligned address, got strides {qkv.stride()}")
    return prefix


def rope_packed(qkv: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Rotate q and k of the last N = len(sin) tokens of a packed
    (B, T, 3, H, D) tensor in place (the kernel for a CUDA tensor, the plain
    version for a CPU one); returns ``qkv``."""
    global launches
    if qkv.device.type == "cpu":
        return rope_packed_plain(qkv, sin, cos)
    prefix = check_inputs(qkv, sin, cos)
    b, t, _, h, d = qkv.shape
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = _library().rope2d_packed_launch(
        qkv.data_ptr(), sin.data_ptr(), cos.data_ptr(),
        b, t, h, d, prefix, _DTYPE_CODES[qkv.dtype],
        qkv.stride(0), qkv.stride(1), qkv.stride(2), qkv.stride(3),
        stream,
    )
    if err != 0:
        raise RuntimeError(f"rope2d_packed launch failed: cudaError_t {err}")
    with _count_lock:
        launches += 1
    return qkv
