"""``exp``, the logistic sigmoid and ``rsqrt`` as XLA's CPU backend computes
them in f32: one hand-written CUDA pass and its plain versions.

Not a port of a TPU kernel: the JAX package's ``probs_from_logits`` calls
``jax.nn.sigmoid``, which XLA compiles to ``divide(1, add(exponential(
negate(x)), 1))`` in one fusion. ``torch.sigmoid`` rounds apart from that
by up to 2 ulp on about 0.4% of f32 logits, and the scoring policy's parity
bar is bit-exact, so the port writes out XLA's own steps.

XLA's f32 ``exponential`` on the CPU is Cephes' ``expf`` with every
multiply-add fused:

* ``m = min(floor(fma(x, log2e, 0.5)), 127)``;
* ``r = fma(m, -0.693359375, x)``, then ``r = fma(m, 2.12194440e-4, r)``;
* ``p`` a degree-5 Horner in ``r`` (six constants, each step an FMA);
* ``y = fma(p, r * r, r) + 1``, then ``y * 2**m``.

Its runtime flushes subnormal results to zero, so ``exp(x)`` is 0 wherever
it would be subnormal (x below about -87.34) and ``sigmoid(x)`` likewise (x
below about -87.34 again, through ``1 / (1 + exp(-x))``). Below -88.3762626
the result is 0 outright; the cap on ``m`` is what makes ``exp`` finite up
to 88.7227 and ``inf`` above. A NaN comes back quieted with its payload,
its sign flipped by the sigmoid's negate. These rules were found by
comparing with jitted ``jnp.exp`` and ``jax.nn.sigmoid`` on every f32
binade of both signs (``tests/test_torch_sigmoid.py`` repeats it).

The plain version computes each FMA in f64 (the product of two f32 is exact
there) and rounds the sum to f32 once, by rounding to odd in f64 first: an
f64 sum rounded to nearest and then to f32 could round twice. The CUDA pass
(``csrc/xla_sigmoid.cu``) uses ``__fmaf_rn``, ``__fmul_rn``, ``__fadd_rn``
and ``__frcp_rn`` (no fast math); it is bound by bytes (x read once, the
output written once) where it is long, by its chains' latency at a tagger
batch's logits. It runs one value a thread (the ``"scalar"`` body) while
that fits in one wave of the card's resident threads, four beyond (the
``"vec"`` body, 16-byte loads). A wrapper launches the kernel for a CUDA
tensor and raises if the launch fails; it takes the plain version only for
a CPU tensor. ``launches`` counts the sigmoid pass's launches,
``exp_launches`` those of ``exp``, ``rsqrt_launches`` those of ``rsqrt``.

XLA's f32 ``rsqrt`` on an x86 CPU (``jax.lax.rsqrt``, which the JAX window
kernel normalises q and k with) is the intrinsic ``xla.rsqrt.f32``: the
12-bit hardware estimate of ``_mm256_rsqrt_ps``, then two Newton steps
``y = fma(-0.5 * y, fma(x * y, y, -1), y)`` (``x * y`` and ``-0.5 * y``
rounded, the other two steps fused), then the raw estimate again for the
inputs ``llvm.is.fpclass(x, 764)`` names: zeros and subnormals (``inf`` of
their sign), ``+inf`` (0) and every negative number (the default NaN). A NaN
stays NaN. The estimate depends only on the exponent's parity and the top 10
mantissa bits, so it is a table of 2048 entries; it differs between x86
vendors, so ``rsqrt_estimate_table`` reads it once from the host's own
instruction (``native/xla_rsqrt.cpp``) and raises on a host without it.
``rsqrt_plain`` looks the estimate up and takes the steps with ``fma_f32``;
the CUDA pass and the window kernel (``csrc/xla_rsqrt.cuh``) take the same
table, copied once a device into device memory and read through the
read-only cache; the window kernel's ``"mma"`` body reads a 16-bit copy of
it in shared memory. ``rsqrt`` is the form the port's LayerNorms call: this
value on either device, with ``jax.lax.rsqrt``'s gradient
``g * (-0.5 * (y / x))``.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from pathlib import Path

import numpy as np

import torch

launches = 0
exp_launches = 0
rsqrt_launches = 0
_count_lock = threading.Lock()

_SOURCE = "xla_sigmoid.cu"
_OPS = {"exp": 0, "sigmoid": 1, "rsqrt": 2}
VARIANTS = {None: 0, "vec": 1, "scalar": 2}  # None: by size

LOG2E = 1.44269504088896341
LN2_HI = -0.693359375
LN2_LO = 2.12194440e-4
POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
        1.6666665459e-1, 5.0000001201e-1)
EXP_LO = -88.3762626647949  # exp is 0 below (its result would be subnormal)
M_MAX = 127.0
FLT_MIN = 1.17549435e-38  # the smallest normal f32: below it, a result flushes to 0
RSQRT_TABLE_SIZE = 2048
_rsqrt_table: np.ndarray | None = None


def _f32(v: float) -> float:
    return struct.unpack("f", struct.pack("f", v))[0]


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to f32 (a true fused multiply-add).

    The f64 product of two f32 is exact; the sum is rounded to odd in f64
    (the TwoSum error decides the last bit), and an f64 value rounded to odd
    rounds to the nearest f32 correctly (53 bits >= 24 + 2)."""
    p = a.double() * (b.double() if isinstance(b, torch.Tensor) else _f32(b))
    c = c.double() if isinstance(c, torch.Tensor) else torch.tensor(_f32(c), dtype=torch.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    inexact = (err != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    # the neighbour of s toward the exact sum is odd: one step up in
    # magnitude when err has s's sign, one step down otherwise
    step = torch.where((err > 0) == (s > 0), 1, -1)
    return torch.where(inexact, bits + step, bits).view(torch.float64).float()


def _flush(y: torch.Tensor) -> torch.Tensor:
    return torch.where(y.abs() < FLT_MIN, torch.zeros_like(y), y)


def _quiet_nan(x: torch.Tensor, *, flip_sign: bool) -> torch.Tensor:
    bits = x.view(torch.int32) | 0x00400000
    if flip_sign:
        bits = bits ^ torch.tensor(-0x80000000, dtype=torch.int32)
    return bits.view(torch.float32)


def exp_plain(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU f32 ``exp`` of an f32 tensor (module docstring)."""
    x = x.float()
    m = torch.clamp_max(torch.floor(fma_f32(x, LOG2E, 0.5)), M_MAX)
    r = fma_f32(m, LN2_HI, x)
    r = fma_f32(m, LN2_LO, r)
    p = torch.full_like(r, _f32(POLY[0]))
    for c in POLY[1:]:
        p = fma_f32(p, r, c)
    y = fma_f32(p, r * r, r) + 1.0
    # 2**m is a normal f32 for m in [-126, 127]; below, y * 2**m is subnormal
    scale = ((torch.clamp_min(m, -126.0).to(torch.int32) + 127) << 23).view(torch.float32)
    out = torch.where(m < -126.0, torch.zeros_like(y), _flush(y * scale))
    out = torch.where(x < _f32(EXP_LO), torch.zeros_like(out), out)
    return torch.where(torch.isnan(x), _quiet_nan(x, flip_sign=False), out)


def _native_rsqrt_library() -> ctypes.CDLL:
    """``native/xla_rsqrt.cpp``, built at first use into ``native/_xla_rsqrt.so``
    under the repository's native build lock (``build/native_build.lock``):
    the loader builds through one fixed temporary name, so processes that
    build at once would meet each other's half-written file."""
    import fcntl

    from kobato_eyes_tpu_torch.native.build import load_native_library

    lock = Path(__file__).resolve().parents[2] / "build" / "native_build.lock"
    lock.parent.mkdir(exist_ok=True)
    with lock.open("w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            return load_native_library("xla_rsqrt")
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def rsqrt_estimate_table() -> np.ndarray:
    """The host's ``rsqrtps`` estimate as 2048 f32 bit patterns (uint32):
    entry ``((E & 1) << 10) | (mantissa >> 13)`` is the estimate of
    ``2**(E0 - 127) * (1 + top10 / 1024)``, ``E0 = 126 + (E & 1)``. Read once
    a process; raises where the host has no ``rsqrtps``."""
    global _rsqrt_table
    with _count_lock:
        if _rsqrt_table is None:
            fn = _native_rsqrt_library().xla_rsqrt_estimate_table
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            table = np.zeros(RSQRT_TABLE_SIZE, dtype=np.uint32)
            if fn(table.ctypes.data) != 0:
                raise RuntimeError("this host has no rsqrtps: XLA's CPU rsqrt cannot be reproduced here")
            table.setflags(write=False)
            _rsqrt_table = table
        return _rsqrt_table


def rsqrt_plain(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU f32 ``rsqrt`` of an f32 tensor (module docstring), on the
    tensor's own device."""
    x = x.float()
    bits = x.view(torch.int32)
    e = (bits >> 23) & 0xFF
    table = torch.tensor(rsqrt_estimate_table().view(np.int32), device=x.device)
    # the estimate of the reference binade E0 of the same parity, moved by
    # (E - E0) / 2 binades the other way
    est = table[((e & 1) << 10) | ((bits >> 13) & 1023)] - (((e - 126 - (e & 1)) >> 1) << 23)
    y = est.view(torch.float32)
    for _ in range(2):
        y = fma_f32(y * -0.5, fma_f32(x * y, y, -1.0), y)
    sign = bits < 0
    # negatives: the default NaN (0xffc00000); +inf: 0; zeros, subnormals: inf of their sign
    raw = torch.where(sign, torch.tensor(-0x00400000, dtype=torch.int32), 0).view(torch.float32)
    raw = torch.where(e == 0, torch.where(sign, -torch.inf, torch.inf), raw)
    out = torch.where((e == 0) | sign | torch.isposinf(x), raw, y)
    return torch.where(torch.isnan(x), _quiet_nan(x, flip_sign=False), out)


def sigmoid_plain(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA's CPU backend computes it in f32."""
    x = x.float()
    out = _flush(1.0 / (exp_plain(-x) + 1.0))
    return torch.where(torch.isnan(x), _quiet_nan(x, flip_sign=True), out)


def _library() -> ctypes.CDLL:
    from kobato_eyes_tpu_torch.ops.build import load

    lib = load(_SOURCE)
    if lib.xla_math_launch.argtypes is None:
        vp = ctypes.c_void_p
        lib.xla_math_launch.argtypes = [vp, vp, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, vp, vp]
        lib.xla_math_launch.restype = ctypes.c_int
    return lib


def _check_variant(variant: str | None) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is none of {sorted(v for v in VARIANTS if v)}")


def _launch(x: torch.Tensor, op: str, variant: str | None) -> torch.Tensor:
    if x.dtype != torch.float32:
        raise ValueError(f"xla {op} kernel takes float32, got {x.dtype}")
    xc = x.contiguous()
    out = torch.empty_like(xc)
    if xc.numel():
        stream = torch.cuda.current_stream(xc.device).cuda_stream
        table = rsqrt_estimate_table().ctypes.data if op == "rsqrt" else None
        err = _library().xla_math_launch(xc.data_ptr(), out.data_ptr(), xc.numel(), _OPS[op], VARIANTS[variant],
                                         table, stream)
        if err != 0:
            raise RuntimeError(f"xla {op} launch failed: cudaError_t {err}")
    return out


def xla_exp_f32(x: torch.Tensor, *, variant: str | None = None) -> torch.Tensor:
    """XLA's f32 ``exp``: the CUDA pass for a CUDA tensor (``variant`` as
    :func:`xla_sigmoid_f32`'s), the plain version for a CPU tensor."""
    global exp_launches
    _check_variant(variant)
    if x.device.type == "cpu":
        return exp_plain(x)
    out = _launch(x, "exp", variant)
    if x.numel():
        with _count_lock:
            exp_launches += 1
    return out


def xla_sigmoid_f32(x: torch.Tensor, *, variant: str | None = None) -> torch.Tensor:
    """``jax.nn.sigmoid`` in f32 as XLA computes it: the CUDA pass for a CUDA
    tensor, the plain version for a CPU tensor. ``variant`` (``"vec"``,
    ``"scalar"``) runs that body whatever the size, to check or time it."""
    global launches
    _check_variant(variant)
    if x.device.type == "cpu":
        return sigmoid_plain(x)
    out = _launch(x, "sigmoid", variant)
    if x.numel():
        with _count_lock:
            launches += 1
    return out


def xla_rsqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.rsqrt`` in f32 as XLA computes it on this host's CPU: the
    CUDA pass for a CUDA tensor (its body chosen by size), the plain version
    for a CPU tensor."""
    global rsqrt_launches
    if x.device.type == "cpu":
        return rsqrt_plain(x)
    out = _launch(x, "rsqrt", None)
    if x.numel():
        with _count_lock:
            rsqrt_launches += 1
    return out


class _Rsqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = xla_rsqrt_f32(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        x, y = ctx.saved_tensors
        return g * (-0.5 * (y / x))  # jax.lax.rsqrt's JVP rule


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``rsqrt`` as :func:`xla_rsqrt_f32` computes it (the CUDA pass
    for a CUDA tensor, the plain version for a CPU one), differentiable as
    ``jax.lax.rsqrt`` is: what flax's ``nn.LayerNorm`` and the JAX package's
    LayerNorms call."""
    return _Rsqrt.apply(x)
