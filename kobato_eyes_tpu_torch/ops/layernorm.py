"""The port's LayerNorms in one pass: the hand-written CUDA kernel and its
plain version.

Not a port of a TPU kernel: the JAX package leaves its LayerNorms to XLA,
which fuses each into one loop over a row. The port's modules write them op
by op in torch, some twelve passes over f32 copies of the rows:
``vit.LayerNorm`` (flax's, in the ViT, EVA02 and SwinV2's patch-embed,
merging and final norms) and ``swin.ResidualPostNorm`` under
``ln_impl="xla"`` (the JAX package's post-norm residual). On a CUDA tensor,
while autograd does not record (``takes_kernel``), each runs as one pass of
``csrc/layernorm.cu`` with the module's own arithmetic, per row of C values:

* ``S = sum(x)``, ``Q = sum(round(x * x))`` in f32; ``mean = S * fl(1 / C)``
  and ``m2 = Q * fl(1 / C)``: torch's CUDA ``mean`` multiplies its sum by
  the f32 reciprocal of the count (its CPU ``mean`` divides);
* ``vit.LayerNorm`` (no ``shortcut``): ``var = max(m2 - mean^2, 0)``,
  ``mul = rsqrt(var + eps) * w``, ``y = (x - mean) * mul + b`` rounded once
  to ``dtype``;
* ``ResidualPostNorm`` (a ``shortcut``): ``var = m2 - mean^2`` (no clamp),
  ``y = ((x - mean) * rsqrt(var + eps)) * w + b``, rounded to ``dtype``,
  then ``shortcut + y`` in f32 rounded again to ``dtype``, as the chain's
  add in ``dtype`` does;

rsqrt XLA's CPU one (``xla_math.rsqrt_plain``; ``csrc/xla_rsqrt.cuh`` on
the card), each product and sum rounded alone (no FMA), w and b read as
stored (f32, or bf16 with ``bf16_params``). The only freedom taken is the
order in which a row's two sums are added: a thread adds its chunks' values
in column order, then a butterfly over the row's lanes, then a block's warp
sums in warp order. ``layernorm_plain`` adds in that order, so on the card
the kernel equals it bit for bit; it differs from the module's chain by the
sums' order alone.

Bound on the card: bytes (x and the shortcut read once, the output written
once). ``layout`` chooses the body from C, the dtypes and the alignment
alone: chunks of E consecutive values, as wide as one 16-byte load of x
holds where C and the rows' addresses and pitch allow it, narrower
otherwise; T = 16 or 32 threads a row with K = 1 to 8 chunks each up to 256
chunks a row, a block of 128 threads a row beyond (256 past 1536 chunks). x
of bf16 with an f32 output is widened to f32 first (exact: the same
result).

The output's rows may lie wider apart than C (``out_pitch``, a multiple of
16 bytes; the plain epilogue, x no wider than the output): the kernel writes
zeros past C. EVA02's SwiGLU (``models/eva02.py``)
writes its 2730-column sub-LayerNorm at a 2752-column pitch that way, so the
product after it reads 16-byte-aligned rows.

A wrapper launches the kernel for a CUDA tensor and raises if the launch
fails; it takes the plain version only for a CPU tensor. ``launches`` counts
the kernel's launches in this process, under a lock (the watcher's tag jobs
run the tagger on worker threads). The library builds at the first launch,
never at import.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from kobato_eyes_tpu_torch.ops.xla_math import rsqrt_estimate_table, rsqrt_plain

launches = 0
_count_lock = threading.Lock()

_SOURCE = "layernorm.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHANNELS = 4096
VECTOR_BYTES = 16
WARP = 32
# (T, K) in the order tried: a (half) warp a row, then a block a row
BODIES = ((16, 1), (32, 1), (32, 2), (32, 4), (32, 8), (128, 4), (128, 8), (128, 12), (256, 8), (256, 16))


def on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def takes_kernel(x: torch.Tensor, *params: torch.Tensor) -> bool:
    """Whether a module's LayerNorm of ``x`` runs as the kernel: ``x`` on a
    CUDA device while autograd does not record for it (no grad mode, or
    neither ``x`` nor a parameter requires grad). The tagger's forwards run
    under ``inference_mode``; a training forward keeps the module's chain,
    whose gradient autograd knows."""
    if not on_card(x):
        return False
    return not (torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params)))


# ---------------------------------------------------------------------------
# Layout: the body of csrc/layernorm.cu a call runs
# ---------------------------------------------------------------------------


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as (R, C) rows with a unit column stride: a view where one
    exists, else a contiguous copy."""
    rows = t.reshape(-1, t.shape[-1])
    return rows if rows.stride(-1) == 1 else rows.contiguous()


def operands(x: torch.Tensor, dtype: torch.dtype,
             shortcut: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The (R, C) rows the kernel reads: x (widened to f32 where it is bf16
    and ``dtype`` f32) and the shortcut in ``dtype``, as ``ResidualPostNorm``
    casts it."""
    if x.dtype == torch.bfloat16 and dtype == torch.float32:
        x = x.float()
    return _rows(x), None if shortcut is None else _rows(shortcut.to(dtype))


def chunk_values(rows: list[torch.Tensor]) -> int:
    """E, the values a thread loads at once: the most that 16 bytes of the
    first tensor's dtype hold and that divide C, each tensor's pitch and,
    in bytes, its address."""
    c = rows[0].shape[-1]
    e = VECTOR_BYTES // rows[0].element_size()
    while e > 1:
        if c % e == 0 and all(r.data_ptr() % (e * r.element_size()) == 0 and r.stride(0) % e == 0 for r in rows):
            break
        e //= 2
    return e


def body(channels: int, e: int) -> tuple[int, int]:
    """(T, K): threads a row and chunks a thread for C columns in chunks of
    E, the first of ``BODIES`` that holds them: a half warp or a warp up to
    256 chunks, a block of 128 threads up to 1536, of 256 beyond."""
    chunks = channels // e
    return next((t, k) for t, k in BODIES if chunks <= t * k)


def layout(x2: torch.Tensor, shortcut2: torch.Tensor | None = None) -> tuple[int, int, int]:
    """(E, T, K) of the body a call on these rows (``operands``) runs."""
    e = chunk_values([x2] if shortcut2 is None else [x2, shortcut2])
    return (e, *body(x2.shape[-1], e))


# ---------------------------------------------------------------------------
# Plain version (the CPU path, and what the kernel is held against)
# ---------------------------------------------------------------------------


def row_sums(xf: torch.Tensor, e: int, t: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(S, Q) of each f32 row of (R, C), each (R, 1), added in the kernel's
    order for the layout (E, T, K): thread j of a row owns chunks j, j + T,
    ... of E columns and adds their values in column order, x * x rounded
    before its add; then xor butterflies over min(T, 32) lanes; then the
    warps' sums in warp order."""
    r, c = xf.shape
    v = xf.new_zeros(r, k * t * e)
    v[:, :c] = xf
    v = v.view(r, k, t, e)
    s = xf.new_zeros(r, t)
    q = xf.new_zeros(r, t)
    for kk in range(k):
        for i in range(e):
            col = v[:, kk, :, i]
            s = s + col
            q = q + col * col
    lanes = min(t, WARP)
    s, q = s.view(r, t // lanes, lanes), q.view(r, t // lanes, lanes)
    lane = torch.arange(lanes, device=xf.device)
    o = lanes // 2
    while o:
        s, q = s + s[..., lane ^ o], q + q[..., lane ^ o]
        o //= 2
    s, q = s[..., 0], q[..., 0]
    total_s, total_q = s[:, :1], q[:, :1]
    for w in range(1, s.shape[1]):
        total_s, total_q = total_s + s[:, w : w + 1], total_q + q[:, w : w + 1]
    return total_s, total_q


def layernorm_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *, eps: float, dtype: torch.dtype,
    shortcut: torch.Tensor | None = None, body_of: tuple[int, int, int] | None = None,
    out_pitch: int | None = None,
) -> torch.Tensor:
    """The kernel's result step for step (module docstring), in the order of
    ``body_of`` (E, T, K) or else of the body the card would run on these
    tensors. Without ``shortcut`` ``vit.LayerNorm``'s arithmetic, with it
    ``ResidualPostNorm``'s. With ``out_pitch`` the rows are ``out_pitch``
    columns wide, the C results first and zeros after."""
    c = x.shape[-1] if x.dim() else 0
    x2, shortcut2 = operands(x, dtype, shortcut)
    e, t, k = layout(x2, shortcut2) if body_of is None else body_of
    xf = x2.float()
    s, q = row_sums(xf, e, t, k)
    inv_c = torch.ones((), dtype=torch.float32, device=x.device) / c
    mean = s * inv_c
    var = q * inv_c - mean * mean
    if shortcut is None:
        mul = rsqrt_plain(torch.clamp(var, min=0.0) + eps) * weight
        out = ((xf - mean) * mul + bias).to(dtype)
    else:
        y = (xf - mean) * rsqrt_plain(var + eps)
        y = y * weight + bias
        out = shortcut2 + y.to(dtype)
    if out_pitch is not None and out_pitch != c:
        out = torch.nn.functional.pad(out, (0, out_pitch - c))
    return out.reshape(*x.shape[:-1], out.shape[-1])


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def _library() -> ctypes.CDLL:
    from kobato_eyes_tpu_torch.ops.build import load

    lib = load(_SOURCE)
    fn = lib.layernorm_launch
    if fn.argtypes is None:
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [vp, ll, vp, ll, vp, vp, vp, ll, ll, i, i, i, i, i, i, i, i, ctypes.c_float, vp, vp]
        fn.restype = ctypes.c_int
    return lib


def check_inputs(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype,
                 shortcut: torch.Tensor | None = None) -> None:
    """Raise on what the kernel does not take: CUDA tensors on one device,
    x, the shortcut and ``dtype`` float32 or bfloat16, C from 1 to 4096,
    weight and bias of shape (C,), a shortcut of x's shape."""
    for name, t in (("x", x), ("weight", weight), ("bias", bias), ("shortcut", shortcut)):
        if t is None:
            continue
        if t.device != x.device or not on_card(t):
            raise ValueError(f"layernorm kernel needs CUDA tensors on one device, got {name} on {t.device}")
        if t.dtype not in _DTYPE_CODES:
            raise ValueError(f"layernorm kernel takes float32 or bfloat16, got {name} of {t.dtype}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"layernorm kernel writes float32 or bfloat16, not {dtype}")
    c = x.shape[-1] if x.dim() else 0
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"layernorm kernel takes 1 <= C <= {MAX_CHANNELS}, got {c}")
    if tuple(weight.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"weight and bias must be ({c},), got {tuple(weight.shape)} and {tuple(bias.shape)}")
    if shortcut is not None and shortcut.shape != x.shape:
        raise ValueError(f"shortcut must have x's shape {tuple(x.shape)}, got {tuple(shortcut.shape)}")


def _aligned_param(p: torch.Tensor) -> torch.Tensor:
    p = p.contiguous()
    return p if p.data_ptr() % VECTOR_BYTES == 0 else p.clone()


def _launch(x2: torch.Tensor, shortcut2: torch.Tensor | None, weight: torch.Tensor, bias: torch.Tensor,
            out: torch.Tensor, body_of: tuple[int, int, int], eps: float) -> None:
    e, t, k = body_of
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    err = _library().layernorm_launch(
        x2.data_ptr(), x2.stride(0), None if shortcut2 is None else shortcut2.data_ptr(),
        0 if shortcut2 is None else shortcut2.stride(0), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        out.stride(0), x2.shape[0], x2.shape[1], _DTYPE_CODES[x2.dtype], _DTYPE_CODES[out.dtype],
        _DTYPE_CODES[weight.dtype], _DTYPE_CODES[bias.dtype], e, t, k, float(eps), rsqrt_estimate_table().ctypes.data,
        stream,
    )
    if err != 0:
        raise RuntimeError(f"layernorm launch failed: cudaError_t {err}")


def layernorm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *, eps: float, dtype: torch.dtype,
    shortcut: torch.Tensor | None = None, out_pitch: int | None = None,
) -> torch.Tensor:
    """LayerNorm over the last axis, any leading shape, written in ``dtype``:
    ``vit.LayerNorm``'s arithmetic, or with ``shortcut`` ``ResidualPostNorm``'s
    (module docstring). The kernel for a CUDA tensor, the plain version for
    a CPU tensor. ``out_pitch`` (C by default): the output's last axis, the
    C results and zeros after them, so a product that reads the rows finds
    them aligned; wider than C only on 16 bytes, without ``shortcut`` and
    with x no wider than ``dtype`` (the kernel's padded instances)."""
    global launches
    c = x.shape[-1] if x.dim() else 0
    pitch = c if out_pitch is None else out_pitch
    if pitch != c and (pitch < c or pitch * dtype.itemsize % VECTOR_BYTES or shortcut is not None
                       or x.dtype.itemsize > dtype.itemsize):
        raise ValueError(f"layernorm writes rows wider apart than C = {c} only at a multiple of {VECTOR_BYTES} bytes, "
                         f"without a shortcut and from x no wider than {dtype}: not at {pitch} values "
                         f"from {x.dtype}{' with a shortcut' if shortcut is not None else ''}")
    if not on_card(x):
        return layernorm_plain(x, weight, bias, eps=eps, dtype=dtype, shortcut=shortcut, out_pitch=pitch)
    check_inputs(x, weight, bias, dtype, shortcut)
    x2, shortcut2 = operands(x, dtype, shortcut)
    out = torch.empty((x2.shape[0], pitch), dtype=dtype, device=x.device)
    if x2.shape[0] == 0:
        return out.reshape(*x.shape[:-1], pitch)
    _launch(x2, shortcut2, _aligned_param(weight), _aligned_param(bias), out, layout(x2, shortcut2), eps)
    with _count_lock:
        launches += 1
    return out.reshape(*x.shape[:-1], pitch)
