"""GELU as XLA evaluates ``jax.nn.gelu``: one hand-written CUDA pass and its
plain version, for the erf form (``approximate=False``) and the tanh form
(``approximate=True``), in bf16 and f32.

Not a port of a TPU kernel: the JAX package leaves the activation to XLA.
What the port has to match is the op sequence of XLA's compiled HLO
(``jax.jit(lambda x: jax.nn.gelu(x, approximate=...)).lower(x).compile()
.as_text()`` on the CPU, at (rows, 3072) for each dtype and form):

* erf, bf16: ``0.5 * x`` rounded to bf16; ``z = -x * 0.70703125`` (sqrt(0.5)
  rounded to bf16) in f32, NOT rounded; ``erfc(z)`` as one f32 sequence
  (below), rounded to bf16; the product rounded to bf16.
* erf, f32: ``(0.5 * x) * erfc(-x * 0.707106769)``, all f32.
* erfc(z), f32: ``w = z * z``; for ``|z| < 1`` ``1 - z * P(w)`` (P of degree
  6); else ``exp(-w) * (1 / |z|) * (A(1/w) if |z| < 2 else B(1/w))`` (A of
  degree 8, B of degree 7), 0 where ``-w < -88.7228394``, ``2 - that`` for
  ``z < 0``. Both arms are computed and selected, as the HLO's selects do.
* tanh, bf16: every step rounded to bf16 with the constants rounded to bf16
  (0.0446777344, 0.796875): ``x * (0.5 * (1 + tanh(c * (x + k * x**3))))``.
* tanh, f32: the same in f32 with 0.044715 and 0.797884583.

XLA's CPU backend contracts every multiply-add of those sequences that no
bf16 rounding separates into one fused multiply-add: the Horner steps, ``1 -
z * P(w)`` and, in the f32 tanh form, ``x + k * x**3``. The kernel writes
them as ``__fmaf_rn`` and every other step as ``__fmul_rn`` / ``__fadd_rn``
/ ``__fdiv_rn`` (so that nvcc contracts nothing else), with ``expf`` and
``tanhf`` (which torch's CUDA ``exp`` and ``tanh`` equal bit for bit). The
plain version computes a fused multiply-add through f64 with f32 constants
(the product of two f32 is exact there; the sum is rounded twice, which can
move one in ~10^9 results by one f32 step). What remains against XLA: its
CPU runtime flushes subnormals to zero, which moves 1 of 200 000 bf16
values of N(0, 9) in the erf form (none in the tanh form), and in f32 the
last bits of its own ``exp`` and ``tanh`` (``tests/test_torch_gelu.py``).

On the card the pass is bound by bytes: x read once and the output written
once (2 x 154 MB at ViT-B/448, batch 32, in bf16). ``kernel_variant`` says
which body a call runs, by dtype and alignment alone: ``"lut"`` for bf16 and
``"vec"`` for f32 when every tensor starts at a 16-byte boundary,
``"scalar"`` (one element a thread) otherwise. ``"vec"`` (16-byte loads and
stores, 8 bf16 or 4 f32 a thread) computes the sequences above element by
element; ``"lut"`` reads bf16 results from a table instead. In bf16 the
forward is a function of the one 16-bit input, and the gradient's factors
of x alone (erf: ``e = bf16(exp(-bf16(bf16(z)**2)))`` and ``E =
bf16(erfc(z))``; tanh: ``t = bf16(tanh(inner))`` and ``cdf``) are too,
each a value the HLO rounds. Inside a window of |x|'s binades
(``LUT_WINDOW``) a table holds them; outside it one rule does
(``gelu_lut_plain``, ``gelu_backward_lut_plain``). The table is built on the
card, once per device, form and direction, by the ``"vec"`` body's own
functions over the window's bit patterns (``lut_table``; ``table_builds``
counts the builds, which are not launches). The window and the rules were
found by comparing with the plain version on all 65 536 bf16 inputs, which
``tests/test_torch_gelu.py`` repeats for the mirror.

``gelu`` differentiates: its backward is JAX's own jvp of the same formula
(``d erfc(z) = -2/sqrt(pi) * exp(-z**2)``; the tanh form's chain rule as
XLA's compiled vjp arranges it), one more pass of ``csrc/gelu.cu``
(``gelu_backward``, bound by three tensors' bytes), whose plain versions
are ``gelu_*_backward_plain``. A wrapper launches its kernel for CUDA
tensors and raises if the launch fails, or if a table is missing while a
CUDA graph is captured (``prepare_tables`` builds them beforehand); it
takes the plain version only for a CPU tensor. ``launches`` and
``backward_launches`` count the two kernels' launches in this process.
"""

from __future__ import annotations

import ctypes
import struct
import threading

import torch

launches = 0
backward_launches = 0
table_builds = 0

_SOURCE = "gelu.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FORM_CODES = {"erf": 0, "tanh": 1}
_VARIANT_CODES = {"scalar": 0, "vec": 1}  # "lut" has entries of its own
VARIANTS = ("scalar", "vec", "lut")
# |x|'s binades that the "lut" tables cover, as biased bf16 exponents (the
# erf form 2^-9 .. 2^3, the tanh form 2^-9 .. 2^1), for the forward and the
# gradient's factors alike: the narrowest outside which the rules hold for
# every bf16 input (tests/test_torch_gelu.py)
LUT_WINDOW = {"erf": (118, 130), "tanh": (118, 128)}

# the constants XLA's HLO prints (f32; bf16-rounded where the bf16 HLO has them)
_SQRT_HALF = {torch.float32: 0.707106769, torch.bfloat16: 0.70703125}
_TANH_C = {torch.float32: 0.797884583, torch.bfloat16: 0.796875}
_TANH_K = {torch.float32: 0.044715, torch.bfloat16: 0.0446777344}
_NEG_TWO_OVER_SQRT_PI = {torch.float32: -1.12837923, torch.bfloat16: -1.125}
_TANH_CK_F32 = 0.0356774069  # c * k, folded by XLA in the f32 vjp
_P_SMALL = (7.85386146e-05, -0.000801019371, 0.00518832775, -0.0268538129, 0.112835854,
            -0.37612626, 1.12837911)
_P_MID = (0.0232682, -0.138703942, 0.368742466, -0.582473278, 0.621000469, -0.494451523,
          0.340488, -0.274112701, 0.563825965)
_P_BIG = (-10.477664, 12.9772, -7.49551868, 2.92101908, -1.01526523, 0.42184633,
          -0.282076746, 0.564189494)
_EXP_UNDERFLOW = -88.7228394


def _check_dtype(x: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"gelu takes float32 or bfloat16, got {x.dtype}")


def _f32(v: float) -> float:
    """A Python float rounded to f32, as the kernel's ``f`` literals are."""
    return struct.unpack("f", struct.pack("f", v))[0]


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` with one f32 rounding (through f64: the product of two
    f32 is exact there); constants are f32 values, as in the HLO."""
    b64 = b.double() if isinstance(b, torch.Tensor) else _f32(b)
    c64 = c.double() if isinstance(c, torch.Tensor) else _f32(c)
    return (a.double() * b64 + c64).float()


def _horner(t: torch.Tensor, coeffs: tuple[float, ...]) -> torch.Tensor:
    """``coeffs[0] * t**n + ... + coeffs[n]``, each step one fused multiply-add."""
    p = _fma(t, coeffs[0], coeffs[1])
    for c in coeffs[2:]:
        p = _fma(p, t, c)
    return p


def _erfc(z: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erfc`` sequence on an f32 tensor, both arms selected."""
    az = z.abs()
    w = z * z
    small = _fma(-z, _horner(w, _P_SMALL), 1.0)
    nw = -w
    q = torch.reciprocal(w)
    poly = torch.where(az < 2.0, _horner(q, _P_MID), _horner(q, _P_BIG))
    big = (torch.exp(nw) * torch.reciprocal(az)) * poly
    big = torch.where(nw < _EXP_UNDERFLOW, torch.zeros_like(big), big)
    big = torch.where(z < 0.0, 2.0 - big, big)
    return torch.where(az < 1.0, small, big)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round an f32 tensor to bf16 and back (XLA's convert pair)."""
    return t.to(torch.bfloat16).float()


def gelu_erf_plain(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=False)`` step for step as XLA compiles it."""
    _check_dtype(x)
    xf = x.float()
    z = (-xf) * _SQRT_HALF[x.dtype]
    if x.dtype == torch.bfloat16:
        return (_bf16(xf * 0.5) * _bf16(_erfc(z))).to(torch.bfloat16)
    return (xf * 0.5) * _erfc(z)


def gelu_tanh_plain(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` step for step as XLA compiles it."""
    _check_dtype(x)
    c, k = _TANH_C[x.dtype], _TANH_K[x.dtype]
    xf = x.float()
    if x.dtype == torch.bfloat16:
        x3 = _bf16(_bf16(xf * xf) * xf)
        inner = _bf16(_bf16(xf + _bf16(x3 * k)) * c)
        cdf = _bf16(_bf16(_bf16(torch.tanh(inner)) + 1.0) * 0.5)
        return (xf * cdf).to(torch.bfloat16)
    inner = _fma((xf * xf) * xf, k, xf) * c
    return xf * ((torch.tanh(inner) + 1.0) * 0.5)


def _grad_factors_bf16(xf: torch.Tensor, form: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16 gradient's two factors of x alone, as f32 tensors of bf16
    values: erf ``e = bf16(exp(-bf16(bf16(z)**2)))`` and ``E =
    bf16(erfc(z))`` (``z = -x * 0.70703125``, not rounded); tanh ``t =
    bf16(tanh(inner))`` and ``cdf = bf16(bf16(t + 1) * 0.5)``."""
    dt = torch.bfloat16
    if form == "erf":
        z = (-xf) * _SQRT_HALF[dt]
        zb = _bf16(z)
        return _bf16(torch.exp(-_bf16(zb * zb))), _bf16(_erfc(z))
    x3 = _bf16(_bf16(xf * xf) * xf)
    inner = _bf16(_bf16(xf + _bf16(x3 * _TANH_K[dt])) * _TANH_C[dt])
    t = _bf16(torch.tanh(inner))
    return t, _bf16(_bf16(t + 1.0) * 0.5)


def _grad_apply_bf16(xf: torch.Tensor, gf: torch.Tensor, a: torch.Tensor, c: torch.Tensor,
                     form: str) -> torch.Tensor:
    """The bf16 gradient's steps that take g, given its factors ``a, c``."""
    dt = torch.bfloat16
    if form == "erf":  # a = e, c = E
        t2 = _bf16(_bf16(_bf16(xf * 0.5) * gf) * _NEG_TWO_OVER_SQRT_PI[dt])
        d1 = -_bf16(_bf16(t2 * a) * _SQRT_HALF[dt])
        m0 = _bf16(_bf16(gf * c) * 0.5)
        return (d1 + m0).to(dt)
    x2 = _bf16(xf * xf)  # a = t, c = cdf
    direct = _bf16(gf * c)
    m6 = _bf16(_bf16(_bf16(xf * gf) * 0.5) * _bf16(1.0 - a))
    a2 = _bf16(m6 + _bf16(m6 * a))
    m3 = _bf16(a2 * _TANH_C[dt])
    a1 = _bf16(direct + m3)
    m0 = _bf16(_bf16(m3 * _TANH_K[dt]) * _bf16(x2 * 3.0))
    return (a1 + m0).to(dt)


def gelu_erf_backward_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient through ``gelu_erf_plain`` as XLA compiles JAX's vjp:
    ``g * erfc(z) * 0.5 - (0.5 * x * g) * 2/sqrt(pi) * exp(-z**2) * sqrt(0.5)``
    with ``z = -x * sqrt(0.5)``; in bf16 every step is rounded and the
    exp's argument is built from z rounded to bf16."""
    _check_dtype(x)
    dt = x.dtype
    xf, gf = x.float(), g.float()
    if dt == torch.bfloat16:
        return _grad_apply_bf16(xf, gf, *_grad_factors_bf16(xf, "erf"), "erf")
    s = _SQRT_HALF[dt]
    z = (-xf) * s
    t2 = ((xf * 0.5) * gf) * _NEG_TWO_OVER_SQRT_PI[dt]
    t3 = t2 * torch.exp(-(z * z))
    return _fma(-t3, s, (gf * _erfc(z)) * 0.5)


def gelu_tanh_backward_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient through ``gelu_tanh_plain`` as XLA compiles JAX's vjp."""
    _check_dtype(x)
    dt = x.dtype
    xf, gf = x.float(), g.float()
    if dt == torch.bfloat16:
        return _grad_apply_bf16(xf, gf, *_grad_factors_bf16(xf, "tanh"), "tanh")
    c, k = _TANH_C[dt], _TANH_K[dt]
    x2 = xf * xf
    t = torch.tanh(_fma(x2 * xf, k, xf) * c)
    direct = gf * ((t + 1.0) * 0.5)
    m6 = ((xf * gf) * 0.5) * (1.0 - t)
    a2 = _fma(m6, t, m6)
    a1 = _fma(a2, c, direct)
    return _fma(a2 * _TANH_CK_F32, x2 * 3.0, a1)


# ---- the "lut" body's plain mirror ----


def _window(form: str) -> tuple[int, int]:
    """``(lo, span)``: the table covers |x|'s bit patterns lo .. lo + span - 1."""
    first, last = LUT_WINDOW[form]
    return first << 7, (last - first + 1) << 7


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor's bit patterns, 0 .. 65535, as int32."""
    return t.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF


def _from_bits(b: torch.Tensor) -> torch.Tensor:
    """bf16 values from bit patterns 0 .. 65535."""
    return ((b + 0x8000) % 0x10000 - 0x8000).to(torch.int16).view(torch.bfloat16)


def lut_patterns(form: str) -> torch.Tensor:
    """The bf16 inputs of the table's entries, in its order: |x|'s window,
    then the same negated (the order ``gelu_table_kernel`` writes)."""
    lo, span = _window(form)
    mags = torch.arange(lo, lo + span, dtype=torch.int32)
    return _from_bits(torch.cat([mags, mags | 0x8000]))


def gelu_table_plain(form: str, *, backward: bool = False) -> torch.Tensor:
    """The table the card builds for ``form``, from the plain version: bf16
    outputs (forward), or the gradient's two factors packed first-low
    (backward), as int32 bit patterns."""
    x = lut_patterns(form)
    if not backward:
        return _bits(gelu_tanh_plain(x) if form == "tanh" else gelu_erf_plain(x))
    a, c = _grad_factors_bf16(x.float(), form)
    return _bits(a.to(torch.bfloat16)) | (_bits(c.to(torch.bfloat16)) << 16)


def _lut_index(b: torch.Tensor, form: str) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's index arithmetic on bit patterns ``b``: ``i = (b & 0x7FFF)
    - lo`` (below the window where negative), whether it is inside, and the
    entry it reads there (``i``, or ``i + span`` for a negative x), clamped
    outside it. Raises if an entry read inside falls outside the table."""
    lo, span = _window(form)
    i = (b & 0x7FFF) - lo
    inside = (i >= 0) & (i < span)
    entry = i + (b >> 15) * span
    read = entry[inside]
    if read.numel() and (int(read.min()) < 0 or int(read.max()) >= 2 * span):
        raise AssertionError(f"gelu {form} table index out of range")
    return i, inside, entry.clamp(0, 2 * span - 1)


def gelu_lut_plain(x: torch.Tensor, *, approximate: bool) -> torch.Tensor:
    """The ``"lut"`` body's forward in torch ops (bf16): the table entry
    inside the window, ``bf16(0.5 * x)`` below it, ``bf16(x * (x > 0))``
    above it (x, a signed zero, or NaN for -inf and NaN)."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the gelu table takes bfloat16, got {x.dtype}")
    form = "tanh" if approximate else "erf"
    b = _bits(x).reshape(-1)
    i, inside, entry = _lut_index(b, form)
    scale = torch.where(i < 0, 0.5, torch.where(b >= 0x8000, 0.0, 1.0))
    rule = _bits((x.reshape(-1).float() * scale).to(torch.bfloat16))
    return _from_bits(torch.where(inside, gelu_table_plain(form)[entry], rule)).reshape(x.shape)


def gelu_backward_lut_plain(x: torch.Tensor, g: torch.Tensor, *, approximate: bool) -> torch.Tensor:
    """The ``"lut"`` body's gradient in torch ops (bf16): the two factors of
    x from the table inside the window; below it erf (1, 1), tanh
    (bf16(0.796875 x), 0.5); above it erf (0, 2) / (0, 0), tanh (1, 1) /
    (-1, 0) for x > 0 / x < 0; then the steps that take g."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the gelu table takes bfloat16, got {x.dtype}")
    form = "tanh" if approximate else "erf"
    b = _bits(x).reshape(-1)
    i, inside, entry = _lut_index(b, form)
    xf, gf = x.reshape(-1).float(), g.reshape(-1).float()
    packed = gelu_table_plain(form, backward=True)[entry]
    below, negative = i < 0, b >= 0x8000
    if form == "erf":
        a_rule = torch.where(below, 1.0, 0.0)
        c_rule = torch.where(below, 1.0, torch.where(negative, 0.0, 2.0))
    else:
        a_rule = torch.where(below, _bf16(xf * _TANH_C[torch.bfloat16]), torch.where(negative, -1.0, 1.0))
        c_rule = torch.where(below, 0.5, torch.where(negative, 0.0, 1.0))
    a = torch.where(inside, _from_bits(packed & 0xFFFF).float(), a_rule)
    c = torch.where(inside, _from_bits((packed >> 16) & 0xFFFF).float(), c_rule)
    return _grad_apply_bf16(xf, gf, a, c, form).reshape(x.shape)


def kernel_variant(*tensors: torch.Tensor) -> str:
    """Which body of ``csrc/gelu.cu`` a CUDA call runs: ``"lut"`` (bf16) or
    ``"vec"`` (f32) when every tensor starts at a multiple of 16 bytes,
    ``"scalar"`` otherwise."""
    if not all(t.data_ptr() % 16 == 0 for t in tensors):
        return "scalar"
    return "lut" if tensors[0].dtype == torch.bfloat16 else "vec"


def _library() -> ctypes.CDLL:
    from kobato_eyes_tpu_torch.ops.build import load

    lib = load(_SOURCE)
    if lib.gelu_launch.argtypes is None:
        vp, ll, i, u = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint
        for fn, args in (
            (lib.gelu_backward_launch, [vp, vp, vp, ll, i, i, i, vp]),
            (lib.gelu_table_build, [vp, i, i, u, u, vp]),
            (lib.gelu_lut_launch, [vp, vp, ll, i, vp, u, u, vp]),
            (lib.gelu_backward_lut_launch, [vp, vp, vp, ll, i, vp, u, u, vp]),
            (lib.gelu_launch, [vp, vp, ll, i, i, i, vp]),  # last: its argtypes mark the set
        ):
            fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


_tables: dict[tuple[int, str, bool], torch.Tensor] = {}
_tables_lock = threading.Lock()


def lut_table(device: torch.device, form: str, *, backward: bool = False) -> torch.Tensor:
    """The ``"lut"`` body's table for ``form`` on a CUDA ``device``: built
    by the ``"vec"`` body's functions the first time it is asked for, then
    kept (2 * span int16 outputs, or int32 packed factors for the
    gradient). Raises if it is missing while the current stream captures a
    CUDA graph."""
    global table_builds
    device = torch.device(device)
    key = (device.index if device.index is not None else torch.cuda.current_device(), form, backward)
    table = _tables.get(key)
    if table is not None:
        return table
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"gelu {form} table missing on {device} during a CUDA graph capture: "
                           "call gelu.prepare_tables(device) before capturing")
    with _tables_lock:
        table = _tables.get(key)
        if table is None:
            lo, span = _window(form)
            table = torch.empty(2 * span, dtype=torch.int32 if backward else torch.int16, device=device)
            stream = torch.cuda.current_stream(device)
            err = _library().gelu_table_build(table.data_ptr(), _FORM_CODES[form], int(backward), lo, span,
                                              stream.cuda_stream)
            if err != 0:
                raise RuntimeError(f"gelu table build failed: cudaError_t {err}")
            stream.synchronize()  # the table is read on any stream from here on
            _tables[key] = table
            table_builds += 1
    return table


def prepare_tables(device: torch.device | str = "cuda") -> None:
    """Build every ``"lut"`` table on ``device`` (both forms, forward and
    gradient), as a CUDA graph capture needs them beforehand."""
    for form in _FORM_CODES:
        for backward in (False, True):
            lut_table(torch.device(device), form, backward=backward)


def _cuda_operands(*tensors: torch.Tensor) -> list[torch.Tensor]:
    """``tensors`` made contiguous, after checking they are CUDA tensors of
    one supported dtype and shape."""
    x = tensors[0]
    if x.device.type != "cuda":
        raise ValueError(f"gelu kernel needs a CUDA tensor, got {x.device}")
    _check_dtype(x)
    for t in tensors[1:]:
        if t.device != x.device or t.dtype != x.dtype or t.shape != x.shape:
            raise ValueError("gelu backward takes x and its gradient on one device, of one dtype and shape")
    return [t.contiguous() for t in tensors]


def _launch(xc: torch.Tensor, gc: torch.Tensor | None, approximate: bool, variant: str | None) -> torch.Tensor:
    """One launch of the forward (``gc`` None) or the gradient on contiguous
    CUDA operands. ``variant`` names a body instead of ``kernel_variant``
    (the ``"vec"`` body in bf16, to time or check it); one that does not
    take these tensors raises."""
    out = torch.empty_like(xc)
    if xc.numel() == 0:
        return out
    operands = (xc, out) if gc is None else (xc, gc, out)
    chosen = kernel_variant(*operands)
    if variant is None:
        variant = chosen
    elif variant not in VARIANTS or (variant != "scalar" and chosen == "scalar") or (
            variant == "lut" and xc.dtype != torch.bfloat16):
        raise ValueError(f"gelu variant {variant!r} does not take these tensors (runs {chosen!r})")
    form = "tanh" if approximate else "erf"
    stream = torch.cuda.current_stream(xc.device).cuda_stream
    lib = _library()
    if variant == "lut":
        table = lut_table(xc.device, form, backward=gc is not None)
        lo, span = _window(form)
        if gc is None:
            err = lib.gelu_lut_launch(xc.data_ptr(), out.data_ptr(), xc.numel(), _FORM_CODES[form],
                                      table.data_ptr(), lo, span, stream)
        else:
            err = lib.gelu_backward_lut_launch(xc.data_ptr(), gc.data_ptr(), out.data_ptr(), xc.numel(),
                                               _FORM_CODES[form], table.data_ptr(), lo, span, stream)
    elif gc is None:
        err = lib.gelu_launch(xc.data_ptr(), out.data_ptr(), xc.numel(), _DTYPE_CODES[xc.dtype],
                              _FORM_CODES[form], _VARIANT_CODES[variant], stream)
    else:
        err = lib.gelu_backward_launch(xc.data_ptr(), gc.data_ptr(), out.data_ptr(), xc.numel(),
                                       _DTYPE_CODES[xc.dtype], _FORM_CODES[form], _VARIANT_CODES[variant], stream)
    if err != 0:
        raise RuntimeError(f"gelu{'' if gc is None else ' backward'} launch ({variant}) failed: cudaError_t {err}")
    return out


def gelu_forward(x: torch.Tensor, *, approximate: bool, variant: str | None = None) -> torch.Tensor:
    """One GELU pass, no autograd: the kernel for a CUDA tensor (``variant``
    as in ``_launch``), the plain version for a CPU tensor."""
    global launches
    if x.device.type == "cpu":
        return gelu_tanh_plain(x) if approximate else gelu_erf_plain(x)
    (xc,) = _cuda_operands(x)
    out = _launch(xc, None, approximate, variant)
    if xc.numel():
        launches += 1
    return out


def gelu_backward(x: torch.Tensor, grad: torch.Tensor, *, approximate: bool,
                  variant: str | None = None) -> torch.Tensor:
    """The gradient through ``gelu_forward`` at ``x`` given ``grad`` (of x's
    dtype and shape): the backward kernel for CUDA tensors (``variant`` as
    in ``_launch``), the plain version for CPU tensors."""
    global backward_launches
    if x.device.type == "cpu":
        backward = gelu_tanh_backward_plain if approximate else gelu_erf_backward_plain
        return backward(x, grad)
    xc, gc = _cuda_operands(x, grad)
    out = _launch(xc, gc, approximate, variant)
    if xc.numel():
        backward_launches += 1
    return out


class _Gelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, approximate: bool) -> torch.Tensor:
        ctx.save_for_backward(x)
        ctx.approximate = approximate
        return gelu_forward(x, approximate=approximate)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (x,) = ctx.saved_tensors
        return gelu_backward(x, grad.to(x.dtype), approximate=ctx.approximate), None


def gelu(x: torch.Tensor, *, approximate: bool = False) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=...)`` as XLA computes it; differentiable."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Gelu.apply(x, approximate)
    return gelu_forward(x, approximate=approximate)
