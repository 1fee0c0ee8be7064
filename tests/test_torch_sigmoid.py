"""The port's XLA-rounded ``exp`` and sigmoid against jitted JAX, bit for bit.

``ops/xla_math.py`` writes out the steps of XLA's CPU f32 exponential and of
``jax.nn.sigmoid`` (``1 / (1 + exp(-x))``), with the runtime's flush of
subnormal results. Held here on every f32 binade of both signs (edge
mantissas and 2048 random ones each), the specials, and the tagger's
logits; every comparison is of the f32 bit patterns (NaN payloads too).
"""

from __future__ import annotations

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kobato_eyes_tpu_torch.models import postprocess as tpost
from kobato_eyes_tpu_torch.ops import xla_math

torch.set_num_threads(1)

_JIT_EXP = jax.jit(jnp.exp)
_JIT_SIGMOID = jax.jit(jax.nn.sigmoid)


def _binades(exponents: range, sign: int) -> np.ndarray:
    """Every biased exponent in ``exponents`` with edge and random mantissas."""
    rng = np.random.default_rng(sum(exponents) * 2 + sign)
    edges = np.array([0, 1, 2, 1 << 22, (1 << 22) + 1, (1 << 23) - 2, (1 << 23) - 1], dtype=np.uint32)
    parts = []
    for e in exponents:
        mant = np.concatenate([edges, rng.integers(0, 1 << 23, size=2048).astype(np.uint32)])
        parts.append((np.uint32(sign << 31) | np.uint32(e << 23) | mant).astype(np.uint32))
    return np.concatenate(parts).view(np.float32)


def _bits_equal(got: np.ndarray, want: np.ndarray) -> None:
    diff = got.view(np.uint32) != want.view(np.uint32)
    assert not diff.any(), (
        f"{int(diff.sum())} of {diff.size} differ, e.g. x-index {np.flatnonzero(diff)[:5]}: "
        f"{got[diff][:5]} vs {want[diff][:5]}"
    )


_EXPONENT_GROUPS = [range(lo, min(lo + 32, 256)) for lo in range(0, 256, 32)]


@pytest.mark.parametrize("sign", [0, 1], ids=["pos", "neg"])
@pytest.mark.parametrize("exponents", _EXPONENT_GROUPS, ids=lambda r: f"e{r.start}-{r.stop - 1}")
@pytest.mark.parametrize("fn", ["exp", "sigmoid"])
def test_every_binade_matches_jitted_jax(fn, exponents, sign):
    x = _binades(exponents, sign)
    if fn == "exp":
        got, want = xla_math.xla_exp_f32(torch.from_numpy(x)), _JIT_EXP(x)
    else:
        got, want = xla_math.xla_sigmoid_f32(torch.from_numpy(x)), _JIT_SIGMOID(x)
    _bits_equal(got.numpy(), np.asarray(want))


def test_specials():
    x = np.array(
        [0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 1e-40, -1e-40, 88.3762626, 88.7226562, 88.7228394,
         -87.336, -87.3369446, -88.3762626, -88.38, -103.9, -104.0, 16.6, 17.0, -16.6, 1e38, -1e38],
        dtype=np.float32,
    )
    nans = np.array([0x7FC00000, 0x7F800001, 0x7FA5A5A5, 0xFFC00000, 0xFF800123], dtype=np.uint32)
    x = np.concatenate([x, nans.view(np.float32)])
    _bits_equal(xla_math.xla_exp_f32(torch.from_numpy(x)).numpy(), np.asarray(_JIT_EXP(x)))
    _bits_equal(xla_math.xla_sigmoid_f32(torch.from_numpy(x)).numpy(), np.asarray(_JIT_SIGMOID(x)))


def test_subnormal_results_flush_to_zero():
    """XLA's runtime flushes: exp and sigmoid are +0 wherever the result
    would be subnormal (x below about -87.34), as the port's are."""
    x = np.linspace(-88.5, -87.2, 20001, dtype=np.float32)
    want_e, want_s = np.asarray(_JIT_EXP(x)), np.asarray(_JIT_SIGMOID(x))
    assert (want_e == 0).any() and (want_e > 0).any()
    assert not ((want_e > 0) & (want_e < np.finfo(np.float32).tiny)).any()
    _bits_equal(xla_math.xla_exp_f32(torch.from_numpy(x)).numpy(), want_e)
    _bits_equal(xla_math.xla_sigmoid_f32(torch.from_numpy(x)).numpy(), want_s)


def test_tagger_logits_and_probs_from_logits():
    """The roadmap's measurement size: torch.sigmoid is 2 ulp apart on ~0.4%
    of these; the port's sigmoid and probs_from_logits on none."""
    logits = (np.random.default_rng(1).normal(size=(256, 8192)) * 4).astype(np.float32)
    want = np.asarray(_JIT_SIGMOID(logits))
    assert (torch.sigmoid(torch.from_numpy(logits)).numpy().view(np.uint32) != want.view(np.uint32)).any()
    _bits_equal(xla_math.xla_sigmoid_f32(torch.from_numpy(logits)).numpy(), want)
    _bits_equal(tpost.probs_from_logits(torch.from_numpy(logits)).numpy(), want)


def _exact_fma(a: float, b: float, c: float) -> np.float32:
    """a * b + c rounded once to f32, in exact rational arithmetic."""
    exact = Fraction(a) * Fraction(b) + Fraction(c)
    lo = np.float32(float(exact))  # within one f32 step of the exact value
    cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
    errs = [abs(Fraction(float(v)) - exact) for v in cands]
    best = min(errs)
    ties = [v for v, e in zip(cands, errs) if e == best]
    return min(ties, key=lambda v: int(v.view(np.uint32)) & 1)  # ties to even


def test_fma_rounds_once():
    """Sums that an f64 add rounds twice: a * b an odd 25-bit integer (a
    midpoint of the f32 grid), c a nudge below the f64 grid there. Rounded
    to nearest in f64 the nudge vanishes and the tie goes to even; rounded
    to odd it decides the f32 result, as a fused multiply-add's does."""
    rng = np.random.default_rng(5)
    a = rng.integers(1 << 11, 1 << 12, size=4000) | 1
    b = rng.integers(1 << 12, 1 << 13, size=4000) | 1
    keep = a * b >= 1 << 24
    a, b = a[keep][:300].astype(np.float32), b[keep][:300].astype(np.float32)
    c = (rng.choice([-1.0, 1.0], size=a.size) * 2.0**-30).astype(np.float32)
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    rng_more = np.random.default_rng(6)
    a = np.concatenate([a, rng_more.normal(size=200).astype(np.float32)])
    b = np.concatenate([b, rng_more.normal(size=200).astype(np.float32)])
    c = np.concatenate([c, rng_more.normal(size=200).astype(np.float32)])
    got = xla_math.fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    want = np.array([_exact_fma(float(x), float(y), float(z)) for x, y, z in zip(a, b, c)], dtype=np.float32)
    assert (naive != want[: naive.size]).sum() > 50  # the cases are real
    _bits_equal(got, want)


def test_cpu_tensor_takes_the_plain_version_without_counting():
    before = (xla_math.launches, xla_math.exp_launches)
    x = torch.linspace(-10, 10, 97)
    assert torch.equal(xla_math.xla_sigmoid_f32(x), xla_math.sigmoid_plain(x))
    assert torch.equal(xla_math.xla_exp_f32(x), xla_math.exp_plain(x))
    assert (xla_math.launches, xla_math.exp_launches) == before


@pytest.mark.parametrize("variant", [None, "vec", "scalar"])
def test_a_named_body_takes_the_plain_version_on_the_cpu(variant):
    x = torch.linspace(-90, 90, 101)
    assert torch.equal(xla_math.xla_sigmoid_f32(x, variant=variant), xla_math.sigmoid_plain(x))
    assert torch.equal(xla_math.xla_exp_f32(x, variant=variant), xla_math.exp_plain(x))


def test_an_unknown_body_raises():
    with pytest.raises(ValueError, match="variant 'lut'"):
        xla_math.xla_sigmoid_f32(torch.zeros(4), variant="lut")
    with pytest.raises(ValueError, match="variant 'lut'"):
        xla_math.xla_exp_f32(torch.zeros(4), variant="lut")


def test_xla_rsqrt_is_none_of_the_portable_forms():
    """Why ``xla_math.rsqrt_plain`` reads the host's estimate table (see
    ``tests/test_torch_xla_rsqrt.py``): XLA's CPU f32 ``rsqrt`` equals none of
    ``1 / sqrt(x)``, ``sqrt(1 / x)`` or the f64 value rounded to f32 on more
    than a few of these inputs."""
    x = (np.abs(np.random.default_rng(1).normal(size=200_000)) * 4 + 1e-3).astype(np.float32)
    want = np.asarray(jax.jit(jax.lax.rsqrt)(x)).view(np.uint32)
    forms = {
        "1/sqrt": np.float32(1) / np.sqrt(x),
        "sqrt(1/x)": np.sqrt(np.float32(1) / x),
        "f64": (1 / np.sqrt(x.astype(np.float64))).astype(np.float32),
    }
    apart = {name: float((v.astype(np.float32).view(np.uint32) != want).mean()) for name, v in forms.items()}
    assert all(share > 0.1 for share in apart.values()), apart
