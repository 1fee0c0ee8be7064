"""The port's GELU (``ops/gelu.py``) against ``jax.nn.gelu`` as XLA compiles it.

The CUDA pass runs only on the card (``chip_smoke.py`` holds it against the
plain version there); here the wrapper takes the plain version, which is the
same op sequence in torch ops. The reference is the jitted JAX function: XLA
drops the bf16 rounding of ``-x * sqrt(0.5)`` before ``erfc`` when it fuses,
which op-by-op JAX keeps, and the JAX package runs its tagger jitted.

The ``"lut"`` body (bf16: a table of the forward's outputs, or of the
gradient's factors of x alone, over a window of |x|'s binades, and one rule
outside it) has a plain mirror, ``gelu_lut_plain`` /
``gelu_backward_lut_plain``, with the kernel's index arithmetic. It is held
to the plain version on all 65 536 bf16 inputs, bit for bit (NaN to NaN),
and to jitted JAX on all of them but those XLA flushes.

Tolerances: bf16 results are compared bit for bit, and every mismatch
must be where XLA flushed a subnormal to zero: XLA's CPU runtime computes
with denormals flushed, so its ``exp(-w)`` is 0 wherever the true value is
below the smallest normal f32 (x between -13.3 and -13.06 in the erf form),
where torch and the CUDA pass keep the subnormal and give a result under
1e-37. At N(0, 9) that is 1 value in 200 000 (the bar is 20). f32 results
differ by XLA's ``exp`` and ``tanh`` approximations against torch's: 2e-6
absolute at |x| <= 15.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kobato_eyes_tpu_torch.models import vit as tvit
from kobato_eyes_tpu_torch.ops import gelu as tgelu

torch.set_num_threads(1)

N = 200_000
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}
F32_ATOL = 2e-6


def _assert_equal_but_flushed(got: np.ndarray, want: np.ndarray) -> int:
    """Bit-equal but where XLA flushed a subnormal; returns the count."""
    diff = got != want
    assert np.all(want[diff] == 0) and np.all(np.abs(got[diff]) < 1e-37)
    return int(diff.sum())


def _values(seed: int = 0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=N) * 3).astype(np.float32)


def _xla_gelu(x: np.ndarray, jdt, approximate: bool) -> np.ndarray:
    fn = jax.jit(lambda v: jax.nn.gelu(v, approximate=approximate))
    return np.asarray(fn(jnp.asarray(x, jdt)), np.float32)


def _xla_gelu_grad(x: np.ndarray, g: np.ndarray, jdt, approximate: bool) -> np.ndarray:
    def vjp(v, ct):
        return jax.vjp(lambda u: jax.nn.gelu(u, approximate=approximate), v)[1](ct)[0]

    return np.asarray(jax.jit(vjp)(jnp.asarray(x, jdt), jnp.asarray(g, jdt)), np.float32)


def test_erf_bf16_matches_xla_but_one_value_in_200k():
    """The bar is 20 of 200 000; 1 is measured. ``F.gelu`` (one rounding of
    an f32 erf) differs on about a quarter of them, and the op-by-op form of
    ``0.5 * x * erfc(-x * sqrt(0.5))`` with torch's erfc on still more."""
    x = _values()
    xt = torch.from_numpy(x).to(torch.bfloat16)
    want = _xla_gelu(x, jnp.bfloat16, approximate=False)
    got = tgelu.gelu_erf_plain(xt)
    assert got.dtype == torch.bfloat16
    assert _assert_equal_but_flushed(got.float().numpy(), want) <= 1
    one_rounding = torch.nn.functional.gelu(xt).float().numpy()
    assert (one_rounding != want).sum() > 40_000


def test_tanh_bf16_matches_xla_bit_for_bit():
    x = _values(1)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    want = _xla_gelu(x, jnp.bfloat16, approximate=True)
    np.testing.assert_array_equal(tgelu.gelu_tanh_plain(xt).float().numpy(), want)
    np.testing.assert_array_equal(tgelu.gelu(xt, approximate=True).float().numpy(), want)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_forward_matches_xla(dt, approximate, seed):
    tdt, jdt = DTYPES[dt]
    x = _values(seed)[:50_000] * np.float32(1 + seed)  # out to |x| ~ 40 at seed 2
    xt = torch.from_numpy(x).to(tdt)
    want = _xla_gelu(x, jdt, approximate)
    got = tgelu.gelu_forward(xt, approximate=approximate)
    assert got.dtype == tdt and got.shape == xt.shape
    if dt == "bf16":
        _assert_equal_but_flushed(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_ATOL * (1 + seed))


@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_special_values_match_xla(dt, approximate):
    tdt, jdt = DTYPES[dt]
    x = np.array([0.0, -0.0, 1.0, -1.0, 0.999, -0.999, 1.0001, 2.0, -2.0, 1.999, -5.5, 5.5,
                  30.0, -30.0, 1e-30, -1e-30, 1e30, -1e30, np.inf, -np.inf, np.nan], np.float32)
    want = _xla_gelu(x, jdt, approximate)
    got = tgelu.gelu_forward(torch.from_numpy(x).to(tdt), approximate=approximate).float().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    # f32: XLA's exp and tanh round apart from torch's by a few ulps
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-6 if dt == "f32" else 0,
                               atol=1e-7 if dt == "f32" else 0)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_backward_matches_jax_grad(dt, approximate, seed):
    """The gradient against JAX's vjp, jitted. bf16: bit for bit but where
    XLA flushed a subnormal (2 of 200 000 for erf, 0 for tanh). f32: XLA's
    exp and tanh, 1.2e-5 at |g'| up to 4.6."""
    tdt, jdt = DTYPES[dt]
    x = _values(seed)
    g = np.random.default_rng(10 + seed).normal(size=N).astype(np.float32)
    want = _xla_gelu_grad(x, g, jdt, approximate)
    backward = tgelu.gelu_tanh_backward_plain if approximate else tgelu.gelu_erf_backward_plain
    got = backward(torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt
    got = got.float().numpy()
    if dt == "bf16":
        assert _assert_equal_but_flushed(got, want) <= 2
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_autograd_through_gelu_is_the_plain_backward(dt, approximate):
    tdt, _ = DTYPES[dt]
    x = torch.from_numpy(_values(3)[:4096].reshape(64, 64)).to(tdt).requires_grad_(True)
    g = torch.from_numpy(np.random.default_rng(4).normal(size=(64, 64)).astype(np.float32)).to(tdt)
    y = tgelu.gelu(x, approximate=approximate)
    np.testing.assert_array_equal(
        y.detach().float().numpy(), tgelu.gelu_forward(x.detach(), approximate=approximate).float().numpy()
    )
    (grad,) = torch.autograd.grad(y, x, g)
    backward = tgelu.gelu_tanh_backward_plain if approximate else tgelu.gelu_erf_backward_plain
    np.testing.assert_array_equal(grad.float().numpy(), backward(x.detach(), g).float().numpy())


def test_mlp_differentiates_like_jax_in_f32():
    """``vit.Mlp`` with the erf form: the input gradient of a scalar loss
    against ``jax.grad`` of the same flax computation, f32."""
    import flax.linen as nn

    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    w1 = (rng.normal(size=(16, 32)) / 4).astype(np.float32)
    w2 = (rng.normal(size=(32, 16)) / 4).astype(np.float32)

    def jax_loss(v):
        h = nn.gelu(v @ w1, approximate=False)
        return jnp.sum((h @ w2) ** 2)

    want = np.asarray(jax.jit(jax.grad(jax_loss))(jnp.asarray(x)))
    cfg = tvit.vit_config("tiny", dtype=torch.float32)
    mlp = tvit.Mlp(16, 32, cfg)
    with torch.no_grad():
        mlp.fc1.weight.copy_(torch.from_numpy(w1.T))
        mlp.fc2.weight.copy_(torch.from_numpy(w2.T))
        mlp.fc1.bias.zero_()
        mlp.fc2.bias.zero_()
    xt = torch.from_numpy(x).requires_grad_(True)
    (mlp(xt) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5, atol=1e-5)


def test_kernel_variant_by_alignment():
    """By dtype and alignment alone: the table body for aligned bf16, the
    16-byte body for aligned f32, one element a thread otherwise."""
    base = torch.zeros(64, dtype=torch.bfloat16)
    assert tgelu.kernel_variant(base, torch.empty_like(base)) == "lut"
    assert tgelu.kernel_variant(base[1:], torch.empty(63, dtype=torch.bfloat16)) == "scalar"
    assert tgelu.kernel_variant(base[8:], torch.empty(56, dtype=torch.bfloat16)) == "lut"
    f32 = torch.zeros(64)
    assert tgelu.kernel_variant(f32, torch.empty_like(f32)) == "vec"
    assert tgelu.kernel_variant(f32[4:], torch.empty(60)) == "vec"
    assert tgelu.kernel_variant(f32[1:], torch.empty(63)) == "scalar"


def test_unsupported_dtype_and_device_raise():
    with pytest.raises(ValueError):
        tgelu.gelu_forward(torch.zeros(4, dtype=torch.float16), approximate=False)
    with pytest.raises(ValueError):
        tgelu.gelu_forward(torch.zeros(4, device="meta"), approximate=True)
    with pytest.raises(ValueError):
        tgelu.gelu_backward(torch.zeros(4, device="meta"), torch.zeros(4, device="meta"), approximate=False)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = tgelu.launches
    x = torch.linspace(-4, 4, 101)
    np.testing.assert_array_equal(tgelu.gelu_forward(x, approximate=False).numpy(),
                                  tgelu.gelu_erf_plain(x).numpy())
    assert tgelu.launches == before


@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_cpu_backward_takes_the_plain_version_and_counts_no_launch(dt, approximate):
    tdt, _ = DTYPES[dt]
    before = tgelu.backward_launches
    x = torch.from_numpy(_values(6)[:3001]).to(tdt)
    g = torch.from_numpy(np.random.default_rng(7).normal(size=3001).astype(np.float32)).to(tdt)
    got = tgelu.gelu_backward(x, g, approximate=approximate)
    plain = tgelu.gelu_tanh_backward_plain if approximate else tgelu.gelu_erf_backward_plain
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), plain(x, g).float().numpy())
    assert tgelu.backward_launches == before


# ---- the "lut" body's mirror on every bf16 input ----

ALL_BF16 = tgelu._from_bits(torch.arange(65536, dtype=torch.int32))
FORMS = {"erf": False, "tanh": True}


def _n_apart(got: torch.Tensor, want) -> np.ndarray:
    """Where two bf16 results differ in their bits (NaN equals NaN, -0 is
    not +0)."""
    a = got.float().numpy()
    w = np.asarray(want, np.float32)
    return ~((a.view(np.uint32) == w.view(np.uint32)) | (np.isnan(a) & np.isnan(w)))


def _plain(form):
    return tgelu.gelu_tanh_plain if form == "tanh" else tgelu.gelu_erf_plain


def _plain_backward(form):
    return tgelu.gelu_tanh_backward_plain if form == "tanh" else tgelu.gelu_erf_backward_plain


def _seeded_grad(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=65536).astype(np.float32)


@pytest.mark.parametrize("form", list(FORMS))
def test_lut_patterns_index_to_their_own_entries(form):
    """The table's inputs, run through the kernel's index arithmetic, read
    entries 0 .. 2 * span - 1 in order; the window is 13 (erf) / 11 (tanh)
    binades, both signs."""
    lo, span = tgelu._window(form)
    pats = tgelu.lut_patterns(form)
    i, inside, entry = tgelu._lut_index(tgelu._bits(pats), form)
    assert bool(inside.all())
    np.testing.assert_array_equal(entry.numpy(), np.arange(2 * span))
    assert span == {"erf": 13, "tanh": 11}[form] * 128 and lo == 118 << 7
    assert tgelu.gelu_table_plain(form).shape == (2 * span,)
    assert tgelu.gelu_table_plain(form, backward=True).shape == (2 * span,)


@pytest.mark.parametrize("form", list(FORMS))
def test_lut_forward_mirror_equals_plain_on_every_bf16_input(form):
    got = tgelu.gelu_lut_plain(ALL_BF16, approximate=FORMS[form])
    assert got.dtype == torch.bfloat16
    assert not _n_apart(got, _plain(form)(ALL_BF16).float().numpy()).any()


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("form", list(FORMS))
def test_lut_backward_mirror_equals_plain_on_every_bf16_input(form, seed):
    g = torch.from_numpy(_seeded_grad(seed)).to(torch.bfloat16)
    got = tgelu.gelu_backward_lut_plain(ALL_BF16, g, approximate=FORMS[form])
    assert got.dtype == torch.bfloat16
    assert not _n_apart(got, _plain_backward(form)(ALL_BF16, g).float().numpy()).any()


@pytest.mark.parametrize("side", ["low", "high"])
@pytest.mark.parametrize("form", list(FORMS))
def test_lut_window_is_the_narrowest(form, side, monkeypatch):
    """One binade less at either end and the rules no longer hold: the
    window was found on every input, not assumed."""
    first, last = tgelu.LUT_WINDOW[form]
    monkeypatch.setitem(tgelu.LUT_WINDOW, form, (first + 1, last) if side == "low" else (first, last - 1))
    got = tgelu.gelu_lut_plain(ALL_BF16, approximate=FORMS[form])
    assert _n_apart(got, _plain(form)(ALL_BF16).float().numpy()).sum() > 50
    g = torch.from_numpy(_seeded_grad(0)).to(torch.bfloat16)
    got = tgelu.gelu_backward_lut_plain(ALL_BF16, g, approximate=FORMS[form])
    assert _n_apart(got, _plain_backward(form)(ALL_BF16, g).float().numpy()).sum() > 50


# The inputs on which the mirror (and the card's kernel) differ from
# jitted JAX, all where XLA's CPU runtime flushes subnormals to zero: in both
# forms the 508 nonzero x below 2^-125 (x or 0.5 * x subnormal: XLA gives a
# signed zero), and in the erf form 5 x in [-13.3125, -13.0625] where XLA
# flushes exp(-z^2) (its result 0, ours under 4e-38).
XLA_FLUSHED_FORWARD = {"erf": 513, "tanh": 508}
# The gradient: only in the erf form at x in [-13.625, -12.9375], where
# exp(-z^2) and the products after it are subnormal or near it (both
# results under 1.5e-36 in magnitude), on 9 / 10 / 11 x for g of seeds 0 / 1 / 2.
XLA_FLUSHED_BACKWARD = {"erf": (9, 10, 11), "tanh": (0, 0, 0)}


@pytest.mark.parametrize("form", list(FORMS))
def test_lut_forward_mirror_equals_xla_but_flushed(form):
    approximate = FORMS[form]
    xj = jnp.asarray(ALL_BF16.view(torch.int16).numpy().view(jnp.bfloat16))
    want = np.asarray(jax.jit(lambda v: jax.nn.gelu(v, approximate=approximate))(xj), np.float32)
    got = tgelu.gelu_lut_plain(ALL_BF16, approximate=approximate)
    apart = _n_apart(got, want)
    assert int(apart.sum()) == XLA_FLUSHED_FORWARD[form]
    x = ALL_BF16.float().numpy()[apart]
    assert np.all(want[apart] == 0)
    tiny = (np.abs(x) < 2.0**-125) & (x != 0)
    assert int(tiny.sum()) == 508
    if form == "erf":
        assert np.all((x[~tiny] >= -13.3125) & (x[~tiny] <= -13.0625))
        assert np.all(np.abs(got.float().numpy()[apart][~tiny]) < 4e-38)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("form", list(FORMS))
def test_lut_backward_mirror_equals_jax_vjp_but_flushed(form, seed):
    approximate = FORMS[form]
    xj = jnp.asarray(ALL_BF16.view(torch.int16).numpy().view(jnp.bfloat16))
    g = _seeded_grad(seed)
    want = _xla_gelu_grad_bf16(xj, g, approximate)
    got = tgelu.gelu_backward_lut_plain(ALL_BF16, torch.from_numpy(g).to(torch.bfloat16), approximate=approximate)
    apart = _n_apart(got, want)
    assert int(apart.sum()) == XLA_FLUSHED_BACKWARD[form][seed]
    x = ALL_BF16.float().numpy()[apart]
    assert np.all((x >= -13.625) & (x <= -12.9375))
    assert np.all(np.abs(got.float().numpy()[apart]) < 1.5e-36) and np.all(np.abs(want[apart]) < 1.5e-36)


def _xla_gelu_grad_bf16(xj, g: np.ndarray, approximate: bool) -> np.ndarray:
    def vjp(v, ct):
        return jax.vjp(lambda u: jax.nn.gelu(u, approximate=approximate), v)[1](ct)[0]

    return np.asarray(jax.jit(vjp)(xj, jnp.asarray(g, jnp.bfloat16)), np.float32)


def test_lut_mirror_takes_bf16_only():
    with pytest.raises(ValueError):
        tgelu.gelu_lut_plain(torch.zeros(4), approximate=False)
    with pytest.raises(ValueError):
        tgelu.gelu_backward_lut_plain(torch.zeros(4), torch.zeros(4), approximate=True)
