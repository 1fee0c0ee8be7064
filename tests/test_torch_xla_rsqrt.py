"""The port's XLA-rounded ``rsqrt`` against jitted ``jax.lax.rsqrt``, bit for bit.

XLA's CPU f32 ``rsqrt`` is the host's 12-bit ``rsqrtps`` estimate and two
Newton steps with fused multiply-adds, the raw estimate kept for zeros,
subnormals, ``+inf`` and negatives (``ops/xla_math.py``). The estimate table
is read from this host's instruction through ``native/xla_rsqrt.cpp``, built
under the repository's native build lock (``build/native_build.lock``, the
one ``tests/torch_native.py`` takes). Held here on every
f32 binade of both signs, on a million random bit patterns (NaNs and the
other specials among them) and on the window kernel's own inputs; every
comparison is of the f32 bit patterns, NaN payloads too.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from kobato_eyes_tpu_torch.ops import xla_math

torch.set_num_threads(1)

_JIT_RSQRT = jax.jit(jax.lax.rsqrt)
_SPECIALS = np.array([
    0x00000000, 0x80000000, 0x00000001, 0x80000001, 0x007FFFFF, 0x807FFFFF, 0x00800000, 0x80800000,
    0x3F800000, 0xBF800000, 0x7F7FFFFF, 0xFF7FFFFF, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000,
    0x7F800001, 0xFF800001, 0x7FC12345, 0xFFBFFFFF, 0x2B8CBCCC,  # 1e-12, the window kernel's floor
], dtype=np.uint32)


def _bits_equal(x: np.ndarray) -> None:
    want = np.asarray(_JIT_RSQRT(x)).view(np.uint32)
    got = xla_math.xla_rsqrt_f32(torch.from_numpy(x)).numpy().view(np.uint32)
    diff = got != want
    assert not diff.any(), (
        f"{int(diff.sum())} of {diff.size} differ, e.g. x {[hex(v) for v in x.view(np.uint32)[diff][:5]]}: "
        f"{[hex(v) for v in got[diff][:5]]} vs {[hex(v) for v in want[diff][:5]]}"
    )


@pytest.mark.parametrize("sign", [0, 1], ids=["pos", "neg"])
@pytest.mark.parametrize("lo", range(0, 256, 32), ids=lambda lo: f"e{lo}-{min(lo + 31, 255)}")
def test_every_binade_matches_jitted_jax(lo, sign):
    rng = np.random.default_rng(lo * 2 + sign)
    edges = np.array([0, 1, 2, (1 << 13) - 1, 1 << 13, 1 << 22, (1 << 23) - 1], dtype=np.uint32)
    parts = [np.uint32(sign << 31) | np.uint32(e << 23)
             | np.concatenate([edges, rng.integers(0, 1 << 23, size=4096).astype(np.uint32)])
             for e in range(lo, min(lo + 32, 256))]
    _bits_equal(np.concatenate(parts).astype(np.uint32).view(np.float32))


def test_a_million_random_bit_patterns_and_the_specials():
    bits = np.random.default_rng(13).integers(0, 1 << 32, size=1 << 20, dtype=np.uint64).astype(np.uint32)
    x = np.concatenate([_SPECIALS, bits]).view(np.float32)
    assert np.isnan(x).sum() > 1000 and (x < 0).sum() > 400_000  # the specials are among them
    _bits_equal(x)


def test_the_window_kernels_sums_of_squares():
    """The values the window kernel takes rsqrt of: sums of squares of q and
    k rows, floored at 1e-12."""
    rows = np.random.default_rng(3).normal(size=(20_000, 32)).astype(np.float32)
    rows[:100] *= 1e-8  # below the floor
    ss = np.maximum((rows * rows).sum(-1), np.float32(1e-12)).astype(np.float32)
    _bits_equal(ss)


def test_the_estimate_table_is_twelve_bits_and_falls():
    table = xla_math.rsqrt_estimate_table()
    assert table.shape == (xla_math.RSQRT_TABLE_SIZE,) and table.dtype == np.uint32
    assert not (table & 0x7FF).any()  # 12 mantissa bits: the low 11 are 0
    est = table.view(np.float32)
    # within the binade the estimate of 1 / sqrt(x) falls with x
    assert (np.diff(est[:1024]) <= 0).all() and (np.diff(est[1024:]) <= 0).all()
    ideal = 1 / np.sqrt(np.concatenate([2.0 ** -1 * (1 + np.arange(1024) / 1024),
                                        1 + np.arange(1024) / 1024]))
    assert np.abs(est / ideal - 1).max() < 2 ** -11


def test_cpu_tensor_takes_the_plain_version_without_counting():
    before = xla_math.rsqrt_launches
    x = torch.linspace(1e-6, 100, 97)
    assert torch.equal(xla_math.xla_rsqrt_f32(x), xla_math.rsqrt_plain(x))
    assert xla_math.rsqrt_launches == before
