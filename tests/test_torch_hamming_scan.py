"""The port's banded Hamming scan against the JAX package's.

* the device pieces of the resident scan — band sort, max run, and the two
  bitmask scans at windows 8, 32 and 64 — against the JAX functions on the
  same hashes (exact);
* ``BandedHammingScanner(host_scan_max=0)`` (the resident path on the CPU)
  against the JAX scanner's resident path, the host scan and the brute-force
  spec, with ``bucket_pair_cap``, ``size_ratio`` and a forced oversized
  bucket (``max_window=8``);
* the host C++ band scan: both packages build and load an extension named
  ``_hamming_scan`` in one process, from their own directories.
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kobato_eyes_tpu.ops import hamming as jham
from kobato_eyes_tpu.utils.bits import u64_to_u32pair
from kobato_eyes_tpu_torch.ops import hamming as tham
from tests.torch_native import native_built  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

ROOT = Path(__file__).parent.parent


def _edges(ei, ej, ed):
    return {(int(a), int(b), int(d)) for a, b, d in zip(ei, ej, ed)}


def _population(seed: int, n: int, *, run_len: int = 0) -> np.ndarray:
    """A third planted near-duplicates (0-5 flipped bits); ``run_len`` hashes
    share their low 16 bits (one long bucket of band 0)."""
    rng = np.random.default_rng(seed)
    n_dups = n // 3
    orig = rng.integers(0, 1 << 64, size=n - n_dups, dtype=np.uint64)
    dups = orig[rng.integers(0, len(orig), size=n_dups)].copy()
    for i in range(n_dups):
        for bit in rng.integers(0, 64, size=int(rng.integers(0, 6))):
            dups[i] ^= np.uint64(1) << np.uint64(bit)
    out = np.concatenate([orig, dups])
    rng.shuffle(out)
    if run_len:
        out[:run_len] = (out[:run_len] & ~np.uint64(0xFFFF)) | np.uint64(0x1234)
    return out


def _as_tensor(ph: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(ph.view(np.int64).copy())


def test_popcount32_exact():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.integers(0, 1 << 32, size=4096, dtype=np.uint64),
                        np.array([0, 1, 0xFFFFFFFF, 0x80000000], np.uint64)])
    got = tham.popcount32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, np.bitwise_count(x))


@pytest.mark.parametrize("band_bits,band_count", [(16, 4), (8, 8), (32, 2)])
def test_band_sort_and_max_run_equal_jax(band_bits, band_count):
    ph = _population(1, 400, run_len=40)
    order, sk = tham._band_sort_kernel(_as_tensor(ph), band_bits=band_bits, band_count=band_count)
    jorder, jsk = jham._band_sort_kernel(
        jnp.asarray(u64_to_u32pair(ph)), band_bits=band_bits, band_count=band_count
    )
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(sk.numpy(), np.asarray(jsk))
    assert int(tham._max_run_kernel(sk)) == int(jham._max_run_kernel(jsk))


@pytest.mark.parametrize("window", [8, 32, 64])
def test_bitmask_scans_equal_jax(window):
    ph = _population(2, 500, run_len=70)
    order, sk = tham._band_sort_kernel(_as_tensor(ph), band_bits=16, band_count=4)
    jph = jnp.asarray(u64_to_u32pair(ph))
    jorder, jsk = jham._band_sort_kernel(jph, band_bits=16, band_count=4)
    thr = 8
    if window <= 32:
        got = tham._scan_bitmask_kernel(_as_tensor(ph), order, sk, thr, window=window)
        want = jham._scan_bitmask_kernel(jph, jorder, jsk, jnp.int32(thr), window=window)
    else:
        got = tham._scan_bitmask_words_kernel(_as_tensor(ph), order, sk, thr, window=window)
        want = jham._scan_bitmask_words_kernel(jph, jorder, jsk, jnp.int32(thr), window=window)
    want = np.asarray(want).astype(np.int64)
    assert want.any()  # the planted run gives hits at every distance
    np.testing.assert_array_equal(got.numpy(), want)


def _spec(ph, *, thr, band_bits=16, band_count=4, cap=None, sizes=None, ratio=None):
    """The port's brute-force spec, held to the JAX package's copy of it."""
    keys = tham.band_keys_np(ph, band_bits, band_count)
    ok = tham.bucket_ok_np(keys, cap)
    np.testing.assert_array_equal(ok, jham.bucket_ok_np(jham.band_keys_np(ph, band_bits, band_count), cap))
    edges = _edges(*tham.edge_scan_np(ph, keys, ok, hamming_threshold=thr, sizes=sizes, size_ratio=ratio))
    assert edges == _edges(*jham.edge_scan_np(ph, keys, ok, hamming_threshold=thr, sizes=sizes,
                                              size_ratio=ratio))
    return edges


CASES = {
    "default": dict(),
    "pair_cap": dict(cap=20),
    "size_ratio": dict(ratio=0.5),
    "oversized": dict(max_window=8),
    "cap_ratio_oversized": dict(cap=200, ratio=0.3, max_window=8),
}


@pytest.mark.parametrize("case", list(CASES))
def test_resident_scan_equals_jax_host_and_spec(case):
    kw = CASES[case]
    ph = _population(3, 450, run_len=60)  # run of 60 > max_window 8: oversized
    sizes = np.random.default_rng(4).integers(1_000, 5_000_000, size=len(ph)).astype(np.float64)
    args = dict(hamming_threshold=9, sizes=sizes, size_ratio=kw.get("ratio"),
                bucket_pair_cap=kw.get("cap"))
    mw = kw.get("max_window", 256)
    port = tham.BandedHammingScanner(host_scan_max=0, max_window=mw, device="cpu")
    got = _edges(*port.scan(ph, **args))
    assert port.last_window == (8 if mw == 8 else 64)
    want = _edges(*jham.BandedHammingScanner(host_scan_max=0, max_window=mw).scan(ph, **args))
    host = _edges(*tham.host_window_scan(ph, band_bits=16, band_count=4, hamming_threshold=9,
                                         sizes=sizes if kw.get("ratio") else None,
                                         size_ratio=kw.get("ratio"), bucket_pair_cap=kw.get("cap")))
    spec = _spec(ph, thr=9, cap=kw.get("cap"), sizes=sizes, ratio=kw.get("ratio"))
    assert got == want == host == spec
    assert len(got) > 50


def test_resident_population_is_reused_across_thresholds():
    ph = _population(5, 300)
    scanner = tham.BandedHammingScanner(host_scan_max=0, device="cpu")
    a = scanner.scan(ph, hamming_threshold=8)
    digest, order = scanner._digest, scanner._order_dev
    b = scanner.scan(ph, hamming_threshold=2)
    assert scanner._digest == digest and scanner._order_dev is order
    assert _edges(*a) == _spec(ph, thr=8)
    assert _edges(*b) == _spec(ph, thr=2)


def test_host_route_below_the_crossover_equals_jax(monkeypatch):
    monkeypatch.delenv("KET_DUP_HOST_SCAN_MAX", raising=False)
    ph = _population(6, 600)
    port = tham.BandedHammingScanner(device="cpu")
    assert port.host_scan_max == 262144
    got = _edges(*port.scan(ph, hamming_threshold=8))
    assert port.last_window == 0  # never reached the device path
    assert got == _edges(*jham.BandedHammingScanner().scan(ph, hamming_threshold=8)) == _spec(ph, thr=8)


def test_both_packages_load_their_own_native_scan(native_built, monkeypatch):
    # Each package's scan keeps a process-wide "unavailable" flag that its
    # first failed load sets. Another test file in this worker may have met
    # the JAX package's unlocked build half-written (its loader builds to one
    # fixed temporary name) and set that flag before the fixture's locked
    # load succeeded; the flags are cleared so that this test checks the
    # loads, not what ran before it.
    monkeypatch.setattr(jham, "_NATIVE_SCAN_UNAVAILABLE", False)
    monkeypatch.setattr(tham, "_NATIVE_SCAN_UNAVAILABLE", False)
    tmod = native_built["hamming_scan"]
    jmod = native_built["jax"]["hamming_scan"]
    assert tmod is not jmod
    assert Path(tmod.__file__).parent == ROOT / "kobato_eyes_tpu_torch" / "native"
    assert Path(jmod.__file__).parent == ROOT / "kobato_eyes_tpu" / "native"
    tasm, jasm = native_built["assembly"], native_built["jax"]["assembly"]
    assert tasm is not jasm and Path(tasm.__file__) != Path(jasm.__file__)
    ph = _population(7, 500)
    got = tham._native_band_scan(ph, band_bits=16, band_count=4, hamming_threshold=8,
                                 sizes=None, size_ratio=None, bucket_pair_cap=None)
    want = jham._native_band_scan(ph, band_bits=16, band_count=4, hamming_threshold=8,
                                  sizes=None, size_ratio=None, bucket_pair_cap=None)
    assert got is not None and want is not None
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not tham._NATIVE_SCAN_UNAVAILABLE


def test_mesh_and_probe_wait_for_their_slices(monkeypatch):
    with pytest.raises(NotImplementedError, match="multi-device"):
        tham.BandedHammingScanner(mesh=object(), device="cpu")
    monkeypatch.setenv("KET_DUP_HOST_SCAN_MAX", "probe")
    with pytest.raises(NotImplementedError, match="probe"):
        tham.BandedHammingScanner(device="cpu")
