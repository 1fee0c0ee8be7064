"""The rest of the port's ``ops/hamming.py`` against the JAX package's: the
dense ``edge_scan``, the gather-form ``edge_scan_banded``, the crossover
probe and ``hamming_distance_pairs`` (``tests/ops/test_hamming_banded.py``,
``tests/ops/test_crossover_probe.py`` and ``tests/dup/test_engine_parity.py::
test_edge_scan_matches_numpy_bruteforce``, case for case). Edge sets and
arrays are exact."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kobato_eyes_tpu.ops import hamming as jham
from kobato_eyes_tpu_torch.ops import hamming as tham
from kobato_eyes_tpu_torch.ops.hamming import (
    BandedHammingScanner,
    band_keys_np,
    bucket_ok_np,
    edge_scan,
    edge_scan_banded,
    edge_scan_np,
    hamming_distance_pairs,
)
from kobato_eyes_tpu_torch.utils.bits import u64_to_u32pair
from tests.torch_native import native_built  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

CPU = {"device": "cpu"}


def _edges_set(ei, ej, ed):
    return {(int(a), int(b), int(d)) for a, b, d in zip(ei, ej, ed)}


def _population(rng, n, dup_fraction=0.4):
    n_dups = int(n * dup_fraction)
    orig = rng.integers(0, 1 << 64, size=n - n_dups, dtype=np.uint64)
    src = rng.integers(0, len(orig), size=n_dups)
    dups = orig[src].copy()
    for i in range(n_dups):
        for bit in rng.integers(0, 64, size=int(rng.integers(0, 6))):
            dups[i] ^= np.uint64(1) << np.uint64(bit)
    out = np.concatenate([orig, dups])
    rng.shuffle(out)
    return out


def _both_banded(pairs, keys, ok, **kw):
    got = edge_scan_banded(pairs, keys, ok, **kw, **CPU)
    want = jham.edge_scan_banded(pairs, keys, ok, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    return got


@pytest.mark.parametrize("threshold", [0, 4, 8])
def test_banded_matches_bruteforce(rng, threshold):
    ph = _population(rng, 300)
    keys = band_keys_np(ph, 16, 4)
    ok = bucket_ok_np(keys, None)
    bi, bj, bd = _both_banded(u64_to_u32pair(ph), keys, ok, hamming_threshold=threshold)
    ni, nj, nd = edge_scan_np(ph, keys, ok, hamming_threshold=threshold)
    assert _edges_set(bi, bj, bd) == _edges_set(ni, nj, nd)


def test_banded_with_size_ratio(rng):
    ph = _population(rng, 200)
    sizes = rng.integers(1_000, 1_000_000, size=200).astype(np.float64)
    keys = band_keys_np(ph, 16, 4)
    ok = bucket_ok_np(keys, None)
    bi, bj, bd = _both_banded(u64_to_u32pair(ph), keys, ok, hamming_threshold=8, sizes=sizes, size_ratio=0.5)
    ni, nj, nd = edge_scan_np(ph, keys, ok, hamming_threshold=8, sizes=sizes, size_ratio=0.5)
    assert _edges_set(bi, bj, bd) == _edges_set(ni, nj, nd)


def test_oversized_bucket_fallback(rng):
    # a giant bucket (identical hashes) and a tiny window: the exact host
    # fallback handles it
    ph = np.concatenate([np.full(64, 0x0123456789ABCDEF, dtype=np.uint64), _population(rng, 100)])
    keys = band_keys_np(ph, 16, 4)
    ok = bucket_ok_np(keys, None)
    bi, bj, bd = _both_banded(u64_to_u32pair(ph), keys, ok, hamming_threshold=8, max_window=4)
    ni, nj, nd = edge_scan_np(ph, keys, ok, hamming_threshold=8)
    assert _edges_set(bi, bj, bd) == _edges_set(ni, nj, nd)


def test_bucket_pair_cap_respected(rng):
    # buckets whose pair count exceeds the cap are skipped entirely
    ph = np.concatenate([np.full(50, 0xDEADBEEF00000000, dtype=np.uint64), _population(rng, 100)])
    keys = band_keys_np(ph, 16, 4)
    ok = bucket_ok_np(keys, 100)  # 50*49/2 = 1225 > 100 -> capped
    bi, bj, bd = _both_banded(u64_to_u32pair(ph), keys, ok, hamming_threshold=8, max_window=8)
    ni, nj, nd = edge_scan_np(ph, keys, ok, hamming_threshold=8)
    assert _edges_set(bi, bj, bd) == _edges_set(ni, nj, nd)


def test_banded_edge_cap_retry(rng):
    """A cap below the edge count retries with a larger one (same edges)."""
    ph = np.concatenate([np.full(40, 0x0123456789ABCDEF, dtype=np.uint64), _population(rng, 100)])
    keys = band_keys_np(ph, 16, 4)
    ok = bucket_ok_np(keys, None)
    pairs = u64_to_u32pair(ph)
    small = edge_scan_banded(pairs, keys, ok, hamming_threshold=8, max_edges_hint=16, **CPU)
    for a, b in zip(small, edge_scan_banded(pairs, keys, ok, hamming_threshold=8, **CPU)):
        np.testing.assert_array_equal(a, b)


def test_empty_and_tiny():
    for n in (0, 1):
        out = edge_scan_banded(np.zeros((n, 2), np.uint32), np.zeros((n, 4), np.uint64),
                               np.ones((n, 4), bool), hamming_threshold=8, **CPU)
        assert all(len(x) == 0 for x in out)
        out = edge_scan(np.zeros((n, 2), np.uint32), np.zeros((n, 4), np.uint64),
                        np.ones((n, 4), bool), hamming_threshold=8, **CPU)
        assert all(len(x) == 0 for x in out)


def test_size_ratio_f64_boundary_parity():
    """Sizes > 2^24 bytes quantize in f32; the edge decision must still match
    the exact-f64 spec at the ratio boundary (device results are re-checked
    on the host in f64)."""
    ph = np.array([1234567890123, 1234567890123, 1234567890123], dtype=np.uint64)
    a = float(2**27 + 15)
    b = float(2**28)
    thr = float(np.float32(0.5 + 16 / 2**28))
    sizes = np.array([a, b, 10.0], dtype=np.float64)
    assert (a / b) < thr <= float(np.float32(a) / np.float32(b))
    keys = band_keys_np(ph, 16, 4)
    ok = bucket_ok_np(keys, None)
    pairs = u64_to_u32pair(ph)
    ni, nj, nd = edge_scan_np(ph, keys, ok, hamming_threshold=8, sizes=sizes, size_ratio=thr)
    bi, bj, bd = _both_banded(pairs, keys, ok, hamming_threshold=8, sizes=sizes, size_ratio=thr)
    di, dj, dd = edge_scan(pairs, keys, ok, hamming_threshold=8, sizes=sizes, size_ratio=thr, **CPU)
    assert _edges_set(bi, bj, bd) == _edges_set(ni, nj, nd) == _edges_set(di, dj, dd) == set()
    ri, rj, rd = BandedHammingScanner(**CPU).scan(ph, hamming_threshold=8, sizes=sizes, size_ratio=thr)
    assert _edges_set(ri, rj, rd) == set()
    # opposite rounding direction: exact passes, naive f32 would drop
    a2 = float(2**27 + 7)
    sizes2 = np.array([a2, b, 10.0], dtype=np.float64)
    thr2 = a2 / b
    ni2, nj2, _ = edge_scan_np(ph, keys, ok, hamming_threshold=8, sizes=sizes2, size_ratio=thr2)
    bi2, bj2, _ = _both_banded(pairs, keys, ok, hamming_threshold=8, sizes=sizes2, size_ratio=thr2)
    di2, dj2, _ = edge_scan(pairs, keys, ok, hamming_threshold=8, sizes=sizes2, size_ratio=thr2, **CPU)
    want = {(int(i), int(j)) for i, j in zip(ni2, nj2)}
    assert {(int(i), int(j)) for i, j in zip(bi2, bj2)} == want == {(0, 1)}
    assert {(int(i), int(j)) for i, j in zip(di2, dj2)} == want


def test_edge_scan_matches_numpy_bruteforce(rng):
    n = 500
    ph = rng.integers(0, 1 << 63, size=n, dtype=np.int64).astype(np.uint64)
    for k in range(0, 100, 2):  # plant near dups
        ph[k + 1] = ph[k] ^ np.uint64(1 << int(rng.integers(0, 64)))
    keys = band_keys_np(ph, 16, 4)
    ok = bucket_ok_np(keys, None)
    pairs = u64_to_u32pair(ph)
    gi, gj, gd = edge_scan(pairs, keys, ok, hamming_threshold=8, block=128, **CPU)
    wi, wj, wd = edge_scan_np(ph, keys, ok, hamming_threshold=8)
    assert sorted(zip(gi.tolist(), gj.tolist(), gd.tolist())) == sorted(zip(wi.tolist(), wj.tolist(), wd.tolist()))
    for a, b in zip((gi, gj, gd), jham.edge_scan(pairs, keys, ok, hamming_threshold=8, block=128)):
        np.testing.assert_array_equal(a, b)


def test_edge_scan_filters_and_ragged_tail_equal_jax(rng):
    """Size and cosine filters, a block that does not divide n (the shifted
    tail), and a per-block cap small enough to retry: the same arrays as the
    JAX package's."""
    n = 301
    ph = _population(rng, n)
    keys = band_keys_np(ph, 16, 4)
    ok = bucket_ok_np(keys, 40)
    pairs = u64_to_u32pair(ph)
    sizes = rng.integers(1_000, 1_000_000, size=n).astype(np.float64)
    emb = rng.standard_normal((n, 8)).astype(np.float32)
    emb[::7] = 0.0  # missing embeddings pass the filter
    kw = dict(hamming_threshold=10, sizes=sizes, size_ratio=0.3, embeddings=emb, cosine_threshold=0.1,
              block=64, max_edges_per_block=8)
    got = edge_scan(pairs, keys, ok, **kw, **CPU)
    want = jham.edge_scan(pairs, keys, ok, **kw)
    assert len(got[0]) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_hamming_distance_pairs():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 1 << 32, size=(50, 2), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, size=(50, 2), dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(hamming_distance_pairs(a, b), jham.hamming_distance_pairs(a, b))
    assert (hamming_distance_pairs(a, a) == 0).all()


def test_probe_returns_sane_economics(monkeypatch):
    monkeypatch.setattr(tham, "_CROSSOVER_PROBE", None)
    out = tham.probe_crossover(n_probe=2000, **CPU)
    assert 4096 <= out["derived_host_scan_max"] <= 1 << 22
    assert out["host_s_per_item"] > 0
    assert out["upload_mb_per_s"] > 0
    assert set(out) == {"derived_host_scan_max", "host_s_per_item", "device_s_per_item", "device_rtt_s",
                        "upload_mb_per_s", "n_probe"}
    # cached on second call (identity, not just equality)
    assert tham.probe_crossover() is out


def test_env_probe_routes_scanner(monkeypatch):
    monkeypatch.setattr(tham, "_CROSSOVER_PROBE", None)
    monkeypatch.setenv("KET_DUP_HOST_SCAN_MAX", "probe")
    s = BandedHammingScanner(**CPU)
    assert s.host_scan_max == tham.probe_crossover()["derived_host_scan_max"]


def test_env_static_still_respected(monkeypatch):
    monkeypatch.setenv("KET_DUP_HOST_SCAN_MAX", "12345")
    assert BandedHammingScanner(**CPU).host_scan_max == 12345


def test_probe_does_not_perturb_scan_results(monkeypatch):
    monkeypatch.setattr(tham, "_CROSSOVER_PROBE", None)
    ph = np.random.default_rng(5).integers(0, 1 << 63, size=3000).astype(np.uint64)
    before = tham.host_window_scan(ph, band_bits=16, band_count=4, hamming_threshold=8)
    tham.probe_crossover(n_probe=2000, **CPU)
    after = tham.host_window_scan(ph, band_bits=16, band_count=4, hamming_threshold=8)
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a, b)
