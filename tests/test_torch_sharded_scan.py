"""The port's row-sharded windowed scan against the JAX package's and the
single-device spec (``tests/parallel/test_sharded_scan.py``, case for case),
on 8 ``cpu`` mesh entries. Edges are exact."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kobato_eyes_tpu.parallel.mesh import make_mesh as jmake_mesh
from kobato_eyes_tpu.parallel.sharded_scan import sharded_window_scan as jsharded_window_scan
from kobato_eyes_tpu_torch.ops.hamming import band_keys_np, bucket_ok_np, edge_scan_np
from kobato_eyes_tpu_torch.parallel.mesh import make_mesh
from kobato_eyes_tpu_torch.parallel.sharded_scan import sharded_window_scan
from kobato_eyes_tpu_torch.utils.bits import u64_to_u32pair

torch.set_num_threads(1)


def _population(rng, n):
    n_dups = n // 3
    orig = rng.integers(0, 1 << 64, size=n - n_dups, dtype=np.uint64)
    dups = orig[rng.integers(0, len(orig), size=n_dups)].copy()
    for i in range(n_dups):
        for bit in rng.integers(0, 64, size=int(rng.integers(0, 6))):
            dups[i] ^= np.uint64(1) << np.uint64(bit)
    out = np.concatenate([orig, dups])
    rng.shuffle(out)
    return out


def _sorted_inputs(ph):
    keys = band_keys_np(ph, 16, 4)
    ok = bucket_ok_np(keys, None)
    pairs = u64_to_u32pair(ph)
    # per-band sort on host (same prep as the single-device scanner)
    orders = np.stack([np.argsort(keys[:, b].astype(np.uint32), kind="stable") for b in range(4)])
    sk = np.take_along_axis(keys.T.astype(np.uint32), orders, axis=1)
    max_run = max(int(np.unique(keys[:, b], return_counts=True)[1].max()) for b in range(4))
    return keys, ok, orders, sk, pairs[orders], np.take_along_axis(ok.T, orders, axis=1), max(8, max_run)


@pytest.mark.parametrize("data", [8, 3])
def test_sharded_scan_matches_spec(rng, data):
    n = 400
    ph = _population(rng, n)
    keys, ok, orders, sk, sph, sok, window = _sorted_inputs(ph)
    mesh = make_mesh(data=data, model=1, devices=["cpu"] * data)
    out = sharded_window_scan(mesh, sk, sph, sok, hamming_threshold=8, window=window)
    jout = jsharded_window_scan(jmake_mesh(data=8, model=1), sk, sph, sok, hamming_threshold=8, window=window)
    if data == 8:  # the same shards: the same arrays, in the same order
        for a, b in zip(out, jout):
            assert a.dtype == b.dtype == np.int64
            np.testing.assert_array_equal(a, b)
    b, i_s, j_s, d = out
    # map back to original coordinates + dedup (same as the single-device path)
    gi = orders[b, i_s]
    gj = orders[b, j_s]
    lo = np.minimum(gi, gj)
    hi = np.maximum(gi, gj)
    _, first = np.unique(lo * n + hi, return_index=True)
    got = {(int(lo[k]), int(hi[k]), int(d[k])) for k in first}
    ni, nj, nd = edge_scan_np(ph, keys, ok, hamming_threshold=8)
    assert got == {(int(a), int(b_), int(c)) for a, b_, c in zip(ni, nj, nd)}


def test_overflow_raises_and_count_slot_never_leaks(rng):
    """A cap below a shard's edge count raises with the JAX text; at a cap
    that holds them, the reserved count slot is not an edge."""
    ph = np.full(40, 0x0123456789ABCDEF, dtype=np.uint64)  # one bucket of 40
    _, _, _, sk, sph, sok, window = _sorted_inputs(ph)
    mesh = make_mesh(data=2, model=1, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="sharded scan overflow: a shard produced"):
        sharded_window_scan(mesh, sk, sph, sok, hamming_threshold=0, window=window, max_edges_per_shard=64)
    b, i_s, j_s, d = sharded_window_scan(mesh, sk, sph, sok, hamming_threshold=0, window=window,
                                         max_edges_per_shard=4096)
    # each band holds 40 * 39 / 2 pairs within the window
    assert len(b) == 4 * 40 * 39 // 2 and (d == 0).all() and (j_s > i_s).all()
