"""The port's mesh-sharded flat and IVF indexes against the JAX package's
(``tests/parallel/test_sharded_ann.py``, case for case) and against the
port's single-device indexes, on an 8-entry CPU mesh.

Result ids are exact, ties included (the merge must pick the lowest global
row, as ``lax.top_k`` does). Scores are held at the JAX test's rtol=1e-6:
a row shard's product may block differently from the whole corpus's.
IVF identity goes through the shared ``quantizer=``; the port's own
sharded training is held by recall.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kobato_eyes_tpu.index.flat import FlatIndex as JFlatIndex
from kobato_eyes_tpu.index.ivf import IvfFlatIndex as JIvfFlatIndex
from kobato_eyes_tpu.parallel.mesh import make_mesh as jmake_mesh
from kobato_eyes_tpu_torch.index import auto as tauto
from kobato_eyes_tpu_torch.index.flat import FlatIndex
from kobato_eyes_tpu_torch.index.ivf import IvfFlatIndex, kmeans, recall_at_k
from kobato_eyes_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(data=8, model=1, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(data=8, model=1)


@pytest.fixture(scope="module")
def rng_module():
    return np.random.default_rng(3)


@pytest.fixture(scope="module")
def corpus(rng_module):
    return rng_module.standard_normal((1000, 64)).astype(np.float32)


def _same(a, b):
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_allclose(a[0], b[0], rtol=1e-6, atol=0)


def test_flat_sharded_matches_single(corpus, mesh, jmesh, rng_module):
    q = rng_module.standard_normal((17, 64)).astype(np.float32)
    single = FlatIndex(corpus, **CPU).search(q, k=25)
    sharded = FlatIndex(corpus, mesh=mesh).search(q, k=25)
    _same(single, sharded)
    _same(JFlatIndex(corpus, mesh=jmesh).search(q, k=25), sharded)


def test_flat_sharded_tie_break(mesh, jmesh):
    # duplicate vectors => exact score ties; the merge must pick the lowest
    # global rows, like the single index
    base = np.random.default_rng(5).standard_normal((40, 32)).astype(np.float32)
    corpus = np.concatenate([base, base, base])  # every vector x3
    q = base[:4]
    _, i0 = FlatIndex(corpus, **CPU).search(q, k=9)
    _, i1 = FlatIndex(corpus, mesh=mesh).search(q, k=9)
    _, ij = JFlatIndex(corpus, mesh=jmesh).search(q, k=9)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(ij, i1)


def test_flat_sharded_small_corpus_padding(mesh, jmesh):
    # n smaller than the device count: most shards are pure padding
    corpus = np.random.default_rng(9).standard_normal((5, 16)).astype(np.float32)
    q = corpus[:2]
    sharded = FlatIndex(corpus, mesh=mesh).search(q, k=5)
    _same(FlatIndex(corpus, **CPU).search(q, k=5), sharded)
    _same(JFlatIndex(corpus, mesh=jmesh).search(q, k=5), sharded)


def test_ivf_sharded_matches_single(corpus, mesh, jmesh, rng_module):
    q = rng_module.standard_normal((9, 64)).astype(np.float32)
    # shared quantizer: sharded Lloyd reductions may differ in the last bit,
    # which is a different (equally valid) index — identity is asserted on
    # the SEARCH given the same quantizer
    vecs = corpus / np.maximum(np.linalg.norm(corpus, axis=1, keepdims=True), 1e-30)
    quant = kmeans(vecs, 32, iters=5, seed=0, **CPU)
    single = IvfFlatIndex(corpus, n_clusters=32, quantizer=quant, **CPU)
    sharded = IvfFlatIndex(corpus, n_clusters=32, quantizer=quant, mesh=mesh)
    jsharded = JIvfFlatIndex(corpus, n_clusters=32, quantizer=quant, mesh=jmesh)
    for nprobe in (1, 4, 32):
        s0, i0 = single.search(q, k=15, nprobe=nprobe)
        s1, i1 = sharded.search(q, k=15, nprobe=nprobe)
        sj, ij = jsharded.search(q, k=15, nprobe=nprobe)
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_array_equal(ij, i1)
        finite = np.isfinite(s0)
        np.testing.assert_array_equal(finite, np.isfinite(s1))
        np.testing.assert_array_equal(np.isfinite(sj), np.isfinite(s1))
        np.testing.assert_allclose(s0[finite], s1[finite], rtol=1e-6, atol=0)
        np.testing.assert_allclose(sj[finite], s1[finite], rtol=1e-6, atol=0)


def test_ivf_sharded_training_recall(corpus, mesh, rng_module):
    """Fully mesh-trained IVF (per-shard Lloyd sums reduced in shard order)
    is a valid index: with every list probed, recall against exact is 1."""
    q = rng_module.standard_normal((16, 64)).astype(np.float32)
    _, truth = FlatIndex(corpus, **CPU).search(q, k=10)
    sharded = IvfFlatIndex(corpus, n_clusters=16, mesh=mesh)
    _, got = sharded.search(q, k=10, nprobe=16)  # all lists probed => exact
    assert recall_at_k(got, truth, k=10) == 1.0


def test_sharded_training_uses_only_real_rows(mesh):
    """1003 rows over 8 shards pad 5 zero rows: training assigns the 1003
    real rows only (every list member is a real row, each once), while the
    search's assignment shards carry the padding."""
    vecs = np.random.default_rng(12).standard_normal((1003, 16)).astype(np.float32)
    sharded = IvfFlatIndex(vecs, n_clusters=8, mesh=mesh, train_iters=4)
    members = sharded._members[sharded._members >= 0]
    np.testing.assert_array_equal(np.sort(members), np.arange(1003))
    assert [c.device for c in sharded._centroids] == list(mesh.devices[:, 0])
    assert sum(int(a.numel()) for a in sharded._assign_list) == 1008


def test_auto_index_round_trips_a_sharded_corpus(corpus, mesh, tmp_path):
    """auto.py's save reads the vectors back from the shards (padding cut)."""
    idx = tauto.build_auto_index(corpus, np.arange(1000) + 7, mesh=mesh)
    assert type(idx).__name__ == "FlatIndex"
    vecs, ids = tauto._corpus_of(idx)
    assert vecs.shape == (1000, 64) and ids[0] == 7
    tauto.save_auto_index(idx, tmp_path / "ann")
    back = tauto.load_auto_index(tmp_path / "ann", dim=64, mesh=mesh)
    q = corpus[:3]
    np.testing.assert_array_equal(back.search(q, k=5)[1], idx.search(q, k=5)[1])
