"""The port's ANN indexes against the JAX package's, on the CPU.

Flat: ids exact and scores within 1e-6, equal scores lowest row first in
both. IVF: given one quantizer (``quantizer=``) the searches agree exactly;
the port's own k-means gives JAX's assignments on the clustered corpus of
``tests/index/test_ann.py``. HNSW and the auto index: the same graph from
the same inputs, and every file either package saves loads in the other.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from kobato_eyes_tpu.index import auto as jauto
from kobato_eyes_tpu.index import flat as jflat
from kobato_eyes_tpu.index import hnsw as jhnsw
from kobato_eyes_tpu.index import ivf as jivf
from kobato_eyes_tpu_torch.index import auto as tauto
from kobato_eyes_tpu_torch.index import flat as tflat
from kobato_eyes_tpu_torch.index import hnsw as thnsw
from kobato_eyes_tpu_torch.index import ivf as tivf
from tests.torch_native import hnsw_built  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def corpus():
    """The clustered corpus of ``tests/index/test_ann.py``: 4000 x 64 around
    32 centres, 50 queries."""
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(32, 64)).astype(np.float32)
    assign = rng.integers(0, 32, size=4000)
    vecs = centers[assign] + 0.15 * rng.normal(size=(4000, 64)).astype(np.float32)
    queries = centers[rng.integers(0, 32, size=50)] + 0.15 * rng.normal(size=(50, 64)).astype(np.float32)
    return vecs.astype(np.float32), queries.astype(np.float32)


@pytest.fixture(scope="module")
def dup_corpus():
    """400 random rows, 40 of them copies of 8 others (five each, spread
    over the corpus), and queries that are those rows: exact ties."""
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(400, 16)).astype(np.float32)
    sources = rng.choice(400, size=8, replace=False)
    targets = rng.choice(np.setdiff1d(np.arange(400), sources), size=40, replace=False)
    vecs[targets] = vecs[np.repeat(sources, 5)]
    ids = np.arange(1000, 1400, dtype=np.int64)
    return vecs, ids, vecs[sources]


def test_flat_equals_jax_exactly(corpus):
    vecs, queries = corpus
    js, ji = jflat.FlatIndex(vecs).search(queries, k=10)
    ts, ti = tflat.FlatIndex(vecs, **CPU).search(queries, k=10)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, atol=1e-6, rtol=0)
    assert ts.dtype == np.float32 and ti.dtype == np.int64


def test_flat_ties_lowest_row_first(dup_corpus):
    vecs, ids, queries = dup_corpus
    js, ji = jflat.FlatIndex(vecs, ids).search(queries, k=8)
    ts, ti = tflat.FlatIndex(vecs, ids, **CPU).search(queries, k=8)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, atol=1e-6, rtol=0)
    for s, i in zip(ts, ti):
        top = i[s == s[0]]
        assert len(top) == 6 and (np.diff(top) > 0).all()  # six equal rows, ascending


@pytest.mark.parametrize("case", ["ties_everywhere", "ties_inside_the_candidates"])
def test_topk_rows_orders_like_lax_top_k(case):
    """Seven values over 300 columns: tie groups wider than the 2k
    candidates (the whole-row path). Distinct scores with the top five and
    a pair inside the top k equal: the candidates' path."""
    import jax

    rng = np.random.default_rng(9)
    if case == "ties_everywhere":
        scores = rng.choice(np.array([-np.inf, -2.5, -0.5, 0.0, 0.25, 1.0, 3.0], np.float32), size=(6, 300))
    else:
        scores = rng.normal(size=(6, 300)).astype(np.float32)
        for row in scores:
            top = np.argsort(-row, kind="stable")
            row[top[:5]] = row[top[0]]
            row[top[20]] = row[top[21]]
    want_s, want_i = jax.lax.top_k(scores, 40)
    got_s, got_i = tflat.topk_rows(torch.from_numpy(scores), 40)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_find_similar_equal(dup_corpus):
    vecs, ids, queries = dup_corpus
    jidx, tidx = jflat.FlatIndex(vecs, ids), tflat.FlatIndex(vecs, ids, **CPU)
    for row in (0, 17, 399):
        want = jflat.find_similar(jidx, vecs[row], exclude_id=int(ids[row]), k=7)
        got = tflat.find_similar(tidx, vecs[row], exclude_id=int(ids[row]), k=7)
        assert [f for f, _ in got] == [f for f, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-6)


@pytest.mark.parametrize("nprobe", [1, 4, 8])
def test_ivf_search_equal_through_quantizer(corpus, nprobe):
    vecs, queries = corpus
    quantizer = jivf.kmeans(vecs, 32, iters=8)
    ids = np.arange(len(vecs), dtype=np.int64) * 3 + 5
    j = jivf.IvfFlatIndex(vecs, ids, n_clusters=32, quantizer=quantizer)
    t = tivf.IvfFlatIndex(vecs, ids, n_clusters=32, quantizer=quantizer, **CPU)
    assert t.n_lists == j.n_lists
    np.testing.assert_array_equal(t._members, np.asarray(j._members))
    js, ji = j.search(queries, k=10, nprobe=nprobe)
    ts, ti = t.search(queries, k=10, nprobe=nprobe)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, atol=1e-6, rtol=0)


def test_ivf_pads_with_minus_one_like_jax(corpus):
    """Fewer eligible rows than k: -1 ids (and -inf scores) in both."""
    vecs, queries = corpus
    quantizer = jivf.kmeans(vecs[:200], 50, iters=3)
    js, ji = jivf.IvfFlatIndex(vecs[:200], n_clusters=50, quantizer=quantizer).search(queries[:5], k=20, nprobe=1)
    ts, ti = tivf.IvfFlatIndex(vecs[:200], n_clusters=50, quantizer=quantizer, **CPU).search(
        queries[:5], k=20, nprobe=1)
    assert (ji == -1).any()
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(np.isinf(ts), np.isinf(js))


def test_kmeans_equals_jax(corpus):
    vecs, _ = corpus
    jc, ja = jivf.kmeans(vecs, 32, iters=8)
    tc, ta = tivf.kmeans(vecs, 32, iters=8, **CPU)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(tc, jc, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(tc, axis=1), 1.0, atol=1e-4)


def test_ivf_recall_beats_floor(corpus):
    vecs, queries = corpus
    _, exact = tflat.FlatIndex(vecs, **CPU).search(queries, k=10)
    ivf = tivf.IvfFlatIndex(vecs, n_clusters=32, train_iters=8, **CPU)
    _, ids = ivf.search(queries, k=10, nprobe=8)
    assert tivf.recall_at_k(ids, exact, k=10) >= 0.9


def test_max_list_pad_splits_keeps_all():
    rng = np.random.default_rng(0)
    base = rng.normal(size=(1, 16)).astype(np.float32)
    vecs = base + 0.01 * rng.normal(size=(64, 16)).astype(np.float32)
    j = jivf.IvfFlatIndex(vecs, n_clusters=4, train_iters=4, max_list_pad=16)
    t = tivf.IvfFlatIndex(vecs, n_clusters=4, train_iters=4, max_list_pad=16, **CPU)
    present = t._members[t._members >= 0]
    assert len(present) == 64 and len(np.unique(present)) == 64
    assert t.n_lists == j.n_lists >= 4
    _, ids = t.search(vecs[:4], k=3, nprobe=t.n_lists)
    assert (ids[:, 0] == np.arange(4)).all()


# ---------------------------------------------------------------------------
# HNSW and the auto index
# ---------------------------------------------------------------------------


def test_hnsw_identical_across_packages(corpus, tmp_path):
    vecs, queries = corpus
    j = jhnsw.HnswIndex(dim=64, M=16, ef_construction=100)
    t = thnsw.HnswIndex(dim=64, M=16, ef_construction=100)
    # a batch of 64 or more is linked by several threads in whatever order
    # they run; batches of 63 link in input order, so both graphs are one
    for start in range(0, 1500, 63):
        j.add(vecs[start:min(start + 63, 1500)])
        t.add(vecs[start:min(start + 63, 1500)])
    js, ji = j.search(queries, k=10, ef=100)
    ts, ti = t.search(queries, k=10, ef=100)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts, js)
    # a graph saved by either package loads in the other
    for saver, loader in ((j, thnsw.HnswIndex), (t, jhnsw.HnswIndex)):
        path = tmp_path / f"{type(saver).__module__}.hnsw"
        saver.save(path)
        loaded = loader.load(path, dim=64)
        ls, li = loaded.search(queries, k=10, ef=100)
        np.testing.assert_array_equal(li, ji)


@pytest.mark.parametrize("cap", [10_000, 100], ids=["hnsw", "flat"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_auto_files_load_across_packages(tmp_path, cap, writer):
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((400, 32)).astype(np.float32)
    ids = np.arange(1000, 1400, dtype=np.int64)
    path = tmp_path / "clip.hnsw"
    if writer == "jax":
        jauto.save_auto_index(jauto.build_auto_index(vecs, ids, hnsw_max=cap), path)
    else:
        tauto.save_auto_index(tauto.build_auto_index(vecs, ids, hnsw_max=cap, **CPU), path)
    meta = json.loads(path.with_suffix(".meta.json").read_text())
    assert meta["kind"] == ("hnsw" if cap > 400 else "FlatIndex")
    j = jauto.load_auto_index(path, dim=32)
    t = tauto.load_auto_index(path, dim=32, **CPU)
    assert type(t).__name__ == type(j).__name__
    js, ji = j.search(vecs[10:14], k=5)
    ts, ti = t.search(vecs[10:14], k=5)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), atol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_ivf_npz_loads_across_packages(tmp_path, writer):
    rng = np.random.default_rng(4)
    vecs = rng.standard_normal((300, 8)).astype(np.float32)
    path = tmp_path / "clip.hnsw"
    if writer == "jax":
        jauto.save_auto_index(jivf.IvfFlatIndex(vecs, n_clusters=8), path)
    else:
        tauto.save_auto_index(tivf.IvfFlatIndex(vecs, n_clusters=8, **CPU), path)
    assert json.loads(path.with_suffix(".meta.json").read_text())["kind"] == "IvfFlatIndex"
    j = jauto.load_auto_index(path, dim=8)
    t = tauto.load_auto_index(path, dim=8, **CPU)
    assert isinstance(t, tivf.IvfFlatIndex) and isinstance(j, jivf.IvfFlatIndex)
    np.testing.assert_allclose(tauto._corpus_of(t)[0], jauto._corpus_of(j)[0], atol=1e-7)
    _, ti = t.search(vecs[:3], k=5, nprobe=t.n_lists)
    assert (ti[:, 0] == np.arange(3)).all()


def test_routing_equal(monkeypatch):
    rng = np.random.default_rng(6)
    vecs = rng.standard_normal((300, 8)).astype(np.float32)
    for cap in (None, 1000, 100):
        j = jauto.build_auto_index(vecs, hnsw_max=cap)
        t = tauto.build_auto_index(vecs, hnsw_max=cap, **CPU)
        assert type(t).__name__ == type(j).__name__
    for raw, want in (("12345", 12345), ("bogus", 300_000), ("", 300_000)):
        monkeypatch.setenv("KET_ANN_HNSW_MAX", raw)
        assert tauto.hnsw_max_vectors() == jauto.hnsw_max_vectors() == want
    monkeypatch.setenv("KET_ANN_HNSW_MAX", "100")
    assert type(tauto.build_auto_index(vecs, **CPU)).__name__ == "FlatIndex"
    assert tauto.DEFAULT_FLAT_MIN == jauto.DEFAULT_FLAT_MIN


def test_default_device_without_gpu_raises(monkeypatch, corpus):
    vecs, _ = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: tflat.FlatIndex(vecs), lambda: tivf.IvfFlatIndex(vecs, n_clusters=4),
                  lambda: tivf.kmeans(vecs, 4), lambda: tauto.build_auto_index(vecs, hnsw_max=10)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    # a mesh over the visible cards needs a card too; one over CPU entries builds
    from kobato_eyes_tpu_torch.parallel.mesh import make_mesh

    for build in (lambda: tflat.FlatIndex(vecs, mesh=make_mesh()),
                  lambda: tivf.IvfFlatIndex(vecs, mesh=make_mesh())):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    cpu_mesh = make_mesh(devices=["cpu"] * 2)
    assert len(tflat.FlatIndex(vecs, mesh=cpu_mesh)) == len(tivf.IvfFlatIndex(vecs, n_clusters=4, mesh=cpu_mesh))
