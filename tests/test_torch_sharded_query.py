"""The port's mesh-sharded query engine against the JAX package's
(``tests/query/test_sharded_query.py``, case for case) and against the
single-device engine: one catalog, written once, read by both packages;
result lists (file ids and relevances) are exact.
"""

from __future__ import annotations

import logging

import numpy as np
import pytest
import torch

from kobato_eyes_tpu.db.connection import bootstrap, reset_bootstrap_cache
from kobato_eyes_tpu.db.repository import TaggingItem, upsert_file, write_tagging_batch
from kobato_eyes_tpu.parallel.mesh import make_mesh as jmake_mesh
from kobato_eyes_tpu.query import engine as jeng
from kobato_eyes_tpu_torch.db import connection as tconnection
from kobato_eyes_tpu_torch.parallel.mesh import Mesh, make_mesh
from kobato_eyes_tpu_torch.query import engine as teng
from kobato_eyes_tpu_torch.query import sharded as tsharded
from tests.torch_native import catalog_fetch_built  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8

TAG_POOL = [
    ("1girl", 0), ("solo", 0), ("long_hair", 0), ("smile", 0), ("blue_eyes", 0),
    ("some_char", 4), ("other_char", 4), ("franchise_a", 3), ("franchise_b", 3),
    ("rating_safe", 2), ("artist_x", 1), ("highres", 5),
]

QUERIES = [
    "",
    "1girl",
    "1girl solo",
    "1girl OR solo",
    "1girl -smile",
    "NOT smile",
    "( 1girl OR solo ) long_hair",
    "category:character",
    "category:character score>=0.5",
    "score>=0.9",
    "score<0.3",
    "score<=0.25",
    "1girl AND ( some_char OR other_char )",
    "-( 1girl solo )",
    "unknown_tag",
    "1girl OR unknown_tag",
]


@pytest.fixture(scope="module")
def epochs(tmp_path_factory):
    reset_bootstrap_cache()
    db = tmp_path_factory.mktemp("sqdb") / "catalog.sqlite"
    conn = bootstrap(db)
    rng = np.random.default_rng(11)
    items = []
    for i in range(300):
        fid = upsert_file(
            conn, path=f"/data/img_{i:04d}.png", size=1000 + i,
            mtime=1e9 + (i % 41) * 100,
        )
        n_tags = int(rng.integers(0, 8))
        picks = rng.choice(len(TAG_POOL), size=n_tags, replace=False)
        tags = [
            (TAG_POOL[p][0], float(rng.uniform(0.05, 1.0)), TAG_POOL[p][1])
            for p in picks
        ]
        items.append(TaggingItem(file_id=fid, tags=tags, tagger_sig="t"))
    write_tagging_batch(conn, items)
    jepoch = jeng.build_epoch(conn)
    conn.close()
    tconnection.reset_bootstrap_cache()
    tconn = tconnection.bootstrap(db)
    tepoch = teng.build_epoch(tconn, device="cpu")
    tconn.close()
    return jepoch, tepoch


def _results(rows):
    return [(r.file_id, r.relevance) for r in rows]


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(data=8, model=1, devices=CPU8)


@pytest.mark.parametrize("query", QUERIES)
@pytest.mark.parametrize("order_by", ["relevance", "mtime", "path", "id"])
def test_sharded_matches_single_chip(epochs, mesh, query, order_by):
    jepoch, tepoch = epochs
    thr = {0: 0.35, 4: 0.25, 3: 0.25}
    single = teng.search_epoch(tepoch, query, thresholds=thr, order_by=order_by, limit=50)
    sharded = teng.search_epoch(tepoch, query, thresholds=thr, order_by=order_by, limit=50, mesh=mesh)
    jsharded = jeng.search_epoch(jepoch, query, thresholds=thr, order_by=order_by, limit=50,
                                 mesh=jmake_mesh(data=8, model=1))
    assert _results(sharded) == _results(single) == _results(jsharded)


def test_sharded_paging_and_exact_score(epochs, mesh):
    # the exact-equality score term walks all postings: a score==0.0 query
    # must not light up a shard's local row 0
    _, tepoch = epochs
    for query in ["score>=0.0", "1girl score>=0.2", "score=0.0"]:
        for off in (0, 10, 40):
            a = teng.search_epoch(tepoch, query, limit=7, offset=off)
            b = teng.search_epoch(tepoch, query, limit=7, offset=off, mesh=mesh)
            assert [r.file_id for r in a] == [r.file_id for r in b]


def test_sharded_mesh_2dev(epochs):
    """Non-trivial model axis: only the data axis shards the rows."""
    _, tepoch = epochs
    mesh = make_mesh(data=2, model=4, devices=CPU8)
    a = teng.search_epoch(tepoch, "1girl OR solo", limit=100)
    b = teng.search_epoch(tepoch, "1girl OR solo", limit=100, mesh=mesh)
    assert [r.file_id for r in a] == [r.file_id for r in b]
    sharded = tsharded._shard_epoch(tepoch, mesh)
    assert sharded.n_shards == 2 and sharded.rps == tepoch.n_pad // 2


def test_words_come_back_in_shard_order(epochs, mesh):
    """Each shard's words are its own rows' bits, and the shards' postings
    add up to the epoch's."""
    _, tepoch = epochs
    expr = teng.parse_query("1girl OR smile")
    thr = teng.normalize_thresholds({})
    words = tsharded.sharded_mask_words(tepoch, mesh, "1girl OR smile", expr, thr)
    single = teng._mask_words(tepoch, teng._slot_tables_np(tepoch, expr, thr)).numpy()
    np.testing.assert_array_equal(words, single)
    sharded = tsharded._shard_epoch(tepoch, mesh)
    assert sum(int(s.rows_dev.numel()) for s in sharded.shards) == tepoch.nnz
    assert all(s.device == mesh.devices[i, 0] and s.n_pad == sharded.rps for i, s in enumerate(sharded.shards))


def test_unshardable_mesh_falls_back_to_single_chip(epochs):
    """A data axis that cannot divide the padded file rows (3 rows) serves
    the query on one device with a warning, not an error."""
    _, tepoch = epochs
    mesh = Mesh([["cpu"], ["cpu"], ["cpu"]])
    solo = teng.search_epoch(tepoch, "1girl OR smile", limit=50)
    via_mesh = teng.search_epoch(tepoch, "1girl OR smile", limit=50, mesh=mesh)
    assert _results(via_mesh) == _results(solo)


def test_unshardable_verdict_memoized(epochs, caplog):
    """The unshardable (epoch, mesh) verdict is cached: the shard attempt and
    its warning happen once, not per request on a hot serving path."""
    _, tepoch = epochs
    mesh = Mesh([["cpu"], ["cpu"], ["cpu"]])
    teng._UNSHARDABLE_VERDICTS.pop(tepoch, None)
    with caplog.at_level(logging.WARNING, logger="kobato_eyes_tpu_torch.query.engine"):
        first = teng.search_epoch(tepoch, "1girl", limit=10, mesh=mesh)
        n_warn_first = sum("cannot shard" in r.message for r in caplog.records)
        second = teng.search_epoch(tepoch, "1girl", limit=10, mesh=mesh)
        n_warn_total = sum("cannot shard" in r.message for r in caplog.records)
    assert n_warn_first == 1
    assert n_warn_total == 1, "verdict must be memoized per (epoch, mesh)"
    assert [r.file_id for r in first] == [r.file_id for r in second]
    solo = teng.search_epoch(tepoch, "1girl", limit=10)
    assert [r.file_id for r in second] == [r.file_id for r in solo]


def test_skewed_postings_shard_without_amplification():
    """The JAX module refuses to shard an epoch whose postings crowd one row
    shard (its rectangular table would pay D times the memory,
    tests/query/test_sharded_skew.py); the port's shards hold their own
    postings, so it shards, each shard no larger than its share, with the
    single-device results."""
    n_files = 2000
    rng = np.random.default_rng(5)
    rows = rng.permutation(200)  # every tagged row in the first of 8 shards
    r_idx = np.repeat(rows, 10).astype(np.int32)
    t_idx = (r_idx + np.tile(np.arange(10), len(rows)) * 5) % len(TAG_POOL)
    key = r_idx.astype(np.int64) * len(TAG_POOL) + t_idx
    _, uniq = np.unique(key, return_index=True)
    epoch = teng._assemble_epoch(
        version=0, file_ids=np.arange(1, n_files + 1, dtype=np.int64),
        mtimes=rng.uniform(1e9, 2e9, size=n_files), sizes=rng.integers(1000, 9000, size=n_files),
        paths=[f"/skew/{i:07d}.png" for i in range(n_files)],
        tag_names=[t[0] for t in TAG_POOL], tag_cats=np.array([t[1] for t in TAG_POOL], dtype=np.int32),
        t_idx=t_idx[uniq].astype(np.int64), r_idx=r_idx[uniq],
        sc=rng.uniform(0.05, 1.0, size=len(uniq)).astype(np.float32), device="cpu",
    )
    mesh = make_mesh(data=8, model=1, devices=CPU8)
    sharded = tsharded._shard_epoch(epoch, mesh)
    sizes = [int(s.rows_dev.numel()) for s in sharded.shards]
    assert sizes[0] == epoch.nnz and sum(sizes[1:]) == 0
    for q in ("1girl OR smile", "1girl solo", "-smile"):
        assert _results(teng.search_epoch(epoch, q, limit=50, mesh=mesh)) == _results(
            teng.search_epoch(epoch, q, limit=50))
