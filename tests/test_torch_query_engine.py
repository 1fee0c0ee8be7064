"""The port's device query engine (on the CPU) against the JAX engine and
against the SQL backend.

One catalog file, written with the JAX package's repository, is opened by
both packages. Epoch host arrays and panels, the unpacked file masks and the
result rows (``file_id``, ``path``, ``mtime``, ``size``, ``relevance``) must be
equal bit for bit: integers, booleans and f64 host sums, so every comparison
here is exact. The comparison with SQLite's own ``SUM`` holds the ids exactly
and the relevance to 1e-9 (SQLite adds in row order, the engines in term
order).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import kobato_eyes_tpu.query.engine as jeng
import kobato_eyes_tpu_torch.query.engine as teng
from kobato_eyes_tpu.db.connection import bootstrap as jbootstrap
from kobato_eyes_tpu.db.connection import reset_bootstrap_cache as jreset
from kobato_eyes_tpu.db.repository import (
    TaggingItem,
    delete_files,
    mark_files_absent,
    upsert_file,
    write_tagging_batch,
)
from kobato_eyes_tpu_torch.db.connection import bootstrap as tbootstrap
from kobato_eyes_tpu_torch.db.connection import reset_bootstrap_cache as treset
from kobato_eyes_tpu_torch.db.repository import search_files
from kobato_eyes_tpu_torch.query.ast import extract_positive_tag_terms, parse_query
from kobato_eyes_tpu_torch.query.sql import normalize_thresholds, translate_query
from tests.torch_native import catalog_fetch_built  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

TAG_POOL = [
    ("1girl", 0), ("solo", 0), ("long_hair", 0), ("smile", 0), ("blue_eyes", 0),
    ("some_char", 4), ("other_char", 4), ("franchise_a", 3), ("franchise_b", 3),
    ("rating_safe", 2), ("artist_x", 1), ("highres", 5),
]
KNOWN = [t for t, _ in TAG_POOL]
CATS = ["general", "artist", "rating", "copyright", "character", "meta"]
ORDERINGS = ["relevance", "mtime", "path", "id"]

# the 15 hand queries of tests/query/test_device_sql_parity.py
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
    "1girl AND ( some_char OR other_char )",
    "-( 1girl solo )",
    "unknown_tag",
    "1girl OR unknown_tag",
]

HOST_ARRAYS = ("file_ids", "mtimes", "sizes", "tag_cats", "offsets", "rows_np", "scores_np")
DEVICE_ARRAYS = ("rows_dev", "scores_dev", "cat_max_dev", "cat_present_dev", "smax_dev", "smin_dev")


def _write_catalog(path, n_files: int, seed: int):
    """A catalog through the JAX package's repository: files with 0-8 of the
    pool's tags at scores in [0.05, 1), some exactly 0.5 (a threshold a query
    can sit on), mtimes with ties."""
    jreset()
    conn = jbootstrap(path)
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n_files):
        fid = upsert_file(conn, path=f"/lib/{i % 9}/img_{i:04d}.png", size=500 + i,
                          mtime=1e9 + (i % 23) * 777)
        picks = rng.choice(len(TAG_POOL), size=int(rng.integers(0, 9)), replace=False)
        tags = [(TAG_POOL[p][0], 0.5 if rng.random() < 0.1 else float(rng.uniform(0.05, 1.0)),
                 TAG_POOL[p][1]) for p in picks]
        items.append(TaggingItem(file_id=fid, tags=tags, tagger_sig="t"))
    write_tagging_batch(conn, items)
    conn.commit()
    return conn


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    """(JAX connection, port connection, JAX epoch, port epoch) on one file."""
    path = tmp_path_factory.mktemp("qdb") / "catalog.sqlite"
    jconn = _write_catalog(path, 150, seed=13)
    treset()
    tconn = tbootstrap(path)
    jepoch = jeng.build_epoch(jconn, version=1)
    tepoch = teng.build_epoch(tconn, version=1, device="cpu")
    yield jconn, tconn, jepoch, tepoch
    tconn.close()
    jconn.close()


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_epochs_equal(got, want, *, canonical: bool = False):
    """Every array of two epochs (port or JAX), exactly. ``canonical``: the
    postings of each tag compared as a set ordered by row. A delta keeps a
    tag's surviving postings and appends its fresh ones, a full build has
    them in catalog order; no query can tell the two apart."""
    assert (got.num_files, got.num_tags, got.nnz, got.n_pad, got.t_pad) == (
        want.num_files, want.num_tags, want.nnz, want.n_pad, want.t_pad)
    assert got.paths == want.paths and got.tag_names == want.tag_names
    assert got.name_to_tid == want.name_to_tid
    arrays = {}
    for name in HOST_ARRAYS + DEVICE_ARRAYS:
        a, b = _host(getattr(got, name)), _host(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        arrays[name] = (a, b)
    if canonical:
        for side in (0, 1):
            offsets, rows = arrays["offsets"][side], arrays["rows_np"][side]
            tags = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))
            order = np.lexsort((rows, tags))
            for name in ("rows_np", "scores_np", "rows_dev", "scores_dev"):
                pair = list(arrays[name])
                pair[side] = pair[side].copy()
                pair[side][: len(order)] = pair[side][: len(order)][order]
                arrays[name] = tuple(pair)
    for name, (a, b) in arrays.items():
        np.testing.assert_array_equal(a, b, err_msg=name)


def _jax_mask(epoch, query: str, thr: dict) -> np.ndarray:
    tabs = jeng._query_tables(epoch, query, jeng.parse_query(query), jeng.normalize_thresholds(thr))
    words = np.asarray(jeng._structure_fn(tabs[0], tabs[1])(
        epoch.rows_dev, epoch.scores_dev, epoch.cat_max_dev, epoch.cat_present_dev,
        epoch.smax_dev, epoch.smin_dev, *tabs[2:]))
    return jeng._unpack_mask(words, epoch.num_files)


def _port_mask(epoch, query: str, thr: dict) -> np.ndarray:
    tabs = teng._slot_tables_np(epoch, parse_query(query), normalize_thresholds(thr))
    return teng._unpack_mask(teng._mask_words(epoch, tabs).numpy(), epoch.num_files)


def _as_tuples(rows):
    return [(r.file_id, r.path, r.mtime, r.size, r.relevance) for r in rows]


def _sql_rows(conn, query, thr, order_by, limit, offset):
    frag = translate_query(query, thresholds=thr)
    return search_files(
        conn, frag.where, frag.params, positive_tags=extract_positive_tag_terms(query),
        thresholds=normalize_thresholds(thr), order_by=order_by, limit=limit, offset=offset,
        hydrate=False,
    )


def _assert_query_equal(catalog, query, thr, order_by, limit, offset):
    jconn, tconn, jepoch, tepoch = catalog
    np.testing.assert_array_equal(_port_mask(tepoch, query, thr), _jax_mask(jepoch, query, thr))
    got = teng.search_epoch(tepoch, query, thresholds=thr, order_by=order_by, limit=limit, offset=offset)
    want = jeng.search_epoch(jepoch, query, thresholds=thr, order_by=order_by, limit=limit, offset=offset)
    assert _as_tuples(got) == _as_tuples(want), (query, thr, order_by, limit, offset)
    sql = _sql_rows(tconn, query, thr, order_by, limit, offset)
    assert [r.file_id for r in got] == [r.file_id for r in sql], (query, thr, order_by)
    if order_by == "relevance":
        np.testing.assert_allclose([r.relevance for r in got], [r.relevance for r in sql],
                                   rtol=0, atol=1e-9)


def test_epoch_arrays_equal_the_jax_epoch(catalog):
    _, _, jepoch, tepoch = catalog
    assert tepoch.nnz > 400 and tepoch.device.type == "cpu"
    assert tepoch.rows_dev.dtype == torch.int32 and tepoch.scores_dev.dtype == torch.float32
    assert tepoch.cat_present_dev.dtype == torch.bool
    _assert_epochs_equal(tepoch, jepoch)
    np.testing.assert_array_equal(tepoch.path_ranks, jepoch.path_ranks)


def test_native_fetch_route_ran(catalog, catalog_fetch_built):  # noqa: F811
    """With the library built, the port's full-table fetch takes the C route
    on a file catalog and returns what the Python route returns."""
    _, tconn, _, _ = catalog
    native = teng._fetch_file_tag_arrays_native(tconn)
    assert native is not None
    python = teng._fetch_file_tag_arrays(tconn, where="WHERE 1 = 1")
    order_n, order_p = (np.lexsort((a[1], a[0])) for a in (native, python))
    for got, want in zip(native, python):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got[order_n], want[order_p])


@pytest.mark.parametrize("order_by", ORDERINGS)
@pytest.mark.parametrize("query", QUERIES)
def test_hand_queries_equal_jax_and_sql(catalog, query, order_by):
    _assert_query_equal(catalog, query, {}, order_by, 1000, 0)


@pytest.mark.parametrize("query", [
    "1girl", "category:character", "1girl some_char", "score=0.50", "score>0.5", "score<=0.5",
    "rating_safe OR artist_x OR highres", "-category:meta score>=0.5",
])
@pytest.mark.parametrize("thr", [{0: 0.9, 4: 0.1}, {0: 0.5, 3: 0.5, 4: 0.5}, {1: 0.3, 2: 0.7, 5: 0.2}])
def test_threshold_overrides_and_score_operators(catalog, query, thr):
    """Per-category gates (f32 against f32: a score of exactly 0.5 sits on
    the 0.5 gates) and every bare score operator, the ``=`` scatter included."""
    _assert_query_equal(catalog, query, thr, "relevance", 1000, 0)


@pytest.mark.parametrize("limit,offset", [(1, 0), (7, 3), (50, 60), (1000, 149), (5, 1000)])
def test_limit_and_offset(catalog, limit, offset):
    for order_by in ORDERINGS:
        _assert_query_equal(catalog, "1girl OR solo OR smile", {}, order_by, limit, offset)


@st.composite
def _queries(draw) -> str:
    depth = draw(st.integers(0, 3))

    def atom() -> str:
        kind = draw(st.sampled_from(["known", "known", "known", "unknown", "cat", "score"]))
        if kind == "known":
            return draw(st.sampled_from(KNOWN))
        if kind == "unknown":
            return "zz_" + draw(st.sampled_from(["a", "b", "c"]))
        if kind == "cat":
            return "category:" + draw(st.sampled_from(CATS))
        op = draw(st.sampled_from([">=", "<=", "=", ">", "<"]))
        return f"score{op}{draw(st.floats(0, 1, allow_nan=False)):.2f}"

    def expr(d: int) -> str:
        if d == 0:
            return atom()
        kind = draw(st.sampled_from(["atom", "atom", "not", "neg", "and", "or", "paren", "implicit"]))
        if kind == "atom":
            return atom()
        if kind == "not":
            return "NOT " + expr(d - 1)
        if kind == "neg":
            return "-" + atom()
        if kind == "and":
            return expr(d - 1) + " AND " + expr(d - 1)
        if kind == "or":
            return expr(d - 1) + " OR " + expr(d - 1)
        if kind == "implicit":
            return expr(d - 1) + " " + atom()
        return "( " + expr(d - 1) + " )"

    return expr(depth)


@st.composite
def _thresholds(draw):
    n = draw(st.integers(0, 3))
    cats = draw(st.lists(st.sampled_from([0, 1, 2, 3, 4, 5]), min_size=n, max_size=n, unique=True))
    return {c: round(draw(st.floats(0.0, 1.0, allow_nan=False)), 2) for c in cats}


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.function_scoped_fixture])
@given(query=_queries(), thr=_thresholds(), order_by=st.sampled_from(ORDERINGS),
       limit=st.sampled_from([1, 7, 50, 1000]), offset=st.sampled_from([0, 0, 0, 3, 60]))
def test_fuzz_equals_jax_and_sql(catalog, query, thr, order_by, limit, offset):
    _assert_query_equal(catalog, query, thr, order_by, limit, offset)


def test_partial_topk_path_equals_jax_and_sql(tmp_path, monkeypatch):
    """Both engines pushed onto the partial top-k path at a small size."""
    monkeypatch.setattr(teng, "_TOPK_MIN_HITS", 8)
    monkeypatch.setattr(jeng, "_TOPK_MIN_HITS", 8)
    jreset()
    jconn = jbootstrap(tmp_path / "p.sqlite")
    rng = np.random.default_rng(9)
    for i in range(400):
        fid = upsert_file(jconn, path=f"/p/{i:04d}.png", mtime=1e9 + int(rng.integers(0, 7)))
        tags = [("common", float(rng.choice([0.5, 0.9])), 0)]
        if i % 3 == 0:
            tags.append(("rare", 0.8, 0))
        write_tagging_batch(jconn, [TaggingItem(fid, tags)])
    jconn.commit()
    treset()
    tconn = tbootstrap(tmp_path / "p.sqlite")
    both = (jconn, tconn, jeng.build_epoch(jconn), teng.build_epoch(tconn, device="cpu"))
    for query, order_by in (("common", "relevance"), ("common", "mtime"), ("common", "id"),
                            ("common", "path"), ("common OR rare", "relevance"),
                            ("common OR rare", "path")):
        _assert_query_equal(both, query, {}, order_by, 25, 5)
    tconn.close()
    jconn.close()


def test_batch_equals_singles_and_the_jax_batch(catalog):
    _, _, jepoch, tepoch = catalog
    queries = QUERIES + ["score=0.50", "1girl", "category:meta -solo"]  # a repeated query too
    thr = {0: 0.4, 4: 0.2}
    for order_by in ("relevance", "path"):
        kw = dict(thresholds=thr, order_by=order_by, limit=20, offset=2)
        batch = teng.search_epoch_batch(tepoch, queries, **kw)
        singles = [teng.search_epoch(tepoch, q, **kw) for q in queries]
        assert [_as_tuples(r) for r in batch] == [_as_tuples(r) for r in singles]
        want = jeng.search_epoch_batch(jepoch, queries, **kw)
        assert [_as_tuples(r) for r in batch] == [_as_tuples(r) for r in want]
    assert teng.search_epoch_batch(tepoch, []) == []


def test_batch_waits_once_for_the_device(catalog, monkeypatch):
    """All masks are evaluated before the one copy to the host."""
    _, _, _, tepoch = catalog
    events = []
    real_words, real_rank = teng._mask_words, teng._rank_and_page
    monkeypatch.setattr(teng, "_mask_words", lambda *a: (events.append("mask"), real_words(*a))[1])
    monkeypatch.setattr(teng, "_rank_and_page", lambda *a: (events.append("rank"), real_rank(*a))[1])
    teng.search_epoch_batch(tepoch, ["1girl", "solo", "-smile"])
    assert events == ["mask"] * 3 + ["rank"] * 3


# -- delta epochs -------------------------------------------------------------


def _change_retag_in_place(conn, ids):
    write_tagging_batch(conn, [
        TaggingItem(ids[0], [("1girl", 0.95, 0)], tagger_sig="s2"),
        TaggingItem(ids[1], [("solo", 0.1, 0), ("some_char", 0.99, 4)], tagger_sig="s2"),
        TaggingItem(ids[2], [], tagger_sig="s2"),
    ])
    return ids[:3]


def _change_add_files(conn, ids):
    new = [upsert_file(conn, path=f"/lib/new_{i}.png", mtime=2e9 + i, size=7 + i) for i in range(5)]
    write_tagging_batch(conn, [TaggingItem(f, [("1girl", 0.9, 0), ("highres", 0.3, 5)]) for f in new])
    return new


def _change_remove_files(conn, ids):
    mark_files_absent(conn, ids[:3])
    delete_files(conn, ids[3:6])
    return ids[:6]


def _change_new_tag(conn, ids):
    write_tagging_batch(conn, [
        TaggingItem(ids[4], [("brand_new_tag", 0.77, 0), ("smile", 0.6, 0)], tagger_sig="s2"),
        TaggingItem(ids[9], [("another_new", 0.5, 4)], tagger_sig="s2"),
    ])
    return [ids[4], ids[9]]


def _change_category(conn, ids):
    """A tag moves category: the vocabulary is no longer append-only, so the
    delta takes its full re-sort path."""
    conn.execute("UPDATE tags SET category = 3 WHERE name = 'smile'")
    write_tagging_batch(conn, [TaggingItem(ids[0], [("smile", 0.8, 3)], tagger_sig="s2")])
    return [ids[0]]


def _change_mixed(conn, ids):
    return (_change_retag_in_place(conn, ids[10:]) + _change_add_files(conn, ids)
            + _change_remove_files(conn, ids[20:]) + _change_new_tag(conn, ids[30:]))


@pytest.mark.parametrize("change", [
    _change_retag_in_place, _change_add_files, _change_remove_files, _change_new_tag,
    _change_category, _change_mixed,
], ids=lambda f: f.__name__.removeprefix("_change_"))
def test_update_epoch_equals_a_fresh_build_and_the_jax_delta(tmp_path, change):
    path = tmp_path / "d.sqlite"
    jconn = _write_catalog(path, 80, seed=11)
    treset()
    tconn = tbootstrap(path)
    jprev = jeng.build_epoch(jconn, version=1)
    tprev = teng.build_epoch(tconn, version=1, device="cpu")
    before = {name: getattr(tprev, name).clone() for name in DEVICE_ARRAYS}
    ids = [int(r[0]) for r in jconn.execute("SELECT id FROM files ORDER BY id")]
    changed = change(jconn, ids)
    jconn.commit()

    delta = teng.update_epoch(tconn, tprev, changed_file_ids=changed, version=2)
    assert delta.version == 2 and delta.device == tprev.device
    _assert_epochs_equal(delta, teng.build_epoch(tconn, version=2, device="cpu"), canonical=True)
    _assert_epochs_equal(delta, jeng.update_epoch(jconn, jprev, changed_file_ids=changed, version=2))
    # the previous epoch's tensors were not written: old readers keep them
    for name, was in before.items():
        assert torch.equal(getattr(tprev, name), was), name
    for query in ("1girl", "smile OR brand_new_tag", "-1girl", "category:copyright", "score>=0.8", ""):
        got = teng.search_epoch(delta, query, order_by="id", limit=10_000)
        want = _sql_rows(tconn, query, {}, "id", 10_000, 0)
        assert [r.file_id for r in got] == [r.file_id for r in want], query
    tconn.close()
    jconn.close()


def test_epoch_manager_rebuilds_then_applies_deltas(tmp_path):
    jconn = _write_catalog(tmp_path / "m.sqlite", 40, seed=5)
    treset()
    tconn = tbootstrap(tmp_path / "m.sqlite")
    manager = teng.EpochManager(device="cpu")
    assert manager.current is None and manager.device.type == "cpu"
    first = manager.apply_delta(tconn, [1])  # no epoch yet: a full build
    assert first.version == 1 and manager.current is first
    assert manager.apply_delta(tconn, []) is first  # nothing changed: same epoch
    ids = [int(r[0]) for r in jconn.execute("SELECT id FROM files ORDER BY id")]
    changed = _change_retag_in_place(jconn, ids)
    jconn.commit()
    second = manager.apply_delta(tconn, changed)
    assert second.version == 2 and manager.current is second and first.version == 1
    _assert_epochs_equal(second, teng.build_epoch(tconn, version=2, device="cpu"), canonical=True)
    assert manager.rebuild(tconn).version == 3
    tconn.close()
    jconn.close()


# -- the port's own rules -----------------------------------------------------


def test_cuda_is_the_default_and_raises_without_a_gpu(catalog):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device resolves")
    _, tconn, _, _ = catalog
    with pytest.raises(RuntimeError, match="CUDA"):
        teng.build_epoch(tconn)
    with pytest.raises(RuntimeError, match="CUDA"):
        teng.EpochManager()


def test_mesh_waits_for_the_multi_device_slice(catalog):
    """The multi-device slice landed: a mesh of CPU entries shards the mask
    and gives the single-device results."""
    from kobato_eyes_tpu_torch.parallel.mesh import make_mesh

    _, _, _, tepoch = catalog
    mesh = make_mesh(devices=["cpu"] * 2)
    assert [r.file_id for r in teng.search_epoch(tepoch, "1girl", mesh=mesh)] == [
        r.file_id for r in teng.search_epoch(tepoch, "1girl")
    ]
    with pytest.raises(ValueError, match="order_by"):
        teng.search_epoch(tepoch, "1girl", order_by="size")
    with pytest.raises(ValueError, match="order_by"):
        teng.search_epoch_batch(tepoch, ["1girl"], order_by="size")


def test_term_mask_is_a_reduction_not_a_racing_store():
    """Rows named twice, once hit and once not, come out hit."""
    rows = torch.tensor([3, 5, 3, 7, 5], dtype=torch.int32)
    hit = torch.tensor([False, True, True, False, False])
    got = teng._hit_rows(rows, hit, 8)
    assert got.tolist() == [False, False, False, True, False, True, False, False]


def test_packed_words_round_trip():
    rng = np.random.default_rng(0)
    mask = rng.random(256) < 0.3
    words = (torch.from_numpy(mask).view(-1, 8).to(torch.int32) * teng._bit_weights(torch.device("cpu")))
    packed = words.sum(dim=1).to(torch.uint8).numpy()
    np.testing.assert_array_equal(packed, np.packbits(mask, bitorder="little"))
    np.testing.assert_array_equal(teng._unpack_mask(packed, 250), mask[:250])
