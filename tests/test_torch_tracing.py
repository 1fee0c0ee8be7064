"""The port's spans: user annotations in a recording ``torch.profiler``
session, nothing while none records.

``utils/tracing.py``'s ``span`` and its ``gc.callbacks`` hook, and the spans
the tagger (``tagger.*``) and the query engine (``query.*``) open around a
request's parts, on one device and on a mesh. Each test reads the host side of the trace
(the kineto events that are user annotations), as the benchmark's readers do.
"""

from __future__ import annotations

import gc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kobato_eyes_tpu_torch.db.connection import bootstrap
from kobato_eyes_tpu_torch.db.repository import TaggingItem, upsert_file, write_tagging_batch
from kobato_eyes_tpu_torch.models.labels import synthetic_labels
from kobato_eyes_tpu_torch.models.tagger import WD14Tagger
from kobato_eyes_tpu_torch.models.vit import vit_config
from kobato_eyes_tpu_torch.parallel.mesh import Mesh, make_mesh
from kobato_eyes_tpu_torch.query.engine import _UNSHARDABLE_VERDICTS, build_epoch, search_epoch, search_epoch_batch
from kobato_eyes_tpu_torch.utils import tracing
from kobato_eyes_tpu_torch.utils.tracing import NO_SPAN, span
from tests.torch_native import catalog_fetch_built  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

TAGS = [("1girl", 0), ("solo", 0), ("smile", 0), ("long_hair", 0), ("some_char", 4), ("rating_safe", 2)]
QUERIES = ["1girl", "1girl -smile", "solo OR some_char", "( smile OR long_hair ) category:character",
           "score>=0.6", "unknown_tag"]


def annotations(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of the trace's host-side user annotations, by start."""
    out = [
        (ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
        for ev in prof.profiler.kineto_results.events()
        if ev.is_user_annotation() and not str(ev.device_type()).endswith("CUDA")
    ]
    return sorted(out, key=lambda a: (a[1], -a[2]))


def children(spans, parent, prefix: str) -> list[str]:
    """Names of the spans starting with ``prefix`` inside ``parent``, in order."""
    _, lo, hi = parent
    return [n for n, s, e in spans if n.startswith(prefix) and (n, s, e) != parent and lo <= s and e <= hi]


def profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, annotations(prof)


@pytest.fixture(scope="module")
def epoch(tmp_path_factory):
    rng = np.random.default_rng(5)
    conn = bootstrap(tmp_path_factory.mktemp("tracing") / "catalog.sqlite")
    try:
        items = []
        for i in range(40):
            fid = upsert_file(conn, path=f"/library/{i:03d}.jpg", size=1000 + i, mtime=1.6e9 + i % 7)
            picked = rng.choice(len(TAGS), size=3, replace=False)
            items.append(TaggingItem(file_id=fid, tags=[(TAGS[j][0], float(rng.uniform(0.4, 0.99)), TAGS[j][1])
                                                        for j in picked]))
        write_tagging_batch(conn, items)
        return build_epoch(conn, device="cpu")
    finally:
        conn.close()


@pytest.fixture(scope="module")
def tagger():
    cfg = vit_config("tiny", image_size=64, patch_size=16, num_classes=48, dtype=torch.float32)
    return WD14Tagger(labels=synthetic_labels(48), vit=cfg, fast_math=False, device="cpu", seed=3)


@pytest.fixture(scope="module")
def batch():
    return np.random.default_rng(8).integers(0, 256, size=(3, 64, 64, 3), dtype=np.uint8)


@pytest.fixture
def entered(monkeypatch):
    """Counts every ``record_function`` made or entered, and every record the
    GC hook would open."""
    counts = {"record_function": 0, "enter_new": 0}
    cls = torch.autograd.profiler.record_function
    init, enter = cls.__init__, cls.__enter__

    def counting_init(self, *a, **k):
        counts["record_function"] += 1
        init(self, *a, **k)

    def counting_enter(self):
        counts["record_function"] += 1
        return enter(self)

    real = torch.ops.profiler._record_function_enter_new

    def counting_enter_new(*a):
        counts["enter_new"] += 1
        return real(*a)

    monkeypatch.setattr(cls, "__init__", counting_init)
    monkeypatch.setattr(cls, "__enter__", counting_enter)
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", counting_enter_new)
    return counts


def test_no_profiler_gives_the_shared_noop(entered, epoch, tagger, batch):
    assert not torch.autograd._profiler_enabled()
    assert span("tagger.upload") is NO_SPAN
    with span("query.search") as inside:
        assert inside is None
    search_epoch(epoch, "1girl -smile")
    search_epoch_batch(epoch, QUERIES[:2])
    tagger.complete_batch_prepared(tagger.dispatch_batch_prepared(batch))
    gc.collect(2)
    assert entered == {"record_function": 0, "enter_new": 0}


def test_search_epoch_spans(epoch):
    _, spans = profiled(lambda: search_epoch(epoch, "1girl -smile"))
    parents = [s for s in spans if s[0] == "query.search"]
    assert len(parents) == 1
    assert children(spans, parents[0], "query.") == ["query.plan", "query.mask", "query.fetch", "query.rank"]


def test_search_epoch_batch_spans(epoch):
    _, spans = profiled(lambda: search_epoch_batch(epoch, QUERIES[:2]))
    parents = [s for s in spans if s[0] == "query.batch"]
    assert len(parents) == 1
    assert children(spans, parents[0], "query.") == [
        "query.plan", "query.mask", "query.plan", "query.mask",  # both queries enqueued
        "query.fetch",  # one wait for every query's words
        "query.fetch", "query.rank", "query.fetch", "query.rank",  # each unpacked and ranked
    ]


def test_sharded_search_spans(epoch):
    """On a mesh the names cover the same work as on one device: the shards'
    tables are planning, their launches the mask, the gather and the unpack
    the fetch."""
    mesh = make_mesh(data=8, model=1, devices=["cpu"] * 8)
    plain = search_epoch(epoch, "1girl -smile")
    out, spans = profiled(lambda: search_epoch(epoch, "1girl -smile", mesh=mesh))
    assert [(r.file_id, r.relevance) for r in out] == [(r.file_id, r.relevance) for r in plain]
    (parent,) = [s for s in spans if s[0] == "query.search"]
    assert children(spans, parent, "query.") == [
        "query.plan", "query.plan", "query.mask", "query.fetch", "query.fetch", "query.rank"]


def test_unshardable_fallback_spans(epoch):
    """A mesh that cannot shard the epoch serves on one device, its tables
    planned inside ``query.plan``, the first query and the memoized ones alike."""
    mesh = Mesh([["cpu"], ["cpu"], ["cpu"]])
    _UNSHARDABLE_VERDICTS.pop(epoch, None)
    _, spans = profiled(lambda: [search_epoch(epoch, "1girl", mesh=mesh) for _ in range(2)])
    parents = [s for s in spans if s[0] == "query.search"]
    assert len(parents) == 2
    for parent in parents:
        assert children(spans, parent, "query.") == [
            "query.plan", "query.plan", "query.mask", "query.fetch", "query.rank"]


def test_mesh_tagger_upload_span(batch):
    cfg = vit_config("tiny", image_size=64, patch_size=16, num_classes=48, dtype=torch.float32)
    tagger = WD14Tagger(labels=synthetic_labels(48), vit=cfg, fast_math=False, seed=3,
                        mesh=make_mesh(data=2, model=1, devices=["cpu"] * 2))
    _, spans = profiled(lambda: tagger.complete_batch_prepared(tagger.dispatch_batch_prepared(batch)))
    (dispatch,) = [s for s in spans if s[0] == "tagger.dispatch"]
    assert children(spans, dispatch, "tagger.") == ["tagger.upload"]


def test_tagger_spans(tagger, batch):
    _, spans = profiled(lambda: tagger.complete_batch_prepared(tagger.dispatch_batch_prepared(batch)))
    (dispatch,) = [s for s in spans if s[0] == "tagger.dispatch"]
    (complete,) = [s for s in spans if s[0] == "tagger.complete"]
    assert children(spans, dispatch, "tagger.") == ["tagger.upload"]
    assert children(spans, complete, "tagger.") == ["tagger.fetch", "tagger.select"]
    assert dispatch[2] <= complete[1]


def test_infer_batch_prepared_is_dispatch_then_complete(tagger, batch):
    _, spans = profiled(lambda: tagger.infer_batch_prepared(batch))
    assert [n for n, _, _ in spans if n.startswith("tagger.")] == [
        "tagger.dispatch", "tagger.upload", "tagger.complete", "tagger.fetch", "tagger.select"]


@pytest.fixture
def no_automatic_gc():
    """Only the collections a test asks for run."""
    gc.disable()
    yield
    gc.enable()


@pytest.mark.parametrize("generation,names", [(2, ["gc.gen2"]), (1, ["gc.gen1"]), (0, [])])
def test_gc_span(no_automatic_gc, generation, names):
    _, spans = profiled(lambda: gc.collect(generation))
    assert [n for n, _, _ in spans if n.startswith("gc.")] == names
    assert tracing._gc_record is None


def test_gc_span_without_profiler(no_automatic_gc, entered):
    gc.collect(2)
    gc.collect(1)
    assert entered["enter_new"] == 0 and tracing._gc_record is None


def test_answers_equal_with_and_without_profiler(epoch, tagger, batch):
    def answers():
        single = [[(r.file_id, r.relevance) for r in search_epoch(epoch, q)] for q in QUERIES]
        batched = [[(r.file_id, r.relevance) for r in page] for page in search_epoch_batch(epoch, QUERIES)]
        pipelined = tagger.complete_batch_prepared(tagger.dispatch_batch_prepared(batch))
        return single, batched, pipelined, tagger.infer_batch_prepared(batch)

    plain = answers()
    traced, spans = profiled(answers)
    assert traced == plain
    assert plain[0] == plain[1] and plain[2] == plain[3]
    assert sum(1 for n, _, _ in spans if n == "query.search") == len(QUERIES)
    assert any(r.tags for r in plain[2]) and any(plain[0])
