"""The readers of the program's spans (``tagger.*``, ``query.*``, ``gc.*``)
on hand-built traces: spans nested in the harness's, crossing the window's
edges, overlapping, and the query tail's grouping; ``None`` where the spans
are absent. Times are in milliseconds, written to the trace in ns."""

import json

import pytest

from ketbench.core import ROOT, RunRecord, Trace, load_reader, reduce_trace


def ms(*spans):
    return [(name, int(s * 1e6), int(e * 1e6)) for name, s, e in spans]


def run_of(trace):
    return RunRecord(correct=True, attempted=0, failed=0, e2e={}, checks={}, trace=trace)


def tag_trace():
    return Trace(
        window=(int(100e6), int(1100e6)),
        ops=ms(("k", 50, 150), ("k", 300, 400), ("k", 1050, 1200)),
        spans=ms(
            ("dispatch", 80, 260), ("tagger.dispatch", 90, 250), ("tagger.upload", 95, 130),
            ("complete", 258, 482), ("tagger.complete", 260, 480), ("tagger.fetch", 262, 420),
            ("gc.gen1", 430, 440), ("tagger.select", 420, 478),
            ("dispatch", 499, 701), ("tagger.dispatch", 500, 700), ("tagger.upload", 510, 560),
            ("gc.gen2", 600, 650), ("gc.gen1", 640, 660),
            ("complete", 719, 991), ("tagger.complete", 720, 990), ("tagger.fetch", 722, 900),
            ("tagger.select", 900, 985),
            ("dispatch", 999, 1160), ("tagger.dispatch", 1000, 1150), ("tagger.upload", 1010, 1030),
            ("gc.gen2", 1090, 1300), ("gc.gen2", 1200, 1250),
        ),
    )


def query_trace():
    spans = [("query.search", -50, 5), ("query.plan", -40, -38), ("query.rank", -10, 3)]
    t = 10
    for _ in range(18):  # short queries: 10 ms, plan 2, rank 5
        spans += [("search", t - 1, t + 11), ("query.search", t, t + 10), ("query.plan", t, t + 2),
                  ("query.rank", t + 5, t + 10)]
        t += 20
    spans += [("query.search", 500, 600), ("query.plan", 500, 505), ("query.rank", 560, 590),
              ("query.search", 800, 900), ("query.plan", 800, 801), ("query.rank", 850, 900),
              ("gc.gen2", 855, 895), ("gc.gen1", 100, 150)]
    return Trace(window=(0, int(1000e6)), ops=ms(("k", 10, 11)), spans=ms(*spans))


# (metric, trace, hand-computed value)
EXPECTED = [
    # clipped durations 150, 200, 100
    ("tag.dispatch_ms", tag_trace, 150.0),
    # clipped 30, 50, 20
    ("tag.upload_ms", tag_trace, 30.0),
    ("tag.fetch_wait_ms", tag_trace, (158 + 178) / 2),
    ("tag.select_ms", tag_trace, (58 + 85) / 2),
    # dispatch open over [100, 250], [500, 700], [1000, 1100]; the device busy over
    # [100, 150], [300, 400], [1050, 1100]: 100 + 200 + 50 of 1000
    ("device_idle.tag.dispatch", tag_trace, 35.0),
    # 10 + the union [600, 660] + [1090, 1100] of 1000; the span past the window left out
    ("host.gc_share.tag", tag_trace, 8.0),
    # 18 plans of 2, then 5 and 1 (the one at [-40, -38] lies before the window)
    ("query.plan_ms", query_trace, 2.0),
    # the clipped 3, 18 of 5, then 30 and 50
    ("query.rank_ms", query_trace, 5.0),
    # durations 5, 18 x 10, 100, 100: the 95th percentile is 100, so the tail
    # is the two long searches: (30 + 50) / 200
    ("query.tail_rank_share", query_trace, 40.0),
    # [100, 150] and [855, 895] of 1000
    ("host.gc_share.query", query_trace, 9.0),
]
NEW = [name for name, _, _ in EXPECTED]


@pytest.mark.parametrize("metric,trace,value", EXPECTED, ids=NEW)
def test_reader_reads_the_hand_computed_value(metric, trace, value):
    assert load_reader(metric)(run_of(trace())) == pytest.approx(value, rel=1e-9)


@pytest.mark.parametrize("metric", NEW)
def test_reader_reads_nothing_without_its_spans(metric):
    read = load_reader(metric)
    assert read(run_of(None)) is None
    harness_only = Trace(window=(0, int(1e9)), ops=ms(("k", 1, 2)),
                         spans=ms(("dispatch", 5, 20), ("complete", 30, 40), ("search", 50, 60)))
    assert read(run_of(harness_only)) is None
    for trace in (tag_trace(), query_trace()):  # the spans, but no device operation (a CPU run)
        trace.ops = []
        assert read(run_of(trace)) is None


def test_tail_share_counts_only_children_inside_the_tail():
    trace = query_trace()
    # a rank span of a short search, and one straddling a long search's end
    trace.spans += ms(("query.rank", 590, 610))
    assert load_reader("query.tail_rank_share")(run_of(trace)) == pytest.approx(40.0)


def test_new_entries_have_readers_and_name_existing_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"] for w in bench["workloads"]}
    entries = {m["name"]: m for m in bench["per_layer"]}
    moves = {"tag_images_per_s": ["vit-tag", "swin-tag"], "query_p95_ms": ["vit-query"]}
    for name in NEW:
        m = entries[name]
        assert (ROOT / "ketbench" / "metrics" / f"{name}.py").is_file()
        assert m["source"] == "program_span" and set(m["workloads"]) <= cells
        assert m["workloads"] == moves[m["moves"]]


def test_reduce_trace_keeps_the_program_spans():
    """The port's spans reach ``Trace.spans`` through the harness's reduction."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from kobato_eyes_tpu_torch.utils.tracing import span

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("window"):
            with record_function("search"), span("query.search"):
                with span("query.rank"):
                    torch.ones(2).sum()
    names = [n for n, _, _ in reduce_trace(prof).spans]
    assert names.count("query.search") == 1 and names.count("query.rank") == 1 and "search" in names
