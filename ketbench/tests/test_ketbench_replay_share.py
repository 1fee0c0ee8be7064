"""``tag.replay_share``: the tagger's ``tagger.replay`` spans over its
``tagger.dispatch`` spans in the traced window, on hand-built traces; nothing
for a program that opens no ``tagger.replay`` span (the parent of the
captured dispatch) and nothing for a run with no device operation."""

import json

from ketbench.core import ROOT, RunRecord, Trace, load_reader


def ms(*spans):
    return [(name, int(s * 1e6), int(e * 1e6)) for name, s, e in spans]


def run_of(trace):
    return RunRecord(correct=True, attempted=0, failed=0, e2e={}, checks={}, trace=trace)


def trace(replayed):
    """Four dispatches, one before the window; ``replayed`` of them replay."""
    spans = []
    for k, t in enumerate((-100, 100, 400, 800)):
        spans += [("dispatch", t - 1, t + 61), ("tagger.dispatch", t, t + 60), ("tagger.upload", t + 1, t + 5)]
        if k < replayed:
            spans.append(("tagger.replay", t + 6, t + 58))
    return Trace(window=(0, int(1000e6)), ops=ms(("k", 10, 90)), spans=ms(*spans))


def test_share_of_the_window_dispatches_that_replayed():
    read = load_reader("tag.replay_share")
    assert read(run_of(trace(4))) == 100.0
    assert read(run_of(trace(3))) == 100.0 * 2 / 3  # the replay before the window is left out
    assert read(run_of(trace(2))) == 100.0 * 1 / 3


def test_nothing_without_replay_spans_or_device_operations():
    read = load_reader("tag.replay_share")
    assert read(run_of(trace(0))) is None
    assert read(run_of(trace(1))) is None  # its one replay lies before the window
    assert read(run_of(None)) is None
    cpu = trace(4)
    cpu.ops = []
    assert read(run_of(cpu)) is None


def test_entry_reads_the_tagging_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (entry,) = [m for m in bench["per_layer"] if m["name"] == "tag.replay_share"]
    assert entry == {"name": "tag.replay_share", "unit": "%", "better": "higher", "source": "program_span",
                     "layer": "tagger", "moves": "tag_images_per_s", "workloads": ["vit-tag", "swin-tag"]}
