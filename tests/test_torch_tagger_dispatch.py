"""The tagger's dispatch / complete pair (``models/graph_dispatch.py``).

On the CPU every dispatch runs eager; the CUDA graph's capture and replay
run on the card (``chip_smoke.py``'s ``tagger_graph_phase``). Here: the
packing of a batch's result, the interleaved pipeline against
``infer_batch_prepared``, the pinned slots' free list, the capture rule, the
bounded cache of graphs, the launch counters a replay adds, and the tagger's
counters.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import types

import numpy as np
import pytest
import torch

from kobato_eyes_tpu_torch.models import graph_dispatch as gd
from kobato_eyes_tpu_torch.models.labels import synthetic_labels
from kobato_eyes_tpu_torch.models.preprocess import PreprocessSpec, mean_std_on_device, normalize_on_device
from kobato_eyes_tpu_torch.models.tagger import PixaiTagger, WD14Tagger
from kobato_eyes_tpu_torch.models.vit import vit_config

torch.set_num_threads(1)

N_LABELS = 48
CUDA, CPU = torch.device("cuda", 0), torch.device("cpu")


def _tagger(cls):
    labels = synthetic_labels(N_LABELS)
    ips = {17: ("tag_23",), 34: ("tag_23", "tag_46")}
    labels = [dataclasses.replace(m, ips=ips.get(i, ())) for i, m in enumerate(labels)]
    cfg = vit_config("tiny", image_size=32, patch_size=16, num_classes=N_LABELS, dtype=torch.float32)
    return cls(labels=labels, vit=cfg, fast_math=False, seed=5, device="cpu", topk_cap=16)


def _batch(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(n, 32, 32, 3), dtype=np.uint8)


@pytest.mark.parametrize("carry", ["pack", "fetch"])
@pytest.mark.parametrize("batch", [1, 5, 32])
def test_pack_unpack_round_trip_is_exact(batch, carry):
    """``pack`` then ``unpack``, or ``fetch`` (the two in one call, through
    the host), gives back every array bit for bit in its dtype and shape."""
    rng = np.random.default_rng(batch)
    scores = rng.random((batch, 128), dtype=np.float32)
    scores[:, 100:] = -np.inf
    scores[0, 0] = np.float32(0.35)  # a threshold's own f32 value
    idx = rng.integers(0, 2**53, size=(batch, 128), dtype=np.int64)
    hits = rng.integers(0, 9083, size=(batch,), dtype=np.int32)
    tensors = [torch.from_numpy(a) for a in (scores, idx, hits)]
    if carry == "fetch":
        got = gd.fetch(tensors)
    else:
        flat, layout = gd.pack(tensors)
        assert flat.dtype == torch.float64 and flat.numel() == scores.size + idx.size + hits.size
        got = gd.unpack(flat.numpy(), layout)
        flat.fill_(0)  # the arrays are copies: the slot may be written again
    for want, have in zip((scores, idx, hits), got):
        assert have.dtype == want.dtype and have.shape == want.shape
        np.testing.assert_array_equal(have, want)


@pytest.mark.parametrize("cls", [WD14Tagger, PixaiTagger], ids=["wd14", "pixai"])
def test_interleaved_dispatch_at_depth_3_equals_infer(cls):
    """5 batches of mixed sizes, 3 in flight, a thresholds override from the
    third: each completion is what ``infer_batch_prepared`` returns alone."""
    tagger = _tagger(cls)
    sizes = [3, 1, 4, 3, 2]
    override = {0: 0.45, 4: 0.2}
    calls = [(_batch(n, i), None if i < 2 else override, {4: 1} if i == 3 else None) for i, n in enumerate(sizes)]
    want = [tagger.infer_batch_prepared(b, thresholds=t, max_tags=m) for b, t, m in calls]
    assert any(r.tags for rows in want for r in rows)
    got, inflight = [], []
    for b, t, m in calls:
        inflight.append(tagger.dispatch_batch_prepared(b, thresholds=t, max_tags=m))
        if len(inflight) == 3:
            got.append(tagger.complete_batch_prepared(inflight.pop(0)))
    got += [tagger.complete_batch_prepared(h) for h in inflight]
    assert got == want
    assert [len(rows) for rows in got] == sizes


def test_slot_pool_never_hands_out_a_slot_in_flight():
    pool = gd.SlotPool(pinned=False)
    held = [pool.acquire(8) for _ in range(3)]
    assert len({s.data_ptr() for s in held}) == 3
    pool.release(held[1])
    again = pool.acquire(8)
    assert again is held[1]
    fresh = [pool.acquire(8) for _ in range(2)]
    assert not any(f is h for f in fresh for h in (held[0], held[2], again))
    other = pool.acquire(4)
    assert other.numel() == 4 and other.dtype == torch.float64


def test_completion_returns_its_slot_once():
    pool = gd.SlotPool(pinned=False)
    slot = pool.acquire(3)
    slot.copy_(torch.tensor([1.0, 2.0, 7.0]))
    done = gd.InFlight(slot, (((2,), np.dtype(np.float32)), ((1,), np.dtype(np.int32))), None, pool)
    first = done.wait()
    assert [a.tolist() for a in first] == [[1.0, 2.0], [7]]
    done.wait()
    assert pool.acquire(3) is slot
    assert pool.acquire(3) is not slot  # released once, so handed out once
    for _ in range(gd.MAX_FREE_SLOTS + 4):
        pool.release(torch.empty(3, dtype=torch.float64))
    assert len(pool._free) == gd.MAX_FREE_SLOTS


@pytest.mark.parametrize(
    "device,on_mesh,ran_here,captured,mode",
    [
        (CPU, False, False, False, "eager"),
        (CPU, False, True, False, "eager"),
        (CUDA, True, True, False, "eager"),
        (CUDA, False, False, False, "eager"),
        (CUDA, False, True, False, "capture"),
        (CUDA, False, False, True, "replay"),
    ],
    ids=["cpu-first", "cpu-later", "mesh", "first-sighting-on-this-thread", "second-sighting", "captured"],
)
def test_capture_rule(device, on_mesh, ran_here, captured, mode):
    assert gd.dispatch_mode(device, on_mesh, ran_here, captured) == mode


def test_graph_cache_is_bounded_least_recently_used_dropped():
    graphs = gd.BatchGraphs(CPU, on_mesh=False)
    ran = []

    def dispatch(key):
        return graphs.dispatch(
            key, None, upload=lambda batch: batch, work=lambda _: (ran.append(key) or torch.zeros(1),)
        ).wait()

    for key in range(gd.MAX_GRAPHS):
        dispatch(key)
    dispatch(0)  # touched: now the most recent
    dispatch("new")
    assert len(graphs._entries) == gd.MAX_GRAPHS
    assert list(graphs._entries) == [2, 3, 0, "new"]
    assert graphs.eager_dispatches == len(ran) == gd.MAX_GRAPHS + 2


def test_each_thread_runs_a_key_eager_before_it_may_capture():
    """The thread that captures must have run the key eager (its cuBLAS
    handle and the like are made there, never inside a capture)."""
    graphs = gd.BatchGraphs(CPU, on_mesh=False)
    run = lambda: graphs.dispatch("k", None, upload=lambda b: b, work=lambda _: (torch.ones(2),)).wait()  # noqa: E731
    run()
    other = threading.Thread(target=run)
    other.start()
    other.join(timeout=60)
    assert not other.is_alive()
    assert graphs._entries["k"].eager_threads == {threading.get_ident(), other.ident}


def test_replays_add_the_launches_a_capture_counted(monkeypatch):
    fake = types.ModuleType("kobato_eyes_tpu_torch.ops._fake")
    fake.launches, fake.variant_launches, fake.MAX_WIDTH, fake.counted = 5, {"a": 1, "b": 0}, 64, True
    monkeypatch.setitem(sys.modules, fake.__name__, fake)
    before = gd.launch_counts()
    assert before[(fake.__name__, "launches", None)] == 5 and (fake.__name__, "counted", None) not in before
    fake.launches += 12  # what a capture's wrappers count
    fake.variant_launches["b"] += 12
    moved = gd.counts_moved(before, gd.launch_counts())
    assert moved == {(fake.__name__, "launches", None): 12, (fake.__name__, "variant_launches", "b"): 12}
    gd.add_counts(moved, -1)
    assert (fake.launches, fake.variant_launches) == (5, {"a": 1, "b": 0})
    gd.add_counts(moved)
    gd.add_counts(moved)
    assert (fake.launches, fake.variant_launches) == (29, {"a": 1, "b": 24})
    fake.launches, fake.variant_launches = 0, dict.fromkeys(fake.variant_launches, 0)  # a caller's reset
    gd.add_counts(moved)
    assert (fake.launches, fake.variant_launches) == (12, {"a": 0, "b": 12})


def test_tagger_counters_on_the_cpu():
    tagger = _tagger(WD14Tagger)
    assert (tagger.graph_captures, tagger.graph_replays, tagger.eager_dispatches) == (0, 0, 0)
    for i in range(3):
        tagger.infer_batch_prepared(_batch(2, i))
    tagger.complete_batch_prepared(tagger.dispatch_batch_prepared(torch.from_numpy(_batch(2, 9))))
    assert (tagger.graph_captures, tagger.graph_replays, tagger.eager_dispatches) == (0, 0, 4)


def test_thresholds_buffer_follows_the_values_asked_for():
    tagger = _tagger(WD14Tagger)
    default = tagger._thr_vec(None)
    buf = tagger._thr_dev(default)
    assert torch.equal(buf, torch.from_numpy(default))
    override = tagger._thr_vec({0: 0.9})
    assert tagger._thr_dev(override) is buf and torch.equal(buf, torch.from_numpy(override))
    copied = tagger._thr_copied
    tagger._thr_dev(override.copy())  # equal values: nothing copied
    assert tagger._thr_copied is copied
    assert torch.equal(tagger._thr_dev(default), torch.from_numpy(default))


def test_pixai_mean_std_made_once_equal_per_call():
    spec = PreprocessSpec(mode="pixai", size=8, mean=(0.5, 0.4, 0.3), std=(0.2, 0.25, 0.3))
    batch = torch.from_numpy(_batch(2, 3)[:, :8, :8])
    assert torch.equal(normalize_on_device(batch, spec, mean_std_on_device(spec, "cpu")),
                       normalize_on_device(batch, spec))
    tagger = _tagger(PixaiTagger)
    assert tagger._mean_std is not None and _tagger(WD14Tagger)._mean_std is None
