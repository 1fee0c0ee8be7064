"""Tagging traffic: letterboxed batches through the tagger's pipelined pair.

Set-up letterboxes ``batches`` x ``batch_size`` seeded pictures with the
port's ``prepare_batch_from_rgb`` and drops the sources. The window is a
closed loop, batch after batch in turn: ``dispatch_batch_prepared``, and once
``pipeline_depth`` batches are in flight ``complete_batch_prepared`` of the
oldest, as the tag stage drives them; the last ones are completed before it
closes. The window keeps only a reservoir of ``check_batches`` completions
drawn from the seed (and the count of rows), so that the harness holds no
growing heap there; afterwards those completions are held to the plain
reference, which makes and letterboxes their pictures again. Set-up's objects
are frozen out of the collector's passes before the window opens.
"""

from __future__ import annotations

import gc
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ketbench import check, images, model, weights
from ketbench.core import RunContext, RunRecord
from ketbench.reference.pictures import letterbox


def reference_logits(cfg: dict, state: dict, pictures: np.ndarray, device: str, precision: str = "float32") -> np.ndarray:
    from ketbench.reference.swinv2 import swin_logits
    from ketbench.reference.vit import vit_logits

    fn = vit_logits if cfg["reference"] == "vit" else swin_logits
    return fn(state, cfg, torch.from_numpy(pictures).to(device), precision=precision).double().cpu().numpy()


def sources(ctx: RunContext, mix: dict) -> np.ndarray:
    count = mix["batches"] * ctx.config["batch_size"]
    fixed = images.picture_sizes(count, *mix["long_side"], *mix["aspect"])
    return images.assign_sizes(ctx.seed_words(), fixed)


def run(ctx: RunContext) -> RunRecord:
    cfg, mix, device = ctx.config, ctx.traffic, ctx.device
    bs = cfg["batch_size"]
    names, cats = weights.label_table(cfg)
    thr = weights.threshold_vector(cfg, cats)
    with ctx.part("weights"):
        state = weights.make_state(cfg, weights.model_shapes(cfg), cats, ctx.torch_seed(0), device)
    with ctx.part("tagger"):
        tagger = model.build_tagger(cfg, state, names, cats, device)

    shapes = sources(ctx, mix)
    seed_words = ctx.seed_words()

    def prepared(i: int) -> np.ndarray:
        return tagger.prepare_batch_from_rgb([images.picture(seed_words, i, *map(int, shapes[i]))])[0]

    with ctx.part("inputs"), ThreadPoolExecutor(max_workers=mix["threads"]) as pool:
        batches = [np.stack(list(pool.map(prepared, range(b * bs, (b + 1) * bs)))) for b in range(mix["batches"])]
    n = len(batches)
    depth = mix["pipeline_depth"]

    def closed_loop(deadline: float | None, count: int | None, keep) -> int:
        inflight: deque = deque()
        k = 0
        while (deadline is None or time.perf_counter() < deadline) and (count is None or k < count):
            with ctx.span("dispatch"):
                handle = tagger.dispatch_batch_prepared(batches[k % n])
            inflight.append((k % n, handle))
            k += 1
            if len(inflight) >= depth:
                j, handle = inflight.popleft()
                with ctx.span("complete"):
                    out = tagger.complete_batch_prepared(handle)
                keep(j, ctx.apply_fault("tag_rows", model.result_rows(out)))
        while inflight:
            j, handle = inflight.popleft()
            with ctx.span("complete"):
                out = tagger.complete_batch_prepared(handle)
            keep(j, ctx.apply_fault("tag_rows", model.result_rows(out)))
        return k

    with ctx.part("warm"):
        closed_loop(None, mix["warm_batches"], lambda j, rows: None)
    ctx.host_spans.clear()
    sample = Reservoir(mix["check_batches"], ctx.seed_words(3))
    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    gc.collect()
    gc.freeze()
    try:
        with ctx.window():
            t0 = time.perf_counter()
            dispatched = closed_loop(t0 + ctx.seconds, None, sample.offer)
            elapsed = time.perf_counter() - t0
    finally:
        gc.unfreeze()
    peak = torch.cuda.max_memory_allocated() if device.startswith("cuda") else 0
    done = sample.rows
    del tagger, batches
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()

    with ctx.span("reference"):
        numbers, extra = check_tags(ctx, state, names, cats, thr, shapes, sample.kept)
    limits = {**mix["check_limits"], **cfg["check_limits"]}
    checks = {k: (numbers[k], limits[k]) for k in ("logit_gap", "bad_rows", "rows_missing")}
    return RunRecord(
        correct=all(v <= lim for v, lim in checks.values()),
        attempted=dispatched * bs, failed=dispatched * bs - done,
        e2e={"tag_images_per_s": done / elapsed},
        checks=checks,
        counters={"forwards": sample.seen, "batch_size": bs, "window_s": elapsed,
                  "tags_per_row": numbers["tags_per_row"], **extra},
        host_spans=ctx.host_spans, config=cfg, memory_peak_bytes=peak,
    )


class Reservoir:
    """A uniform sample of ``size`` of the completions offered, drawn from
    ``seed_words`` (Algorithm R), with the count of completions and rows."""

    def __init__(self, size: int, seed_words: list[int]) -> None:
        self.size, self.rng = size, np.random.default_rng(seed_words)
        self.kept: list[tuple[int, list]] = []
        self.seen = self.rows = 0

    def offer(self, batch: int, rows: list) -> None:
        self.rows += len(rows)
        if len(self.kept) < self.size:
            self.kept.append((batch, rows))
        else:
            slot = int(self.rng.integers(0, self.seen + 1))
            if slot < self.size:
                self.kept[slot] = (batch, rows)
        self.seen += 1


def check_tags(ctx, state, names, cats, thr, shapes, completed):
    """The sampled completions against the reference; with ``ctx.calibrate``
    also the control's and the planted faults' readings."""
    cfg = ctx.config
    bs = cfg["batch_size"]
    seed_words = ctx.seed_words()
    batches, ref, low = [], [], []
    for j, got in sorted(completed, key=lambda c: c[0]):
        pics = np.stack([
            letterbox(images.picture(seed_words, i, *map(int, shapes[i])), cfg["image_size"])
            for i in range(j * bs, (j + 1) * bs)
        ])
        batches.append(got)
        ref.append(reference_logits(cfg, state, pics, ctx.device))
        if ctx.calibrate:
            low.append(reference_logits(cfg, state, pics, ctx.device, precision="fp8"))

    def compare(answers: list[list]) -> dict[str, float]:
        rows = [r for got in answers for r in got[:bs]]
        kept = np.concatenate([r[: len(got)] for r, got in zip(ref, answers)])
        numbers = check.compare_tag_rows(rows, kept, names, cats, thr, cfg["topk_cap"])
        numbers["rows_missing"] = float(sum(max(bs - len(got), 0) for got in answers))
        return numbers

    numbers = compare(batches)
    extra = {}
    if low:
        extra["control"] = compare([check.select_rows(lo, names, cats, thr, cfg["topk_cap"]) for lo in low])
        extra["faults"] = {
            "answer_altered": compare([check.alter_one_answer(batches[0])] + batches[1:]),
            "half_batch_left_out": compare([check.half_batch_left_out(batches[0])] + batches[1:]),
        }
    return numbers, extra
