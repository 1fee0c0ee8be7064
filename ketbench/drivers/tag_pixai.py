"""PixAI tagging traffic: centre-cropped batches through the PixAI tagger's
pipelined pair, on its EVA02 backbone.

The tagging driver's traffic (``drivers/tag.py``: its seeded picture sizes,
closed loop at ``pipeline_depth`` and seeded reservoir of ``check_batches``
completions) through a ``PixaiTagger`` over ``models/eva02.py``: set-up
writes a ``preprocess.json`` with the configuration's mean and std, builds
the tagger on the card with the harness's weights and a label table whose
characters link by ``ips`` to copyright names, and prepares the pictures
with the tagger's own ``prepare_batch_from_rgb`` (short side scaled, centre
cut). The window runs ``dispatch_batch_prepared`` / ``complete_batch_prepared``
under the spans ``dispatch`` and ``complete``. Afterwards the sampled
completions are held to the plain reference (``reference/eva02.py``) under
PixAI's semantics (``check_pixai.py``).
"""

from __future__ import annotations

import gc
import json
import tempfile
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ketbench import check, check_pixai, images, weights
from ketbench.core import RunContext, RunRecord
from ketbench.drivers.tag import Reservoir, sources
from ketbench.model import _DTYPES, result_rows
from ketbench.reference.pixai_pictures import shortside_centercrop
from kobato_eyes_tpu_torch.models.eva02 import EVA02, EVA02Config

CATEGORY_IDS = {"general": 0, "character": 4}


def label_table(cfg: dict) -> check_pixai.PixaiTable:
    """General tags, then characters (``cfg["labels"]`` gives the counts);
    character i links by ``ips`` to ``series_{i mod copyrights}``."""
    counts = cfg["labels"]
    n_series = cfg["copyrights"]
    names = [f"tag_{i:04d}" for i in range(counts["general"])]
    names += [f"chara_{i:04d}_(series_{i % n_series:04d})" for i in range(counts["character"])]
    cats = np.concatenate([np.full(counts[k], CATEGORY_IDS[k]) for k in ("general", "character")]).astype(np.int32)
    if len(names) != cfg["num_labels"]:
        raise ValueError(f"label counts sum to {len(names)}, not {cfg['num_labels']}")
    first = counts["general"]
    ips = {first + i: (f"series_{i % n_series:04d}",) for i in range(counts["character"])}
    return check_pixai.PixaiTable(
        names=names, cats=cats, ips=ips,
        thresholds={int(k): float(v) for k, v in cfg["thresholds"].items()}, floor=float(cfg["score_floor"]),
        limits={int(k): int(v) for k, v in cfg["max_tags"].items()}, cap=int(cfg["topk_cap"]),
    )


def head_bias(cfg: dict, table: check_pixai.PixaiTable, seed: int) -> np.ndarray:
    """(num_labels,) float32 head bias (``cfg["head_bias"]``): fixed values
    (``weights.HEAD_STREAM``), placed on labels in the seed's order: ``sure``
    labels well over their category's threshold, ``borderline`` ones just
    under it, the rest far under."""
    spec = cfg["head_bias"]
    values = np.random.default_rng(weights.HEAD_STREAM)
    order = np.random.default_rng(seed)
    thr = table.threshold_vector()
    thr_logit = np.log(thr) - np.log1p(-thr)
    bias = np.full(len(table.cats), spec["rest"], dtype=np.float64)
    for name, cat in CATEGORY_IDS.items():
        labels = np.nonzero(table.cats == cat)[0]
        labels = labels[order.permutation(len(labels))]
        sure, border = spec["sure"][name], spec["borderline"][name]
        bias[labels[:sure]] = values.uniform(*spec["sure_bias"][name], sure)
        near = labels[sure : sure + border]
        bias[near] = thr_logit[near] - values.uniform(*spec["borderline_below_threshold"], border)
    return bias.astype(np.float32)


def port_config(cfg: dict) -> EVA02Config:
    """The port's ``EVA02Config`` for the configuration file (its LayerNorm
    eps, RoPE grid and temperature are the model's constants, which the
    file states for the reference)."""
    return EVA02Config(
        image_size=cfg["image_size"], patch_size=cfg["patch_size"], hidden_dim=cfg["hidden_size"],
        depth=cfg["num_hidden_layers"], num_heads=cfg["num_attention_heads"], mlp_hidden=cfg["intermediate_size"],
        num_classes=cfg["num_labels"], dtype=_DTYPES[cfg["dtype"]], param_dtype=_DTYPES[cfg["param_dtype"]],
        attn_impl=cfg["attn_impl"],
    )


AFFINE_STREAM = 1  # the biases' and norm scales' draw, apart from the matrices'
AFFINE_SCALE = 0.3


def make_state(cfg: dict, table: check_pixai.PixaiTable, seed: int, device: str) -> dict[str, torch.Tensor]:
    """The harness's weights (``weights.make_state``) for the port's EVA02
    names and shapes, the head's bias from :func:`head_bias`. Every other
    vector (the q, v, projection, SwiGLU and patch biases, each LayerNorm's
    bias and scale, the class token) is moved off its init by
    N(0, ``AFFINE_SCALE``) drawn from the seed in one call, so that a term
    the port adds in the wrong place, or leaves out, changes the answers."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in EVA02(port_config(cfg)).state_dict().items()}
    state = weights.make_state(cfg, {k: s for k, s in shapes.items() if k != "head.bias"}, table.cats, seed, device)
    state["head.bias"] = torch.from_numpy(head_bias(cfg, table, seed)).to(device)
    vectors = [k for k, s in shapes.items() if k not in ("head.bias", "pos_embed") and (len(s) == 1 or k == "cls_token")]
    sizes = [state[k].numel() for k in vectors]
    gen = torch.Generator(device=device).manual_seed(
        int(np.random.default_rng([seed, AFFINE_STREAM]).integers(0, 2**63 - 1)))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32).mul_(AFFINE_SCALE)
    for key, moved in zip(vectors, flat.split(sizes)):
        state[key].add_(moved.view_as(state[key]))
    return state


def build_tagger(cfg: dict, state: dict, table: check_pixai.PixaiTable, device: str, preprocess_json: Path):
    """A ``PixaiTagger`` on ``device`` over the EVA02 backbone, holding a
    copy of ``state``; its modules are built on the device."""
    from kobato_eyes_tpu_torch.models.base import TagCategory
    from kobato_eyes_tpu_torch.models.labels import TagMeta
    from kobato_eyes_tpu_torch.models.tagger import PixaiTagger

    labels = [TagMeta(name=n, category=TagCategory(int(c)), ips=table.ips.get(i, ()))
              for i, (n, c) in enumerate(zip(table.names, table.cats))]
    with torch.device(device):
        return PixaiTagger(
            eva02=port_config(cfg), labels=labels, params=state, thresholds=table.thresholds,
            max_tags=table.limits, score_floor=table.floor, topk_cap=table.cap,
            preprocess_json=preprocess_json, fast_math=False, device=device,
        )


def write_preprocess_json(cfg: dict, folder: Path) -> Path:
    """PixAI's transform as a ``preprocess.json`` stage list: resize and crop
    to the model's size, then the configuration's mean and std."""
    path = folder / "preprocess.json"
    size = cfg["image_size"]
    path.write_text(json.dumps({"stages": [
        {"type": "resize", "size": size}, {"type": "crop", "size": size},
        {"type": "normalize", "mean": cfg["mean"], "std": cfg["std"]},
    ]}), encoding="utf-8")
    return path


def reference_logits(cfg: dict, state: dict, pictures: np.ndarray, device: str, precision: str = "float32") -> np.ndarray:
    from ketbench.reference.eva02 import eva02_logits

    return eva02_logits(state, cfg, torch.from_numpy(pictures).to(device), precision=precision).double().cpu().numpy()


def run(ctx: RunContext) -> RunRecord:
    cfg, mix, device = ctx.config, ctx.traffic, ctx.device
    bs = cfg["batch_size"]
    table = label_table(cfg)
    with ctx.part("weights"):
        state = make_state(cfg, table, ctx.torch_seed(0), device)
    with ctx.part("tagger"), tempfile.TemporaryDirectory(prefix="ketbench_pixai_") as tmp:
        tagger = build_tagger(cfg, state, table, device, write_preprocess_json(cfg, Path(tmp)))

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
                keep(j, ctx.apply_fault("tag_rows", result_rows(out)))
        while inflight:
            j, handle = inflight.popleft()
            with ctx.span("complete"):
                out = tagger.complete_batch_prepared(handle)
            keep(j, ctx.apply_fault("tag_rows", result_rows(out)))
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
        numbers, extra = check_tags(ctx, state, table, shapes, sample.kept)
    limits = {**mix["check_limits"], **cfg["check_limits"]}
    checks = {k: (numbers[k], limits[k]) for k in ("logit_gap", "bad_rows", "rows_missing")}
    return RunRecord(
        correct=all(v <= lim for v, lim in checks.values()),
        attempted=dispatched * bs, failed=dispatched * bs - done,
        e2e={"tag_images_per_s": done / elapsed},
        checks=checks,
        counters={"forwards": sample.seen, "batch_size": bs, "window_s": elapsed,
                  "tags_per_row": numbers["tags_per_row"],
                  "copyright_rows_per_row": numbers["copyright_rows_per_row"], **extra},
        host_spans=ctx.host_spans, config=cfg, memory_peak_bytes=peak,
    )


def check_tags(ctx, state, table, shapes, completed):
    """The sampled completions against the reference; with ``ctx.calibrate``
    also the control's and the planted faults' readings."""
    cfg = ctx.config
    bs = cfg["batch_size"]
    seed_words = ctx.seed_words()
    batches, ref, low = [], [], []
    for j, got in sorted(completed, key=lambda c: c[0]):
        pics = np.stack([
            shortside_centercrop(images.picture(seed_words, i, *map(int, shapes[i])), cfg["image_size"])
            for i in range(j * bs, (j + 1) * bs)
        ])
        batches.append(got)
        ref.append(reference_logits(cfg, state, pics, ctx.device))
        if ctx.calibrate:
            low.append(reference_logits(cfg, state, pics, ctx.device, precision="fp8"))

    def compare(answers: list[list]) -> dict[str, float]:
        rows = [r for got in answers for r in got[:bs]]
        kept = np.concatenate([r[: len(got)] for r, got in zip(ref, answers)])
        numbers = check_pixai.compare_pixai_rows(rows, kept, table)
        numbers["rows_missing"] = float(sum(max(bs - len(got), 0) for got in answers))
        return numbers

    numbers = compare(batches)
    extra = {}
    if low:
        extra["control"] = compare([check_pixai.select_rows(lo, table) for lo in low])
        extra["faults"] = {
            "answer_altered": compare([check.alter_one_answer(batches[0])] + batches[1:]),
            "half_batch_left_out": compare([check.half_batch_left_out(batches[0])] + batches[1:]),
            "copyright_dropped": compare([check_pixai.drop_one_copyright(batches[0])] + batches[1:]),
        }
    return numbers, extra
