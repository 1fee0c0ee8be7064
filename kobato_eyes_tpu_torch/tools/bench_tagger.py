"""Tagger throughput benchmark (reference ``tools/bench.py tagger`` parity).

Counterpart of the repository's ``tools/bench_tagger.py``: end-to-end
images/sec through the tagger forward + device top-k + host selection,
excluding the warmup batches, and p50/p95 of per-batch device and
postprocess time. On ``cuda`` the tagger runs its fast forward
(``fast_math``: the hand-written attention kernel, ``attn_impl="pallas"``).

Usage:
    python -m kobato_eyes_tpu_torch.tools.bench_tagger --synthetic 512 --batch-size 32
    python -m kobato_eyes_tpu_torch.tools.bench_tagger --images DIR --tagger wd14
    python -m kobato_eyes_tpu_torch.tools.bench_tagger --device cpu --preset tiny ...

``roofline.flops`` is the analytic ``vit_forward_flops`` (a SwinV2 tagger's
is the counted cost), held against the card's published peak (``mfu``; null
on the CPU). ``roofline.compiled_flops_scan_body`` keeps the JAX tool's key
for the FLOPs that ``utils/profiling.compiled_cost`` counts over the
operators one forward dispatches: the hand-written kernels launched through
``ops/build.py`` are no torch operators, so on the card it leaves out the
attention's products (on the CPU the plain attention is counted).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from kobato_eyes_tpu_torch.device import resolve_device


def _percentiles(values: list[float]) -> dict[str, float]:
    if not values:
        return {"p50": 0.0, "p95": 0.0, "mean": 0.0}
    arr = np.asarray(values)
    return {
        "p50": float(np.percentile(arr, 50)),
        "p95": float(np.percentile(arr, 95)),
        "mean": float(arr.mean()),
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--images", help="directory of real images")
    parser.add_argument("--synthetic", type=int, default=0, help="use N synthetic images")
    parser.add_argument("--tagger", choices=["wd14", "pixai"], default="wd14")
    parser.add_argument("--preset", default="base", help="ViT preset (tiny/small/base/large)")
    parser.add_argument("--labels", type=int, default=8192)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--image-size", type=int, default=448)
    parser.add_argument("--warmup-batches", type=int, default=1)
    parser.add_argument(
        "--bf16-params", action="store_true",
        help="inference-only bf16 weights (no per-layer casts)",
    )
    parser.add_argument(
        "--profile",
        metavar="DIR",
        help="capture a torch.profiler trace of the timed loop into DIR",
    )
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from kobato_eyes_tpu_torch.bench import synchronize
    from kobato_eyes_tpu_torch.models.labels import synthetic_labels
    from kobato_eyes_tpu_torch.models.tagger import PixaiTagger, WD14Tagger, fetch
    from kobato_eyes_tpu_torch.models.vit import vit_config

    if args.tagger == "pixai" and args.labels == 8192:
        args.labels = 13461  # reference PixAI label count (model_inspection.py:15)

    cls = WD14Tagger if args.tagger == "wd14" else PixaiTagger
    tagger = cls(
        labels=synthetic_labels(args.labels),
        vit=vit_config(args.preset, image_size=args.image_size, num_classes=args.labels),
        image_size=args.image_size,
        bf16_params=args.bf16_params,
        device=device,
    )

    # ---- inputs: fixed order (reference bench uses deterministic selection)
    rng = np.random.default_rng(0)
    if args.images:
        from kobato_eyes_tpu_torch.utils.image_io import load_rgb_array

        paths = sorted(Path(args.images).rglob("*"))[:2048]
        arrays = [a for p in paths if (a := load_rgb_array(p)) is not None]
    else:
        n = args.synthetic or 256
        arrays = [
            rng.integers(0, 256, size=(args.image_size, args.image_size, 3), dtype=np.uint8)
            for _ in range(n)
        ]
    if len(arrays) < args.batch_size * (args.warmup_batches + 1):
        print(f"need at least {args.batch_size * (args.warmup_batches + 1)} images", file=sys.stderr)
        return 2

    # ---- prepared batches up front (isolate device-side throughput; the
    # loader path is benchmarked by the pipeline bench)
    batches = []
    prep_times = []
    for start in range(0, len(arrays) - args.batch_size + 1, args.batch_size):
        t0 = time.perf_counter()
        batches.append(tagger.prepare_batch_from_rgb(arrays[start : start + args.batch_size]))
        prep_times.append(time.perf_counter() - t0)

    # -- per-batch latency (blocking) on a few batches ----------------------
    infer_times: list[float] = []
    post_times: list[float] = []
    thr = tagger._thr_vec_np
    limits = dict(tagger.max_tags)
    for i, batch in enumerate(batches[: args.warmup_batches + 3]):
        t0 = time.perf_counter()
        probs = tagger.forward_probs(batch)
        synchronize(device)
        t1 = time.perf_counter()
        tagger._select_host(fetch(tagger._select_device(probs, thr, limits)), limits, None)
        t2 = time.perf_counter()
        if i < args.warmup_batches:
            continue
        infer_times.append((t1 - t0) * 1000)
        post_times.append((t2 - t1) * 1000)

    # -- throughput (pipelined): dispatch every batch, then drain ----------
    # the forwards queue on the stream back to back; one copy at the end
    from kobato_eyes_tpu_torch.utils.profiling import device_trace

    timed = batches[args.warmup_batches :] or batches
    with device_trace(args.profile):
        t0 = time.perf_counter()
        all_results = tagger.infer_batches_prepared(timed)
        synchronize(device)
        elapsed = time.perf_counter() - t0
    total_imgs = sum(len(r) for r in all_results)
    imgs_per_s = total_imgs / elapsed if elapsed > 0 else 0.0

    # -- roofline: analytic forward FLOPs against the measured device time
    # and the card's published peak (MFU) ----------------------------------
    from kobato_eyes_tpu_torch.models.vit import ViTConfig, vit_forward_flops
    from kobato_eyes_tpu_torch.utils.profiling import compiled_cost, roofline_summary

    cost = compiled_cost(tagger.forward_probs, batches[0])
    roofline = None
    if infer_times:
        flops = (
            vit_forward_flops(tagger.cfg, batches[0].shape[0])
            if isinstance(tagger.cfg, ViTConfig)
            else cost.get("flops", 0.0)
        )
        if flops:
            roofline = roofline_summary(flops, np.median(infer_times) / 1000.0, device=device)
            roofline["compiled_flops_scan_body"] = cost.get("flops")
            roofline = {
                k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in roofline.items()
            }

    print(json.dumps({
        "metric": f"{args.tagger}_tagging_images_per_sec",
        "value": round(imgs_per_s, 3),
        "unit": "imgs/s",
        "batch_size": args.batch_size,
        "image_size": args.image_size,
        "labels": args.labels,
        "preset": args.preset,
        "batches_timed": len(infer_times),
        "infer_ms": _percentiles(infer_times),
        "post_ms": _percentiles(post_times),
        "prep_ms": _percentiles([t * 1000 for t in prep_times]),
        "roofline": roofline,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
