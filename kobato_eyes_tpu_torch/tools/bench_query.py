"""Query-engine latency benchmark: device posting lists vs SQL fallback.

Counterpart of the repository's ``tools/bench_query.py`` (BASELINE.md metric
3: query p50 latency). Builds a synthetic catalog (default 70k files,
Zipf-ish tag distribution over a 10k-tag vocabulary), snapshots it into a
device epoch, then times a mixed query workload on both backends (asserting
that they agree), the whole workload as one batch, the mask evaluation
alone and the first queries after an epoch swap. Prints one JSON document::

    python -m kobato_eyes_tpu_torch.tools.bench_query [--device cpu]

``dispatch_only_ms`` is the device's share: 50 chained mask evaluations
(``query/engine._mask_words``) between two CUDA events, the host's copy and
ranking tail left out (on the CPU, the host clock around the chain).
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from kobato_eyes_tpu_torch.device import resolve_device

QUERY_WORKLOAD = [
    "tag_0",
    "tag_1 tag_3",
    "tag_0 OR tag_7",
    "tag_2 -tag_9",
    "( tag_1 OR tag_4 ) tag_0 -tag_50",
    "category:character",
    "category:character score>=0.5",
    "score>=0.9",
    "tag_12 AND NOT ( tag_30 OR tag_31 )",
    "unknown_tag OR tag_5",
]


def build_catalog(db_path: Path, n_files: int, n_tags: int, seed: int = 0) -> None:
    from kobato_eyes_tpu_torch.db.connection import bootstrap
    from kobato_eyes_tpu_torch.db.repository import TaggingItem, upsert_file, write_tagging_batch
    from kobato_eyes_tpu_torch.models.base import TagCategory

    rng = np.random.default_rng(seed)
    conn = bootstrap(db_path)
    try:
        cats = np.where(
            rng.random(n_tags) < 0.85, int(TagCategory.GENERAL),
            rng.choice([1, 2, 3, 4, 5], size=n_tags),
        )
        # Zipf-ish popularity: tag_k appears with prob ~ 1/(k+2)
        popularity = 1.0 / (np.arange(n_tags) + 2.0)
        popularity *= 30.0 / popularity.sum()  # ~30 tags/file on average

        items = []
        t0 = time.perf_counter()
        with conn:
            for i in range(n_files):
                fid = upsert_file(
                    conn, path=f"/bench/{i:07d}.png", size=1000 + i, mtime=1e9 + (i % 997)
                )
                hit = rng.random(n_tags) < popularity
                idx = np.nonzero(hit)[0]
                tags = [
                    (f"tag_{k}", float(rng.uniform(0.1, 1.0)), int(cats[k])) for k in idx
                ]
                items.append(TaggingItem(fid, tags, tagger_sig="bench"))
                if len(items) >= 2000:
                    write_tagging_batch(conn, items)
                    items.clear()
            if items:
                write_tagging_batch(conn, items)
        print(f"catalog built in {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    finally:
        conn.close()


def _chain_ms(fn, n: int, device: torch.device) -> float:
    """Milliseconds a call of ``fn`` over ``n`` chained calls: between two
    CUDA events on the card, by the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1000 / n


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--files", type=int, default=70_000)
    parser.add_argument("--tags", type=int, default=10_000)
    parser.add_argument("--repeats", type=int, default=20)
    parser.add_argument("--db", help="reuse an existing bench catalog")
    parser.add_argument(
        "--orders-only", action="store_true",
        help="skip the mixed workload; only time a broad query under every "
             "order_by (path-rank scaling proof: path must stay within 2x of "
             "mtime at 1M files)",
    )
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from kobato_eyes_tpu_torch.bench import synchronize
    from kobato_eyes_tpu_torch.db.connection import bootstrap
    from kobato_eyes_tpu_torch.db.repository import search_files
    from kobato_eyes_tpu_torch.query.ast import extract_positive_tag_terms
    from kobato_eyes_tpu_torch.query.engine import build_epoch, search_epoch
    from kobato_eyes_tpu_torch.query.sql import normalize_thresholds, translate_query

    tmp = None
    if args.db:
        db = Path(args.db)
        if not db.exists():
            build_catalog(db, args.files, args.tags)
    else:
        tmp = tempfile.mkdtemp(prefix="ket_bench_query_")
        db = Path(tmp) / "bench.sqlite"
        build_catalog(db, args.files, args.tags)

    conn = bootstrap(db)
    try:
        t0 = time.perf_counter()
        epoch = build_epoch(conn, device=device)
        synchronize(device)
        build_s = time.perf_counter() - t0

        if args.orders_only:
            broad = "tag_0"  # most popular tag: ~half the catalog hits
            order_stats = {}
            for order in ("relevance", "mtime", "path", "id"):
                t0 = time.perf_counter()
                hits = search_epoch(epoch, broad, order_by=order, limit=200)
                warm_ms = (time.perf_counter() - t0) * 1000  # incl. rank build
                times = []
                for _ in range(args.repeats):
                    t0 = time.perf_counter()
                    search_epoch(epoch, broad, order_by=order, limit=200)
                    times.append((time.perf_counter() - t0) * 1000)
                order_stats[order] = {
                    "p50_ms": round(float(np.percentile(times, 50)), 3),
                    "first_ms": round(warm_ms, 3),
                    "rows": len(hits),
                }
            print(json.dumps({
                "metric": "query_order_by_p50_ms",
                "files": args.files,
                "orders": order_stats,
                "path_vs_mtime": (
                    round(order_stats["path"]["p50_ms"] / order_stats["mtime"]["p50_ms"], 2)
                    if order_stats["mtime"]["p50_ms"] > 0 else None
                ),
            }))
            return 0

        thr = normalize_thresholds({})
        # warmup both backends
        for q in QUERY_WORKLOAD:
            search_epoch(epoch, q, limit=200)
            frag = translate_query(q, thresholds={})
            search_files(conn, frag.where, frag.params,
                         positive_tags=extract_positive_tag_terms(q),
                         thresholds=thr, limit=200, hydrate=False)

        device_ms: list[float] = []
        sql_ms: list[float] = []
        mismatch = 0
        for _ in range(args.repeats):
            for q in QUERY_WORKLOAD:
                t0 = time.perf_counter()
                dev = search_epoch(epoch, q, limit=200)
                device_ms.append((time.perf_counter() - t0) * 1000)
                frag = translate_query(q, thresholds={})
                t0 = time.perf_counter()
                sql = search_files(conn, frag.where, frag.params,
                                   positive_tags=extract_positive_tag_terms(q),
                                   thresholds=thr, limit=200, hydrate=False)
                sql_ms.append((time.perf_counter() - t0) * 1000)
                if [r.file_id for r in dev] != [r.file_id for r in sql]:
                    mismatch += 1
        assert mismatch == 0, f"{mismatch} backend mismatches"

        # --- batched multi-query dispatch: the whole workload in ONE call,
        # one copy for every mask; identity with the singles asserted
        from kobato_eyes_tpu_torch.query.engine import search_epoch_batch

        batched = search_epoch_batch(epoch, QUERY_WORKLOAD, limit=200)  # warm
        for q, rows in zip(QUERY_WORKLOAD, batched):
            solo = search_epoch(epoch, q, limit=200)
            assert [r.file_id for r in rows] == [r.file_id for r in solo], q
        batch_walls = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            search_epoch_batch(epoch, QUERY_WORKLOAD, limit=200)
            batch_walls.append((time.perf_counter() - t0) * 1000)
        batched_amortized_ms = float(np.percentile(batch_walls, 50)) / len(
            QUERY_WORKLOAD
        )

        # --- dispatch-only latency: chained mask evaluations, the copy to
        # the host and the ranking tail left out
        from kobato_eyes_tpu_torch.query.ast import parse_query
        from kobato_eyes_tpu_torch.query.engine import _mask_words, _slot_tables_np

        thr_n = normalize_thresholds({})
        disp_ms: list[float] = []
        n_chain = 50
        for q in QUERY_WORKLOAD:
            tabs = _slot_tables_np(epoch, parse_query(q), thr_n)
            _mask_words(epoch, tabs)  # warm
            synchronize(device)
            disp_ms.append(_chain_ms(lambda: _mask_words(epoch, tabs), n_chain, device))

        # post-epoch-swap cost: rebuild the epoch (a fresh object) and time
        # the FIRST run of each query
        t0 = time.perf_counter()
        epoch2 = build_epoch(conn, version=2, device=device)
        synchronize(device)
        swap_build_s = time.perf_counter() - t0
        first_ms: list[float] = []
        for q in QUERY_WORKLOAD:
            t0 = time.perf_counter()
            search_epoch(epoch2, q, limit=200)
            first_ms.append((time.perf_counter() - t0) * 1000)

        d = np.asarray(device_ms)
        s = np.asarray(sql_ms)
        f = np.asarray(first_ms)
        print(json.dumps({
            "metric": "query_p50_ms_70k",
            "value": round(float(np.percentile(d, 50)), 3),
            "unit": "ms",
            "vs_baseline": round(float(np.percentile(s, 50)) / float(np.percentile(d, 50)), 2),
            "files": args.files,
            "epoch_build_s": round(build_s, 2),
            "device_ms": {"p50": round(float(np.percentile(d, 50)), 3),
                          "p95": round(float(np.percentile(d, 95)), 3)},
            "sql_ms": {"p50": round(float(np.percentile(s, 50)), 3),
                       "p95": round(float(np.percentile(s, 95)), 3)},
            "batched_amortized_ms_per_query": round(batched_amortized_ms, 3),
            "dispatch_only_ms": {
                "p50": round(float(np.percentile(disp_ms, 50)), 3),
                "max": round(float(max(disp_ms)), 3),
            },
            "post_swap_first_query_ms": {
                "p50": round(float(np.percentile(f, 50)), 3),
                "max": round(float(f.max()), 3),
                "epoch_rebuild_s": round(swap_build_s, 2),
            },
        }))
    finally:
        conn.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
