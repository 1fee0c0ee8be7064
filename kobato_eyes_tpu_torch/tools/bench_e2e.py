"""Combined-pipeline E2E at scale (BASELINE config 5 proxy).

Counterpart of the repository's ``tools/bench_e2e.py``: drives the WHOLE
port at --images N (default 5000) real image files with a per-phase wall
ledger:

  gen      synthesize the library (low-frequency random PNGs: distinct
           pHashes, planted duplicate pairs every 10th file as JPEG re-save
           + brightness variant) — cached per (N, seed), reused across runs
  index    scan -> ViT tagger (on ``cuda`` its fast forward: the
           hand-written attention kernel) -> catalog write -> embed stage
           -> epoch
  dup      dup scan from the catalog + CPU-reference cluster parity
           + planted-pair containment check
  query    device search p50 over a small workload on the built epoch
  ann      flat/HNSW build from stored embeddings + self-recall@1
  refresh  add/remove files -> refresh_root -> delta epoch swap

Prints ONE JSON document with phase seconds + assertions' outcomes::

    python -m kobato_eyes_tpu_torch.tools.bench_e2e [--device cpu]

``--workdir`` defaults to ``ket_e2e`` under the temporary directory
(``TMPDIR``). The embedder draws its random weights from the port's own
seed, so the stored vectors are not the JAX tool's; the ``checks`` are.
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

from kobato_eyes_tpu_torch.device import resolve_device


def _gen_library(root: Path, n: int, seed: int) -> dict:
    """Low-frequency random images: distinct pHashes, smooth enough that a
    q92 JPEG re-save stays within a few hash bits (the planted duplicate)."""
    from PIL import Image, ImageEnhance

    marker = root / f".complete_{n}_{seed}"
    if marker.exists():
        return json.loads(marker.read_text())
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    planted: list[tuple[str, str]] = []
    n_base = 0
    i = 0
    while n_base < n:
        low = rng.integers(0, 256, size=(12, 12, 3), dtype=np.uint8)
        img = Image.fromarray(low).resize((320, 320), Image.Resampling.BILINEAR)
        base = root / f"img_{i:06d}.png"
        img.save(base)
        n_base += 1
        if i % 10 == 0 and n_base < n:
            dup = root / f"img_{i:06d}_copy.jpg"
            img.save(dup, quality=92)
            planted.append((base.name, dup.name))
            n_base += 1
        if i % 20 == 0 and n_base < n:
            var = root / f"img_{i:06d}_bright.png"
            ImageEnhance.Brightness(img).enhance(1.06).save(var)
            planted.append((base.name, var.name))
            n_base += 1
        i += 1
    info = {"n": n_base, "planted": planted}
    marker.write_text(json.dumps(info))
    return info


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--images", type=int, default=5000)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--workdir", default=str(Path(tempfile.gettempdir()) / "ket_e2e"))
    parser.add_argument("--labels", type=int, default=9083)
    parser.add_argument("--tagger-preset", default="base")
    parser.add_argument("--tagger-size", type=int, default=448)
    parser.add_argument("--keep-db", action="store_true",
                        help="reuse the workdir catalog (skip the index phase "
                             "if already complete)")
    parser.add_argument("--cached-retag", action="store_true",
                        help="after indexing, force-retag twice with the "
                             "prepared-input cache (cold fill + warm timed)")
    parser.add_argument("--no-fused-embed", action="store_true",
                        help="disable the fused tag+embed dispatch (A/B lane: "
                             "the embed stage decodes+uploads on its own)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    work = Path(args.workdir)
    lib = work / f"lib_{args.images}_{args.seed}"
    db = work / "catalog.sqlite"
    phases: dict[str, float] = {}
    checks: dict[str, object] = {}

    t0 = time.perf_counter()
    info = _gen_library(lib, args.images, args.seed)
    phases["gen_s"] = round(time.perf_counter() - t0, 2)

    from kobato_eyes_tpu_torch.bench import synchronize
    from kobato_eyes_tpu_torch.core.config.schema import (
        IndexSettings,
        PipelineSettings,
        Settings,
    )
    from kobato_eyes_tpu_torch.core.pipeline import run_index_once
    from kobato_eyes_tpu_torch.db.connection import bootstrap, reset_bootstrap_cache
    from kobato_eyes_tpu_torch.models.labels import synthetic_labels
    from kobato_eyes_tpu_torch.models.tagger import WD14Tagger
    from kobato_eyes_tpu_torch.models.vit import vit_config
    from kobato_eyes_tpu_torch.query.engine import EpochManager, search_epoch

    if not args.keep_db and db.exists():
        reset_bootstrap_cache()
        db.unlink()
        for suffix in ("-wal", "-shm"):
            Path(str(db) + suffix).unlink(missing_ok=True)

    settings = Settings(
        pipeline=PipelineSettings(
            roots=[lib], batch_size=args.batch_size, io_workers=4,
        ),
        index=IndexSettings(
            enabled=True, preset="tiny", image_size=64, patch_size=16,
            embed_dim=64, fused=not args.no_fused_embed,
        ),
    )
    tagger = WD14Tagger(
        labels=synthetic_labels(args.labels),
        vit=vit_config(
            args.tagger_preset, image_size=args.tagger_size,
            num_classes=args.labels,
        ),
        image_size=args.tagger_size,
        device=device,
    )

    epochs = EpochManager(device=device)
    t0 = time.perf_counter()
    stats = run_index_once(db, settings, tagger, epoch_manager=epochs, device=device)
    synchronize(device)
    phases["index_s"] = round(time.perf_counter() - t0, 2)
    phases["index_stage_walls"] = stats.extra.get("stage_walls", {})
    phases["index_tag_infer_s"] = stats.extra.get("tag_infer_s")
    checks["indexed"] = {"scanned": stats.scanned, "tagged": stats.tagged,
                         "written": stats.written, "epoch": stats.epoch_version,
                         "embedded_fused": stats.extra.get("embedded_fused"),
                         "embedded": stats.extra.get("embedded")}
    assert stats.scanned == info["n"], (stats.scanned, info["n"])
    assert stats.tagged == stats.written
    phases["index_imgs_per_s"] = round(info["n"] / phases["index_s"], 1)

    # ---- cached re-index: is a RE-tag device-bound? -------------------
    # Two forced retag passes with the prepared-input cache: the first fills
    # the cache (decode + npz save), the second measures the warm cache-hit
    # path, which skips decode+resize for unchanged files.
    if args.cached_retag:
        from kobato_eyes_tpu_torch.core.pipeline.maintenance import retag_all

        cache_dir = work / "input_cache"
        settings_cached = Settings(
            pipeline=PipelineSettings(
                roots=[lib], batch_size=args.batch_size, io_workers=4,
                tagger_input_cache=True, input_cache_dir=cache_dir,
            ),
            index=settings.index,
        )
        retag_all(db, force=True)
        t0 = time.perf_counter()
        st1 = run_index_once(db, settings_cached, tagger, epoch_manager=epochs, device=device)
        synchronize(device)
        phases["retag_coldcache_s"] = round(time.perf_counter() - t0, 2)

        retag_all(db, force=True)
        t0 = time.perf_counter()
        st2 = run_index_once(db, settings_cached, tagger, epoch_manager=epochs, device=device)
        synchronize(device)
        phases["retag_warmcache_s"] = round(time.perf_counter() - t0, 2)
        phases["retag_warmcache_imgs_per_s"] = round(
            info["n"] / phases["retag_warmcache_s"], 1
        )
        checks["cached_retag"] = {
            "cold_tagged": st1.tagged, "warm_tagged": st2.tagged,
        }
        assert st1.tagged == st2.tagged == info["n"], (st1.tagged, st2.tagged)

    # ---- dup scan from the catalog -----------------------------------
    from kobato_eyes_tpu_torch.db.repository import (
        iter_files_for_dup,
        missing_signature_ids,
        upsert_signatures,
    )
    from kobato_eyes_tpu_torch.dup.cpu_ref import CpuDuplicateScanner
    from kobato_eyes_tpu_torch.dup.engine import TpuDuplicateScanner, cluster_ids
    from kobato_eyes_tpu_torch.dup.types import DuplicateFileMeta, DuplicateScanConfig
    from kobato_eyes_tpu_torch.sig.signatures import compute_signatures

    conn = bootstrap(db)
    try:
        t0 = time.perf_counter()
        missing = missing_signature_ids(conn)
        if missing:
            batch = compute_signatures(missing, io_workers=4, device=device)
            with conn:
                upsert_signatures(conn, zip(batch.file_ids, batch.phash, batch.dhash))
        phases["signatures_s"] = round(time.perf_counter() - t0, 2)
        rows = iter_files_for_dup(conn)
    finally:
        conn.close()
    metas = [
        DuplicateFileMeta(
            file_id=int(r["id"]), path=Path(r["path"]), size=r["size"],
            width=r["width"], height=r["height"], phash=r["phash_u64"],
        )
        for r in rows if r["phash_u64"] is not None
    ]
    cfg = DuplicateScanConfig(hamming_threshold=8)
    scanner = TpuDuplicateScanner(cfg, device=device)
    scanner.build_clusters(metas, files_token="e2e")  # warm
    t0 = time.perf_counter()
    clusters = scanner.build_clusters(metas, files_token="e2e")
    synchronize(device)
    phases["dup_scan_s"] = round(time.perf_counter() - t0, 3)

    t0 = time.perf_counter()
    cpu_clusters = CpuDuplicateScanner(cfg).build_clusters(metas)
    phases["dup_cpu_ref_s"] = round(time.perf_counter() - t0, 2)
    assert cluster_ids(clusters) == cluster_ids(cpu_clusters), "cluster parity"

    name_to_cluster: dict[str, int] = {}
    for ci, cl in enumerate(clusters):
        for e in cl.files:
            name_to_cluster[e.file.path.name] = ci
    hit = sum(
        1 for a, b in info["planted"]
        if name_to_cluster.get(a) is not None
        and name_to_cluster.get(a) == name_to_cluster.get(b)
    )
    checks["dup"] = {
        "clusters": len(clusters),
        "planted_pairs": len(info["planted"]),
        "planted_clustered": hit,
    }
    assert hit >= 0.95 * len(info["planted"]), checks["dup"]

    # ---- query latency on the live epoch -----------------------------
    epoch = epochs.current
    workload = ["1girl", "1girl -solo", "category:general score>=0.5"]
    for q in workload:
        search_epoch(epoch, q, limit=200)  # warm
    times = []
    for _ in range(10):
        for q in workload:
            t0 = time.perf_counter()
            search_epoch(epoch, q, limit=200)
            times.append((time.perf_counter() - t0) * 1000)
    phases["query_p50_ms"] = round(float(np.percentile(times, 50)), 2)

    # ---- ANN from stored embeddings ----------------------------------
    from kobato_eyes_tpu_torch.core.pipeline.embed_stage import load_embeddings
    from kobato_eyes_tpu_torch.index.flat import FlatIndex
    from kobato_eyes_tpu_torch.index.hnsw import HnswIndex

    conn = bootstrap(db)
    try:
        ids, vecs = load_embeddings(conn)
    finally:
        conn.close()
    assert len(ids) >= 0.99 * info["n"], (len(ids), info["n"])
    t0 = time.perf_counter()
    flat = FlatIndex(vecs, ids, device=device)
    hnsw = HnswIndex(dim=vecs.shape[1])
    hnsw.add(vecs, ids)
    synchronize(device)
    phases["ann_build_s"] = round(time.perf_counter() - t0, 2)
    probe = np.random.default_rng(0).choice(
        len(ids), size=min(64, len(ids)), replace=False
    )
    t0 = time.perf_counter()
    _, flat_ids = flat.search(vecs[probe], k=10)
    synchronize(device)
    phases["ann_query_s"] = round(time.perf_counter() - t0, 3)
    self_recall = float(np.mean([ids[p] in row for p, row in zip(probe, flat_ids)]))
    _, hnsw_ids = hnsw.search(vecs[probe], k=10)
    hnsw_recall = float(np.mean([ids[p] in row for p, row in zip(probe, hnsw_ids)]))
    checks["ann"] = {"vectors": int(len(ids)), "flat_self_recall": self_recall,
                     "hnsw_self_recall": hnsw_recall}
    assert self_recall == 1.0, checks["ann"]

    # ---- incremental refresh: add 25, remove 10 ----------------------
    from PIL import Image

    from kobato_eyes_tpu_torch.core.pipeline.maintenance import refresh_root

    rng = np.random.default_rng(args.seed + 1)
    for k in range(25):
        low = rng.integers(0, 256, size=(12, 12, 3), dtype=np.uint8)
        Image.fromarray(low).resize((320, 320), Image.Resampling.BILINEAR).save(
            lib / f"new_{k:03d}.png"
        )
    removed = sorted(lib.glob("img_00001*.png"))[:10]
    for p in removed:
        p.unlink()
    version_before = epochs.current.version
    t0 = time.perf_counter()
    rstats = refresh_root(db, settings, tagger, lib, epoch_manager=epochs, device=device)
    synchronize(device)
    phases["refresh_s"] = round(time.perf_counter() - t0, 2)
    checks["refresh"] = {
        "tagged": rstats.tagged, "missing": rstats.missing,
        "epoch": rstats.epoch_version,
    }
    assert rstats.tagged == 25, rstats.tagged
    assert rstats.missing == len(removed), (rstats.missing, len(removed))
    assert epochs.current.version == version_before + 1

    # the phases' walls; a rate (``*_per_s``) is no wall, though the JAX tool
    # adds its images/s into this sum
    total = sum(v for k, v in phases.items() if k.endswith("_s") and not k.endswith("_per_s"))
    print(json.dumps({
        "metric": "e2e_pipeline_5k",
        "images": info["n"],
        "phases": phases,
        "imgs_per_s_index": round(info["n"] / phases["index_s"], 1),
        "total_s": round(total, 1),
        "checks": checks,
    }))
    # cleanup the refresh mutations so a --keep-db rerun starts consistent
    for k in range(25):
        (lib / f"new_{k:03d}.png").unlink(missing_ok=True)
    (lib / f".complete_{args.images}_{args.seed}").unlink(missing_ok=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
