"""Command-line interface of the PyTorch/CUDA port.

Counterpart of ``kobato_eyes_tpu/cli.py``, all 19 commands: ``index``
(scan + tag + write, with fused signatures and, with
``index.enabled``, fused CLIP embeddings), ``refresh`` and ``retag`` (the
upkeep flows), ``watch`` (tag files as they appear), ``search`` over the
device query engine (the default backend) or SQL, with CSV export and result
copying, ``repl`` (queries against a resident epoch), ``dup`` (duplicate
scan, sweep, refinement, cohesion audit, export, trash), ``stats``,
``complete``, ``thresholds``, ``trash``, ``reset``, ``config``, ``ann``
(build / query the CLIP ANN index, find-similar over stored vectors),
``import-weights`` (a .pt/.pth/.safetensors/.onnx file -> the port's
checkpoint directory, which ``tagger.model_path`` and ``index.checkpoint``
name), ``inspect`` and ``validate-checkpoint`` (import -> exact-vs-fast
parity -> tag flips; the CLIP embedder's lane), ``serve`` (the JSON API
over a resident epoch) and ``train`` (fine-tune a ViT tagger on the
library's own tags into a checkpoint directory ``tagger.model_path`` can
name).

Usage: ``python -m kobato_eyes_tpu_torch.cli [--device cuda|cpu] <command> ...``
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
import sys
import time
from pathlib import Path

from kobato_eyes_tpu_torch.core.config.schema import Settings
from kobato_eyes_tpu_torch.core.config.service import load_settings, save_settings
from kobato_eyes_tpu_torch.utils.paths import get_app_paths

logger = logging.getLogger(__name__)


def _setup_logging(verbose: bool) -> None:
    logging.basicConfig(
        level=logging.DEBUG if verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )


def _resolve_tagger(settings: Settings, device: str):
    """name -> tagger instance (reference core/pipeline/resolver.py:40)."""
    from kobato_eyes_tpu_torch.models.tagger import DummyTagger, PixaiTagger, WD14Tagger

    t = settings.tagger
    name = t.name.lower()
    if name == "dummy":
        return DummyTagger()
    cls = {"wd14": WD14Tagger, "pixai": PixaiTagger}.get(name)
    if cls is None:
        raise SystemExit(f"unknown tagger {t.name!r} (dummy | wd14 | pixai)")
    return cls(
        labels_path=t.labels_path,
        checkpoint_path=t.model_path,
        thresholds=t.thresholds,
        max_tags=t.max_tags,
        score_floor=t.score_floor,
        topk_cap=t.topk_cap,
        device=device,
    )


def _load_env(args) -> tuple[Settings, Path]:
    from kobato_eyes_tpu_torch.core.config.service import apply_env_overrides

    settings = apply_env_overrides(load_settings(args.config))
    paths = get_app_paths(args.data_dir or settings.data_dir).ensure()
    return settings, paths.db_path


def _progress_printer(progress) -> None:
    pct = f"{progress.fraction * 100:5.1f}%" if progress.total else "     "
    print(f"\r[{progress.phase.value:>6}] {pct} {progress.done}/{progress.total}",
          end="", file=sys.stderr, flush=True)


# -- commands ----------------------------------------------------------------


def cmd_index(args) -> int:
    settings, db = _load_env(args)
    if args.root:
        settings.pipeline.roots = [Path(r) for r in args.root]
    if not settings.pipeline.roots:
        raise SystemExit("no roots configured; pass --root or set pipeline.roots")
    from kobato_eyes_tpu_torch.core.pipeline import run_index_once

    tagger = _resolve_tagger(settings, args.device)
    stats = run_index_once(db, settings, tagger, progress=_progress_printer, device=args.device)
    print(file=sys.stderr)
    print(json.dumps(stats.__dict__, default=str))
    return 0


def cmd_refresh(args) -> int:
    settings, db = _load_env(args)
    from kobato_eyes_tpu_torch.core.pipeline.maintenance import refresh_root

    stats = refresh_root(
        db, settings, _resolve_tagger(settings, args.device), args.root,
        hard_delete=args.hard_delete, progress=_progress_printer, device=args.device,
    )
    print(file=sys.stderr)
    print(json.dumps(stats.__dict__, default=str))
    return 0


def cmd_retag(args) -> int:
    settings, db = _load_env(args)
    from kobato_eyes_tpu_torch.core.pipeline.fingerprint import current_tagger_sig
    from kobato_eyes_tpu_torch.core.pipeline.maintenance import retag_all, retag_selection

    if args.ids:
        stats = retag_selection(
            db, settings, _resolve_tagger(settings, args.device), args.ids, device=args.device
        )
        print(json.dumps(stats.__dict__, default=str))
        return 0
    sig = current_tagger_sig(_resolve_tagger(settings, args.device).signature_fields())
    cleared = retag_all(db, current_sig=sig, force=args.force)
    print(json.dumps({"cleared": cleared}))
    return 0


def cmd_search(args) -> int:
    settings, db = _load_env(args)
    from kobato_eyes_tpu_torch.db.connection import bootstrap
    from kobato_eyes_tpu_torch.db.repository import load_tag_thresholds, search_files, tags_for_files
    from kobato_eyes_tpu_torch.query.ast import extract_positive_tag_terms
    from kobato_eyes_tpu_torch.query.engine import search_epoch, search_epoch_batch
    from kobato_eyes_tpu_torch.query.sql import normalize_thresholds, translate_query

    queries: list[str] = args.query
    multi = len(queries) > 1
    db_mtime = _catalog_mtime(db)  # before this process's own connection touches -shm
    conn = bootstrap(db)
    try:
        thresholds = load_tag_thresholds(conn)
        t0 = time.perf_counter()
        if args.backend == "device":
            epoch = _load_or_build_epoch(conn, db_mtime, args)
            if multi:
                # every query's mask is enqueued before the batch waits once
                # for all of them (engine.search_epoch_batch)
                per_query = search_epoch_batch(
                    epoch, queries, thresholds=thresholds,
                    order_by=args.order, limit=args.limit, offset=args.offset,
                )
            else:
                per_query = [search_epoch(
                    epoch, queries[0], thresholds=thresholds,
                    order_by=args.order, limit=args.limit, offset=args.offset,
                )]
            grouped = [
                (q, [
                    {"file_id": r.file_id, "path": r.path, "relevance": r.relevance,
                     **({"query": q} if multi else {})}
                    for r in rows
                ])
                for q, rows in zip(queries, per_query)
            ]
        else:
            grouped = []
            for q in queries:
                frag = translate_query(q, thresholds=thresholds)
                rows = search_files(
                    conn, frag.where, frag.params,
                    positive_tags=extract_positive_tag_terms(q),
                    thresholds=normalize_thresholds(thresholds),
                    order_by=args.order, limit=args.limit, offset=args.offset,
                )
                grouped.append((q, [
                    {"file_id": r.file_id, "path": r.path, "relevance": r.relevance,
                     "tags": r.tags[:10], **({"query": q} if multi else {})}
                    for r in rows
                ]))
        results = [r for _, rows in grouped for r in rows]
        elapsed = time.perf_counter() - t0
        if args.export:
            out = _export_csv(args.export, results)
            print(f"exported {len(results)} rows to {out}", file=sys.stderr)
        if args.copy or args.copy_to:
            # "Copy results…" (reference ui/tags_db.py:36-126): copy the FULL
            # hit set of each query — not the displayed page — into a
            # per-query folder; collisions suffix _2/_3…, missing sources
            # count as failures without aborting the batch.
            from kobato_eyes_tpu_torch.utils.export import (
                copy_results, make_export_dir, sanitize_for_folder,
            )

            sr_root = get_app_paths(
                args.data_dir or settings.data_dir
            ).cache_dir / "search_results"
            for q, _rows in grouped:
                if args.backend == "device":
                    hits = search_epoch(
                        epoch, q, thresholds=thresholds,
                        order_by=args.order, limit=max(1, len(epoch.paths)),
                        offset=0,
                    )
                else:
                    frag = translate_query(q, thresholds=thresholds)
                    hits = search_files(
                        conn, frag.where, frag.params,
                        positive_tags=extract_positive_tag_terms(q),
                        thresholds=normalize_thresholds(thresholds),
                        order_by=args.order, limit=2**31 - 1, offset=0,
                        hydrate=False,
                    )
                if args.copy_to:
                    dest = Path(args.copy_to)
                    if multi:
                        dest = dest / sanitize_for_folder(q)
                else:
                    dest = make_export_dir(q, sr_root)
                ok, ng = copy_results([h.path for h in hits], dest)
                print(
                    f"copied {ok} file(s), {ng} failed -> {dest}"
                    + (f"  # query: {q}" if multi else ""),
                    file=sys.stderr,
                )
        for q, rows in grouped:
            if multi:
                print(f"# query: {q}")
            for r in rows:
                print(f"{r['relevance']:8.3f}  {r['path']}")
        ids = [r["file_id"] for r in results]
        if args.show_tags and args.backend == "device" and ids:
            for fid, tags in tags_for_files(conn, ids[: args.limit]).items():
                print(f"# {fid}: {', '.join(f'{n}:{s:.2f}' for n, s, _ in tags[:8])}")
        print(f"{len(results)} results in {elapsed * 1000:.1f} ms", file=sys.stderr)
    finally:
        conn.close()
    return 0


def _catalog_mtime(db: Path) -> float:
    """When the catalog last changed. WAL-mode commits land in db-wal without
    touching the main db file's mtime — freshness must consider both (plus
    -shm for completeness). Opening a connection creates or touches the side
    files, so this is read before the caller opens its own (the JAX package
    reads it after, and then never finds its snapshot fresh)."""
    return max(
        (p.stat().st_mtime for p in (db, Path(str(db) + "-wal"), Path(str(db) + "-shm"))
         if p.exists()),
        default=0.0,
    )


def _load_or_build_epoch(conn, db_mtime: float, args):
    """Reuse the on-disk epoch snapshot when it's newer than the catalog
    (``db_mtime`` from :func:`_catalog_mtime`); otherwise build fresh and
    refresh the snapshot (fast repeat searches). Either way the epoch lands
    on ``args.device``."""
    from kobato_eyes_tpu_torch.core.config.service import load_settings as _ls
    from kobato_eyes_tpu_torch.query.engine import build_epoch
    from kobato_eyes_tpu_torch.query.snapshot import load_epoch, save_epoch

    settings = _ls(args.config)
    snap = get_app_paths(args.data_dir or settings.data_dir).index_dir / "epoch.npz"
    try:
        if snap.exists() and snap.stat().st_mtime >= db_mtime:
            return load_epoch(snap, device=args.device)
    except (OSError, ValueError, KeyError) as exc:
        logger.warning("epoch snapshot unusable (%s); rebuilding", exc)
    epoch = build_epoch(conn, device=args.device)
    try:
        save_epoch(epoch, snap)
    except OSError as exc:
        logger.warning("failed to save epoch snapshot: %s", exc)
    return epoch


def _export_csv(dest: str, rows: list[dict]) -> Path:
    """Timestamped CSV export (reference utils/search_export.py semantics)."""
    base = Path(dest)
    if base.suffix != ".csv":
        base = base / f"search_{time.strftime('%Y%m%d_%H%M%S')}.csv"
    base.parent.mkdir(parents=True, exist_ok=True)
    with base.open("w", newline="", encoding="utf-8") as fh:
        writer = csv.writer(fh)
        keys = [k for k in rows[0] if k != "tags"] if rows else ["file_id", "path", "relevance"]
        writer.writerow(keys)
        for r in rows:
            writer.writerow([r.get(k) for k in keys])
    return base


def cmd_dup(args) -> int:
    settings, db = _load_env(args)
    from kobato_eyes_tpu_torch.db.connection import bootstrap
    from kobato_eyes_tpu_torch.db.repository import iter_files_for_dup, missing_signature_ids, upsert_signatures
    from kobato_eyes_tpu_torch.dup.engine import TpuDuplicateScanner
    from kobato_eyes_tpu_torch.dup.types import DuplicateFileMeta, DuplicateScanConfig
    from kobato_eyes_tpu_torch.sig.signatures import compute_signatures

    conn = bootstrap(db)
    try:
        missing = missing_signature_ids(conn)
        if missing:
            print(f"computing {len(missing)} missing signatures...", file=sys.stderr)
            batch = compute_signatures(
                missing, io_workers=settings.pipeline.io_workers, device=args.device
            )
            with conn:
                upsert_signatures(conn, zip(batch.file_ids, batch.phash, batch.dhash))
        rows = iter_files_for_dup(conn)
    finally:
        conn.close()

    metas = [
        DuplicateFileMeta(
            file_id=int(r["id"]), path=Path(r["path"]), size=r["size"],
            width=r["width"], height=r["height"], phash=r["phash_u64"],
        )
        for r in rows
        if r["phash_u64"] is not None
    ]
    cfg = DuplicateScanConfig(
        hamming_threshold=args.hamming if args.hamming is not None else settings.dup.hamming_threshold,
        band_bits=settings.dup.band_bits, band_count=settings.dup.band_count,
        size_ratio=args.size_ratio if args.size_ratio is not None else settings.dup.size_ratio,
        bucket_pair_cap=settings.dup.bucket_pair_cap,
    )
    # multi-device: shard the candidate compare over the configured mesh when
    # more than one device of --device's kind is visible (single-device runs
    # stay on the resident-scan path)
    import torch

    from kobato_eyes_tpu_torch.parallel import mesh as pmesh

    mesh = None
    devices = pmesh.visible_devices(torch.device(args.device).type)
    if len(devices) > 1:
        mesh = pmesh.make_mesh(
            data=settings.mesh.data_parallel, model=settings.mesh.model_parallel, devices=devices
        )
        if int(mesh.shape.get("data", 1)) > 1:
            # the scanner may still fall back to one device for pathological
            # bucket runs (ops/hamming.py logs that case)
            print(f"dup scan sharded over {mesh.shape} mesh", file=sys.stderr)
    scanner = TpuDuplicateScanner(cfg, mesh=mesh, device=args.device)
    if args.sweep:
        # interactive-slider workload: one scan, clusters for every threshold
        sweep = scanner.build_clusters_sweep(metas, range(0, cfg.hamming_threshold + 1))
        for t, cl in sweep.items():
            print(f"hamming<={t}: {len(cl)} clusters", file=sys.stderr)
        clusters = sweep[cfg.hamming_threshold]
    else:
        clusters = scanner.build_clusters(metas)

    if args.refine:
        from kobato_eyes_tpu_torch.dup.refine_clusters import refine_by_pixels, refine_by_tilehash

        r = settings.refine
        clusters = refine_by_tilehash(
            clusters, grid=r.grid, tile=r.tile, max_bits=r.max_bits,
            io_workers=settings.pipeline.io_workers, device=args.device,
        )
        clusters = refine_by_pixels(
            clusters, mae_thr=r.mae_threshold, thumb_size=r.mae_size,
            io_workers=settings.pipeline.io_workers, device=args.device,
        )

    if args.audit:
        from kobato_eyes_tpu_torch.dup.audit import audit_clusters, summarize

        print(summarize(audit_clusters(clusters, device=args.device)), file=sys.stderr)

    if args.trash_duplicates:
        # UI "trash checked" parity (dup_tab.py:816-836): non-keepers move to
        # the data-dir trash (reversible) and their rows go absent.
        from kobato_eyes_tpu_torch.db.repository import mark_files_absent
        from kobato_eyes_tpu_torch.utils.fs import append_trash_record, trash_file

        trash_dir = get_app_paths(args.data_dir or settings.data_dir).root / "trash"
        trashed_ids: list[int] = []
        for cluster in clusters:
            for entry in cluster.files:
                if entry.file.file_id == cluster.keeper_id:
                    continue
                dest = trash_file(entry.file.path, trash_dir=trash_dir)
                if dest is not None:
                    append_trash_record(
                        trash_dir, file_id=entry.file.file_id,
                        original=entry.file.path, trashed=dest,
                    )
                    trashed_ids.append(entry.file.file_id)
        if trashed_ids:
            conn = bootstrap(db)
            try:
                with conn:
                    mark_files_absent(conn, trashed_ids)
            finally:
                conn.close()
        print(f"trashed {len(trashed_ids)} duplicates -> {trash_dir}", file=sys.stderr)

    out_rows = []
    for ci, cluster in enumerate(clusters):
        for entry in cluster.files:
            out_rows.append({
                "cluster": ci, "file_id": entry.file.file_id,
                "keeper": int(entry.file.file_id == cluster.keeper_id),
                "hamming": entry.best_hamming, "path": str(entry.file.path),
            })
    if args.export:
        out = _export_csv(args.export, out_rows)
        print(f"exported {len(out_rows)} rows to {out}", file=sys.stderr)
    else:
        for row in out_rows:
            marker = "*" if row["keeper"] else " "
            print(f"{row['cluster']:5d} {marker} h={row['hamming']}  {row['path']}")
    print(f"{len(clusters)} clusters", file=sys.stderr)
    return 0


def cmd_stats(args) -> int:
    settings, db = _load_env(args)
    from kobato_eyes_tpu_torch.db.connection import bootstrap
    from kobato_eyes_tpu_torch.db.repository import load_tag_thresholds, tag_stats

    conn = bootstrap(db)
    try:
        rows = tag_stats(
            conn, category=args.category, name_like=args.filter,
            thresholds=load_tag_thresholds(conn), limit=args.limit,
        )
        if args.export:
            out = _export_csv(args.export, [
                {"name": r["name"], "category": r["category"],
                 "file_count": r["file_count"],
                 "avg_score": round(r["avg_score"], 4),
                 "max_score": round(r["max_score"], 4)}
                for r in rows
            ])
            print(f"exported {len(rows)} rows to {out}", file=sys.stderr)
        for r in rows:
            print(f"{r['file_count']:8d}  {r['avg_score']:.3f}  {r['max_score']:.3f}  "
                  f"[{r['category']}] {r['name']}")
    finally:
        conn.close()
    return 0


def cmd_complete(args) -> int:
    settings, db = _load_env(args)
    from kobato_eyes_tpu_torch.db.connection import bootstrap
    from kobato_eyes_tpu_torch.db.repository import autocomplete_tags

    conn = bootstrap(db)
    try:
        for name, cat, n in autocomplete_tags(conn, args.prefix, limit=args.limit):
            print(f"{name}\t{cat}\t{n}")
    finally:
        conn.close()
    return 0


def cmd_thresholds(args) -> int:
    settings, db = _load_env(args)
    from kobato_eyes_tpu_torch.db.connection import bootstrap
    from kobato_eyes_tpu_torch.db.repository import load_tag_thresholds, set_tag_threshold

    conn = bootstrap(db)
    try:
        if args.set:
            for pair in args.set:
                cat, _, value = pair.partition("=")
                set_tag_threshold(conn, int(cat), float(value))
        print(json.dumps(load_tag_thresholds(conn)))
    finally:
        conn.close()
    return 0


def cmd_train(args) -> int:
    """Fine-tune a tagger on the indexed library's own labels."""
    settings, db = _load_env(args)
    from kobato_eyes_tpu_torch.core.finetune import finetune_from_catalog

    out = args.out or str(
        get_app_paths(args.data_dir or settings.data_dir).ensure().index_dir
        / f"finetuned_{time.strftime('%Y%m%d_%H%M%S')}"
    )
    result = finetune_from_catalog(
        db,
        preset=args.preset, image_size=args.image_size, epochs=args.epochs,
        batch_size=args.batch_size, learning_rate=args.lr,
        min_tag_count=args.min_tag_count, limit=args.limit,
        io_workers=settings.pipeline.io_workers, checkpoint_out=out, device=args.device,
    )
    print(json.dumps({
        "files": result.files, "labels": result.labels, "steps": result.steps,
        "first_loss": result.first_loss, "final_loss": result.final_loss,
        "checkpoint": result.checkpoint, "labels_csv": result.labels_csv,
        "elapsed_sec": round(result.elapsed_sec, 1),
    }))
    return 0


def cmd_inspect(args) -> int:
    """Model/checkpoint inspection (label family, counts, an .onnx file's
    weight inventory)."""
    settings, _db = _load_env(args)
    from kobato_eyes_tpu_torch.models.inspection import inspect_model

    info = inspect_model(
        checkpoint_path=args.checkpoint or settings.tagger.model_path,
        labels_path=args.labels or settings.tagger.labels_path,
    )
    print(info.summary())
    return 0


def cmd_import_weights(args) -> int:
    """Convert a torch/timm state dict or a .onnx model (the reference's
    release format, parsed without onnx/onnxruntime) into the port's
    checkpoint directory (``models/tagger.save_checkpoint``), which
    ``tagger.model_path`` / ``index.checkpoint`` then name. The conversion
    runs on the host: no device is touched."""
    from kobato_eyes_tpu_torch.models.archs import ARCHS
    from kobato_eyes_tpu_torch.models.import_weights import import_torch_checkpoint
    from kobato_eyes_tpu_torch.models.tagger import save_checkpoint
    from kobato_eyes_tpu_torch.utils.hashing import compute_sha256

    if args.arch == "clip":
        from kobato_eyes_tpu_torch.index.embedder import embedder_config

        preset = args.preset or "base"
        cfg = embedder_config(preset, args.image_size, 32, args.classes, args.clip_variant)
        manifest = {"embed_dim": args.classes, "clip_variant": args.clip_variant}
    else:
        arch = ARCHS.get(args.arch)
        if arch is None:
            raise SystemExit(f"unknown arch {args.arch!r} ({' | '.join([*ARCHS, 'clip'])})")
        preset = args.preset or arch.default_preset
        cfg = arch.preset_config(preset, image_size=args.image_size, num_classes=args.classes)
        manifest = {"num_classes": args.classes, "clip_variant": None}
    manifest.update(arch=args.arch, preset=preset, image_size=cfg.image_size, patch_size=cfg.patch_size)
    src = Path(args.state_dict)
    manifest["source"] = {"name": src.name, "sha256": None if src.is_dir() else compute_sha256(src)}
    save_checkpoint(args.out, import_torch_checkpoint(src, cfg), manifest=manifest)
    print(json.dumps({"arch": args.arch, "preset": preset, "out": str(args.out)}))
    return 0


def cmd_trash(args) -> int:
    """Trash by id (--put), list, or restore trashed files (the data-dir
    trash keeps its own manifest, so every move is reversible)."""
    settings, db = _load_env(args)
    from kobato_eyes_tpu_torch.db.connection import bootstrap
    from kobato_eyes_tpu_torch.db.repository import mark_files_present
    from kobato_eyes_tpu_torch.utils.fs import load_trash_records, remove_trash_records, restore_from_trash

    trash_dir = get_app_paths(args.data_dir or settings.data_dir).root / "trash"
    if args.put:
        # per-file isolation: one unmovable file must not abort the batch or
        # leave earlier moves unrecorded
        from kobato_eyes_tpu_torch.db.repository import get_file_by_id, mark_files_absent
        from kobato_eyes_tpu_torch.utils.fs import append_trash_record, trash_file

        conn = bootstrap(db)
        trashed: list[int] = []
        failed: list[int] = []
        try:
            rows = {int(fid): get_file_by_id(conn, fid) for fid in args.put}
            for fid, row in rows.items():
                dest = None
                if row is not None:
                    try:
                        dest = trash_file(row["path"], trash_dir=trash_dir)
                    except (OSError, ValueError) as exc:
                        print(f"trash failed for {row['path']}: {exc}", file=sys.stderr)
                if dest is None:
                    failed.append(fid)
                else:
                    append_trash_record(trash_dir, file_id=fid, original=row["path"], trashed=dest)
                    trashed.append(fid)
            if trashed:
                with conn:
                    mark_files_absent(conn, trashed)
        finally:
            conn.close()
        print(json.dumps({"trashed": trashed, "failed": failed}))
        return 0 if not failed else 1
    records = load_trash_records(trash_dir)
    restore_ids = args.restore if args.restore is not None else []
    if args.restore is not None and not restore_ids and not args.restore_all:
        raise SystemExit("--restore needs file ids (or use --restore-all)")
    if not restore_ids and not args.restore_all:
        for r in records:
            print(json.dumps(r))
        print(f"{len(records)} trashed files", file=sys.stderr)
        return 0

    want = None if args.restore_all else {int(i) for i in restore_ids}
    restored_ids: list[int] = []
    restored_paths: set[str] = set()
    for r in records:
        eligible = want is None or int(r["file_id"]) in want
        if not eligible or not Path(r["trashed"]).exists():
            continue
        if Path(r["original"]).exists():
            # never clobber: another file may have taken the original path
            print(f"skip {r['original']}: a file exists there now "
                  "(move it aside, then restore again)", file=sys.stderr)
            continue
        try:
            restore_from_trash(r["trashed"], r["original"])
            restored_ids.append(int(r["file_id"]))
            restored_paths.add(r["trashed"])
        except OSError as exc:
            print(f"restore failed for {r['trashed']}: {exc}", file=sys.stderr)
    if restored_ids:
        conn = bootstrap(db)
        try:
            with conn:
                mark_files_present(conn, restored_ids)
        finally:
            conn.close()
    if restored_paths:
        # drops only what was restored, re-read under the manifest lock
        remove_trash_records(trash_dir, restored_paths)
    remaining = len(load_trash_records(trash_dir))
    print(json.dumps({"restored": restored_ids, "remaining": remaining}))
    return 0


def cmd_reset(args) -> int:
    """Reset the catalog with timestamped backups (db/admin.py)."""
    settings, db = _load_env(args)
    from kobato_eyes_tpu_torch.db.admin import reset_database

    if not args.yes:
        raise SystemExit("refusing to reset without --yes")
    backups = reset_database(db, backup=not args.no_backup)
    print(json.dumps({"backups": [str(b) for b in backups]}))
    return 0


def cmd_watch(args) -> int:
    """Event-driven tagging: poll roots and tag files as they appear, one
    batch-of-one tag job each, on ``--device``."""
    settings, db = _load_env(args)
    from kobato_eyes_tpu_torch.core.watcher import ProcessingPipeline

    roots = args.root or [str(r) for r in settings.pipeline.roots]
    if not roots:
        raise SystemExit("no roots; pass roots or set pipeline.roots")
    tagger = _resolve_tagger(settings, args.device)

    def on_result(path, result):
        status = "ok" if result.tagged else f"skip ({result.reason})"
        print(f"{status}: {path}", file=sys.stderr)

    pipe = ProcessingPipeline(db, tagger, on_result=on_result, device=args.device)
    pipe.start_polling(roots, interval=args.interval)
    print(f"watching {len(roots)} root(s); Ctrl-C to stop", file=sys.stderr)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        pipe.stop()
    return 0


def cmd_serve(args) -> int:
    """Serve search/complete/stats as a JSON API over the resident epoch."""
    settings, db = _load_env(args)
    from kobato_eyes_tpu_torch.services.server import serve_forever

    logging.basicConfig(level=logging.INFO)
    root = get_app_paths(args.data_dir or settings.data_dir).root
    serve_forever(db, args.host, args.port, data_root=root,
                  refine_settings=settings.refine, device=args.device)
    return 0


def cmd_config(args) -> int:
    settings = load_settings(args.config)
    if args.init:
        dest = Path(args.config or "settings.yaml")
        save_settings(settings, dest)
        print(f"wrote {dest}")
        return 0
    print(json.dumps(settings.model_dump(mode="json"), indent=2, default=str))
    return 0


def cmd_repl(args) -> int:
    """Interactive query loop over a resident epoch (steady-state serving).

    Unlike ``search`` (one process per query), the epoch stays on the device
    between queries — the production latency path.
    Reads one query per line from stdin; ':reload' rebuilds the epoch,
    ':quit' exits.
    """
    settings, db = _load_env(args)
    from kobato_eyes_tpu_torch.db.connection import bootstrap
    from kobato_eyes_tpu_torch.db.repository import load_tag_thresholds
    from kobato_eyes_tpu_torch.query.engine import EpochManager, search_epoch

    conn = bootstrap(db)
    manager = EpochManager(device=args.device)
    manager.rebuild(conn)
    thresholds = load_tag_thresholds(conn)
    print(
        f"epoch v{manager.current.version}: {manager.current.num_files} files, "
        f"{manager.current.num_tags} tags; ':reload' to rebuild, ':quit' to exit",
        file=sys.stderr,
    )
    try:
        for line in sys.stdin:
            query = line.strip()
            if not query:
                continue
            if query == ":quit":
                break
            if query == ":reload":
                manager.rebuild(conn)
                thresholds = load_tag_thresholds(conn)
                print(f"epoch v{manager.current.version} rebuilt", file=sys.stderr)
                continue
            t0 = time.perf_counter()
            try:
                rows = search_epoch(
                    manager.current, query, thresholds=thresholds, limit=args.limit
                )
            except ValueError as exc:
                print(f"error: {exc}", file=sys.stderr)
                continue
            for r in rows:
                print(f"{r.relevance:8.3f}  {r.path}")
            print(
                f"{len(rows)} results in {(time.perf_counter() - t0) * 1000:.1f} ms",
                file=sys.stderr,
            )
    finally:
        conn.close()
    return 0


def cmd_validate_checkpoint(args) -> int:
    """Import -> strict manifest -> exact-vs-fast forward parity -> tag parity
    at production thresholds; exit 0 iff everything holds (models/validate.py)."""
    if args.arch == "clip":
        from kobato_eyes_tpu_torch.index.validate import validate_clip_checkpoint

        report = validate_clip_checkpoint(
            args.checkpoint,
            preset=args.preset,
            image_size=args.image_size,
            patch_size=args.patch_size,
            embed_dim=int(args.classes) if args.classes else 512,
            clip_variant=args.clip_variant,
            n_images=args.images,
            device=args.device,
        )
    else:
        from kobato_eyes_tpu_torch.models.validate import validate_checkpoint

        report = validate_checkpoint(
            args.checkpoint,
            arch=args.arch,
            preset=args.preset,
            image_size=args.image_size,
            classes=args.classes,
            labels_path=args.labels,
            n_images=args.images,
            prob_tolerance=args.tolerance,
            device=args.device,
        )
    print(json.dumps(report, indent=2))
    return 0 if report["ok"] else 1


def cmd_ann(args) -> int:
    settings, db = _load_env(args)
    import numpy as np

    from kobato_eyes_tpu_torch.db.connection import bootstrap
    from kobato_eyes_tpu_torch.utils.image_io import load_rgb_array

    paths = get_app_paths(args.data_dir or settings.data_dir).ensure()
    graph_path = paths.index_dir / "clip.hnsw"
    idx_cfg = settings.index

    if args.similar_to is not None:
        # find-similar by catalog id over STORED embeddings: no model needed
        # (exact cosine search on the device)
        from kobato_eyes_tpu_torch.core.pipeline.embed_stage import load_embedding, load_embeddings
        from kobato_eyes_tpu_torch.index.flat import FlatIndex, find_similar

        conn = bootstrap(db)
        try:
            qvec = load_embedding(conn, args.similar_to)
            if qvec is None:
                raise SystemExit(f"no embedding for file {args.similar_to}")
            ids, vecs = load_embeddings(conn)
            if len(ids) == 0:
                raise SystemExit("catalog has no embeddings; enable index settings and re-index")
            index = FlatIndex(vecs, ids, device=args.device)
            for fid, score in find_similar(index, qvec, exclude_id=args.similar_to, k=args.limit):
                r = conn.execute("SELECT path FROM files WHERE id = ?", (fid,)).fetchone()
                print(f"{score:8.4f}  {r['path'] if r else fid}")
        finally:
            conn.close()
        return 0

    # Probe/backfill embeddings must use the prep geometry the catalog's
    # stored vectors were computed with (fused index runs record it in the
    # meta table): a plain-prep probe against derived-prep vectors would
    # search a different embedding space.
    from kobato_eyes_tpu_torch.index.embedder import embedder_from_catalog

    conn = bootstrap(db)
    try:
        embedder = embedder_from_catalog(
            conn,
            preset=idx_cfg.preset, image_size=idx_cfg.image_size,
            patch_size=idx_cfg.patch_size, embed_dim=idx_cfg.embed_dim,
            checkpoint_path=idx_cfg.checkpoint, device=args.device,
        )
    finally:
        conn.close()

    if args.build:
        from kobato_eyes_tpu_torch.core.pipeline.embed_stage import load_embeddings
        from kobato_eyes_tpu_torch.index.auto import build_auto_index, save_auto_index

        conn = bootstrap(db)
        try:
            # prefer embeddings persisted by the index run (index.enabled)
            stored_ids, stored_vecs = load_embeddings(conn)
            rows = conn.execute(
                "SELECT id, path FROM files WHERE is_present = 1 ORDER BY id"
            ).fetchall()
        finally:
            conn.close()
        all_vecs: list[np.ndarray] = []
        all_ids: list[np.ndarray] = []
        if len(stored_ids) and stored_vecs.shape[1] == embedder.embed_dim:
            all_vecs.append(np.asarray(stored_vecs, np.float32))
            all_ids.append(np.asarray(stored_ids, np.int64))
            done = set(stored_ids.tolist())
            rows = [r for r in rows if int(r["id"]) not in done]
            print(f"{len(stored_ids)} stored embeddings loaded", file=sys.stderr)
        batch: list = []
        ids: list[int] = []
        for r in rows:
            arr = load_rgb_array(r["path"])
            if arr is None:
                continue
            batch.append(arr)
            ids.append(int(r["id"]))
            if len(batch) >= settings.pipeline.batch_size:
                all_vecs.append(np.asarray(embedder.embed_batch(batch)))
                all_ids.append(np.array(ids[-len(batch):], np.int64))
                batch.clear()
        if batch:
            all_vecs.append(np.asarray(embedder.embed_batch(batch)))
            all_ids.append(np.array(ids[-len(batch):], np.int64))
        vecs = np.concatenate(all_vecs) if all_vecs else np.zeros((0, embedder.embed_dim), np.float32)
        fids = np.concatenate(all_ids) if all_ids else np.zeros(0, np.int64)
        # corpus-size routing: HNSW graph below KET_ANN_HNSW_MAX (default
        # 300k), device flat/IVF above it
        index = build_auto_index(vecs, fids, device=args.device)
        save_auto_index(index, graph_path)
        print(f"built ANN index ({type(index).__name__}) over {len(index)} images -> {graph_path}")
        return 0

    if args.query_image:
        from kobato_eyes_tpu_torch.index.auto import load_auto_index

        arr = load_rgb_array(args.query_image)
        if arr is None:
            raise SystemExit(f"cannot decode {args.query_image}")
        index = load_auto_index(graph_path, dim=embedder.embed_dim, device=args.device)
        vec = embedder.embed_batch([arr])
        scores, ids = index.search(vec, k=args.limit)
        conn = bootstrap(db)
        try:
            for score, fid in zip(scores[0], ids[0]):
                if fid < 0:
                    continue
                row = conn.execute("SELECT path FROM files WHERE id=?", (int(fid),)).fetchone()
                print(f"{score:7.4f}  {row['path'] if row else fid}")
        finally:
            conn.close()
        return 0
    raise SystemExit("ann: pass --build or --query-image")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="ket-torch", description=__doc__)
    parser.add_argument("--config", help="settings.yaml path")
    parser.add_argument("--data-dir", help="data directory override")
    parser.add_argument("--device", default="cuda",
                        help="torch device for the tagger, signatures, the dup scan, the query epoch, "
                             "the ANN embedder and indexes, the server and training "
                             "(default cuda; 'cpu' to run without a GPU)")
    parser.add_argument("-v", "--verbose", action="store_true")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("index", help="scan + tag + write")
    p.add_argument("--root", action="append", help="scan root (repeatable)")
    p.set_defaults(fn=cmd_index)

    p = sub.add_parser("refresh", help="incremental refresh of one root")
    p.add_argument("root")
    p.add_argument("--hard-delete", action="store_true")
    p.set_defaults(fn=cmd_refresh)

    p = sub.add_parser("retag", help="invalidate or re-run tagging")
    p.add_argument("--force", action="store_true", help="clear every row")
    p.add_argument("--ids", type=int, nargs="+", help="re-tag specific file ids now")
    p.set_defaults(fn=cmd_retag)

    p = sub.add_parser("search", help="tag query search (multiple queries wait once for the device)")
    p.add_argument("query", nargs="+")
    p.add_argument("--backend", choices=["device", "sql"], default="device")
    p.add_argument("--order", choices=["relevance", "mtime", "path", "id"], default="relevance")
    p.add_argument("--limit", type=int, default=200)
    p.add_argument("--offset", type=int, default=0)
    p.add_argument("--export", help="CSV file or directory")
    p.add_argument("--copy", action="store_true",
                   help="copy every hit into a timestamped folder under the "
                        "data dir's cache/search_results (reference "
                        "'Copy results…')")
    p.add_argument("--copy-to", metavar="DIR",
                   help="copy every hit into DIR (per-query subfolders when "
                        "multiple queries are given)")
    p.add_argument("--show-tags", action="store_true")
    p.set_defaults(fn=cmd_search)

    p = sub.add_parser("dup", help="duplicate scan (+ refinement)")
    p.add_argument("--hamming", type=int)
    p.add_argument("--size-ratio", type=float)
    p.add_argument("--refine", action="store_true")
    p.add_argument("--export", help="CSV file or directory")
    p.add_argument("--trash-duplicates", action="store_true",
                   help="move non-keepers to the data-dir trash and mark absent")
    p.add_argument("--sweep", action="store_true",
                   help="report cluster counts for every threshold 0..hamming")
    p.add_argument("--audit", action="store_true",
                   help="dense intra-cluster Hamming audit (diameter/mean/"
                        "keeper eccentricity) for threshold tuning")
    p.set_defaults(fn=cmd_dup)

    p = sub.add_parser("stats", help="per-tag statistics")
    p.add_argument("--category", type=int)
    p.add_argument("--filter", help="name substring")
    p.add_argument("--limit", type=int, default=100)
    p.add_argument("--export", help="CSV file or directory")
    p.set_defaults(fn=cmd_stats)

    p = sub.add_parser("complete", help="tag autocomplete")
    p.add_argument("prefix")
    p.add_argument("--limit", type=int, default=20)
    p.set_defaults(fn=cmd_complete)

    p = sub.add_parser("thresholds", help="get/set per-category search thresholds")
    p.add_argument("--set", action="append", metavar="CAT=VALUE")
    p.set_defaults(fn=cmd_thresholds)

    p = sub.add_parser("train", help="fine-tune a tagger on the library's labels")
    p.add_argument("--preset", default="base")
    p.add_argument("--image-size", type=int, default=448)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--min-tag-count", type=int, default=1)
    p.add_argument("--limit", type=int)
    p.add_argument("--out", help="checkpoint output directory")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("inspect", help="inspect a tagger checkpoint / label file")
    p.add_argument("--checkpoint")
    p.add_argument("--labels")
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser(
        "import-weights", help="torch/timm state dict or .onnx -> the port's checkpoint directory"
    )
    p.add_argument("state_dict", help=".pth/.pt/.safetensors/.onnx file")
    p.add_argument("out", help="output checkpoint directory")
    p.add_argument("--arch", default="swinv2", help="a tagger arch (models/archs.py) or clip (default: swinv2)")
    p.add_argument("--preset", help="model size (default: large for eva02, else base)")
    p.add_argument("--image-size", type=int, default=448)
    p.add_argument("--classes", type=int, default=8192,
                   help="label count (taggers) or embed dim (clip)")
    p.add_argument("--clip-variant", choices=["openai", "open_clip"], default="openai")
    p.set_defaults(fn=cmd_import_weights)

    p = sub.add_parser("reset", help="reset the catalog (timestamped backups)")
    p.add_argument("--yes", action="store_true")
    p.add_argument("--no-backup", action="store_true")
    p.set_defaults(fn=cmd_reset)

    p = sub.add_parser("trash", help="trash/list/restore files")
    p.add_argument("--put", type=int, nargs="+", metavar="FILE_ID",
                   help="move these file ids to the trash and mark absent "
                        "(the app's delete-selected-results; reversible)")
    p.add_argument("--restore", nargs="*", default=None, metavar="FILE_ID",
                   help="restore these file ids (move back + mark present)")
    p.add_argument("--restore-all", action="store_true")
    p.set_defaults(fn=cmd_trash)

    p = sub.add_parser("watch", help="tag new files as they appear (polling)")
    p.add_argument("root", nargs="*")
    p.add_argument("--interval", type=float, default=2.0)
    p.set_defaults(fn=cmd_watch)

    p = sub.add_parser("repl", help="interactive query loop (resident epoch)")
    p.add_argument("--limit", type=int, default=20)
    p.set_defaults(fn=cmd_repl)

    p = sub.add_parser("serve", help="HTTP JSON API over the resident epoch")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8787)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("config", help="show or init settings")
    p.add_argument("--init", action="store_true")
    p.set_defaults(fn=cmd_config)

    p = sub.add_parser(
        "validate-checkpoint",
        help="import -> exact-vs-fast parity -> tag parity, one shot",
    )
    p.add_argument("checkpoint", help=".pth/.pt/.safetensors/.onnx or a checkpoint directory")
    p.add_argument(
        "--arch", choices=["swinv2", "vit", "pixai", "clip"], default="swinv2",
        help="model family lane: WD14 backbones, the PixAI tagger "
             "(preprocess.json + ips propagation), or the CLIP embedder",
    )
    p.add_argument("--preset", default="base")
    p.add_argument("--image-size", type=int, default=448)
    p.add_argument("--classes", type=int, default=None,
                   help="label count when --labels is not given (embed dim for --arch clip)")
    p.add_argument("--labels", default=None, help="label CSV path")
    p.add_argument("--images", type=int, default=8,
                   help="synthetic validation images to run")
    p.add_argument("--tolerance", type=float, default=0.02,
                   help="max allowed exact-vs-fast probability deviation")
    p.add_argument("--clip-variant", choices=["openai", "open_clip"],
                   default="openai", help="tower convention for --arch clip")
    p.add_argument("--patch-size", type=int, default=32,
                   help="ViT patch size for --arch clip (32 for ViT-B/32, 16 for ViT-B/16)")
    p.set_defaults(fn=cmd_validate_checkpoint)

    p = sub.add_parser("ann", help="build / query the CLIP ANN index")
    p.add_argument("--build", action="store_true")
    p.add_argument("--query-image")
    p.add_argument("--similar-to", type=int, metavar="FILE_ID",
                   help="find-similar over stored embeddings (no model load)")
    p.add_argument("--limit", type=int, default=10)
    p.set_defaults(fn=cmd_ann)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    _setup_logging(args.verbose)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
