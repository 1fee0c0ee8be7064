"""Incremental maintenance: per-root refresh, retag, deletion handling.

Counterpart of ``kobato_eyes_tpu/core/pipeline/maintenance.py``: semantics
parity with the reference's manual-refresh and retag flows
(``core/pipeline/manual_refresh.py:30-280``, ``core/pipeline/retag.py:46-236``):

* refresh(root): tag files that are new or untagged under one root, soft- or
  hard-delete rows whose file vanished, then rebuild the device epoch;
* retag_all(force): clear tagger fingerprints (all rows, or only rows tagged
  by the current fingerprint when force=False is inverted — matching
  retag_all(force) keyed on the current sig) so the next index pass re-tags;
* retag_selection(ids): run the pipeline with a scan override emitting
  exactly those ids with needs_tagging=True (the reference's
  ``_RetagScanStage`` seam).

``device`` places the index pipeline's fused signature pass and embedder
for a tagger without a device of its own (``IndexPipeline``'s ``device``).
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Callable, Sequence

from kobato_eyes_tpu_torch.core.config.schema import Settings
from kobato_eyes_tpu_torch.core.pipeline.contracts import FileRecord, ScanResult
from kobato_eyes_tpu_torch.core.pipeline.orchestrator import IndexPipeline, IndexStats
from kobato_eyes_tpu_torch.core.scanner import iter_images
from kobato_eyes_tpu_torch.db.connection import bootstrap
from kobato_eyes_tpu_torch.db.repository import (
    path_prefix_clause,
    clear_tagger_sig,
    delete_files,
    fetch_files_by_paths,
    list_untagged_under_path,
    mark_files_absent,
    upsert_file,
)
from kobato_eyes_tpu_torch.models.base import ITagger
from kobato_eyes_tpu_torch.query.engine import EpochManager

logger = logging.getLogger(__name__)


def refresh_root(
    db_path: str | Path,
    settings: Settings,
    tagger: ITagger,
    root: str | Path,
    *,
    hard_delete: bool = False,
    epoch_manager: EpochManager | None = None,
    progress=None,
    is_cancelled: Callable[[], bool] | None = None,
    device=None,
) -> IndexStats:
    """Refresh one root: find new/untagged files, clean up missing rows,
    tag the queue, swap the epoch."""
    root = Path(root).absolute()
    pipeline = IndexPipeline(
        db_path, settings, tagger,
        epoch_manager=epoch_manager, progress=progress, is_cancelled=is_cancelled,
        device=device,
    )

    def scan_override(conn, emitter) -> ScanResult:
        result = ScanResult()
        on_disk = {
            str(s.path): s
            for s in iter_images([root], excluded=settings.pipeline.excluded,
                                 allow_exts=settings.pipeline.allow_exts)
        }
        # missing rows under this root -> soft or hard delete
        clause, pattern = path_prefix_clause(root)
        rows = conn.execute(
            f"SELECT id, path FROM files WHERE is_present = 1 AND {clause}", (pattern,)
        ).fetchall()
        missing = [int(r["id"]) for r in rows if r["path"] not in on_disk]
        if missing:
            if hard_delete:
                delete_files(conn, missing)
            else:
                mark_files_absent(conn, missing)
            conn.commit()
            result.missing_ids = missing

        # untagged existing rows + brand-new files
        queued: dict[str, None] = {}
        for row in list_untagged_under_path(conn, root):
            if row["path"] in on_disk:
                queued[row["path"]] = None
        existing = fetch_files_by_paths(conn, list(on_disk))
        for path, scanned in on_disk.items():
            row = existing.get(path)
            if row is None:
                queued[path] = None
            elif row["tagger_sig"] != pipeline.tagger_sig:
                queued[path] = None
        for path in queued:
            scanned = on_disk[path]
            fid = upsert_file(conn, path=path, size=scanned.size, mtime=scanned.mtime)
            result.records.append(
                FileRecord(
                    file_id=fid, path=Path(path), size=scanned.size, mtime=scanned.mtime,
                    needs_tagging=True,
                )
            )
        conn.commit()
        result.new = len(result.records)
        logger.info(
            "refresh %s: %d queued, %d missing (%s delete)",
            root, len(result.records), len(missing), "hard" if hard_delete else "soft",
        )
        return result

    pipeline.set_scan_override(scan_override)
    return pipeline.run()


def retag_all(db_path: str | Path, *, current_sig: str | None = None, force: bool = False) -> int:
    """Invalidate tagging state so the next index re-tags.

    force=True clears every row; otherwise only rows whose fingerprint equals
    ``current_sig`` (reference retag.py:82-96 — re-tag what the current model
    already tagged, leaving differently-tagged rows for the normal mismatch
    path).
    """
    conn = bootstrap(db_path)
    try:
        with conn:
            if force:
                return clear_tagger_sig(conn)
            return clear_tagger_sig(conn, only_sig=current_sig)
    finally:
        conn.close()


def retag_selection(
    db_path: str | Path,
    settings: Settings,
    tagger: ITagger,
    file_ids: Sequence[int],
    *,
    epoch_manager: EpochManager | None = None,
    progress=None,
    is_cancelled: Callable[[], bool] | None = None,
    device=None,
) -> IndexStats:
    """Re-tag exactly these ids via a scan-stage override
    (reference run_retag_selection, retag.py:217-236)."""
    ids = [int(i) for i in file_ids]
    pipeline = IndexPipeline(
        db_path, settings, tagger,
        epoch_manager=epoch_manager, progress=progress, is_cancelled=is_cancelled,
        device=device,
    )

    def scan_override(conn, emitter) -> ScanResult:
        result = ScanResult()
        for chunk_start in range(0, len(ids), 900):
            chunk = ids[chunk_start : chunk_start + 900]
            ph = ",".join("?" * len(chunk))
            rows = conn.execute(
                f"SELECT * FROM files WHERE id IN ({ph}) AND is_present = 1", chunk
            ).fetchall()
            for row in rows:
                path = Path(row["path"])
                if not path.exists():
                    continue
                result.records.append(
                    FileRecord(
                        file_id=int(row["id"]), path=path,
                        size=int(row["size"] or 0), mtime=float(row["mtime"] or time.time()),
                        width=row["width"], height=row["height"],
                        needs_tagging=True,
                    )
                )
        return result

    pipeline.set_scan_override(scan_override)
    return pipeline.run()
