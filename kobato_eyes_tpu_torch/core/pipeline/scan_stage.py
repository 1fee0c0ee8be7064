"""Scan stage: sync filesystem state into the catalog, decide who needs tagging.

Change-detection parity with the reference (``scan_stage.py:210-261``):
size/mtime mismatch triggers a sha256 recompute; ``needs_tagging`` is
new | changed | untagged | tagger_sig-mismatch — so a model/threshold change
(different fingerprint) automatically re-tags the library.
"""

from __future__ import annotations

import logging
import sqlite3
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Sequence

from kobato_eyes_tpu_torch.core.pipeline.contracts import FileRecord, ScanResult
from kobato_eyes_tpu_torch.core.progress import IndexPhase, IndexProgress, ProgressEmitter
from kobato_eyes_tpu_torch.core.scanner import ScannedFile, iter_images
from kobato_eyes_tpu_torch.db.repository import bulk_scan_upsert, fetch_files_by_paths, mark_files_absent
from kobato_eyes_tpu_torch.utils.hashing import compute_sha256

logger = logging.getLogger(__name__)


@dataclass
class ScanStageConfig:
    roots: Sequence[str | Path]
    excluded: Sequence[str | Path] = ()
    allow_exts: Sequence[str] | None = None
    detect_missing: bool = True


class ScanStage:
    def __init__(
        self,
        config: ScanStageConfig,
        *,
        tagger_sig: str,
        is_cancelled: Callable[[], bool] | None = None,
    ) -> None:
        self._config = config
        self._tagger_sig = tagger_sig
        self._is_cancelled = is_cancelled or (lambda: False)

    def run(self, conn: sqlite3.Connection, progress: ProgressEmitter) -> ScanResult:
        t0 = time.perf_counter()
        scanned: list[ScannedFile] = list(
            iter_images(
                self._config.roots,
                excluded=self._config.excluded,
                allow_exts=self._config.allow_exts,
            )
        )
        progress.phase(IndexPhase.SCAN, 0, len(scanned))
        result = ScanResult()
        existing = fetch_files_by_paths(conn, [str(s.path) for s in scanned])

        # pass 1: change detection (sha256 only for new/changed — the hot IO)
        pending: list[tuple[ScannedFile, object, bool, bool, bool, str | None]] = []
        for i, item in enumerate(scanned):
            if self._is_cancelled():
                break
            row = existing.get(str(item.path))
            is_new = row is None
            touched = False
            changed = False
            sha = None
            if not is_new:
                touched = (row["size"] or -1) != item.size or abs(
                    (row["mtime"] or 0.0) - item.mtime
                ) > 1e-6
                changed = touched
            if is_new or changed:
                try:
                    sha = compute_sha256(item.path)
                except OSError as exc:
                    logger.warning("hash failed for %s: %s; skipping", item.path, exc)
                    continue  # unreadable: per-item skip
                if not is_new and sha == row["sha256"]:
                    changed = False  # touched but content-identical
            pending.append((item, row, is_new, touched, changed, sha))
            progress.emit(IndexProgress(IndexPhase.SCAN, i + 1, len(scanned)))

        # pass 2: one bulk write for all rows (scales to 1M-file scans)
        with conn:
            ids = bulk_scan_upsert(
                conn,
                [(str(it.path), it.size, it.mtime, sha) for (it, _r, _n, _t, _c, sha) in pending],
            )
        for item, row, is_new, touched, changed, sha in pending:
            untagged = is_new or not bool(row["has_tags"]) if row is not None else True
            sig_mismatch = (row["tagger_sig"] if row is not None else None) != self._tagger_sig
            result.records.append(
                FileRecord(
                    file_id=ids[str(item.path)], path=item.path, size=item.size,
                    mtime=item.mtime,
                    width=row["width"] if row is not None else None,
                    height=row["height"] if row is not None else None,
                    needs_tagging=is_new or changed or untagged or sig_mismatch,
                    content_changed=is_new or changed,
                    touched=touched or is_new,
                )
            )
            result.new += int(is_new)
            result.changed += int(changed and not is_new)

        if self._config.detect_missing and not self._is_cancelled():
            result.missing_ids = self._find_missing(conn, scanned)
            if result.missing_ids:
                mark_files_absent(conn, result.missing_ids)
                conn.commit()

        logger.info(
            "scan: %d files (%d new, %d changed, %d missing) in %.2fs",
            len(result.records), result.new, result.changed,
            len(result.missing_ids), time.perf_counter() - t0,
        )
        progress.phase(IndexPhase.SCAN, len(scanned), len(scanned))
        return result

    def _find_missing(self, conn: sqlite3.Connection, scanned: list[ScannedFile]) -> list[int]:
        """Present rows under the scan roots whose file no longer exists."""
        from kobato_eyes_tpu_torch.db.repository import path_prefix_clause

        seen = {str(s.path) for s in scanned}
        missing: list[int] = []
        for root in self._config.roots:
            clause, pattern = path_prefix_clause(root)
            rows = conn.execute(
                f"SELECT id, path FROM files WHERE is_present = 1 AND {clause}", (pattern,)
            ).fetchall()
            missing.extend(int(r["id"]) for r in rows if r["path"] not in seen)
        return missing
