"""Index pipeline orchestrator: Scan -> Tag -> Write.

Counterpart of ``kobato_eyes_tpu/core/pipeline/orchestrator.py``. Stage
overrides allow tests (and retag flows) to inject fakes, mirroring
``set_stage_override``. The write phase holds the quiesce gate.

With ``settings.pipeline.inline_signatures`` (the default) the tag stage
fuses pHash/dHash into its decode and dispatch for every tagged file that
lacks a signature row; the hash pass runs on the tagger's device, or on
``device`` for a tagger without one (the dummy).

After the write phase an ``epoch_manager`` (``query.engine.EpochManager``)
gets the device query epoch swapped: a full build on the first run, a delta
over the files whose catalog rows moved after that.

What the JAX package runs beyond that comes with a later slice of the port:
the ANN embed lane (``settings.index.enabled``) logs one warning and is
skipped.
"""

from __future__ import annotations

import logging
import sqlite3
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

from kobato_eyes_tpu_torch.core.config.schema import Settings
from kobato_eyes_tpu_torch.core.pipeline.contracts import ScanResult
from kobato_eyes_tpu_torch.core.pipeline.fingerprint import current_tagger_sig
from kobato_eyes_tpu_torch.core.pipeline.scan_stage import ScanStage, ScanStageConfig
from kobato_eyes_tpu_torch.core.pipeline.tag_stage import TagStage, TagStageResult
from kobato_eyes_tpu_torch.core.progress import IndexPhase, ProgressCallback, ProgressEmitter
from kobato_eyes_tpu_torch.db.connection import bootstrap, quiesced
from kobato_eyes_tpu_torch.device import resolve_device
from kobato_eyes_tpu_torch.models.base import ITagger
from kobato_eyes_tpu_torch.query.engine import EpochManager
from kobato_eyes_tpu_torch.services.writer import CatalogWriter

logger = logging.getLogger(__name__)


@dataclass
class IndexStats:
    scanned: int = 0
    new: int = 0
    changed: int = 0
    missing: int = 0
    tagged: int = 0
    tag_failed: int = 0
    skipped: int = 0
    written: int = 0
    elapsed_sec: float = 0.0
    epoch_version: int | None = None
    extra: dict = field(default_factory=dict)


class IndexPipeline:
    def __init__(
        self,
        db_path: str | Path,
        settings: Settings,
        tagger: ITagger,
        *,
        epoch_manager: EpochManager | None = None,
        progress: ProgressCallback | None = None,
        is_cancelled: Callable[[], bool] | None = None,
        device=None,
    ) -> None:
        self._db_path = Path(db_path)
        self._settings = settings
        self._tagger = tagger
        self._epochs = epoch_manager
        # where the fused hash pass runs: the tagger's device, else ``device``
        tagger_device = getattr(tagger, "device", None)
        self._device = tagger_device if tagger_device is not None else device
        self._progress = ProgressEmitter(progress)
        self._is_cancelled = is_cancelled or (lambda: False)
        self._tagger_sig = current_tagger_sig(tagger.signature_fields())
        # test seams (reference set_stage_override)
        self._scan_override: Callable[[sqlite3.Connection, ProgressEmitter], ScanResult] | None = None
        self._writer_factory: Callable[[], CatalogWriter] = lambda: CatalogWriter(
            self._db_path, unsafe_fast=True
        )

    def set_scan_override(self, fn: Callable[[sqlite3.Connection, ProgressEmitter], ScanResult]) -> None:
        self._scan_override = fn

    def set_writer_factory(self, fn: Callable[[], CatalogWriter]) -> None:
        self._writer_factory = fn

    @property
    def tagger_sig(self) -> str:
        return self._tagger_sig

    def run(self) -> IndexStats:
        t0 = time.perf_counter()
        stats = IndexStats()
        # per-stage walls so an index run is attributable line by line
        walls: dict[str, float] = {}
        stats.extra["stage_walls"] = walls
        conn = bootstrap(self._db_path)
        try:
            # SCAN
            if self._scan_override is not None:
                scan = self._scan_override(conn, self._progress)
            else:
                scan = ScanStage(
                    ScanStageConfig(
                        roots=self._settings.pipeline.roots,
                        excluded=self._settings.pipeline.excluded,
                        allow_exts=self._settings.pipeline.allow_exts,
                    ),
                    tagger_sig=self._tagger_sig,
                    is_cancelled=self._is_cancelled,
                ).run(conn, self._progress)
            stats.scanned = len(scan.records)
            stats.new, stats.changed, stats.missing = scan.new, scan.changed, len(scan.missing_ids)
        finally:
            conn.close()
        walls["scan"] = round(time.perf_counter() - t0, 3)

        if self._settings.index.enabled:
            logger.warning(
                "index.enabled: the ANN embed lane comes with the ANN slice of "
                "the port; no vectors are computed"
            )

        # SIG SETUP — files being tagged that lack duplicate signatures get
        # pHash/dHash fused into the same decode + dispatch (the words ride
        # the WriteItems); `ket dup` then finds no missing signatures and
        # skips its own decode pass. Content-changed files refresh theirs.
        sig_need: set[int] = set()
        sig_device = None
        if self._settings.pipeline.inline_signatures and not self._is_cancelled():
            from kobato_eyes_tpu_torch.db.repository import missing_signature_ids

            sig_device = resolve_device(self._device)
            conn = bootstrap(self._db_path)
            try:
                missing = {fid for fid, _ in missing_signature_ids(conn)}
            finally:
                conn.close()
            sig_need = {
                r.file_id for r in scan.records
                if r.file_id in missing or r.content_changed
            }

        # TAG + WRITE under the quiesce gate (exclusive writer phase).
        tag_result = TagStageResult()
        t_stage = time.perf_counter()
        if not self._is_cancelled():
            with quiesced():
                writer = self._writer_factory()
                writer.start()
                try:
                    cache_dir = None
                    if self._settings.pipeline.tagger_input_cache:
                        from kobato_eyes_tpu_torch.utils.paths import get_app_paths

                        cache_dir = str(
                            self._settings.pipeline.input_cache_dir
                            or get_app_paths(self._settings.data_dir).cache_dir / "prepared"
                        )
                    tag_result = TagStage(
                        self._tagger,
                        tagger_sig=self._tagger_sig,
                        batch_size=self._settings.pipeline.batch_size,
                        prefetch_depth=self._settings.pipeline.prefetch_depth,
                        io_workers=self._settings.pipeline.io_workers,
                        input_cache_dir=cache_dir,
                        is_cancelled=self._is_cancelled,
                        pipeline_depth=self._settings.pipeline.pipeline_depth,
                        sig_need=sig_need,
                        sig_device=sig_device,
                    ).run(scan.records, writer, self._progress)
                finally:
                    self._progress.phase(IndexPhase.WRITE)
                    writer.stop(flush=True)
                stats.written = writer.items_written
        stats.tagged = tag_result.tagged
        stats.tag_failed = tag_result.failed
        stats.skipped = tag_result.skipped
        walls["tag_write"] = round(time.perf_counter() - t_stage, 3)
        # device dispatch+fetch inside the tag wall; the remainder is host
        # decode/prepare/queue time the in-flight window could not hide
        stats.extra["tag_infer_s"] = round(tag_result.infer_seconds, 3)
        stats.extra["signatures_fused"] = tag_result.signed

        # EPOCH swap (the reference's offline FTS rebuild, device edition).
        # Incremental when an epoch is already live: only tagged + vanished
        # files are re-read (delta build), else a full snapshot.
        t_stage = time.perf_counter()
        if self._epochs is not None and not self._is_cancelled():
            self._progress.phase(IndexPhase.EPOCH)
            # everything whose catalog row moved: tagged, tag-failed (must
            # still appear in the epoch), and metadata-touched files
            changed = [
                r.file_id for r in scan.records if r.tagged or r.failed or r.touched
            ]
            changed.extend(scan.missing_ids)
            conn = bootstrap(self._db_path)
            try:
                if self._epochs.current is None:
                    epoch = self._epochs.rebuild(conn)
                else:
                    epoch = self._epochs.apply_delta(conn, changed)
                stats.epoch_version = epoch.version
            finally:
                conn.close()
            walls["epoch"] = round(time.perf_counter() - t_stage, 3)

        stats.elapsed_sec = time.perf_counter() - t0
        self._progress.phase(IndexPhase.DONE)
        logger.info("index run: %s", stats)
        return stats


def run_index_once(
    db_path: str | Path,
    settings: Settings,
    tagger: ITagger,
    *,
    epoch_manager: EpochManager | None = None,
    progress: ProgressCallback | None = None,
    is_cancelled: Callable[[], bool] | None = None,
    device=None,
) -> IndexStats:
    """Headless single-pass API (reference run_index_once). ``device`` places
    the fused signature pass when the tagger has no device of its own; the
    epoch swap runs on the ``epoch_manager``'s own device."""
    return IndexPipeline(
        db_path, settings, tagger,
        epoch_manager=epoch_manager, progress=progress, is_cancelled=is_cancelled,
        device=device,
    ).run()
