"""Event-driven processing pipeline: per-file tagging through the scheduler.

Counterpart of ``kobato_eyes_tpu/core/watcher.py`` (the reference's watcher
pipeline, ``src/core/pipeline/watcher.py:41-221``): watched-path resolution
with dedup/containment rules, and a ``ProcessingPipeline`` that enqueues
per-file tag jobs into the JobManager as files appear (filesystem events
arrive from any notifier; polling fallback included since inotify isn't a
dependency). Its one addition is ``device``, passed on to each tag job for
a tagger without a device of its own.
"""

from __future__ import annotations

import logging
import threading
import time
from pathlib import Path
from typing import Callable, Sequence

from kobato_eyes_tpu_torch.core.config.schema import DEFAULT_ALLOW_EXTS
from kobato_eyes_tpu_torch.core.jobs import JobManager, JobPriority
from kobato_eyes_tpu_torch.core.tag_job import TagJobResult, run_tag_job
from kobato_eyes_tpu_torch.models.base import ITagger

logger = logging.getLogger(__name__)


def resolve_watch_paths(paths: Sequence[str | Path]) -> list[Path]:
    """Deduplicate and drop paths contained in other watched paths
    (reference watcher.py:105-131)."""
    absolute = sorted({Path(p).absolute() for p in paths})
    kept: list[Path] = []
    for p in absolute:
        if not p.is_dir():
            logger.warning("watch path missing, skipping: %s", p)
            continue
        if any(parent in kept for parent in p.parents):
            continue
        kept.append(p)
    return kept


class ProcessingPipeline:
    """Enqueue per-file tag jobs; optionally poll roots for new files."""

    def __init__(
        self,
        db_path: str | Path,
        tagger: ITagger,
        *,
        jobs: JobManager | None = None,
        allow_exts: Sequence[str] | None = None,
        on_result: Callable[[Path, TagJobResult], None] | None = None,
        device=None,
    ) -> None:
        self._db_path = Path(db_path)
        self._tagger = tagger
        self._jobs = jobs or JobManager(max_workers=2, name="watch")
        self._owns_jobs = jobs is None
        self._exts = {e.lower() for e in (allow_exts or DEFAULT_ALLOW_EXTS)}
        self._on_result = on_result
        self._device = device
        self._seen: dict[Path, float] = {}
        self._stop = threading.Event()
        self._poll_thread: threading.Thread | None = None

    # -- event entry point ---------------------------------------------------

    def enqueue_file(self, path: str | Path, *, priority: JobPriority = JobPriority.BACKGROUND):
        p = Path(path).absolute()
        if p.suffix.lower() not in self._exts:
            return None

        def job() -> TagJobResult:
            result = run_tag_job(self._db_path, self._tagger, p, device=self._device)
            if self._on_result is not None:
                try:
                    self._on_result(p, result)
                except Exception:  # noqa: BLE001
                    logger.exception("watcher on_result callback failed")
            return result

        return self._jobs.submit(job, priority=priority)

    # -- polling fallback ------------------------------------------------------

    def start_polling(self, roots: Sequence[str | Path], *, interval: float = 2.0) -> None:
        watched = resolve_watch_paths(roots)

        def loop() -> None:
            while not self._stop.is_set():
                for root in watched:
                    for p in root.rglob("*"):
                        if self._stop.is_set():
                            return
                        if not p.is_file() or p.suffix.lower() not in self._exts:
                            continue
                        try:
                            mtime = p.stat().st_mtime
                        except OSError:
                            continue
                        if self._seen.get(p) == mtime:
                            continue
                        self._seen[p] = mtime
                        self.enqueue_file(p)
                self._stop.wait(interval)

        self._poll_thread = threading.Thread(target=loop, name="watch-poll", daemon=True)
        self._poll_thread.start()

    def stop(self, *, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout)
        self._jobs.wait_for_done(timeout)
        if self._owns_jobs:
            self._jobs.shutdown()
