"""Typed progress channel with throttling.

Parity with the reference's progress machinery
(``src/core/pipeline/types.py:18-97``): phase enum, typed progress snapshot,
and an emitter that throttles to 1% / 0.1 s steps and disables itself if the
callback raises (progress must never take down the work).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from enum import Enum
from typing import Callable

logger = logging.getLogger(__name__)


class IndexPhase(str, Enum):
    SCAN = "scan"
    PREPARE = "prepare"
    TAG = "tag"
    WRITE = "write"
    EPOCH = "epoch"  # device-index rebuild (replaces the reference's FTS phase)
    DONE = "done"


@dataclass(frozen=True)
class IndexProgress:
    phase: IndexPhase
    done: int
    total: int
    message: str = ""

    @property
    def fraction(self) -> float:
        return (self.done / self.total) if self.total > 0 else 0.0


ProgressCallback = Callable[[IndexProgress], None]


class ProgressEmitter:
    """Throttled, failure-isolated progress emission."""

    def __init__(
        self,
        callback: ProgressCallback | None,
        *,
        min_step: float = 0.01,
        min_interval: float = 0.1,
    ) -> None:
        self._callback = callback
        self._min_step = min_step
        self._min_interval = min_interval
        self._last_fraction = -1.0
        self._last_time = 0.0
        self._disabled = callback is None

    def emit(self, progress: IndexProgress, *, force: bool = False) -> None:
        if self._disabled:
            return
        now = time.monotonic()
        if not force:
            if (
                progress.fraction - self._last_fraction < self._min_step
                and now - self._last_time < self._min_interval
            ):
                return
        self._last_fraction = progress.fraction
        self._last_time = now
        try:
            self._callback(progress)  # type: ignore[misc]
        except Exception:  # noqa: BLE001
            # Failure policy: a broken progress consumer silences further
            # callbacks but never fails the pipeline (reference types.py:88-95).
            logger.exception("progress callback failed; disabling further progress")
            self._disabled = True

    def phase(self, phase: IndexPhase, done: int = 0, total: int = 0, message: str = "") -> None:
        self.emit(IndexProgress(phase, done, total, message), force=True)
