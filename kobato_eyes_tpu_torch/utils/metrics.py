"""Lightweight metrics registry: counters + timing percentiles.

The observability spine (SURVEY.md §5): stage code records counters and
timings; surfaces log lines like the reference's per-batch
``idle/ort/post/total/imgs-per-s`` instrumentation and the bench harness
consumes the same numbers directly instead of scraping logs.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Iterator

import numpy as np


class MetricsRegistry:
    """Thread-safe counters and timer samples."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, float] = defaultdict(float)
        self._timers: dict[str, list[float]] = defaultdict(list)

    def count(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            self._timers[name].append(seconds)

    @contextlib.contextmanager
    def timer(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def percentiles(self, name: str) -> dict[str, float]:
        with self._lock:
            samples = list(self._timers.get(name, []))
        if not samples:
            return {"count": 0, "p50": 0.0, "p95": 0.0, "mean": 0.0, "total": 0.0}
        arr = np.asarray(samples)
        return {
            "count": len(samples),
            "p50": float(np.percentile(arr, 50)),
            "p95": float(np.percentile(arr, 95)),
            "mean": float(arr.mean()),
            "total": float(arr.sum()),
        }

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            timer_names = list(self._timers)
        return {
            "counters": counters,
            "timers": {n: self.percentiles(n) for n in timer_names},
        }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._timers.clear()


# process-global default registry (stage code uses this unless injected)
metrics = MetricsRegistry()
