"""Job scheduler: priority-ordered thread-pool execution with cancellation.

Functional parity with the reference's ``JobManager``
(``src/core/jobs.py:164-477``) minus the Qt coupling — this engine is
headless-first, so the scheduler is plain threads + a priority heap:

* FOREGROUND jobs preempt queued BACKGROUND jobs (heap order);
* ``BatchJob`` template: load -> process -> write with cooperative
  cancellation between steps;
* ``CallableJob`` wraps a plain function;
* ``JobHandle`` exposes done/cancel/result/error; ``wait_for_done`` joins
  everything (the reference's shutdown path).
"""

from __future__ import annotations

import heapq
import itertools
import logging
import threading
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Any, Callable, Generic, Iterable, Sequence, TypeVar

logger = logging.getLogger(__name__)

T = TypeVar("T")
R = TypeVar("R")


class JobPriority(IntEnum):
    FOREGROUND = 0
    BACKGROUND = 10


class JobCancelled(Exception):
    """Raised inside a job when cancellation was requested."""


@dataclass
class JobHandle:
    """Caller-facing view of a scheduled job."""

    name: str
    _done: threading.Event = field(default_factory=threading.Event)
    _cancel: threading.Event = field(default_factory=threading.Event)
    _result: Any = None
    _error: BaseException | None = None

    def cancel(self) -> None:
        self._cancel.set()

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: float | None = None) -> Any:
        if not self._done.wait(timeout):
            raise TimeoutError(f"job {self.name!r} still running")
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def error(self) -> BaseException | None:
        return self._error


class Job:
    """Base job: override run(handle)."""

    name = "job"

    def run(self, handle: JobHandle) -> Any:  # pragma: no cover - interface
        raise NotImplementedError


class CallableJob(Job):
    """Wrap fn(*args, **kwargs); fn may accept is_cancelled= kwarg
    (reference CallableJob, core/jobs.py:255-281)."""

    def __init__(self, fn: Callable[..., Any], *args: Any, name: str | None = None, **kwargs: Any) -> None:
        self._fn = fn
        self._args = args
        self._kwargs = kwargs
        self.name = name or getattr(fn, "__name__", "callable")

    def run(self, handle: JobHandle) -> Any:
        import inspect

        kwargs = dict(self._kwargs)
        try:
            sig = inspect.signature(self._fn)
            if "is_cancelled" in sig.parameters:
                kwargs["is_cancelled"] = lambda: handle.cancelled
        except (TypeError, ValueError):
            pass
        return self._fn(*self._args, **kwargs)


class BatchJob(Job, Generic[T, R]):
    """Load -> per-item process -> write with cooperative cancel between items
    (reference BatchJob, core/jobs.py:182-253)."""

    name = "batch"

    def load(self) -> Sequence[T]:  # pragma: no cover - interface
        raise NotImplementedError

    def process(self, item: T) -> R:  # pragma: no cover - interface
        raise NotImplementedError

    def write(self, results: list[R]) -> Any:
        return results

    def run(self, handle: JobHandle) -> Any:
        items = self.load()
        results: list[R] = []
        for item in items:
            if handle.cancelled:
                raise JobCancelled(self.name)
            results.append(self.process(item))
        if handle.cancelled:
            raise JobCancelled(self.name)
        return self.write(results)


class JobManager:
    """Priority heap over a fixed worker pool."""

    def __init__(self, max_workers: int = 4, *, name: str = "jobs") -> None:
        self._heap: list[tuple[int, int, Job, JobHandle]] = []
        self._counter = itertools.count()
        self._cv = threading.Condition()
        self._shutdown = False
        self._active = 0
        self._workers = [
            threading.Thread(target=self._worker, name=f"{name}-{i}", daemon=True)
            for i in range(max_workers)
        ]
        for w in self._workers:
            w.start()

    def submit_handle(self, job: Job, priority: JobPriority = JobPriority.BACKGROUND) -> JobHandle:
        handle = JobHandle(name=job.name)
        with self._cv:
            if self._shutdown:
                raise RuntimeError("job manager is shut down")
            heapq.heappush(self._heap, (int(priority), next(self._counter), job, handle))
            self._cv.notify()
        return handle

    def submit(self, fn: Callable[..., Any], *args: Any,
               priority: JobPriority = JobPriority.BACKGROUND, **kwargs: Any) -> JobHandle:
        return self.submit_handle(CallableJob(fn, *args, **kwargs), priority)

    def map_jobs(self, jobs: Iterable[Job], priority: JobPriority = JobPriority.BACKGROUND) -> list[JobHandle]:
        return [self.submit_handle(j, priority) for j in jobs]

    def wait_for_done(self, timeout: float | None = None) -> bool:
        """Block until the queue drains and all workers are idle."""
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        with self._cv:
            while self._heap or self._active:
                remaining = None if deadline is None else deadline - _time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(remaining if remaining is not None else 0.5)
        return True

    def shutdown(self, *, cancel_pending: bool = True, timeout: float = 30.0) -> None:
        with self._cv:
            self._shutdown = True
            if cancel_pending:
                for _, _, _job, handle in self._heap:
                    handle._error = JobCancelled(handle.name)
                    handle._done.set()
                self._heap.clear()
            self._cv.notify_all()
        for w in self._workers:
            w.join(timeout)

    # -- worker loop --------------------------------------------------------

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._heap and not self._shutdown:
                    self._cv.wait()
                if self._shutdown and not self._heap:
                    return
                _, _, job, handle = heapq.heappop(self._heap)
                self._active += 1
            try:
                if handle.cancelled:
                    raise JobCancelled(handle.name)
                handle._result = job.run(handle)
            except BaseException as exc:  # noqa: BLE001
                # Failure policy: job errors are captured on the handle and
                # re-raised at result() — never kill the worker thread.
                handle._error = exc
                if not isinstance(exc, JobCancelled):
                    logger.exception("job %s failed", handle.name)
            finally:
                handle._done.set()
                with self._cv:
                    self._active -= 1
                    self._cv.notify_all()
