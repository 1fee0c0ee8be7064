"""The port's spans: where the tagger and the query engine spend a request,
marked in a recording ``torch.profiler`` session.

A span is a user annotation in that session's trace, on the clock of the
device operations, and is written out with it (any ``export_chrome_trace``:
``utils/profiling.py``'s ``device_trace``, the tools' ``--profile``). While no
profiler records, :func:`span` returns the shared :data:`NO_SPAN` at the cost
of one check. The ``gc.callbacks`` hook installed on import marks each
collection of generation 1 or 2 the same way (``gc.gen1``, ``gc.gen2``).
"""

from __future__ import annotations

import contextlib
import gc

import torch

_profiling = torch.autograd._profiler_enabled
NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager marking ``name`` in the recording profiler's trace
    (``torch.profiler.record_function(name)``); :data:`NO_SPAN` while no
    profiler records."""
    if not _profiling():
        return NO_SPAN
    return torch.profiler.record_function(name)


_GC_SPAN_NAMES = {1: "gc.gen1", 2: "gc.gen2"}
_gc_record = None  # the open collection's span, from its "start" to its "stop"


def _gc_span(phase: str, info: dict) -> None:
    """``gc.callbacks`` hook: a span around each collection of generation 1
    or 2 while a profiler records. Generation 0 gets none: its collections
    are tens of microseconds each and thousands a second. Collections do not
    nest, so one open record suffices."""
    global _gc_record
    if phase == "start":
        if info["generation"] and _profiling():
            _gc_record = torch.ops.profiler._record_function_enter_new(
                _GC_SPAN_NAMES[info["generation"]], None
            )
    elif _gc_record is not None:
        record, _gc_record = _gc_record, None
        torch.ops.profiler._record_function_exit._RecordFunction(record)


gc.callbacks.append(_gc_span)
