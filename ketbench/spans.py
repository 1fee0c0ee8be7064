"""The program's spans in a traced window, for the per-layer readers.

The port marks its own work with ``record_function`` spans while a profiler
records (``kobato_eyes_tpu_torch/utils/tracing.py``: ``tagger.*``,
``query.*``, and ``gc.gen1`` / ``gc.gen2`` around the collector's passes);
``core.reduce_trace`` keeps them in ``Trace.spans`` beside the harness's own.
Each helper clips spans to the traced window and reads nothing (``None``)
where the run has no trace, where the trace holds no device operation (a run
on the CPU: these metrics describe the card's runs) or where the spans are
absent (a program that opens none).
"""

from __future__ import annotations

from bisect import bisect_left

import numpy as np


def clipped(run, name: str | None = None, *, prefix: str | None = None) -> list[tuple[int, int]] | None:
    """The (start, end) of every span named ``name`` (or whose name starts
    with ``prefix``), clipped to the window, by start; ``None`` where there
    is none to read."""
    trace = run.trace
    if trace is None or not trace.ops:
        return None
    lo, hi = trace.window
    out = sorted(
        (max(s, lo), min(e, hi))
        for n, s, e in trace.spans
        if (n == name if prefix is None else n.startswith(prefix)) and min(e, hi) > max(s, lo)
    )
    return out or None


def median_ms(run, name: str) -> float | None:
    """Median duration of the spans named ``name``, in milliseconds."""
    found = clipped(run, name)
    if found is None:
        return None
    return float(np.median([e - s for s, e in found])) / 1e6


def union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """The union of intervals as disjoint intervals, by start."""
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def length(intervals: list[tuple[int, int]]) -> int:
    return sum(e - s for s, e in intervals)


def uncovered(intervals: list[tuple[int, int]], cover: list[tuple[int, int]]) -> int:
    """How long the union of ``intervals`` lies outside the union of ``cover``."""
    cover = union(cover)
    total = 0
    i = 0
    for s, e in union(intervals):
        while i < len(cover) and cover[i][1] <= s:
            i += 1
        t, j = s, i
        while j < len(cover) and cover[j][0] < e:
            total += max(cover[j][0] - t, 0)
            t = max(t, cover[j][1])
            j += 1
        total += max(e - t, 0)
    return total


def window_share(run, name: str | None = None, *, prefix: str | None = None) -> float | None:
    """The share (%) of the window under the union of the spans."""
    found = clipped(run, name, prefix=prefix)
    if found is None:
        return None
    lo, hi = run.trace.window
    return 100.0 * length(union(found)) / (hi - lo)


def idle_share_under(run, name: str) -> float | None:
    """The share (%) of the window in which a span named ``name`` is open
    and no device operation runs."""
    found = clipped(run, name)
    if found is None:
        return None
    lo, hi = run.trace.window
    return 100.0 * uncovered(found, run.trace.busy_intervals()) / (hi - lo)


def tail_child_share(run, parent: str, child: str, quantile: float = 95.0) -> float | None:
    """Over the ``parent`` spans at or above the ``quantile``-th percentile of
    their durations: the summed duration of the ``child`` spans inside them
    over their summed duration (%)."""
    parents = clipped(run, parent)
    kids = clipped(run, child)
    if parents is None or kids is None:
        return None
    durations = np.array([e - s for s, e in parents])
    cut = np.percentile(durations, quantile)
    starts = [s for s, _ in kids]
    inside = 0
    spent = 0
    for s, e in parents:
        if e - s < cut:
            continue
        spent += e - s
        k = bisect_left(starts, s)
        while k < len(kids) and kids[k][0] < e:
            if kids[k][1] <= e:
                inside += kids[k][1] - kids[k][0]
            k += 1
    return 100.0 * inside / spent if spent > 0 else None
