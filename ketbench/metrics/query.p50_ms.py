"""Median of the per-query host times (call to return) in the window."""


def read(run):
    return run.counters.get("p50_ms")
