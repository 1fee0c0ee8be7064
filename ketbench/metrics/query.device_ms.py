"""Device time a query: every device operation's time in the traced
window over the queries answered there."""


def read(run):
    if run.trace is None or not run.trace.ops or not run.counters.get("queries"):
        return None
    return sum(e - s for _, s, e in run.trace.ops) / 1e6 / run.counters["queries"]
