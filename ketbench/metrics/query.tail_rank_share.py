"""Over the ``query.search`` spans at or above the 95th percentile of their
durations (the tail ``query_p95_ms`` reads): the summed duration of the
``query.rank`` spans inside them over their summed duration."""

from ketbench import spans


def read(run):
    return spans.tail_child_share(run, "query.search", "query.rank", 95.0)
