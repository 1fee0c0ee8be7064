"""Median duration of the query engine's ``query.plan`` span: the parse, the
thresholds, the positive terms and the slot tables of one query, clipped to
the traced window."""

from ketbench import spans


def read(run):
    return spans.median_ms(run, "query.plan")
