"""Median duration of the query engine's ``query.rank`` span: relevance,
ordering, paging and result assembly (``_rank_and_page``) of one query,
clipped to the traced window."""

from ketbench import spans


def read(run):
    return spans.median_ms(run, "query.rank")
