"""Median duration of the tagger's ``tagger.select`` span: the host selection
walk over a batch's top-k rows (``select_wd14`` / ``select_pixai``), clipped to
the traced window."""

from ketbench import spans


def read(run):
    return spans.median_ms(run, "tagger.select")
