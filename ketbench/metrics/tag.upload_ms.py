"""Median duration of the tagger's ``tagger.upload`` span: the copy of the
batch to the card in ``forward_probs`` (from pageable memory), clipped to
the traced window."""

from ketbench import spans


def read(run):
    return spans.median_ms(run, "tagger.upload")
