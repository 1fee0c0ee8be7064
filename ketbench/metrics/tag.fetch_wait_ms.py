"""Median duration of the tagger's ``tagger.fetch`` span: in
``complete_batch_prepared``, the enqueue of the cast and concatenation of the
top-k tensors, then the wait for their copy to the host, clipped to the
traced window."""

from ketbench import spans


def read(run):
    return spans.median_ms(run, "tagger.fetch")
