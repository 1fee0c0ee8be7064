"""Median duration of the tagger's ``tagger.dispatch`` span: the whole
``dispatch_batch_prepared`` (thresholds, the batch's upload, the forward's and
the device top-k's enqueue), clipped to the traced window."""

from ketbench import spans


def read(run):
    return spans.median_ms(run, "tagger.dispatch")
