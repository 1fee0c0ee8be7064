"""The traced window's share in which the tagger's ``tagger.dispatch`` span is
open and no operation runs on the device: the idle time that dispatch holds."""

from ketbench import spans


def read(run):
    return spans.idle_share_under(run, "tagger.dispatch")
