"""The share (%) of the tagger's dispatches in the traced window that
replayed a captured CUDA graph: the number of ``tagger.replay`` spans over
the number of ``tagger.dispatch`` spans; nothing where the program opens no
``tagger.replay`` span."""

from ketbench import spans


def read(run):
    replays = spans.clipped(run, "tagger.replay")
    dispatches = spans.clipped(run, "tagger.dispatch")
    if replays is None or dispatches is None:
        return None
    return 100.0 * len(replays) / len(dispatches)
