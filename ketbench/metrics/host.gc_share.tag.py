"""The traced window's share under the collector's spans (``gc.gen1``, ``gc.gen2``:
the union of their intervals, clipped to the window)."""

from ketbench import spans


def read(run):
    return spans.window_share(run, prefix="gc.")
