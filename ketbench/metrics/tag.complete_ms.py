"""Median host time of ``complete_batch_prepared`` (fetch wait and host
selection), from the harness's span around each call."""

import numpy as np


def read(run):
    times = run.host_spans.get("complete")
    return float(np.median(times) * 1e3) if times else None
