"""The traced window's share with no operation on the device: one less the
union of the device operations' intervals over the window."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s())
