"""The LayerNorm kernel (``layernorm_rows_kernel``, ``csrc/layernorm.cu``):
the device time of every launch in the traced window over the forwards
completed there, in ms a batch; nothing where the program has no such
kernel or the run completed no forward."""

KERNEL = r"layernorm_rows_kernel"


def read(run):
    forwards = run.counters.get("forwards")
    if run.trace is None or not forwards:
        return None
    launches = run.trace.matching(KERNEL)
    if not launches:
        return None
    return sum(e - s for _, s, e in launches) / 1e6 / forwards
