"""The RoPE kernel (``rope2d_packed_kernel``, ``csrc/rope_2d.cu``): its least
time from EVA02's shapes (bytes: q and k of the patch tokens read and
written, the sin and cos tables) over its device time, every launch in the
traced window."""

from ketbench import roofline, roofline_eva02
from ketbench.core import percent

KERNEL = r"rope2d_packed_kernel"


def read(run):
    if run.trace is None or run.config.get("arch") != "eva02":
        return None
    launches = run.trace.matching(KERNEL)
    if not launches:
        return None
    one = roofline_eva02.rope_launches(run.config, run.counters["batch_size"])[0]
    bound = roofline.bound_seconds([one] * len(launches), run.counters.get("device_name", ""))
    if bound is None:
        return None
    return percent(bound, sum(e - s for _, s, e in launches) / 1e9)
