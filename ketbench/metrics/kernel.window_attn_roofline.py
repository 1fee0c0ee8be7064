"""Kernel 3 (window cosine attention; ``win_attn_mma_kernel`` and
``win_attn_rows_kernel``): the least time of a forward's 24 launches, each
stage's bound from its shapes by the depths, over their device time, every
launch in the traced window."""

from ketbench import roofline
from ketbench.core import percent

KERNEL = r"win_attn_(mma|rows)_kernel"


def read(run):
    if run.trace is None or run.config.get("arch") != "swinv2":
        return None
    launches = run.trace.matching(KERNEL)
    forward = roofline.swin_attention_launches(run.config, run.counters["batch_size"])
    if not launches or len(launches) % len(forward):
        return None
    bound = roofline.bound_seconds(forward * (len(launches) // len(forward)), run.counters.get("device_name", ""))
    if bound is None:
        return None
    return percent(bound, sum(e - s for _, s, e in launches) / 1e9)
