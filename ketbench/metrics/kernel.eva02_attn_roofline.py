"""Kernel 1 (head-resident attention; ``attn_wgmma_kernel<D, FULL, false>``
and its f32 ``attn_fma_kernel``) in the EVA02 cell, at T = 1025, H = 16,
D = 64: its least time from those shapes over its device time, every launch
in the traced window."""

from ketbench import roofline, roofline_eva02
from ketbench.core import percent

KERNEL = r"attn_wgmma_kernel<\d+, ?(true|false), ?false>|attn_fma_kernel"


def read(run):
    if run.trace is None or run.config.get("arch") != "eva02":
        return None
    launches = run.trace.matching(KERNEL)
    if not launches:
        return None
    one = roofline_eva02.eva02_attention_launches(run.config, run.counters["batch_size"])[0]
    bound = roofline.bound_seconds([one] * len(launches), run.counters.get("device_name", ""))
    if bound is None:
        return None
    return percent(bound, sum(e - s for _, s, e in launches) / 1e9)
