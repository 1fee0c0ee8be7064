"""Kernel 1 (head-resident attention; ``attn_wgmma_kernel<D, FULL, false>``
and its f32 ``attn_fma_kernel``, not the flash forward's ``<D, FULL, true>``):
its least time from the ViT's shapes over its device time, every launch in
the traced window."""

from ketbench import roofline
from ketbench.core import percent

KERNEL = r"attn_wgmma_kernel<\d+, ?(true|false), ?false>|attn_fma_kernel"


def read(run):
    if run.trace is None or run.config.get("arch") != "vit":
        return None
    launches = run.trace.matching(KERNEL)
    if not launches:
        return None
    one = roofline.vit_attention_launches(run.config, run.counters["batch_size"])[0]
    bound = roofline.bound_seconds([one] * len(launches), run.counters.get("device_name", ""))
    if bound is None:
        return None
    return percent(bound, sum(e - s for _, s, e in launches) / 1e9)
