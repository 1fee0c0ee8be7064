"""The EVA02 forwards' share of the card's bf16 peak over the traced window:
analytic FLOPs of every forward completed there
(``roofline_eva02.eva02_forward_flops``) over the window's seconds."""

from ketbench import roofline, roofline_eva02
from ketbench.core import percent


def read(run):
    pk = roofline.peaks(run.counters.get("device_name", ""))
    if run.trace is None or pk is None or run.config.get("arch") != "eva02" or not run.counters.get("forwards"):
        return None
    flops = run.counters["forwards"] * roofline_eva02.eva02_forward_flops(run.config, run.counters["batch_size"])
    return percent(flops / run.trace.window_s(), pk[0])
