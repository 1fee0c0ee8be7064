"""The frozen operation, byte and bound formulas against the port's and the
kernel table's numbers."""

import pytest

from ketbench import roofline
from ketbench.core import load_benchmark, load_config
from ketbench.model import port_model_config

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("name", ["wd14-vit-b16-448", "wd14-swinv2-b-448"])
@pytest.mark.parametrize("batch", [1, 32])
def test_forward_flops_equal_the_ports(name, batch):
    from kobato_eyes_tpu_torch.models.swin import swin_forward_flops
    from kobato_eyes_tpu_torch.models.vit import vit_forward_flops

    cfg = load_config(load_benchmark(), name)
    port = vit_forward_flops if cfg["arch"] == "vit" else swin_forward_flops
    assert roofline.forward_flops(cfg, batch) == port(port_model_config(cfg), batch)


def test_kernel_1_launch_at_vit_b_448():
    ops, nbytes = roofline.head_attention_launch(32, 785, 12, 64)
    assert round(ops / 1e9, 1) == 60.6
    assert round(nbytes / 1e6, 1) == 154.3
    assert round(roofline.bound_seconds([(ops, nbytes)], H100) * 1e3, 4) == 0.0613
    cfg = load_config(load_benchmark(), "wd14-vit-b16-448")
    assert roofline.vit_attention_launches(cfg, 32) == [(ops, nbytes)] * 12


def test_kernel_3_stage_bounds():
    """Stage 0 of SwinV2-B/448 at batch 32 (shifted): 0.1234 ms, memory-bound;
    24 launches a forward."""
    ops, nbytes = roofline.window_attention_launch(32, 112, 7, 4, 128, shifted=True)
    assert round(roofline.bound_seconds([(ops, nbytes)], H100) * 1e3, 4) == 0.1234
    cfg = load_config(load_benchmark(), "wd14-swinv2-b-448")
    launches = roofline.swin_attention_launches(cfg, 32)
    assert len(launches) == 24
    assert all(nbytes / 3.35e12 > ops / 989e12 for ops, nbytes in launches)


def test_unknown_card_has_no_bound():
    assert roofline.bound_seconds([(1.0, 1.0)], "some other card") is None
