"""The port's profiling helpers (``utils/profiling.py``) against the JAX
package's (``tests/utils/test_profiling.py``, case for case): cost counts,
MFU math, trace capture."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from kobato_eyes_tpu.utils import profiling as jprofiling
from kobato_eyes_tpu_torch.models import vit as tvit
from kobato_eyes_tpu_torch.utils.profiling import (
    PEAK_BF16_FLOPS,
    compiled_cost,
    device_peak_flops,
    device_trace,
    mfu,
    roofline_summary,
)

torch.set_num_threads(1)


def test_compiled_cost_reports_matmul_flops():
    a = torch.ones(64, 128)
    b = torch.ones(128, 32)
    cost = compiled_cost(torch.matmul, a, b)
    # 2*M*N*K FLOPs for a dense matmul, as the JAX package's cost model
    assert cost["flops"] == 2 * 64 * 128 * 32
    jcost = jprofiling.compiled_cost(lambda x, y: x @ y, np.ones((64, 128), np.float32), np.ones((128, 32), np.float32))
    assert jcost["flops"] >= cost["flops"]
    # each operand read once and the product written once
    assert cost["bytes accessed"] == 4 * (64 * 128 + 128 * 32 + 64 * 32)


def test_compiled_cost_of_an_uncountable_call_is_empty():
    def boom():
        raise RuntimeError("no")

    assert compiled_cost(boom) == {}


def test_mfu_math(monkeypatch):
    assert mfu(50.0, 1.0, peak_flops=100.0) == jprofiling.mfu(50.0, 1.0, peak_flops=100.0) == 0.5
    assert mfu(50.0, 0.0, peak_flops=100.0) is None
    # unknown peak (no card here) -> None rather than a fabricated number
    assert device_peak_flops() is None
    assert mfu(50.0, 1.0) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    assert device_peak_flops() == 989e12 == PEAK_BF16_FLOPS["h100"]
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 PCIe")
    assert device_peak_flops() == 756e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "Some Other Card")
    assert device_peak_flops() is None


def test_roofline_summary_shape():
    out = roofline_summary(1e12, 0.5)
    assert out["achieved_tflops"] == 2.0
    assert set(out) == set(jprofiling.roofline_summary(1e12, 0.5))
    assert set(out) == {"flops", "seconds", "achieved_tflops", "peak_tflops", "mfu"}


def test_device_trace_noop_and_capture(tmp_path):
    with device_trace(None):
        pass  # no-op path
    out = tmp_path / "trace"
    with device_trace(out):
        torch.square(torch.arange(8.0))
    assert (out / "trace.json").stat().st_size > 0


def test_vit_forward_flops_closed_form():
    """Analytic FLOPs equal the counted ones, and (as the JAX test holds)
    one layer of ViT-B/448 at batch 32 is within 3% of the 454.3 GFLOP the
    JAX package's compiled cost model gave on its hardware. Counted on fake
    tensors: no memory, no arithmetic."""
    cfg = tvit.vit_config("base", image_size=448, num_classes=13461, depth=1)
    with FakeTensorMode():
        cost = compiled_cost(tvit.ViT(cfg), torch.empty(32, 448, 448, 3))
    one_layer = tvit.vit_forward_flops(cfg, 32)
    assert cost["flops"] == one_layer
    assert abs(one_layer - 454.3e9) / 454.3e9 < 0.03
    full = tvit.vit_forward_flops(tvit.vit_config("base", image_size=448, num_classes=13461), 32)
    assert full > 11 * (one_layer - 2 * 768 * 13461 * 32)


def test_mfu_and_roofline_edge_inputs():
    assert mfu(1e12, 0.0) is None  # zero elapsed: undefined, not inf
    assert mfu(1e12, 1.0, peak_flops=None) is None
    assert mfu(1e12, 1.0, peak_flops=2e12) == pytest.approx(0.5)
    out = roofline_summary(0.0, 0.0)
    assert out["achieved_tflops"] == 0.0


def test_device_trace_none_is_noop(tmp_path):
    with device_trace(None):
        pass  # no-op contract: no dir created, no error
    assert not any(tmp_path.iterdir())
