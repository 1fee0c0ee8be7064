"""Device profiling: trace capture, cost counts, MFU.

Counterpart of ``kobato_eyes_tpu/utils/profiling.py``:

- :func:`device_trace` captures a ``torch.profiler`` trace (CPU and CUDA
  activity, a Chrome trace viewable in Perfetto) around any block.
- :func:`compiled_cost` counts the FLOPs and the bytes of ``fn(*args)`` by
  running it once under ``torch.utils.flop_counter.FlopCounterMode`` (2
  FLOPs a multiply-add of the matrix products, convolutions and attention)
  and a dispatch mode that adds up every operator's input and output bytes
  (``bytes accessed``, as XLA's cost analysis names it). PyTorch runs
  eagerly, so there is no compiled executable to ask: the counts are of the
  operators the call dispatches.
- :func:`mfu` turns (flops, seconds) into model-flops-utilization against
  the device's published peak.

The peaks are the published dense bf16 rates of the cards the port runs on
(NVIDIA's data sheets), keyed by a substring of
``torch.cuda.get_device_name(0)``; not measurements. A device not in the
table has no peak, and :func:`mfu` then returns None.
"""

from __future__ import annotations

import contextlib
import logging
from pathlib import Path
from typing import Any, Callable, Iterator

logger = logging.getLogger(__name__)

# Published per-card peak dense-matmul throughput, bf16 FLOP/s. Keys are
# matched as substrings of the lowercased device name, first match wins.
PEAK_BF16_FLOPS: dict[str, float] = {
    "h100 pcie": 756e12,
    "h100": 989e12,  # SXM (the "H100 80GB HBM3" of chip_smoke.py's runs)
    "h200": 989e12,
}


def device_peak_flops() -> float | None:
    """Peak bf16 FLOP/s of the first CUDA device, or None if unknown."""
    import torch

    if not torch.cuda.is_available():
        return None
    kind = torch.cuda.get_device_name(0).lower()
    for key, peak in PEAK_BF16_FLOPS.items():
        if key in kind:
            return peak
    return None


def peak_flops_for(device: Any) -> float | None:
    """Peak bf16 FLOP/s of the card a measurement ran on: None for the CPU
    (a CPU run has no device rate to hold it against); on a CUDA device its
    published peak, and a card missing from :data:`PEAK_BF16_FLOPS` raises,
    so that no number is ever held against a peak of another device."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    kind = torch.cuda.get_device_name(device).lower()
    for key, peak in PEAK_BF16_FLOPS.items():
        if key in kind:
            return peak
    raise RuntimeError(f"no published bf16 peak for {kind!r}; add it to PEAK_BF16_FLOPS")


@contextlib.contextmanager
def device_trace(outdir: str | Path | None) -> Iterator[None]:
    """Capture a torch.profiler trace into ``outdir`` (no-op when None).

    Degrades to a no-op with a warning if the profiler cannot start (e.g. a
    sandbox without CUPTI): profiling is observability, never correctness.
    """
    if outdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = Path(outdir)
    path.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        prof.__enter__()
    except Exception:
        logger.warning("device trace unavailable on this backend", exc_info=True)
        yield
        return
    try:
        yield
    finally:
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(str(path / "trace.json"))
            logger.info("device trace written to %s", path)
        except Exception:
            logger.warning("device trace finalization failed", exc_info=True)


def compiled_cost(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> dict[str, float]:
    """FLOPs and bytes of ``fn(*args, **kwargs)``, counted over the operators
    one run dispatches: ``{"flops": ..., "bytes accessed": ...}``; empty
    when the call cannot be counted."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import FlopCounterMode

    class _Bytes(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in torch.utils._pytree.tree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor):
                    self.total += t.numel() * t.element_size()
            return out

    try:
        counter = FlopCounterMode(display=False)
        with torch.inference_mode(), counter, _Bytes() as bytes_mode:
            fn(*args, **kwargs)
    except Exception:
        logger.warning("cost analysis unavailable", exc_info=True)
        return {}
    return {"flops": float(counter.get_total_flops()), "bytes accessed": float(bytes_mode.total)}


def mfu(flops: float, seconds: float, peak_flops: float | None = None) -> float | None:
    """Model-flops-utilization in [0,1]; None when the peak is unknown."""
    peak = peak_flops if peak_flops is not None else device_peak_flops()
    if not peak or seconds <= 0:
        return None
    return (flops / seconds) / peak


def roofline_summary(flops: float, seconds: float, *, device: Any = None) -> dict[str, float | None]:
    """Achieved TFLOP/s + MFU for a measured (flops, wall) pair. ``device``:
    the device the wall was measured on, whose peak (:func:`peak_flops_for`)
    the MFU is held against; without it, the first CUDA device's, if known."""
    achieved = flops / seconds if seconds > 0 else 0.0
    peak = device_peak_flops() if device is None else peak_flops_for(device)
    util = mfu(flops, seconds, peak) if peak else None
    return {
        "flops": flops,
        "seconds": seconds,
        "achieved_tflops": achieved / 1e12,
        "peak_tflops": (peak / 1e12) if peak else None,
        "mfu": util,
    }
