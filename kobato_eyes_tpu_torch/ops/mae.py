"""Batched pixel mean-absolute-error on the device.

Counterpart of ``kobato_eyes_tpu/ops/mae.py``, replacing the reference's
per-pair 128x128 grayscale MAE (``src/ui/dup_refine_parallel.py:205-215``):
absolute-difference sums for a whole batch of (member, keeper) thumbnail
pairs are computed on the device, exact in int32; the final 0..1
normalisation and threshold compare happen on the host in float64 so the
decision is bit-identical to ``np.mean(|a-b|)/255 <= thr``.
"""

from __future__ import annotations

import numpy as np
import torch

from kobato_eyes_tpu_torch.device import resolve_device


def abs_diff_sums(a: np.ndarray, b: np.ndarray, *, device=None) -> np.ndarray:
    """(B, H, W) uint8 pairs -> (B,) int32 sums of |a - b| (exact while
    255 * H * W < 2^31, as at the 128x128 thumbnails)."""
    dev = resolve_device(device)
    ta = torch.from_numpy(np.ascontiguousarray(a)).to(dev).to(torch.int32)
    tb = torch.from_numpy(np.ascontiguousarray(b)).to(dev).to(torch.int32)
    return (ta - tb).abs().sum(dim=(1, 2), dtype=torch.int32).cpu().numpy()


def mae01_batch(a: np.ndarray, b: np.ndarray, *, device=None) -> np.ndarray:
    """(B, H, W) uint8 pairs -> (B,) float64 MAE in 0..1 (reference order)."""
    sums = abs_diff_sums(a, b, device=device).astype(np.float64)
    n = a.shape[1] * a.shape[2]
    return (sums / n) / 255.0


def mae01_np(a: np.ndarray, b: np.ndarray) -> float:
    """Reference formula (dup_refine_parallel.py:211-213)."""
    return float(np.mean(np.abs(a.astype(np.int16) - b.astype(np.int16))) / 255.0)
