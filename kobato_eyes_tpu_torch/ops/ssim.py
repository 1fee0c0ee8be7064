"""Batched SSIM on the device.

Counterpart of ``kobato_eyes_tpu/ops/ssim.py``, the replacement for the
reference's per-pair scikit-image call (``src/dup/refine.py:44-52``, skimage
``structural_similarity`` with default parameters on float images,
``data_range=1.0``). The defaults it relies on:

    win_size = 7, uniform (box) windows, K1 = 0.01, K2 = 0.03,
    sample covariance normalisation N/(N-1) with N = win_size**2,
    score = mean of the SSIM map cropped by (win_size-1)//2 on every edge.

The cropped region holds only fully-valid windows, so window sums over
VALID windows (``avg_pool2d`` with ``divisor_override=1``: a sum, divided by
``win * win`` after, as the JAX package's ``reduce_window`` does) reproduce
the cropped skimage map. All five window sums for a batch of pairs run on
``device`` (default ``cuda``; raises without a GPU).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from kobato_eyes_tpu_torch.device import resolve_device

_K1 = 0.01
_K2 = 0.03


def _window_mean(x: torch.Tensor, win: int) -> torch.Tensor:
    """(B, H, W) -> (B, H-win+1, W-win+1) box-window means."""
    s = F.avg_pool2d(x[:, None], win, stride=1, divisor_override=1)[:, 0]
    return s / (win * win)


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)


def ssim_map_valid(a, b, *, win_size: int = 7, device=None) -> torch.Tensor:
    """SSIM map over fully-valid windows for (B, H, W) float32 pairs in 0..1
    (numpy arrays or tensors; numpy arrays go to ``device``)."""
    dev = a.device if isinstance(a, torch.Tensor) else resolve_device(device)
    a = _as_tensor(a, dev)
    b = _as_tensor(b, dev)
    ux = _window_mean(a, win_size)
    uy = _window_mean(b, win_size)
    uxx = _window_mean(a * a, win_size)
    uyy = _window_mean(b * b, win_size)
    uxy = _window_mean(a * b, win_size)
    n = win_size * win_size
    cov_norm = n / (n - 1.0)  # sample covariance (skimage default)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = _K1 * _K1  # data_range = 1.0
    c2 = _K2 * _K2
    a1 = 2.0 * ux * uy + c1
    a2 = 2.0 * vxy + c2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    return (a1 * a2) / (b1 * b2)


def ssim_batch(a, b, *, win_size: int = 7, device=None) -> np.ndarray:
    """(B, H, W) float32 image pairs in 0..1 -> (B,) SSIM scores (numpy)."""
    with torch.inference_mode():
        return ssim_map_valid(a, b, win_size=win_size, device=device).mean(dim=(1, 2)).cpu().numpy()


# ---------------------------------------------------------------------------
# numpy reference (executable spec; float64, mirrors the skimage defaults)
# ---------------------------------------------------------------------------


def ssim_np(a: np.ndarray, b: np.ndarray, win_size: int = 7) -> float:
    a = a.astype(np.float64)
    b = b.astype(np.float64)

    def box(x: np.ndarray) -> np.ndarray:
        # valid-window box means via 2-D cumulative sums
        c = np.cumsum(np.cumsum(x, axis=0), axis=1)
        c = np.pad(c, ((1, 0), (1, 0)))
        w = win_size
        s = c[w:, w:] - c[:-w, w:] - c[w:, :-w] + c[:-w, :-w]
        return s / (w * w)

    ux, uy = box(a), box(b)
    uxx, uyy, uxy = box(a * a), box(b * b), box(a * b)
    n = win_size * win_size
    cov_norm = n / (n - 1.0)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1, c2 = _K1**2, _K2**2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))
    return float(s.mean())
