"""Pair-level refinement (library path): metric table -> OR decision.

Counterpart of ``kobato_eyes_tpu/dup/refine.py``, the behavioral
counterpart of the reference's ``src/dup/refine.py`` (duplicate iff SSIM >=
0.9 OR ORB match ratio >= 0.15), extended with the tile-aHash structural
signal the reference app uses in production (``ui/dup_refine_parallel.py``).
The implementation is metric-table driven: each metric is an independent
scorer with its own threshold and failure policy (a metric that raises
degrades to "no opinion", it never aborts the pair — reference failure
policy, dup/refine.py:90-97).

SSIM and tile-aHash run as batched device passes (ops/ssim.py,
ops/tile_hash.py) on ``device`` (default ``cuda``; raises without a GPU).
ORB stays a host signal via OpenCV when importable — keypoint detection is
branch-heavy and tiny; the device adds nothing there. Without OpenCV the ORB
ratio is ``None``, as in the JAX package.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
from PIL import Image, ImageOps

from kobato_eyes_tpu_torch.device import resolve_device
from kobato_eyes_tpu_torch.ops.ssim import ssim_batch
from kobato_eyes_tpu_torch.ops.tile_hash import tile_ahash_batch, tile_hamming_words
from kobato_eyes_tpu_torch.utils.image_io import safe_load_image

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class RefinementThresholds:
    """Per-metric accept thresholds (reference defaults 0.9 / 0.15)."""

    ssim: float = 0.9
    orb: float = 0.15
    structural: float = 0.85  # tile-hash agreement (additional signal)


@dataclass(frozen=True)
class RefinedMatch:
    file_id_a: int
    file_id_b: int
    ssim: float | None
    structural_ratio: float | None
    is_duplicate: bool
    reason: str
    orb_ratio: float | None = None  # None when OpenCV is unavailable


def _gray_f32(img: Image.Image, size: tuple[int, int]) -> np.ndarray:
    """Grayscale crop-fit to ``size`` in [0, 1] (ImageOps.fit semantics)."""
    fitted = ImageOps.fit(img.convert("L"), size, Image.Resampling.BICUBIC)
    return np.asarray(fitted, dtype=np.float32) / 255.0


def compute_ssim(img_a: Image.Image, img_b: Image.Image, *, device=None) -> float:
    """SSIM over the pair fitted to their common size (on ``device``)."""
    common = (min(img_a.width, img_b.width), min(img_a.height, img_b.height))
    if 0 in common:
        common = (max(img_a.width, img_b.width), max(img_a.height, img_b.height))
    pair = np.stack([_gray_f32(img_a, common), _gray_f32(img_b, common)])
    return float(ssim_batch(pair[:1], pair[1:], device=device)[0])


def compute_orb_ratio(img_a: Image.Image, img_b: Image.Image, *, device=None) -> float | None:
    """Mutual-best ORB match ratio in [0, 1]; None when OpenCV is absent.

    Semantics follow the reference scorer: the ratio denominator is the
    smaller keypoint count, and a side with no detectable features scores 0.
    A host signal: ``device`` is not used.
    """
    try:
        import cv2
    except ImportError:
        return None

    def _features(img: Image.Image):
        return cv2.ORB_create().detectAndCompute(np.asarray(img.convert("L")), None)

    kp_a, desc_a = _features(img_a)
    kp_b, desc_b = _features(img_b)
    n_min = min(len(kp_a or ()), len(kp_b or ()))
    if n_min == 0 or desc_a is None or desc_b is None:
        return 0.0
    mutual = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True).match(desc_a, desc_b)
    return len(mutual) / n_min


def compute_structural_ratio(
    img_a: Image.Image, img_b: Image.Image, *, grid: int = 8, tile: int = 8, device=None
) -> float:
    """Tile-aHash agreement in 0..1 (1 = identical structure; on ``device``)."""
    side = grid * tile
    frames = np.stack([
        np.asarray(img.convert("L").resize((side, side), Image.Resampling.BILINEAR), np.uint8)
        for img in (img_a, img_b)
    ])
    words = tile_ahash_batch(frames, grid=grid, tile=tile, device=device)
    dist = int(tile_hamming_words(words[0][None], words[1][None])[0])
    return 1.0 - dist / (side * side)


# Metric table: (field name, scorer, threshold accessor).  Order fixes the
# order of reason fragments; adding a signal means adding a row, not another
# try/except block.
_METRICS: tuple[tuple[str, Callable, Callable[[RefinementThresholds], float]], ...] = (
    ("ssim", compute_ssim, lambda t: t.ssim),
    ("orb_ratio", compute_orb_ratio, lambda t: t.orb),
    ("structural_ratio", compute_structural_ratio, lambda t: t.structural),
)


def _score_metrics(
    img_a: Image.Image, img_b: Image.Image, tag: str, device
) -> tuple[dict[str, float | None], list[str]]:
    """Run every metric; a raising metric scores None and is noted."""
    scores: dict[str, float | None] = {}
    degraded: list[str] = []
    for name, scorer, _ in _METRICS:
        try:
            scores[name] = scorer(img_a, img_b, device=device)
        except Exception:
            scores[name] = None
            degraded.append(name)
            logger.warning("pair metric %s raised on %s", name, tag, exc_info=True)
    return scores, degraded


def refine_pair(
    file_id_a: int,
    file_id_b: int,
    path_a: str | Path,
    path_b: str | Path,
    *,
    thresholds: RefinementThresholds | None = None,
    device=None,
) -> RefinedMatch | None:
    """Score one candidate pair on ``device`` (default ``cuda``; raises
    without a GPU, before any metric runs); None when either image fails to
    load."""
    device = resolve_device(device)
    img_a = safe_load_image(path_a)
    img_b = safe_load_image(path_b)
    if img_a is None or img_b is None:
        return None

    cfg = thresholds or RefinementThresholds()
    scores, degraded = _score_metrics(img_a, img_b, f"({path_a}, {path_b})", device)

    hits = [
        f"{name} {scores[name]:.3f} >= {thr_of(cfg)}"
        for name, _, thr_of in _METRICS
        if scores[name] is not None and scores[name] >= thr_of(cfg)
    ]
    if hits:
        reason = " + ".join(hits)
    elif degraded:
        reason = "degraded: " + ", ".join(degraded)
    else:
        reason = "no metric cleared its threshold"

    return RefinedMatch(
        file_id_a=file_id_a,
        file_id_b=file_id_b,
        ssim=scores["ssim"],
        structural_ratio=scores["structural_ratio"],
        is_duplicate=bool(hits),
        reason=reason,
        orb_ratio=scores["orb_ratio"],
    )


__all__ = [
    "RefinementThresholds",
    "RefinedMatch",
    "refine_pair",
    "compute_ssim",
    "compute_orb_ratio",
    "compute_structural_ratio",
]
