"""The host side of a picture, plainly: WD14's letterbox (white square pad,
then PIL's BOX to shrink and BICUBIC to grow)."""

from __future__ import annotations

import numpy as np
from PIL import Image


def letterbox(rgb: np.ndarray, size: int) -> np.ndarray:
    h, w = rgb.shape[:2]
    side = max(h, w)
    if h != w:
        canvas = np.full((side, side, 3), 255, dtype=np.uint8)
        top, left = (side - h) // 2, (side - w) // 2
        canvas[top : top + h, left : left + w] = rgb
        rgb = canvas
    if side != size:
        resample = Image.Resampling.BOX if side > size else Image.Resampling.BICUBIC
        rgb = np.asarray(Image.fromarray(rgb).resize((size, size), resample), dtype=np.uint8)
    return rgb

