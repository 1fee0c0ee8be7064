"""The host side of a PixAI picture, plainly: the short side scaled to the
model's size (PIL's BICUBIC, the long side rounded) and the centre cut out
(the upper-left of the two middles where the overhang is odd), as the
reference application's PixAI tagger prepares a picture."""

from __future__ import annotations

import numpy as np
from PIL import Image


def shortside_centercrop(rgb: np.ndarray, size: int) -> np.ndarray:
    h, w = rgb.shape[:2]
    short = min(h, w)
    nh, nw = max(size, round(h * size / short)), max(size, round(w * size / short))
    if (nh, nw) != (h, w):
        rgb = np.asarray(Image.fromarray(rgb).resize((nw, nh), Image.Resampling.BICUBIC), dtype=np.uint8)
    top, left = (nh - size) // 2, (nw - size) // 2
    return rgb[top : top + size, left : left + size]
