"""Seeded pictures: RGB sources for the tagging cells.

The set of sizes is the same for every seed (drawn once from a fixed
stream); the seed decides which picture gets which size and what each
picture shows. A picture is smooth colour fields at three scales (the
largest blobs a sixth of the picture, the finest three pixels), so that it
letterboxes as an illustration does rather than as white noise. Picture ``i`` of a seed can be made again alone.
"""

from __future__ import annotations

import math

import numpy as np
from PIL import Image

SIZE_STREAM = 20240611  # fixed: the sizes do not depend on the seed


def picture_sizes(count: int, long_lo: int, long_hi: int, aspect_lo: float, aspect_hi: float) -> np.ndarray:
    """(count, 2) (height, width): the long side log-uniform in
    [long_lo, long_hi], the aspect width / height log-uniform in
    [aspect_lo, aspect_hi]; seed-independent."""
    rng = np.random.default_rng(SIZE_STREAM)
    long_side = np.exp(rng.uniform(math.log(long_lo), math.log(long_hi), count))
    aspect = np.exp(rng.uniform(math.log(aspect_lo), math.log(aspect_hi), count))
    h = np.where(aspect >= 1, long_side / aspect, long_side)
    w = np.where(aspect >= 1, long_side, long_side * aspect)
    return np.stack([np.maximum(np.rint(h), 16), np.maximum(np.rint(w), 16)], axis=1).astype(np.int64)


def assign_sizes(seed_words: list[int], sizes: np.ndarray) -> np.ndarray:
    """The seed's order of the fixed sizes: picture i gets ``out[i]``."""
    perm = np.random.default_rng([*seed_words, 1]).permutation(len(sizes))
    return sizes[perm]


def _octave(rng: np.random.Generator, h: int, w: int, cell: int) -> np.ndarray:
    gh, gw = max(2, -(-h // cell) + 1), max(2, -(-w // cell) + 1)
    small = Image.fromarray(rng.integers(0, 256, (gh, gw, 3), dtype=np.uint8))
    return np.asarray(small.resize((w, h), Image.Resampling.BICUBIC))


def _blend(a: np.ndarray, b: np.ndarray, alpha: float) -> np.ndarray:
    """PIL's ``Image.blend`` of two uint8 pictures, value for value (a float32
    ``a + alpha * (b - a)``, truncated), in NumPy, which lets the other
    set-up threads run where PIL's blend holds the interpreter's lock."""
    a32 = a.astype(np.float32)
    return (a32 + np.float32(alpha) * (b.astype(np.float32) - a32)).astype(np.uint8)


def picture(seed_words: list[int], index: int, h: int, w: int) -> np.ndarray:
    """(h, w, 3) uint8 RGB, a function of the seed and ``index`` alone."""
    rng = np.random.default_rng([*seed_words, 2, int(index)])
    big = max(h, w)
    coarse = _octave(rng, h, w, max(8, big // 6))
    middle = _octave(rng, h, w, max(4, big // 48))
    fine = _octave(rng, h, w, 3)
    return _blend(_blend(coarse, middle, 0.32), fine, 0.14)
