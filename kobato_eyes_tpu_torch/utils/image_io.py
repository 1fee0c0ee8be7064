"""Safe image loading for the indexing pipelines.

Behavioral counterpart of the reference's ``src/utils/image_io.py:60-151``
(``safe_load_image``): header-first size check with a hard megapixel cap,
decompression-bomb tolerance, EXIF orientation transpose, and alpha
composited over white into plain RGB.  Thumbnailing for UI surfaces is out of
scope for the engine; the loader instead exposes an optional longest-side
clamp used to bound host->device transfer sizes.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
from PIL import Image, ImageOps

logger = logging.getLogger(__name__)

# Hard skip for absurd images (reference uses 220 Mpx; src/utils/image_io.py:55-57).
DEFAULT_MAX_PIXELS = 220_000_000
# Pillow's own decompression-bomb warning threshold would reject large-but-legit
# scans; raise it and rely on our explicit cap instead.
Image.MAX_IMAGE_PIXELS = None


class ImageTooLargeError(ValueError):
    """Image exceeds the configured pixel cap."""


def safe_load_image(
    path: str | Path,
    *,
    max_pixels: int = DEFAULT_MAX_PIXELS,
    max_side: int | None = None,
) -> Image.Image | None:
    """Load an image defensively; return None when undecodable.

    - Checks the header-reported size against ``max_pixels`` before decoding.
    - Applies EXIF orientation.
    - Composites any alpha channel over white and converts to RGB.
    - Optionally clamps the longest side to ``max_side`` (BILINEAR), used to
      bound transfer size when the device does the final resize.
    """
    p = Path(path)
    try:
        with Image.open(p) as opened:
            width, height = opened.size
            if width * height > max_pixels:
                logger.warning("image too large, skipping: %s (%dx%d)", p, width, height)
                return None
            opened = ImageOps.exif_transpose(opened)
            img = _flatten_to_rgb(opened)
    except (OSError, ValueError, SyntaxError) as exc:
        # Failure policy: undecodable files are per-item data errors, never
        # pipeline-fatal (reference loaders.py:426-452 falls back then skips).
        logger.warning("failed to load image %s: %s", p, exc)
        return None
    if max_side is not None and max(img.size) > max_side:
        scale = max_side / max(img.size)
        new_size = (max(1, round(img.width * scale)), max(1, round(img.height * scale)))
        img = img.resize(new_size, Image.Resampling.BILINEAR)
    return img


def _flatten_to_rgb(img: Image.Image) -> Image.Image:
    """Composite alpha over white, yielding RGB.

    Matches the reference's alpha handling (white matte before any resize;
    loaders.py:147-168) so downstream hashes agree.
    """
    if img.mode == "RGB":
        return img.copy()
    if img.mode in ("RGBA", "LA", "PA") or (img.mode == "P" and "transparency" in img.info):
        rgba = img.convert("RGBA")
        background = Image.new("RGBA", rgba.size, (255, 255, 255, 255))
        return Image.alpha_composite(background, rgba).convert("RGB")
    return img.convert("RGB")


def load_rgb_array(
    path: str | Path,
    *,
    max_pixels: int = DEFAULT_MAX_PIXELS,
    max_side: int | None = None,
) -> np.ndarray | None:
    """Load to an (H, W, 3) uint8 RGB array, or None on failure."""
    img = safe_load_image(path, max_pixels=max_pixels, max_side=max_side)
    if img is None:
        return None
    return np.asarray(img, dtype=np.uint8)


def generate_thumbnail(
    path: str | Path,
    *,
    cache_dir: str | Path,
    size: int = 256,
    quality: int = 80,
) -> Path | None:
    """Cached WEBP thumbnail keyed by path+size+mtime (reference
    image_io.py:181-263 semantics). Returns the cached file, None on failure."""
    import hashlib

    p = Path(path)
    try:
        st = p.stat()
    except OSError:
        return None
    key = hashlib.sha1(f"{p}|{size}|{st.st_size}|{st.st_mtime_ns}".encode()).hexdigest()
    cache = Path(cache_dir)
    dest = cache / key[:2] / f"{key}.webp"
    if dest.exists():
        return dest
    img = safe_load_image(p)
    if img is None:
        return None
    img.thumbnail((size, size), Image.Resampling.BILINEAR)
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_suffix(".tmp.webp")
    try:
        img.save(tmp, "WEBP", quality=quality)
        tmp.replace(dest)
    except OSError as exc:
        logger.warning("thumbnail write failed for %s: %s", p, exc)
        return None
    return dest


def gray_resized(img: Image.Image, size: tuple[int, int], resample: Image.Resampling) -> np.ndarray:
    """Grayscale-convert then resize; float32 output.

    The grayscale+resize front half of the reference's hash pipeline
    (sig/phash.py:22-27).  Conversion uses PIL's ITU-R 601-2 weights so hashes
    computed here agree bit-for-bit with any PIL-based implementation.
    """
    gray = img.convert("L").resize(size, resample)
    return np.asarray(gray, dtype=np.float32)
