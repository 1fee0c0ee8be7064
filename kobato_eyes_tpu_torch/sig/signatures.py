"""Host pipeline for batched signature computation.

Counterpart of ``kobato_eyes_tpu/sig/signatures.py``: a thread pool decodes
and downsamples images on the host (PIL, the reference's grayscale and
LANCZOS front end, unchanged) and one batched device pass computes all
pHash / dHash words per chunk (``ops/phash.py``). Every entry point takes
``device`` (``cuda`` when None).
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterable, Sequence

import numpy as np
import torch
from PIL import Image

from kobato_eyes_tpu_torch.ops.phash import dhash_batch, phash_batch, to_u32pairs
from kobato_eyes_tpu_torch.utils.bits import to_signed64, u32pair_to_u64
from kobato_eyes_tpu_torch.utils.image_io import gray_resized, safe_load_image

logger = logging.getLogger(__name__)

_LANCZOS = Image.Resampling.LANCZOS


@dataclass
class SignatureBatch:
    """Signatures for a batch of files; hashes are signed-64 ints (storage form)."""

    file_ids: list[int]
    phash: list[int]
    dhash: list[int]
    failed_ids: list[int]


def _decode_one(path: str | Path) -> tuple[np.ndarray, np.ndarray] | None:
    img = safe_load_image(path)
    if img is None:
        return None
    g32 = gray_resized(img, (32, 32), _LANCZOS)
    g98 = gray_resized(img, (9, 8), _LANCZOS)  # PIL size=(w=9,h=8) -> array (8,9)
    return g32, g98


def hash_images(images: Sequence[Image.Image], *, device=None) -> tuple[np.ndarray, np.ndarray]:
    """PIL images -> (phash_pairs, dhash_pairs) as (N, 2) uint32 arrays."""
    g32 = np.stack([gray_resized(im, (32, 32), _LANCZOS) for im in images])
    g98 = np.stack([gray_resized(im, (9, 8), _LANCZOS) for im in images])
    return to_u32pairs(phash_batch(g32, device=device)), to_u32pairs(dhash_batch(g98, device=device))


def phash_image(image: Image.Image, *, device=None) -> int:
    """Single-image pHash64 as a signed-64 int (reference-compatible)."""
    ph, _ = hash_images([image], device=device)
    return to_signed64(int(u32pair_to_u64(ph)[0]))


def dhash_image(image: Image.Image, *, device=None) -> int:
    _, dh = hash_images([image], device=device)
    return to_signed64(int(u32pair_to_u64(dh)[0]))


# -- fused-lane split (dispatch/complete) -----------------------------------
# The index pipeline's tag stage chains signature hashing onto each batch's
# already-decoded pixels (core/pipeline/tag_stage.py): dispatch queues the
# device work WITHOUT syncing so the bounded in-flight window covers it,
# complete fetches both words in one copy to the host. Same functions as
# the standalone lane below => fused hashes are bit-identical by construction.


def gray_pair_from_rgb(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Decoded (H, W, 3) uint8 RGB -> the (32,32) and (8,9) float32 grayscale
    tiles the hash kernels consume. PIL round-trip keeps the ITU-R 601-2
    grayscale + LANCZOS front end identical to ``_decode_one``."""
    img = Image.fromarray(arr)
    return (
        gray_resized(img, (32, 32), _LANCZOS),
        gray_resized(img, (9, 8), _LANCZOS),
    )


def dispatch_hash_batch(g32: np.ndarray, g98: np.ndarray, *, device=None) -> torch.Tensor:
    """Queue pHash + dHash on the device without syncing; returns the
    (2, B, 2) int64 words [phash, dhash] still on the device."""
    return torch.stack([phash_batch(g32, device=device), dhash_batch(g98, device=device)])


def complete_hash_batch(pending: torch.Tensor) -> tuple[list[int], list[int]]:
    """Fetch a dispatched hash pair (one copy to the host) -> (phash, dhash)
    signed-64 lists."""
    words = to_u32pairs(pending)
    ph = u32pair_to_u64(words[0])
    dh = u32pair_to_u64(words[1])
    return (
        [to_signed64(int(v)) for v in ph],
        [to_signed64(int(v)) for v in dh],
    )


def compute_signatures(
    items: Iterable[tuple[int, str | Path]],
    *,
    batch_size: int = 1024,
    io_workers: int = 8,
    progress: Callable[[int, int], None] | None = None,
    is_cancelled: Callable[[], bool] | None = None,
    device=None,
) -> SignatureBatch:
    """Compute (phash, dhash) for (file_id, path) pairs.

    Decode failures are per-item skips, never fatal (failure policy of
    reference fastsig/_compute_worker).  Progress is reported per completed
    batch.
    """
    pending = list(items)
    total = len(pending)
    out = SignatureBatch(file_ids=[], phash=[], dhash=[], failed_ids=[])
    done = 0
    with ThreadPoolExecutor(max_workers=io_workers) as pool:
        for start in range(0, total, batch_size):
            if is_cancelled is not None and is_cancelled():
                break
            chunk = pending[start : start + batch_size]
            decoded = list(pool.map(lambda it: (it[0], _decode_one(it[1])), chunk))
            ok = [(fid, g) for fid, g in decoded if g is not None]
            out.failed_ids.extend(fid for fid, g in decoded if g is None)
            if ok:
                g32 = np.stack([g[0] for _, g in ok])
                g98 = np.stack([g[1] for _, g in ok])
                ph, dh = complete_hash_batch(dispatch_hash_batch(g32, g98, device=device))
                out.file_ids.extend(fid for fid, _ in ok)
                out.phash.extend(ph)
                out.dhash.extend(dh)
            done += len(chunk)
            if progress is not None:
                progress(done, total)
    return out
