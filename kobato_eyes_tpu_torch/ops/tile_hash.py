"""Batched tile-aHash on the device.

Counterpart of ``kobato_eyes_tpu/ops/tile_hash.py``, replacing the
reference's per-file tile hash (``src/ui/dup_refine_parallel.py:59-83``):
the whole set of (grid*tile)^2 grayscale thumbnails is hashed in one
vectorized pass. Bit semantics are identical -- per-tile mean binarisation
with *strict* greater-than, bit stream ordered (gy, gx, ty, tx), packed
little-endian.

Exactness note: the reference compares uint8 pixels against a float64 tile
mean.  To stay bit-exact without relying on float rounding, the device pass
compares ``pixel * tile_area > tile_sum`` in integer arithmetic, which is
equivalent for positive tile areas and exact at every boundary. Words are
packed in int64 (torch's unsigned types have no shifts) and fetched as
``np.uint32``.
"""

from __future__ import annotations

import numpy as np
import torch

from kobato_eyes_tpu_torch.device import resolve_device

_POP8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint32)


def tile_ahash_batch(gray: np.ndarray, *, grid: int, tile: int, device=None) -> np.ndarray:
    """(B, side, side) uint8 grayscale (side = grid*tile) -> packed bits.

    Returns (B, nbits // 32) uint32 words in little-endian stream order
    (word w bit b == stream bit 32*w + b), matching the reference's
    ``np.packbits(bitorder="little")`` + ``int.from_bytes(..., "little")``.
    """
    b = gray.shape[0]
    nbits = grid * grid * tile * tile
    assert nbits % 32 == 0, "grid*tile must make the bit count a multiple of 32"
    x = torch.from_numpy(np.ascontiguousarray(gray)).to(resolve_device(device)).to(torch.int32)
    # (B, gy, ty, gx, tx) -> (B, gy, gx, ty, tx): the reference bit order.
    a = x.reshape(b, grid, tile, grid, tile).permute(0, 1, 3, 2, 4)
    sums = a.sum(dim=(3, 4), keepdim=True)
    bits = (a * (tile * tile)) > sums  # exact integer compare == pixel > mean
    flat = bits.reshape(b, nbits // 32, 32).to(torch.int64)
    weights = torch.ones((), dtype=torch.int64, device=x.device) << torch.arange(
        32, dtype=torch.int64, device=x.device
    )
    return (flat * weights).sum(dim=-1).cpu().numpy().astype(np.uint32)


def words_to_int(words: np.ndarray) -> int:
    """One row of packed uint32 words -> arbitrary-precision Python int."""
    return int.from_bytes(np.ascontiguousarray(words, dtype="<u4").tobytes(), "little")


def tile_hamming_words(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise Hamming distance between packed word arrays (..., W)."""
    xor = (np.asarray(a, dtype=np.uint32) ^ np.asarray(b, dtype=np.uint32)).view(np.uint8)
    return _POP8[xor].reshape(*xor.shape[:-1], -1).sum(axis=-1)



def tile_ahash_int(gray: np.ndarray, *, grid: int, tile: int, device=None) -> int:
    """Single-image helper mirroring the reference's int return."""
    words = tile_ahash_batch(gray[None], grid=grid, tile=tile, device=device)[0]
    return words_to_int(words)

# ---------------------------------------------------------------------------
# numpy reference (executable spec)
# ---------------------------------------------------------------------------


def tile_ahash_np(arr: np.ndarray, grid: int, tile: int) -> int:
    """Reference formula: per-tile float mean, strict >, little-endian pack."""
    a = arr.reshape(grid, tile, grid, tile).transpose(0, 2, 1, 3)
    means = a.mean(axis=(2, 3), keepdims=True)
    bits = (a > means).reshape(-1).astype(np.uint8)
    packed = np.packbits(bits, bitorder="little")
    return int.from_bytes(packed.tobytes(), "little")
