"""64-bit hash word helpers shared by host-side code.

TPUs have no native uint64, so the engine represents every 64-bit perceptual
hash as a pair of uint32 words ``(hi, lo)`` where ``value = hi << 32 | lo``.
These helpers convert between that device layout, Python ints, and the
signed-64 form used for storage parity (the reference wraps hashes to signed
64-bit for SQLite; src/sig/phash.py:29-30).
"""

from __future__ import annotations

import numpy as np

U64_MASK = (1 << 64) - 1


def to_signed64(value: int) -> int:
    """Wrap an unsigned 64-bit value into signed-64 range."""
    value &= U64_MASK
    return value - (1 << 64) if value >= (1 << 63) else value


def to_unsigned64(value: int) -> int:
    """Inverse of :func:`to_signed64`."""
    return value & U64_MASK


def u64_to_u32pair(values: np.ndarray) -> np.ndarray:
    """(N,) uint64 -> (N, 2) uint32 as [hi, lo]."""
    v = np.asarray(values, dtype=np.uint64)
    hi = (v >> np.uint64(32)).astype(np.uint32)
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return np.stack([hi, lo], axis=-1)


def u32pair_to_u64(pairs: np.ndarray) -> np.ndarray:
    """(N, 2) uint32 [hi, lo] -> (N,) uint64."""
    p = np.asarray(pairs, dtype=np.uint32)
    return (p[..., 0].astype(np.uint64) << np.uint64(32)) | p[..., 1].astype(np.uint64)


def ints_to_u32pairs(values: list[int] | np.ndarray) -> np.ndarray:
    """Python ints (signed or unsigned 64-bit) -> (N, 2) uint32 pairs."""
    arr = np.array([int(v) & U64_MASK for v in values], dtype=np.uint64)
    return u64_to_u32pair(arr)


def u32pairs_to_signed_ints(pairs: np.ndarray) -> list[int]:
    """(N, 2) uint32 pairs -> signed-64 Python ints (storage form)."""
    return [to_signed64(int(v)) for v in u32pair_to_u64(pairs)]


def popcount64_np(values: np.ndarray) -> np.ndarray:
    """Vectorized popcount over uint64 (host reference path)."""
    v = np.asarray(values, dtype=np.uint64)
    if hasattr(np, "bitwise_count"):  # numpy >= 2.0: single C ufunc pass
        return np.bitwise_count(v).astype(np.uint32)
    count = np.zeros(v.shape, dtype=np.uint32)
    for shift in range(0, 64, 8):
        count += _POP8[(v >> np.uint64(shift)).astype(np.uint64) & np.uint64(0xFF)]
    return count


_POP8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint32)


def hamming64_int(a: int, b: int) -> int:
    """Hamming distance between two 64-bit hash ints (any signedness)."""
    return ((int(a) ^ int(b)) & U64_MASK).bit_count()
