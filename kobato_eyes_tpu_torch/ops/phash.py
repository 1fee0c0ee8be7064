"""Batched perceptual hashing on the device (pHash64 / dHash64).

Counterpart of ``kobato_eyes_tpu/ops/phash.py``: the 2-D DCT-II of a batch
of 32x32 grayscale tiles as two basis products ``C @ X @ C.T``, the 8x8
low-frequency block, bits = coefficient > mean of the block without its
first element, packed MSB-first into a 64-bit word held as a ``(B, 2)``
[hi, lo] pair of 32-bit values. dHash compares adjacent columns of an
(8, 9) tile.

Two choices differ from the JAX module, both for exact bits:

* The DCT runs in float64 on the device. The JAX function takes it in f32 at
  ``Precision.HIGHEST``; on the card a float32 product could go through TF32
  (three decimal digits) if a global flag allowed it, and the tag stage's
  threads must not toggle those flags. The float64 product is immune to
  them, costs nothing at B x 32^3, and is what ``phash_np`` computes, the
  spec the JAX package's tests hold ``phash_batch`` to.
* Bits are packed and shifted in int64: torch's unsigned types have no
  shifts (``>>`` on a ``torch.uint32`` tensor raises on the CPU). The public
  functions return int64 tensors whose values are the 32-bit words;
  :func:`to_u32pairs` fetches them as ``np.uint32``.

The grayscale conversion and LANCZOS resize stay on the host (PIL), in
``sig/signatures.py``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from kobato_eyes_tpu_torch.device import resolve_device


@lru_cache(maxsize=None)
def dct2_basis(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis matrix (float64): D = C @ X @ C.T.

    Matches cv2.dct's scaling convention (orthonormal DCT-II).
    """
    k = np.arange(n)[:, None].astype(np.float64)
    m = np.arange(n)[None, :].astype(np.float64)
    basis = np.cos(np.pi * (2.0 * m + 1.0) * k / (2.0 * n))
    scale = np.full((n, 1), np.sqrt(2.0 / n))
    scale[0, 0] = np.sqrt(1.0 / n)
    return basis * scale


def _on_device(x: np.ndarray | torch.Tensor, device) -> torch.Tensor:
    """A tensor stays where it is unless ``device`` names another place;
    an array goes to ``device`` (``cuda`` when None)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(resolve_device(device))
    return torch.from_numpy(np.ascontiguousarray(x)).to(resolve_device(device))


def pack_bits64(bits: torch.Tensor) -> torch.Tensor:
    """(B, 64) bool, MSB-first -> (B, 2) int64 [hi, lo], each in [0, 2^32)."""
    weights = torch.ones((), dtype=torch.int64, device=bits.device) << (
        31 - torch.arange(32, dtype=torch.int64, device=bits.device)
    )
    b = bits.to(torch.int64)
    hi = (b[:, :32] * weights).sum(dim=1)
    lo = (b[:, 32:] * weights).sum(dim=1)
    return torch.stack([hi, lo], dim=-1)


def phash_batch(gray: np.ndarray | torch.Tensor, *, device=None) -> torch.Tensor:
    """Batched pHash64: (B, 32, 32) grayscale -> (B, 2) int64 [hi, lo].

    Queued on the device without waiting for it.
    """
    x = _on_device(gray, device).to(torch.float64)
    # only the 8x8 low-frequency block is read: its rows of the basis suffice
    c8 = torch.from_numpy(dct2_basis(32)[:8]).to(x.device)
    block = torch.einsum("km,bmn,ln->bkl", c8, x, c8).reshape(-1, 64)
    mean = (block.sum(dim=1, keepdim=True) - block[:, :1]) / 63.0
    return pack_bits64(block > mean)


def dhash_batch(gray: np.ndarray | torch.Tensor, *, device=None) -> torch.Tensor:
    """Batched dHash64: (B, 8, 9) grayscale -> (B, 2) int64 [hi, lo]."""
    x = _on_device(gray, device)
    diff = x[:, :, 1:] > x[:, :, :-1]
    return pack_bits64(diff.reshape(-1, 64))


def to_u32pairs(words: torch.Tensor) -> np.ndarray:
    """(B, 2) int64 words -> (B, 2) np.uint32 on the host."""
    return words.cpu().numpy().astype(np.uint32)


# ---------------------------------------------------------------------------
# numpy reference implementations (the executable spec; used by parity tests
# and by the CPU fallback path)
# ---------------------------------------------------------------------------


def phash_np(gray: np.ndarray) -> int:
    """Single-image pHash64 reference on float64; returns unsigned int."""
    c = dct2_basis(32)
    d = c @ gray.astype(np.float64) @ c.T
    flat = d[:8, :8].reshape(64)
    mean = flat[1:].mean() if flat.size > 1 else flat.mean()
    bits = flat > mean
    value = 0
    for bit in bits:
        value = (value << 1) | int(bit)
    return value & 0xFFFFFFFFFFFFFFFF


def dhash_np(gray: np.ndarray) -> int:
    """Single-image dHash64 reference; gray is (8, 9) float."""
    diff = gray[:, 1:] > gray[:, :-1]
    value = 0
    for bit in diff.reshape(64):
        value = (value << 1) | int(bit)
    return value & 0xFFFFFFFFFFFFFFFF
