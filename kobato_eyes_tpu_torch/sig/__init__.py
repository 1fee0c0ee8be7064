"""Perceptual-signature layer: host decode feeding batched device hash kernels."""

from kobato_eyes_tpu_torch.sig.signatures import (
    SignatureBatch,
    compute_signatures,
    hash_images,
    phash_image,
    dhash_image,
)

__all__ = [
    "SignatureBatch",
    "compute_signatures",
    "hash_images",
    "phash_image",
    "dhash_image",
]
