"""The port's pHash/dHash device pass against the JAX package's and the spec.

Seeded grayscale tiles go through ``kobato_eyes_tpu.ops.phash`` (XLA on the
CPU), ``kobato_eyes_tpu_torch.ops.phash`` on the CPU and the numpy spec
``phash_np`` / ``dhash_np``: every hash word must be equal (exact).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from PIL import Image

from kobato_eyes_tpu.ops import phash as jphash
from kobato_eyes_tpu_torch.ops import phash as tphash
from kobato_eyes_tpu_torch.utils.bits import u32pair_to_u64

torch.set_num_threads(1)

N_TILES = 512


def _tiles(kind: str, shape: tuple[int, int], seed: int) -> np.ndarray:
    """512 seeded float32 tiles: uniform noise, or smooth photo-like fields
    (bicubic up-sampled 4x4 noise, the LANCZOS front end's kind of input)."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(0, 255, size=(N_TILES, *shape)).astype(np.float32)
    small = rng.integers(0, 256, size=(N_TILES, 4, 4), dtype=np.uint8)
    h, w = shape
    return np.stack([
        np.asarray(Image.fromarray(s).resize((w, h), Image.Resampling.BICUBIC), np.float32)
        for s in small
    ])


@pytest.mark.parametrize("kind", ["uniform", "smooth"])
def test_phash_words_equal_jax_and_spec(kind):
    g = _tiles(kind, (32, 32), seed=1)
    got = tphash.to_u32pairs(tphash.phash_batch(g, device="cpu"))
    want = np.asarray(jphash.phash_batch(g))
    assert got.dtype == np.uint32 and got.shape == (N_TILES, 2)
    np.testing.assert_array_equal(got, want)
    spec = np.array([tphash.phash_np(x) for x in g], dtype=np.uint64)
    np.testing.assert_array_equal(u32pair_to_u64(got), spec)


@pytest.mark.parametrize("kind", ["uniform", "smooth"])
def test_dhash_words_equal_jax_and_spec(kind):
    g = _tiles(kind, (8, 9), seed=2)
    got = tphash.to_u32pairs(tphash.dhash_batch(g, device="cpu"))
    np.testing.assert_array_equal(got, np.asarray(jphash.dhash_batch(g)))
    spec = np.array([tphash.dhash_np(x) for x in g], dtype=np.uint64)
    np.testing.assert_array_equal(u32pair_to_u64(got), spec)


def test_pack_bits64_msb_first_and_top_bits():
    bits = np.zeros((3, 64), bool)
    bits[0, 0] = True  # MSB of hi
    bits[1, 63] = True  # LSB of lo
    bits[2, :] = True  # every bit: both words 2^32 - 1
    got = tphash.pack_bits64(torch.from_numpy(bits)).numpy()
    want = np.asarray(jphash.pack_bits64(bits)).astype(np.int64)
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [[1 << 31, 0], [0, 1], [(1 << 32) - 1, (1 << 32) - 1]]


def test_dct2_basis_and_specs_are_the_reference_copies():
    np.testing.assert_array_equal(tphash.dct2_basis(32), jphash.dct2_basis(32))
    rng = np.random.default_rng(3)
    g32 = rng.uniform(0, 255, size=(32, 32))
    g98 = rng.uniform(0, 255, size=(8, 9))
    assert tphash.phash_np(g32) == jphash.phash_np(g32)
    assert tphash.dhash_np(g98) == jphash.dhash_np(g98)


def test_tensor_input_stays_on_its_device():
    g = torch.from_numpy(_tiles("uniform", (32, 32), seed=4)[:8])
    out = tphash.phash_batch(g)  # no device: the tensor's own (the CPU)
    assert out.device.type == "cpu" and out.dtype == torch.int64
    np.testing.assert_array_equal(tphash.to_u32pairs(out), np.asarray(jphash.phash_batch(g.numpy())))
