"""The library refine path of the port against the JAX package: SSIM
(``ops/ssim.py``), pair refinement (``dup/refine.py``), the cluster builder
over refined matches (``dup/cluster.py``), ``tile_ahash_int`` and
``mae01_batch``, on the CPU.

Tolerances: SSIM scores agree with the JAX function and the float64 numpy
spec to 2e-5 (f32 window sums in another order); the tile hashes, the MAE
sums, the duplicate decisions, the reasons and the clusters are exact. ORB
runs through OpenCV on both sides (the same host code).
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from kobato_eyes_tpu.dup import cluster as jcluster
from kobato_eyes_tpu.dup import refine as jrefine
from kobato_eyes_tpu.ops import mae as jmae
from kobato_eyes_tpu.ops import ssim as jssim
from kobato_eyes_tpu.ops import tile_hash as jtile
from kobato_eyes_tpu_torch.dup import cluster as tcluster
from kobato_eyes_tpu_torch.dup import refine as trefine
from kobato_eyes_tpu_torch.ops import mae as tmae
from kobato_eyes_tpu_torch.ops import ssim as tssim
from kobato_eyes_tpu_torch.ops import tile_hash as ttile

torch.set_num_threads(1)

SSIM_ATOL = 2e-5


def _pairs(b: int, h: int, w: int, seed: int, noise: float) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    a = rng.random((b, h, w)).astype(np.float32)
    # smooth the first image so that SSIM is not near 0 everywhere
    a = (a + np.roll(a, 1, axis=1) + np.roll(a, 1, axis=2)) / 3
    b_ = np.clip(a + noise * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    return a, b_


@pytest.mark.parametrize("win", [7, 5])
@pytest.mark.parametrize("shape,noise", [((3, 16, 16), 0.02), ((2, 40, 23), 0.2), ((4, 7, 9), 0.5)])
def test_ssim_batch_matches_jax_and_numpy(shape, noise, win):
    a, b = _pairs(*shape, seed=sum(shape), noise=noise)
    got = tssim.ssim_batch(a, b, win_size=win, device="cpu")
    want_jax = np.asarray(jssim.ssim_batch(jnp.asarray(a), jnp.asarray(b), win_size=win))
    want_np = np.array([tssim.ssim_np(x, y, win_size=win) for x, y in zip(a, b)])
    assert got.shape == (shape[0],) and got.dtype == np.float32
    np.testing.assert_allclose(got, want_jax, rtol=0, atol=SSIM_ATOL)
    np.testing.assert_allclose(got, want_np, rtol=0, atol=SSIM_ATOL)
    assert tssim.ssim_np(a[0], b[0], win) == jssim.ssim_np(a[0], b[0], win)


def test_ssim_map_of_identical_images_is_one():
    a, _ = _pairs(2, 20, 20, seed=3, noise=0.0)
    m = tssim.ssim_map_valid(torch.from_numpy(a), torch.from_numpy(a))
    assert m.shape == (2, 14, 14)
    np.testing.assert_allclose(m.numpy(), 1.0, atol=1e-5)


def _write_images(root: Path) -> dict[str, Path]:
    """A base image, a JPEG re-encode, a resize, a brightness edit, an
    unrelated image, a flat image (no ORB features) and a broken file."""
    rng = np.random.default_rng(7)
    root.mkdir(parents=True, exist_ok=True)
    small = rng.integers(0, 256, size=(12, 12, 3), dtype=np.uint8)
    base = Image.fromarray(small).resize((160, 120), Image.Resampling.BICUBIC)
    arr = np.asarray(base).astype(np.int16)
    base = Image.fromarray(np.clip(arr + rng.integers(-20, 21, size=arr.shape), 0, 255).astype(np.uint8))
    other = Image.fromarray(rng.integers(0, 256, size=(120, 160, 3), dtype=np.uint8))
    paths = {
        "base": root / "base.png", "jpeg": root / "copy.jpg", "small": root / "small.png",
        "bright": root / "bright.png", "other": root / "other.png", "flat": root / "flat.png",
        "broken": root / "broken.jpg",
    }
    base.save(paths["base"])
    base.save(paths["jpeg"], quality=85)
    base.resize((80, 60), Image.Resampling.BILINEAR).save(paths["small"])
    Image.fromarray(np.clip(np.asarray(base).astype(np.int16) + 40, 0, 255).astype(np.uint8)).save(paths["bright"])
    other.save(paths["other"])
    Image.new("RGB", (64, 64), (120, 120, 120)).save(paths["flat"])
    paths["broken"].write_bytes(b"\xff\xd8 nope")
    return paths


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    return _write_images(tmp_path_factory.mktemp("refine"))


PAIRS = [("base", "jpeg"), ("base", "small"), ("base", "bright"), ("base", "other"),
         ("jpeg", "small"), ("other", "flat"), ("flat", "flat"), ("base", "broken")]


@pytest.mark.parametrize("pair", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_refine_pair_equals_the_reference(images, pair):
    a, b = pair
    want = jrefine.refine_pair(1, 2, images[a], images[b])
    got = trefine.refine_pair(1, 2, images[a], images[b], device="cpu")
    if want is None:
        assert got is None
        return
    assert (got.file_id_a, got.file_id_b, got.is_duplicate, got.reason) == (
        want.file_id_a, want.file_id_b, want.is_duplicate, want.reason)
    assert got.structural_ratio == want.structural_ratio
    assert got.orb_ratio == want.orb_ratio
    assert got.ssim == pytest.approx(want.ssim, abs=SSIM_ATOL)


def test_refine_thresholds_move_the_decision(images):
    strict = trefine.RefinementThresholds(ssim=1.01, orb=1.01, structural=1.01)
    got = trefine.refine_pair(1, 2, images["base"], images["jpeg"], thresholds=strict, device="cpu")
    want = jrefine.refine_pair(
        1, 2, images["base"], images["jpeg"],
        thresholds=jrefine.RefinementThresholds(ssim=1.01, orb=1.01, structural=1.01),
    )
    assert not got.is_duplicate and got.reason == want.reason == "no metric cleared its threshold"


def test_cluster_builder_equals_the_reference(images):
    ids = {name: i + 10 for i, name in enumerate(images)}
    jb, tb = jcluster.ClusterBuilder(), tcluster.ClusterBuilder()
    for a, b in PAIRS + [("small", "bright"), ("other", "flat")]:
        jb.add_match(jrefine.refine_pair(ids[a], ids[b], images[a], images[b]))
        tb.add_match(trefine.refine_pair(ids[a], ids[b], images[a], images[b], device="cpu"))
    want, got = jb.build(), tb.build()
    assert len(want) >= 1
    assert [(c.representative, c.members) for c in got] == [(c.representative, c.members) for c in want]
    assert [[(m.file_id_a, m.file_id_b, m.reason) for m in c.matches] for c in got] == [
        [(m.file_id_a, m.file_id_b, m.reason) for m in c.matches] for c in want]


@pytest.mark.parametrize("grid,tile", [(8, 8), (4, 8), (16, 4)])
def test_tile_ahash_int_equals_the_reference(grid, tile):
    side = grid * tile
    gray = np.random.default_rng(grid * tile).integers(0, 256, size=(side, side), dtype=np.uint8)
    want = jtile.tile_ahash_int(gray, grid=grid, tile=tile)
    assert ttile.tile_ahash_int(gray, grid=grid, tile=tile, device="cpu") == want
    assert want == ttile.tile_ahash_np(gray, grid, tile)


@pytest.mark.parametrize("size", [16, 128])
def test_mae01_batch_equals_the_reference(size):
    rng = np.random.default_rng(size)
    a = rng.integers(0, 256, size=(5, size, size), dtype=np.uint8)
    b = np.clip(a.astype(np.int16) + rng.integers(-3, 4, size=a.shape), 0, 255).astype(np.uint8)
    want = jmae.mae01_batch(a, b)
    got = tmae.mae01_batch(a, b, device="cpu")
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [tmae.mae01_np(x, y) for x, y in zip(a, b)])


def test_refine_pair_default_device_raises_without_a_gpu(images):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        trefine.refine_pair(1, 2, images["base"], images["jpeg"])
