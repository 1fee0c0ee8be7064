"""The port's signature layer and fused signature lane against the JAX package's.

* ``compute_signatures`` over one folder (PNG and JPEG of mixed sizes, one
  corrupt file): equal file ids, pHash/dHash words and failed ids;
* ``hash_images`` / ``phash_image`` / ``dhash_image`` / the dispatch and
  complete split: equal words;
* ``run_index_once`` with the dummy tagger and ``inline_signatures=True``
  (the default) on the CPU: the ``signatures`` table equals the JAX
  package's run on the same files, every tagged file is signed, and
  ``missing_signature_ids`` is empty afterwards; the pipelined path fuses
  too, and a failed hash dispatch downgrades to the standalone lane.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from PIL import Image

from kobato_eyes_tpu.core.config.schema import PipelineSettings as JPipelineSettings
from kobato_eyes_tpu.core.config.schema import Settings as JSettings
from kobato_eyes_tpu.core.pipeline import run_index_once as jrun
from kobato_eyes_tpu.db.connection import bootstrap as jbootstrap
from kobato_eyes_tpu.db.connection import reset_bootstrap_cache as jreset
from kobato_eyes_tpu.models.tagger import DummyTagger as JDummyTagger
from kobato_eyes_tpu.sig import signatures as jsig
from kobato_eyes_tpu_torch.core.config.schema import PipelineSettings, Settings
from kobato_eyes_tpu_torch.core.pipeline import run_index_once as trun
from kobato_eyes_tpu_torch.db.connection import bootstrap as tbootstrap
from kobato_eyes_tpu_torch.db.connection import reset_bootstrap_cache as treset
from kobato_eyes_tpu_torch.db.repository import missing_signature_ids
from kobato_eyes_tpu_torch.models.tagger import DummyTagger
from kobato_eyes_tpu_torch.sig import signatures as tsig

torch.set_num_threads(1)

SEED = 21
N_IMAGES = 10


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """10 images (PNG and JPEG; noise and smooth fields, mixed sizes) and one
    corrupt file."""
    root = tmp_path_factory.mktemp("sig_library")
    rng = np.random.default_rng(SEED)
    for i in range(N_IMAGES):
        w, h = (int(x) for x in rng.integers(24, 200, size=2))
        if i % 2:
            arr = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        else:
            small = rng.integers(0, 256, size=(4, 4, 3), dtype=np.uint8)
            arr = np.asarray(Image.fromarray(small).resize((w, h), Image.Resampling.BICUBIC))
        img = Image.fromarray(arr)
        if i % 3 == 0:
            img.save(root / f"img_{i:02d}.jpg", quality=90)
        else:
            img.save(root / f"img_{i:02d}.png")
    (root / "broken.jpg").write_bytes(b"\xff\xd8 not a jpeg")
    return root


def _items(library):
    return [(100 + i, p) for i, p in enumerate(sorted(library.iterdir()))]


def test_compute_signatures_equal_jax(library):
    items = _items(library)
    got = tsig.compute_signatures(items, batch_size=4, io_workers=2, device="cpu")
    want = jsig.compute_signatures(items, batch_size=4, io_workers=2)
    assert got.failed_ids == want.failed_ids == [100]  # broken.jpg sorts first
    assert got.file_ids == want.file_ids and len(got.file_ids) == N_IMAGES
    assert got.phash == want.phash
    assert got.dhash == want.dhash


def test_hash_images_and_single_image_helpers_equal_jax(library):
    images = [Image.open(p).convert("RGB") for p in sorted(library.glob("img_*"))]
    ph, dh = tsig.hash_images(images, device="cpu")
    jph, jdh = jsig.hash_images(images)
    assert ph.dtype == np.uint32
    np.testing.assert_array_equal(ph, jph)
    np.testing.assert_array_equal(dh, jdh)
    assert tsig.phash_image(images[0], device="cpu") == jsig.phash_image(images[0])
    assert tsig.dhash_image(images[1], device="cpu") == jsig.dhash_image(images[1])


def test_dispatch_complete_split_equals_jax(library):
    from kobato_eyes_tpu_torch.utils.image_io import load_rgb_array

    arrs = [load_rgb_array(p) for p in sorted(library.glob("img_*"))]
    pairs = [tsig.gray_pair_from_rgb(a) for a in arrs]
    for (g32, g98), (j32, j98) in zip(pairs, (jsig.gray_pair_from_rgb(a) for a in arrs)):
        np.testing.assert_array_equal(g32, j32)
        np.testing.assert_array_equal(g98, j98)
    g32 = np.stack([p[0] for p in pairs])
    g98 = np.stack([p[1] for p in pairs])
    pending = tsig.dispatch_hash_batch(g32, g98, device="cpu")
    assert isinstance(pending, torch.Tensor) and tuple(pending.shape) == (2, len(arrs), 2)
    assert tsig.complete_hash_batch(pending) == jsig.complete_hash_batch(jsig.dispatch_hash_batch(g32, g98))


def _signatures(bootstrap, db) -> dict[str, tuple[int, int]]:
    conn = bootstrap(db)
    try:
        return {
            r["path"]: (r["phash_u64"], r["dhash_u64"])
            for r in conn.execute(
                "SELECT f.path, s.phash_u64, s.dhash_u64 FROM files f "
                "JOIN signatures s ON s.file_id = f.id"
            )
        }
    finally:
        conn.close()


def _port_run(library, tmp_path, tagger, **kw):
    treset()
    db = tmp_path / "port.sqlite3"
    settings = Settings(pipeline=PipelineSettings(roots=[library], batch_size=4, io_workers=2))
    assert settings.pipeline.inline_signatures  # the default
    return db, trun(db, settings, tagger, device="cpu", **kw)


def test_fused_index_signatures_equal_jax(library, tmp_path):
    db, stats = _port_run(library, tmp_path, DummyTagger())
    jreset()
    jdb = tmp_path / "jax.sqlite3"
    jstats = jrun(jdb, JSettings(pipeline=JPipelineSettings(roots=[library], batch_size=4, io_workers=2)),
                  JDummyTagger())
    assert (stats.tagged, stats.tag_failed) == (jstats.tagged, jstats.tag_failed) == (N_IMAGES, 1)
    assert stats.extra["signatures_fused"] == jstats.extra["signatures_fused"] == N_IMAGES
    got = _signatures(tbootstrap, db)
    assert len(got) == N_IMAGES
    assert got == _signatures(jbootstrap, jdb)
    conn = tbootstrap(db)
    try:  # only the file that does not decode lacks a signature
        assert [p for _, p in missing_signature_ids(conn)] == [str(library / "broken.jpg")]
    finally:
        conn.close()
    # second run: nothing left to sign
    assert trun(db, Settings(pipeline=PipelineSettings(roots=[library], batch_size=4, io_workers=2)),
                DummyTagger(), device="cpu").extra["signatures_fused"] == 0


class _PipelinedDummy(DummyTagger):
    """The dummy with the dispatch/complete split: takes the in-flight path."""

    def dispatch_batch_prepared(self, batch):
        return batch

    def complete_batch_prepared(self, handle):
        return self.infer_batch_prepared(handle)


def test_pipelined_path_fuses_signatures_equal_standalone(library, tmp_path):
    db, stats = _port_run(library, tmp_path, _PipelinedDummy())
    assert stats.tagged == stats.extra["signatures_fused"] == N_IMAGES
    conn = tbootstrap(db)
    try:
        id_paths = [(int(r["id"]), r["path"]) for r in conn.execute("SELECT id, path FROM files")]
    finally:
        conn.close()
    batch = tsig.compute_signatures(id_paths, io_workers=2, device="cpu")
    stored = _signatures(tbootstrap, db)
    assert {fid: stored[p] for fid, p in id_paths if p in stored} == dict(
        zip(batch.file_ids, zip(batch.phash, batch.dhash))
    )


def test_sig_dispatch_failure_downgrades(library, tmp_path, monkeypatch):
    def boom(g32, g98, *, device=None):
        raise RuntimeError("hash pass down")

    monkeypatch.setattr(tsig, "dispatch_hash_batch", boom, raising=True)
    db, stats = _port_run(library, tmp_path, _PipelinedDummy())
    assert stats.tagged == N_IMAGES
    assert stats.extra["signatures_fused"] == 0
    conn = tbootstrap(db)
    try:
        assert len(missing_signature_ids(conn)) == N_IMAGES + 1  # the corrupt file too
    finally:
        conn.close()


def test_inline_signatures_off_signs_nothing(library, tmp_path):
    treset()
    db = tmp_path / "off.sqlite3"
    settings = Settings(pipeline=PipelineSettings(
        roots=[library], batch_size=4, io_workers=2, inline_signatures=False))
    stats = trun(db, settings, DummyTagger())  # no device needed with the lane off
    assert stats.tagged == N_IMAGES and stats.extra["signatures_fused"] == 0
    assert _signatures(tbootstrap, db) == {}
