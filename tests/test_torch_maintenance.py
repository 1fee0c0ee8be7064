"""The port's upkeep flows against the JAX package's, on twin catalogs.

``refresh_root`` (new, untagged, vanished files; soft and hard delete),
``retag_all`` (force and scoped to the current signature) and
``retag_selection`` run in both packages over one image folder, each into
its own catalog, with the dummy tagger and with the tiny ViT in f32 on one
set of weights. The catalogs must then hold the same rows: files (size,
mtime, content hash, geometry, presence, tagger signature), tags (names,
categories, scores: exact for the dummy, 1e-5 for the ViT's f32 forwards)
and pHash/dHash words. The ViT's weight seed is one where every probability
lies at least 8e-3 from its threshold, which the tests assert, so the tag
sets must agree exactly.
"""

from __future__ import annotations

import sqlite3
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from kobato_eyes_tpu.core.config import schema as jschema
from kobato_eyes_tpu.core.pipeline import maintenance as jmaint
from kobato_eyes_tpu.core.pipeline import run_index_once as jrun_index_once
from kobato_eyes_tpu.core.pipeline.fingerprint import current_tagger_sig as jsig
from kobato_eyes_tpu.db.connection import reset_bootstrap_cache as jreset
from kobato_eyes_tpu.models import labels as jlabels
from kobato_eyes_tpu.models import tagger as jtagger
from kobato_eyes_tpu.models import vit as jvit
from kobato_eyes_tpu_torch.core.config import schema as tschema
from kobato_eyes_tpu_torch.core.pipeline import maintenance as tmaint
from kobato_eyes_tpu_torch.core.pipeline import run_index_once as trun_index_once
from kobato_eyes_tpu_torch.core.pipeline.fingerprint import current_tagger_sig as tsig
from kobato_eyes_tpu_torch.db.connection import reset_bootstrap_cache as treset
from kobato_eyes_tpu_torch.models import import_weights as timport
from kobato_eyes_tpu_torch.models import labels as tlabels
from kobato_eyes_tpu_torch.models import tagger as ttagger
from kobato_eyes_tpu_torch.models import vit as tvit
from kobato_eyes_tpu_torch.utils.image_io import load_rgb_array

torch.set_num_threads(1)

N_LABELS = 32
VIT = dict(image_size=64, patch_size=16, num_classes=N_LABELS)
VIT_SEED = 8  # every probability >= 8e-3 from its threshold on these images (asserted)
N_IMAGES = 6


def write_images(root: Path, names, seed: int) -> list[Path]:
    """Seeded random PNGs (lossless, so both packages decode the same pixels)."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for name in names:
        w, h = (int(x) for x in rng.integers(40, 160, size=2))
        path = root / name
        Image.fromarray(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)).save(path)
        paths.append(path)
    return paths


def catalog_rows(db: Path) -> dict[str, list]:
    """What a catalog says about its files, keyed by path (ids and times left
    out: they are the writers' own)."""
    conn = sqlite3.connect(db)
    try:
        files = sorted(conn.execute(
            "SELECT path, size, mtime, sha256, width, height, tagger_sig, is_present FROM files"))
        tags = sorted(conn.execute(
            "SELECT f.path, t.name, t.category, ft.score FROM file_tags ft "
            "JOIN files f ON f.id = ft.file_id JOIN tags t ON t.id = ft.tag_id"))
        sigs = sorted(conn.execute(
            "SELECT f.path, s.phash_u64, s.dhash_u64 FROM signatures s JOIN files f ON f.id = s.file_id"))
    finally:
        conn.close()
    return {"files": files, "tags": tags, "signatures": sigs}


def assert_catalogs_equal(got: Path, want: Path, score_atol: float = 0.0) -> None:
    a, b = catalog_rows(got), catalog_rows(want)
    assert a["files"] == b["files"]
    assert a["signatures"] == b["signatures"]
    assert [r[:3] for r in a["tags"]] == [r[:3] for r in b["tags"]]
    np.testing.assert_allclose([r[3] for r in a["tags"]], [r[3] for r in b["tags"]], rtol=0, atol=score_atol)


def stats_view(stats) -> dict:
    """The counts of an index run, without its walls and timers."""
    d = dict(stats.__dict__)
    d.pop("elapsed_sec")
    extra = {k: v for k, v in d.pop("extra").items() if k not in ("stage_walls", "tag_infer_s")}
    return {**d, "extra": extra}


def taggers(kind: str):
    """(port tagger, JAX tagger) on one set of weights."""
    if kind == "dummy":
        return ttagger.DummyTagger(), jtagger.DummyTagger()
    jcfg = jvit.vit_config("tiny", **VIT, dtype=jnp.float32)
    tcfg = tvit.vit_config("tiny", **VIT, dtype=torch.float32)
    params = jax.tree.map(np.asarray, jvit.init_params(jcfg, seed=VIT_SEED))
    t = ttagger.WD14Tagger(labels=tlabels.synthetic_labels(N_LABELS), vit=tcfg, device="cpu",
                           params=timport.vit_state_from_jax_params(params, tcfg))
    j = jtagger.WD14Tagger(labels=jlabels.synthetic_labels(N_LABELS), vit=jcfg, params=params)
    return t, j


def assert_threshold_margin(tagger, paths, margin: float = 8e-3) -> None:
    if isinstance(tagger, ttagger.DummyTagger):
        return
    probs = tagger.forward_probs(tagger.prepare_batch_from_rgb([load_rgb_array(p) for p in paths])).numpy()
    assert np.abs(probs - tagger._thr_vec_np[None, :]).min() >= margin


class Twins:
    """One image folder, one catalog per package, each package's settings."""

    def __init__(self, tmp: Path, kind: str) -> None:
        self.root = tmp / "images"
        self.paths = write_images(self.root, [f"img_{i}.png" for i in range(N_IMAGES)], seed=0)
        self.port_db, self.jax_db = tmp / "port" / "catalog.sqlite3", tmp / "jax" / "catalog.sqlite3"
        self.port_db.parent.mkdir()
        self.jax_db.parent.mkdir()
        pipeline = dict(roots=[self.root], batch_size=2, io_workers=2)
        self.port_settings = tschema.Settings(pipeline=tschema.PipelineSettings(**pipeline))
        self.jax_settings = jschema.Settings(pipeline=jschema.PipelineSettings(**pipeline))
        self.tagger, self.jtagger = taggers(kind)
        self.score_atol = 0.0 if kind == "dummy" else 1e-5
        treset()
        jreset()
        a = trun_index_once(self.port_db, self.port_settings, self.tagger, device="cpu")
        b = jrun_index_once(self.jax_db, self.jax_settings, self.jtagger)
        assert stats_view(a) == stats_view(b) and a.tagged == N_IMAGES
        self.check()

    def check(self) -> None:
        assert_threshold_margin(self.tagger, sorted(self.root.glob("*.png")))
        assert_catalogs_equal(self.port_db, self.jax_db, self.score_atol)

    def ids(self, db: Path, paths) -> list[int]:
        conn = sqlite3.connect(db)
        try:
            return [conn.execute("SELECT id FROM files WHERE path = ?", (str(p),)).fetchone()[0] for p in paths]
        finally:
            conn.close()


@pytest.fixture(params=["dummy", "vit"])
def twins(request, tmp_path) -> Twins:
    return Twins(tmp_path, request.param)


def test_refresh_root_new_missing_soft_then_hard_delete(twins):
    write_images(twins.root, ["late_arrival.png"], seed=1)
    twins.paths[0].unlink()
    a = tmaint.refresh_root(twins.port_db, twins.port_settings, twins.tagger, twins.root, device="cpu")
    b = jmaint.refresh_root(twins.jax_db, twins.jax_settings, twins.jtagger, twins.root)
    assert stats_view(a) == stats_view(b)
    assert a.tagged == 1 and a.missing == 1
    twins.check()
    assert [r for r in catalog_rows(twins.port_db)["files"] if not r[-1]] == [
        r for r in catalog_rows(twins.jax_db)["files"] if r[0] == str(twins.paths[0])]

    twins.paths[1].unlink()
    a = tmaint.refresh_root(twins.port_db, twins.port_settings, twins.tagger, twins.root,
                            hard_delete=True, device="cpu")
    b = jmaint.refresh_root(twins.jax_db, twins.jax_settings, twins.jtagger, twins.root, hard_delete=True)
    assert stats_view(a) == stats_view(b) and a.missing == 1 and a.tagged == 0
    twins.check()
    assert str(twins.paths[1]) not in {r[0] for r in catalog_rows(twins.port_db)["files"]}


@pytest.mark.parametrize("mode", ["force", "current_sig", "other_sig"])
def test_retag_all_then_reindex(twins, mode):
    port_sig = tsig(twins.tagger.signature_fields())
    assert port_sig == jsig(twins.jtagger.signature_fields())
    kw = {"force": True} if mode == "force" else {"current_sig": port_sig if mode == "current_sig" else "other"}
    cleared = tmaint.retag_all(twins.port_db, **kw)
    assert cleared == jmaint.retag_all(twins.jax_db, **kw)
    assert cleared == (0 if mode == "other_sig" else N_IMAGES)
    twins.check()
    a = trun_index_once(twins.port_db, twins.port_settings, twins.tagger, device="cpu")
    b = jrun_index_once(twins.jax_db, twins.jax_settings, twins.jtagger)
    assert stats_view(a) == stats_view(b) and a.tagged == cleared
    twins.check()


def test_retag_selection(twins):
    picks = [twins.paths[1], twins.paths[4]]
    a = tmaint.retag_selection(twins.port_db, twins.port_settings, twins.tagger,
                               twins.ids(twins.port_db, picks), device="cpu")
    b = jmaint.retag_selection(twins.jax_db, twins.jax_settings, twins.jtagger,
                               twins.ids(twins.jax_db, picks))
    assert stats_view(a) == stats_view(b)
    assert a.tagged == 2 and a.skipped == 0
    twins.check()


def test_flows_default_to_the_card(tmp_path, monkeypatch):
    """Without ``device`` a flow's pipeline asks for ``cuda`` (the fused
    signature pass of a tagger without a device) and raises here."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = tmp_path / "images"
    write_images(root, ["a.png"], seed=2)
    settings = tschema.Settings(pipeline=tschema.PipelineSettings(roots=[root]))
    treset()
    with pytest.raises(RuntimeError, match="CUDA"):
        tmaint.refresh_root(tmp_path / "c.sqlite3", settings, ttagger.DummyTagger(), root)
