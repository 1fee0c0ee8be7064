"""The ANN slice end to end on the CPU: the fused embed lane of the index
run, the residual embed stage and ``ket ann``, against the JAX package's.

Both packages index one library with ``index.enabled`` and the same tagger
and embedder weights (the flax init of the JAX embedder, carried across with
``clip_state_from_jax_params``): the same files get vectors, on the same
lane, and the vectors agree by cosine. ``ket ann`` of both CLIs on one data
directory prints the same lines.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from kobato_eyes_tpu import cli as jcli
from kobato_eyes_tpu.core.config.schema import IndexSettings as JIndexSettings
from kobato_eyes_tpu.core.config.schema import PipelineSettings as JPipelineSettings
from kobato_eyes_tpu.core.config.schema import Settings as JSettings
from kobato_eyes_tpu.core.pipeline import run_index_once as jrun
from kobato_eyes_tpu.core.pipeline.embed_stage import load_embeddings as jload
from kobato_eyes_tpu.db.connection import bootstrap as jbootstrap
from kobato_eyes_tpu.db.connection import reset_bootstrap_cache as jreset
from kobato_eyes_tpu.db.repository import get_embed_prep as jprep
from kobato_eyes_tpu.index import embedder as jemb
from kobato_eyes_tpu.models import labels as jlabels
from kobato_eyes_tpu.models import tagger as jtagger
from kobato_eyes_tpu.models import vit as jvit
from kobato_eyes_tpu_torch import cli as tcli
from kobato_eyes_tpu_torch.core.config.schema import IndexSettings, PipelineSettings, Settings
from kobato_eyes_tpu_torch.core.config.service import save_settings
from kobato_eyes_tpu_torch.core.pipeline import orchestrator as torch_orch
from kobato_eyes_tpu_torch.core.pipeline import run_index_once as trun
from kobato_eyes_tpu_torch.core.pipeline.embed_stage import load_embeddings as tload
from kobato_eyes_tpu_torch.db.connection import bootstrap as tbootstrap
from kobato_eyes_tpu_torch.db.connection import reset_bootstrap_cache as treset
from kobato_eyes_tpu_torch.db.repository import get_embed_prep as tprep
from kobato_eyes_tpu_torch.index import embedder as temb
from kobato_eyes_tpu_torch.models import import_weights as timport
from kobato_eyes_tpu_torch.models import labels as tlabels
from kobato_eyes_tpu_torch.models import tagger as ttagger
from kobato_eyes_tpu_torch.models import vit as tvit
from kobato_eyes_tpu_torch.utils.paths import get_app_paths
from tests.torch_native import hnsw_built  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

N_LABELS = 16
TAGGER = dict(image_size=64, patch_size=16, num_classes=N_LABELS)
# the JAX package's fused-embed geometry: a 64 px letterbox pooled 2x2 to 32
EMB = dict(preset="tiny", image_size=32, patch_size=16, embed_dim=64)
N_FILES = 7
BATCH = 2


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """Seven images (PNG and JPEG, mixed sizes, two of them the same picture)."""
    root = tmp_path_factory.mktemp("ann_library")
    rng = np.random.default_rng(21)
    for i in range(N_FILES - 1):
        w, h = (int(x) for x in rng.integers(40, 150, size=2))
        small = rng.integers(0, 256, size=(6, 6, 3), dtype=np.uint8)
        img = Image.fromarray(small).resize((w, h), Image.Resampling.BICUBIC)
        img.save(root / (f"img_{i}.jpg" if i % 3 == 0 else f"img_{i}.png"))
    (root / f"img_{N_FILES - 1}.png").write_bytes((root / "img_1.png").read_bytes())
    return root


@pytest.fixture(scope="module")
def weights():
    """The JAX embedder's flax init (seed 0, as its index run draws it) and
    the port's state dict of the same weights; the f32 tagger pair's."""
    params = jax.tree.map(np.asarray, jemb.ImageEmbedder(**EMB).params)
    cfg = temb.embedder_config(EMB["preset"], EMB["image_size"], EMB["patch_size"], EMB["embed_dim"], None)
    jcfg = jvit.vit_config("tiny", **TAGGER, dtype=jnp.float32)
    tagger_params = jax.tree.map(np.asarray, jvit.init_params(jcfg, seed=3))
    return {
        "embed_params": params,
        "embed_state": timport.clip_state_from_jax_params(params, cfg),
        "tagger_params": tagger_params,
        "tagger_state": timport.vit_state_from_jax_params(tagger_params, tvit.vit_config(
            "tiny", **TAGGER, dtype=torch.float32)),
    }


@pytest.fixture
def port_embedder_weights(monkeypatch, weights):
    """The port's index run builds its embedder with the JAX init's weights."""
    orig = torch_orch.IndexPipeline._build_embedder

    def build(self):
        emb = orig(self)
        emb._model.load_state_dict(weights["embed_state"])
        return emb

    monkeypatch.setattr(torch_orch.IndexPipeline, "_build_embedder", build)


def _taggers(weights):
    j = jtagger.WD14Tagger(labels=jlabels.synthetic_labels(N_LABELS), params=weights["tagger_params"],
                           vit=jvit.vit_config("tiny", **TAGGER, dtype=jnp.float32))
    t = ttagger.WD14Tagger(labels=tlabels.synthetic_labels(N_LABELS), params=weights["tagger_state"],
                           vit=tvit.vit_config("tiny", **TAGGER, dtype=torch.float32), device="cpu")
    return j, t


def _settings(library, fused=True):
    kw = dict(roots=[library], batch_size=BATCH, io_workers=2, inline_signatures=False)
    return (JSettings(pipeline=JPipelineSettings(**kw), index=JIndexSettings(enabled=True, fused=fused, **EMB)),
            Settings(pipeline=PipelineSettings(**kw), index=IndexSettings(enabled=True, fused=fused, **EMB)))


def _stored(bootstrap, load, prep, db):
    conn = bootstrap(db)
    try:
        ids, vecs = load(conn)
        return ids, vecs, prep(conn, "clip-vit")
    finally:
        conn.close()


def _index_both(library, weights, tmp_path, fused=True, dbs=None):
    j, t = _taggers(weights)
    js, ts = _settings(library, fused)
    jreset()
    treset()
    dbs = dbs or (tmp_path / "jax.sqlite", tmp_path / "torch.sqlite")
    jstats = jrun(dbs[0], js, j)
    tstats = trun(dbs[1], ts, t)
    return jstats, tstats, dbs


def _cosines(a, b):
    return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def test_fused_index_run_equals_jax(library, weights, tmp_path, port_embedder_weights):
    jstats, tstats, dbs = _index_both(library, weights, tmp_path)
    assert tstats.tagged == jstats.tagged == N_FILES and tstats.tag_failed == 0
    for key in ("embedded_fused", "embedded"):
        assert tstats.extra[key] == jstats.extra[key] == N_FILES, key
    assert {"embed_setup", "embed"} <= set(tstats.extra["stage_walls"])
    jids, jvecs, jp = _stored(jbootstrap, jload, jprep, dbs[0])
    tids, tvecs, tp = _stored(tbootstrap, tload, tprep, dbs[1])
    np.testing.assert_array_equal(tids, jids)
    assert tp == jp == "lb64->mean->32"
    assert _cosines(tvecs, jvecs).min() >= 0.999
    np.testing.assert_allclose(np.linalg.norm(tvecs, axis=1), 1.0, atol=1e-4)

    # the stored vectors are the standalone derived embedder's on the same files
    from kobato_eyes_tpu_torch.utils.image_io import load_rgb_array

    conn = tbootstrap(dbs[1])
    try:
        paths = {int(r["id"]): r["path"] for r in conn.execute("SELECT id, path FROM files")}
    finally:
        conn.close()
    standalone = temb.ImageEmbedder(**EMB, derive_from=64, device="cpu", state_dict=weights["embed_state"])
    want = standalone.embed_batch([load_rgb_array(paths[int(i)]) for i in tids])
    np.testing.assert_allclose(tvecs, want, atol=1e-5)

    # a second run embeds nothing
    jstats2, tstats2, _ = _index_both(library, weights, tmp_path, dbs=dbs)
    assert tstats2.extra["embedded"] == jstats2.extra["embedded"] == 0


def test_prep_change_invalidates_stored_vectors(library, weights, tmp_path, port_embedder_weights):
    _, _, dbs = _index_both(library, weights, tmp_path)
    jstats, tstats, _ = _index_both(library, weights, tmp_path, fused=False, dbs=dbs)
    assert tstats.extra["embedded"] == jstats.extra["embedded"] == N_FILES
    assert tstats.extra["embedded_fused"] == jstats.extra["embedded_fused"] == 0
    jids, jvecs, jp = _stored(jbootstrap, jload, jprep, dbs[0])
    tids, tvecs, tp = _stored(tbootstrap, tload, tprep, dbs[1])
    assert tp == jp == "cc32"
    np.testing.assert_array_equal(tids, jids)
    assert _cosines(tvecs, jvecs).min() >= 0.999


def test_failed_fused_dispatch_downgrades_to_residual(library, weights, tmp_path, monkeypatch,
                                                      port_embedder_weights):
    n_batches = -(-N_FILES // BATCH)
    for cls in (jemb.ImageEmbedder, temb.ImageEmbedder):
        calls = {"n": 0}
        orig = cls.dispatch_batch_prepared

        def flaky(self, batch, calls=calls, orig=orig):
            calls["n"] += 1
            if calls["n"] <= n_batches:  # every fused attempt fails...
                raise RuntimeError("fused dispatch down")
            return orig(self, batch)  # ...the residual stage works

        monkeypatch.setattr(cls, "dispatch_batch_prepared", flaky)
    jstats, tstats, dbs = _index_both(library, weights, tmp_path)
    assert tstats.tagged == jstats.tagged == N_FILES
    assert tstats.extra["embedded_fused"] == jstats.extra["embedded_fused"] == 0
    assert tstats.extra["embedded"] == jstats.extra["embedded"] == N_FILES
    tids, _, _ = _stored(tbootstrap, tload, tprep, dbs[1])
    assert len(tids) == N_FILES


def test_fused_lane_uploads_once(library, weights, tmp_path, monkeypatch, port_embedder_weights):
    """The embedder and the tagger of a fused batch read one tensor."""
    seen = {"embed": [], "tag": []}
    for key, cls in (("embed", temb.ImageEmbedder), ("tag", ttagger.WD14Tagger)):
        orig = cls.dispatch_batch_prepared

        def spy(self, batch, *a, key=key, orig=orig, **kw):
            seen[key].append(batch)
            return orig(self, batch, *a, **kw)

        monkeypatch.setattr(cls, "dispatch_batch_prepared", spy)
    _, t = _taggers(weights)
    treset()
    stats = trun(tmp_path / "one.sqlite", _settings(library)[1], t)
    assert stats.extra["embedded_fused"] == N_FILES
    assert len(seen["embed"]) == len(seen["tag"]) == -(-N_FILES // BATCH)
    for e, g in zip(seen["embed"], seen["tag"]):
        assert isinstance(e, torch.Tensor) and e is g


def test_embedder_follows_the_run_device(library, monkeypatch):
    """A tagger without a device (the dummy) and no ``device``: the
    embedder asks for ``cuda`` and raises here instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    treset()
    with pytest.raises(RuntimeError, match="CUDA"):
        trun(library.parent / "dummy.sqlite", _settings(library)[1], ttagger.DummyTagger())


# ---------------------------------------------------------------------------
# ket ann through both CLIs on one data directory
# ---------------------------------------------------------------------------


@pytest.fixture
def ann_data(library, weights, tmp_path, monkeypatch):
    """A data directory indexed by the JAX package with vectors stored, a
    settings file for both CLIs, and both packages' ``embedder_from_catalog``
    giving f32 embedders on the index run's weights."""
    data = tmp_path / "data"
    paths = get_app_paths(data).ensure()
    js, ts = _settings(library)
    j, _ = _taggers(weights)
    jreset()
    treset()
    jrun(paths.db_path, js, j)
    cfg = tmp_path / "settings.yaml"
    save_settings(ts, cfg)

    jorig, torig = jemb.embedder_from_catalog, temb.embedder_from_catalog

    def jfactory(conn, **kw):
        e = jorig(conn, **kw)
        e.cfg = dataclasses.replace(e.cfg, dtype=jnp.float32)
        e._model = jemb.ClipImageEncoder(e.cfg, embed_dim=e.embed_dim)
        e.params = weights["embed_params"]
        return e

    def tfactory(conn, **kw):
        e = torig(conn, **kw)
        e.cfg = dataclasses.replace(e.cfg, dtype=torch.float32)
        e._model = temb.ClipImageEncoder(e.cfg, e.embed_dim)
        e._model.load_state_dict(weights["embed_state"])
        e._model.eval().requires_grad_(False)
        return e

    monkeypatch.setattr(jemb, "embedder_from_catalog", jfactory)
    monkeypatch.setattr(temb, "embedder_from_catalog", tfactory)
    return data, cfg


def _ann(main, data, cfg, argv, capsys, device=()):
    capsys.readouterr()
    assert main(["--config", str(cfg), "--data-dir", str(data), *device, "ann", *argv]) == 0
    return capsys.readouterr().out.splitlines()


JAX_CLI = (jcli.main, ())
PORT_CLI = (tcli.main, ("--device", "cpu"))


def test_ann_similar_to_equals_jax(ann_data, capsys):
    data, cfg = ann_data
    conn = tbootstrap(get_app_paths(data).db_path)
    try:
        ids = [int(r[0]) for r in conn.execute("SELECT file_id FROM embeddings ORDER BY file_id")]
    finally:
        conn.close()
    assert len(ids) == N_FILES
    for fid in ids[:3] + [ids[-1]]:
        argv = ["--similar-to", str(fid), "--limit", "4"]
        want = _ann(jcli.main, data, cfg, argv, capsys)
        got = _ann(tcli.main, data, cfg, argv, capsys, device=PORT_CLI[1])
        assert got == want and len(got) == 4, fid
    # the two copies of one picture find each other first, at cosine 1
    dup = _ann(tcli.main, data, cfg, ["--similar-to", str(ids[-1]), "--limit", "1"], capsys,
               device=PORT_CLI[1])
    assert dup[0].split()[1].endswith("img_1.png") and float(dup[0].split()[0]) == pytest.approx(1.0, abs=1e-4)


def test_ann_build_then_query_image_equals_jax(ann_data, library, capsys):
    data, cfg = ann_data
    query = library / "img_3.jpg"
    out = {}
    for name, (main, device) in (("jax", JAX_CLI), ("torch", PORT_CLI)):
        built = _ann(main, data, cfg, ["--build"], capsys, device=device)
        assert built[-1].startswith(f"built ANN index (HnswIndex) over {N_FILES} images")
        out[name] = _ann(main, data, cfg, ["--query-image", str(query), "--limit", "5"], capsys, device=device)
    assert len(out["torch"]) == 5
    assert out["torch"][0].split()[1] == str(query)  # the file finds itself first
    assert out["torch"] == out["jax"]


def test_new_entry_points_default_to_cuda(ann_data, capsys, monkeypatch, tmp_path):
    """Given no device, the ANN entry points ask for ``cuda`` and raise here
    instead of running on the CPU."""
    from kobato_eyes_tpu_torch.index.validate import validate_clip_checkpoint

    data, cfg = ann_data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--config", str(cfg), "--data-dir", str(data), "ann", "--similar-to", "1"])
    conn = tbootstrap(get_app_paths(data).db_path)
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            temb.embedder_from_catalog(conn, **EMB)
    finally:
        conn.close()
    cfg_clip = temb.embedder_config(EMB["preset"], EMB["image_size"], EMB["patch_size"], EMB["embed_dim"], "openai")
    manifest = timport.clip_vit_state_manifest(cfg_clip, embed_out=EMB["embed_dim"])
    path = tmp_path / "clip.pt"
    torch.save({key: torch.zeros(shape) for key, shape in manifest.items()}, path)
    with pytest.raises(RuntimeError, match="CUDA"):
        validate_clip_checkpoint(path, clip_variant="openai", **EMB)
