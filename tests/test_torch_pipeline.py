"""The port's index pipeline and CLI against the JAX package's.

``run_index_once`` of both packages over one folder (PNG and JPEG of mixed
sizes, one corrupt file) with the same f32 tiny-ViT weights must write the
same catalog rows, and ``search --backend sql`` of both must return the same
results.
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
from kobato_eyes_tpu.core.config.schema import PipelineSettings as JPipelineSettings
from kobato_eyes_tpu.core.config.schema import Settings as JSettings
from kobato_eyes_tpu.core.pipeline import run_index_once as jrun
from kobato_eyes_tpu.db.connection import bootstrap as jbootstrap
from kobato_eyes_tpu.db.connection import reset_bootstrap_cache as jreset
from kobato_eyes_tpu.models import labels as jlabels
from kobato_eyes_tpu.models import swin as jswin
from kobato_eyes_tpu.models import tagger as jtagger
from kobato_eyes_tpu.models import vit as jvit
from kobato_eyes_tpu_torch import cli as tcli
from kobato_eyes_tpu_torch.core.config.schema import PipelineSettings, Settings, TaggerSettings
from kobato_eyes_tpu_torch.core.config.service import save_settings
from kobato_eyes_tpu_torch.core.pipeline import run_index_once as trun
from kobato_eyes_tpu_torch.db.connection import bootstrap as tbootstrap
from kobato_eyes_tpu_torch.db.connection import reset_bootstrap_cache as treset
from kobato_eyes_tpu_torch.models import archs as tarchs
from kobato_eyes_tpu_torch.models import import_weights as timport
from kobato_eyes_tpu_torch.models import labels as tlabels
from kobato_eyes_tpu_torch.models import swin as tswin
from kobato_eyes_tpu_torch.models import tagger as ttagger
from kobato_eyes_tpu_torch.models import vit as tvit

torch.set_num_threads(1)

N_LABELS = 32
SEED = 12
MODEL = dict(image_size=64, patch_size=16, num_classes=N_LABELS)
FILE_COLUMNS = "id, path, size, mtime, sha256, width, height, tagger_sig, is_present"
# SwinV2 cut to 2 stages of narrow width at 32 px (grid 16 and 8, window 4)
SWIN = dict(image_size=32, patch_size=2, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
            window_size=4, num_classes=N_LABELS)
SWIN_SEED = 0


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """12 images (PNG and JPEG, mixed sizes) and one corrupt file."""
    root = tmp_path_factory.mktemp("library")
    rng = np.random.default_rng(SEED)
    for i in range(12):
        w, h = (int(x) for x in rng.integers(24, 140, size=2))
        img = Image.fromarray(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8))
        if i % 3 == 0:
            img.save(root / f"img_{i:02d}.jpg", quality=92)
        else:
            img.save(root / f"img_{i:02d}.png")
    (root / "broken.jpg").write_bytes(b"\xff\xd8 not a jpeg")
    return root


def _taggers(arch: str = "vit"):
    """The JAX and the port's tagger on the same f32 weights; the SwinV2
    pair runs its fast path (the window kernel's plain version in the port,
    the Pallas kernel in interpret mode in the JAX package)."""
    if arch == "swinv2":
        jcfg = jswin.SwinConfig(**SWIN, dtype=jnp.float32, attn_impl="pallas")
        tcfg = tswin.SwinConfig(**SWIN, dtype=torch.float32, attn_impl="pallas")
        params = jax.tree.map(np.asarray, jswin.init_swin_params(jcfg, seed=SWIN_SEED))
        state = timport.swin_state_from_jax_params(params, tcfg)
        kw_j, kw_t = {"swin": jcfg}, {"swin": tcfg}
    else:
        jcfg = jvit.vit_config("tiny", **MODEL, dtype=jnp.float32)
        tcfg = tvit.vit_config("tiny", **MODEL, dtype=torch.float32)
        params = jax.tree.map(np.asarray, jvit.init_params(jcfg, seed=SEED))
        state = timport.vit_state_from_jax_params(params, tcfg)
        kw_j, kw_t = {"vit": jcfg}, {"vit": tcfg}
    j = jtagger.WD14Tagger(labels=jlabels.synthetic_labels(N_LABELS), params=params, **kw_j)
    t = ttagger.WD14Tagger(labels=tlabels.synthetic_labels(N_LABELS), device="cpu", params=state, **kw_t)
    return j, t


def _rows(bootstrap, db):
    conn = bootstrap(db)
    try:
        files = [tuple(r) for r in conn.execute(f"SELECT {FILE_COLUMNS} FROM files ORDER BY id")]
        tags = [tuple(r) for r in conn.execute(
            "SELECT ft.file_id, t.name, t.category, ft.score FROM file_tags ft "
            "JOIN tags t ON t.id = ft.tag_id ORDER BY ft.file_id, t.name"
        )]
    finally:
        conn.close()
    return files, tags


def _index_both(library, tmp_path_factory, arch: str):
    """Both packages index the library; returns their data dirs and stats."""
    j, t = _taggers(arch)
    # exact tag equality is fair only if no probability sits on a threshold
    from kobato_eyes_tpu.utils.image_io import load_rgb_array

    imgs = [load_rgb_array(p) for p in sorted(library.iterdir())]
    batch = j.prepare_batch_from_rgb([a for a in imgs if a is not None])
    probs = np.asarray(j.forward_probs(batch))
    assert np.abs(probs - j._thr_vec_np[None, :]).min() >= 1e-3

    jreset()
    treset()
    out = {}
    for name, run, settings_cls, pipe_cls, tagger in (
        ("jax", jrun, JSettings, JPipelineSettings, j),
        ("torch", trun, Settings, PipelineSettings, t),
    ):
        data = tmp_path_factory.mktemp(f"data_{name}")
        settings = settings_cls(pipeline=pipe_cls(
            roots=[library], batch_size=4, io_workers=2, inline_signatures=False,
        ))
        (data / "db").mkdir()
        stats = run(data / "db" / "catalog.sqlite3", settings, tagger)
        out[name] = (data, stats)
    return out


@pytest.fixture(scope="module")
def indexed(library, tmp_path_factory):
    return _index_both(library, tmp_path_factory, "vit")


@pytest.fixture(scope="module")
def indexed_swin(library, tmp_path_factory):
    return _index_both(library, tmp_path_factory, "swinv2")


def _assert_equal_catalogs(runs):
    (jdata, jstats), (tdata, tstats) = runs["jax"], runs["torch"]
    assert (tstats.scanned, tstats.tagged, tstats.tag_failed) == (13, 12, 1)
    assert (tstats.scanned, tstats.tagged, tstats.tag_failed, tstats.written) == (
        jstats.scanned, jstats.tagged, jstats.tag_failed, jstats.written)
    jfiles, jtags = _rows(jbootstrap, jdata / "db" / "catalog.sqlite3")
    tfiles, ttags = _rows(tbootstrap, tdata / "db" / "catalog.sqlite3")
    assert tfiles == jfiles  # includes the tagger fingerprint: same for both
    assert len(ttags) == len(jtags) > 12
    assert [r[:3] for r in ttags] == [r[:3] for r in jtags]
    np.testing.assert_allclose([r[3] for r in ttags], [r[3] for r in jtags], atol=1e-4)


def test_index_runs_write_equal_catalogs(indexed):
    _assert_equal_catalogs(indexed)


def test_swinv2_index_runs_write_equal_catalogs(indexed_swin):
    _assert_equal_catalogs(indexed_swin)


def _search_lines(main, data, query, capsys):
    capsys.readouterr()
    assert main(["--data-dir", str(data), "search", "--backend", "sql", query]) == 0
    lines = [ln.split(None, 1) for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    return [(float(rel), path) for rel, path in lines]


def test_sql_search_results_equal(indexed, capsys):
    (jdata, _), (tdata, _) = indexed["jax"], indexed["torch"]
    _, tags = _rows(tbootstrap, tdata / "db" / "catalog.sqlite3")
    names = sorted({r[1] for r in tags if r[2] == 0})
    queries = [names[0], f"{names[0]} OR {names[-1]}", f"{names[1]} -{names[2]}"]
    for q in queries:
        want = _search_lines(jcli.main, jdata, q, capsys)
        got = _search_lines(tcli.main, tdata, q, capsys)
        assert [p for _, p in got] == [p for _, p in want], q
        np.testing.assert_allclose([r for r, _ in got], [r for r, _ in want], atol=1.1e-3)
    assert any(_search_lines(tcli.main, tdata, q, capsys) for q in queries)


def test_port_cli_index_and_search_on_cpu(library, tmp_path, monkeypatch, capsys):
    """The port's CLI end to end with --device cpu (the model cut to the tiny
    preset at 64 px, so the CPU run stays short)."""
    vit = tarchs.ARCHS["vit"]
    cut = lambda preset, **kw: vit.preset_config("tiny", **{**kw, "image_size": 64})  # noqa: E731
    monkeypatch.setitem(tarchs.ARCHS, "vit", dataclasses.replace(vit, preset_config=cut))
    labels = tmp_path / "selected_tags.csv"
    labels.write_text(
        "tag_id,name,category,count\n"
        + "".join(f"{i},tag_{i},{4 if i % 7 == 0 else 0},{100 - i}\n" for i in range(N_LABELS)),
        encoding="utf-8",
    )
    cfg = tmp_path / "settings.yaml"
    save_settings(Settings(
        pipeline=PipelineSettings(batch_size=4, io_workers=2, inline_signatures=False),
        tagger=TaggerSettings(name="wd14", labels_path=labels),
    ), cfg)
    base = ["--config", str(cfg), "--data-dir", str(tmp_path / "data"), "--device", "cpu"]
    treset()
    assert tcli.main(base + ["index", "--root", str(library)]) == 0
    stats = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"tagged": 12' in stats and '"tag_failed": 1' in stats
    assert tcli.main(base + ["search", "--backend", "sql", "tag_1 OR tag_2 OR tag_3"]) == 0
    want = capsys.readouterr().out
    assert want.strip()
    # the default backend is the device engine; it answers what SQL answers
    assert tcli.main(base + ["search", "tag_1 OR tag_2 OR tag_3"]) == 0
    assert capsys.readouterr().out == want
    assert tcli.main(base + ["search", "--backend", "device", "tag_1"]) == 0
    assert "not yet ported" not in capsys.readouterr().err


def test_epoch_manager_waits_for_its_slice(library, tmp_path):
    """The slice has come: an index run given an ``EpochManager`` swaps the
    epoch in (a full build on the first run), and nothing raises."""
    from kobato_eyes_tpu_torch.query.engine import EpochManager, search_epoch

    treset()
    manager = EpochManager(device="cpu")
    settings = Settings(pipeline=PipelineSettings(roots=[library], batch_size=4, io_workers=2))
    stats = trun(tmp_path / "c.sqlite3", settings, ttagger.DummyTagger(), epoch_manager=manager,
                 device="cpu")
    assert stats.epoch_version == 1 and manager.current.version == 1
    assert "epoch" in stats.extra["stage_walls"]
    assert manager.current.num_files == stats.tagged + stats.tag_failed
    assert len(search_epoch(manager.current, "", limit=100)) == manager.current.num_files
