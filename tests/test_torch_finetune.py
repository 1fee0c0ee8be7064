"""The port's catalog fine-tuning (``core/finetune.py``, ``ket train``) against
the JAX package's, on one tiny catalog.

The JAX package draws its initial weights with flax's ``init_params(cfg,
seed=0)``; the port trainer's ``_init_model`` (``models/train.py``) is patched to return that same tree
through ``vit_state_from_jax_params``, so both sides train the same weights
on the same batches. f32 (``vit_overrides={"dtype": ...}``), lr 1e-4: the
loss history agrees to 1e-5 relative (sums in another order, carried
through up to 8 AdamW steps; measured up to 1.9e-6). The labels CSV and the ``_config.json``
sidecar are equal byte for byte; the port's checkpoint directory loads into
``TorchTagger``.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from kobato_eyes_tpu.core import finetune as jfinetune
from kobato_eyes_tpu.db.connection import bootstrap as jbootstrap
from kobato_eyes_tpu.db.connection import reset_bootstrap_cache as jreset
from kobato_eyes_tpu.db.repository import TaggingItem, upsert_file, write_tagging_batch
from kobato_eyes_tpu.models import vit as jvit
from kobato_eyes_tpu_torch.core import finetune as tfinetune
from kobato_eyes_tpu_torch.db.connection import reset_bootstrap_cache as treset
from kobato_eyes_tpu_torch.models import import_weights as timport
from kobato_eyes_tpu_torch.models import train as ttrain
from kobato_eyes_tpu_torch.models import vit as tvit

torch.set_num_threads(1)

# (name, category): general, character, rating, copyright, and a category
# out of TagCategory that the CSV writes as a number
TAGS = [("1girl", 0), ("solo", 0), ("smile", 0), ("hat", 0), ("some_char", 4),
        ("general", 2), ("a_series", 3), ("odd_cat", 42), ("rare", 0)]
N_FILES = 13
SIZE = 32


def _write_library(root: Path) -> list[Path]:
    rng = np.random.default_rng(0)
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(N_FILES):
        w, h = (int(v) for v in rng.integers(20, 60, size=2))
        img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        p = root / f"img_{i:02d}.png"
        Image.fromarray(img).save(p)
        paths.append(p)
    (root / "broken.png").write_bytes(b"\x89PNG not an image")
    return paths + [root / "broken.png"]


def _write_catalog(db: Path, paths: list[Path]) -> None:
    jreset()
    conn = jbootstrap(db)
    rng = np.random.default_rng(1)
    items = []
    for i, p in enumerate(paths):
        fid = upsert_file(conn, path=str(p), size=p.stat().st_size, mtime=1e9 + i)
        picks = [t for j, t in enumerate(TAGS[:-1]) if rng.random() < 0.5 or j == i % 8]
        if i == 3:
            picks.append(TAGS[-1])  # "rare": on one file only
        items.append(TaggingItem(file_id=fid, tags=[(n, float(rng.uniform(0.3, 1.0)), c) for n, c in picks],
                                 tagger_sig="t"))
    write_tagging_batch(conn, items)
    conn.commit()
    conn.close()
    jreset()
    treset()


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    base = tmp_path_factory.mktemp("finetune")
    db = base / "catalog.sqlite3"
    _write_catalog(db, _write_library(base / "lib"))
    return db


@pytest.fixture
def jax_init(monkeypatch):
    """The port's initial weights := the JAX package's ``init_params(seed=0)``."""

    def init(cfg):
        jcfg = jvit.vit_config(
            "tiny", image_size=cfg.image_size, num_classes=cfg.num_classes,
            dtype=jnp.float32 if cfg.dtype == torch.float32 else jnp.bfloat16,
        )
        params = jvit.init_params(jcfg, seed=0)
        model = tvit.ViT(cfg)
        model.load_state_dict(timport.vit_state_from_jax_params(params, cfg), strict=True)
        return model

    monkeypatch.setattr(ttrain, "_init_model", init)


def _run_both(catalog: Path, out: Path, **kw):
    common = dict(preset="tiny", image_size=SIZE, batch_size=4, learning_rate=1e-4, io_workers=1, **kw)
    want = jfinetune.finetune_from_catalog(
        catalog, checkpoint_out=out / "jax_ck", vit_overrides={"dtype": jnp.float32}, **common
    )
    got = tfinetune.finetune_from_catalog(
        catalog, checkpoint_out=out / "port_ck", vit_overrides={"dtype": torch.float32},
        device="cpu", **common
    )
    return want, got


@pytest.mark.parametrize("min_tag_count", [1, 2])
@pytest.mark.parametrize("epochs", [1, 2])
def test_loss_history_labels_and_sidecar_equal_the_reference(catalog, tmp_path, jax_init, epochs, min_tag_count):
    want, got = _run_both(catalog, tmp_path, epochs=epochs, min_tag_count=min_tag_count)
    assert (got.files, got.labels, got.steps, got.epochs) == (want.files, want.labels, want.steps, want.epochs)
    assert got.labels == (len(TAGS) if min_tag_count == 1 else len(TAGS) - 1)
    assert got.steps == 4 * epochs  # 13 images and a broken file in batches of 4
    np.testing.assert_allclose(got.loss_history, want.loss_history, rtol=1e-5)
    assert got.first_loss == got.loss_history[0] and got.final_loss == got.loss_history[-1]
    assert Path(got.labels_csv).read_bytes() == Path(want.labels_csv).read_bytes()
    cfg_got = tmp_path / "port_ck_config.json"
    assert cfg_got.read_bytes() == (tmp_path / "jax_ck_config.json").read_bytes()
    assert json.loads(cfg_got.read_text())["arch"] == "vit"


def test_checkpoint_loads_into_the_tagger(catalog, tmp_path, jax_init):
    from kobato_eyes_tpu_torch.models.tagger import TorchTagger, load_checkpoint

    got = tfinetune.finetune_from_catalog(
        catalog, preset="tiny", image_size=SIZE, batch_size=4, learning_rate=1e-3, io_workers=1,
        checkpoint_out=tmp_path / "ck", device="cpu",
    )
    state, manifest = load_checkpoint(got.checkpoint)
    assert manifest["arch"] == "vit" and manifest["preset"] == "tiny" and manifest["image_size"] == SIZE
    assert manifest["num_classes"] == len(TAGS)
    tagger = TorchTagger(checkpoint_path=got.checkpoint, labels_path=got.labels_csv, preset="tiny",
                         image_size=SIZE, device="cpu")
    csv_names = [line.split(",")[0] for line in Path(got.labels_csv).read_text().splitlines()[1:]]
    assert tagger.names == csv_names and sorted(csv_names) == sorted(n for n, _ in TAGS)
    rgb = [np.random.default_rng(i).integers(0, 256, size=(40, 30, 3), dtype=np.uint8) for i in range(3)]
    probs = tagger.forward_probs(tagger.prepare_batch_from_rgb(rgb))
    assert tuple(probs.shape) == (3, len(TAGS)) and bool(torch.isfinite(probs).all())
    loaded = tagger._model.state_dict()
    for k, v in state.items():
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0)


def test_nothing_to_train_on(catalog, tmp_path):
    want, got = _run_both(catalog, tmp_path, min_tag_count=1000)
    assert (got.files, got.labels, got.steps, got.checkpoint) == (want.files, want.labels, 0, None)
    assert got.labels == 0


def test_load_training_set_equals_the_reference(catalog):
    want = jfinetune._load_training_set(catalog, min_tag_count=2, limit=7)
    got = tfinetune._load_training_set(catalog, min_tag_count=2, limit=7)
    assert [(r.file_id, str(r.path)) for r in got[0]] == [(r.file_id, str(r.path)) for r in want[0]]
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


def test_default_device_is_cuda_and_raises_without_a_gpu(catalog):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        tfinetune.finetune_from_catalog(catalog, preset="tiny", image_size=SIZE)


def test_cli_train_matches_the_reference_cli(tmp_path, jax_init, monkeypatch):
    """``ket train`` through both CLIs on one data dir (bf16, the CLI's
    default): the same files, labels and steps, the same labels CSV and
    sidecar, the first loss within bf16's reach of the reference's."""
    from kobato_eyes_tpu import cli as jcli
    from kobato_eyes_tpu_torch import cli as tcli
    from kobato_eyes_tpu_torch.utils.paths import get_app_paths

    data = tmp_path / "data"
    db = get_app_paths(data).ensure().db_path
    _write_catalog(db, _write_library(tmp_path / "lib"))
    outs = {}
    for name, cli, extra in (("jax", jcli, []), ("port", tcli, ["--device", "cpu"])):
        argv = ["--data-dir", str(data), *extra, "train", "--preset", "tiny", "--image-size", str(SIZE),
                "--batch-size", "4", "--lr", "1e-3", "--out", str(tmp_path / f"{name}_ck")]
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(argv) == 0
        outs[name] = json.loads(buf.getvalue().strip().splitlines()[-1])
    want, got = outs["jax"], outs["port"]
    assert set(got) == set(want)
    assert (got["files"], got["labels"], got["steps"]) == (want["files"], want["labels"], want["steps"])
    assert got["first_loss"] == pytest.approx(want["first_loss"], rel=2e-2)
    assert Path(got["labels_csv"]).read_bytes() == Path(want["labels_csv"]).read_bytes()
    assert (tmp_path / "port_ck_config.json").read_bytes() == (tmp_path / "jax_ck_config.json").read_bytes()
