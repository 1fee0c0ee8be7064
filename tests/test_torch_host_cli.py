"""The port's upkeep, weight and host commands against the JAX package's CLI.

One image folder and data directory is indexed (dummy tagger) and copied
twice, modification times kept; each CLI runs the same command on its own
copy, and the two must print the same standard output and leave the same
catalog (paths taken relative to the copy, dates and times masked):
``refresh`` (``--hard-delete``), ``retag`` (``--force``, ``--ids``),
``stats`` (``--export``), ``complete``, ``thresholds`` (``--set``),
``trash`` (``--put``, ``--restore``, ``--restore-all``), ``reset``
(``--yes``, ``--no-backup``), ``config`` (``--init``), ``watch``,
``inspect`` and ``import-weights``. Then the weights a user brings:
``import-weights`` writes the port's checkpoint from a ``.safetensors`` and
an ``.onnx`` file, and ``index`` with ``tagger.model_path`` naming it writes
the same tags and scores, bit for bit, as the tagger holding those weights.
"""

from __future__ import annotations

import dataclasses
import json
import re
import shutil
import sqlite3
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from kobato_eyes_tpu import cli as jcli
from kobato_eyes_tpu.db.connection import reset_bootstrap_cache as jreset
from kobato_eyes_tpu.models import tagger as jtagger
from kobato_eyes_tpu_torch import cli as tcli
from kobato_eyes_tpu_torch.core.config.schema import PipelineSettings, Settings, TaggerSettings
from kobato_eyes_tpu_torch.core.config.service import save_settings
from kobato_eyes_tpu_torch.db.connection import reset_bootstrap_cache as treset
from kobato_eyes_tpu_torch.models import archs as tarchs
from kobato_eyes_tpu_torch.models import import_weights as timport
from kobato_eyes_tpu_torch.models import onnx_import as tonnx
from kobato_eyes_tpu_torch.models import tagger as ttagger
from kobato_eyes_tpu_torch.utils.paths import get_app_paths
from tests.test_torch_maintenance import catalog_rows, write_images

torch.set_num_threads(1)

N_IMAGES = 5


class Tree:
    """A copy of the indexed workspace: images, data directory, settings."""

    def __init__(self, root: Path, main, device: tuple[str, ...]) -> None:
        self.root, self.main, self.device = root, main, device
        self.images = root / "images"
        self.data = root / "data"
        self.cfg = root / "settings.yaml"
        self.db = get_app_paths(self.data).db_path

    def run(self, capsys, *argv: str) -> tuple[int, str]:
        """``<images>`` in ``argv`` names this copy's image folder."""
        capsys.readouterr()
        argv = tuple(a.replace("<images>", str(self.images)) for a in argv)
        rc = self.main(["--config", str(self.cfg), "--data-dir", str(self.data), *self.device, *argv])
        return rc, self.mask(capsys.readouterr().out)

    def mask(self, text: str) -> str:
        text = text.replace(str(self.root), "<tree>")
        text = re.sub(r"\d{8}_\d{6}", "<stamp>", text)
        text = re.sub(r'"(ts|elapsed_sec)": [0-9.e+-]+', r'"\1": <t>', text)
        text = re.sub(r'"stage_walls": \{[^}]*\}', '"stage_walls": <walls>', text)
        return re.sub(r'"tag_infer_s": [0-9.e+-]+', '"tag_infer_s": <t>', text)

    def catalog(self) -> dict:
        rows = catalog_rows(self.db)
        return {k: [tuple(self.mask(v) if isinstance(v, str) else v for v in r) for r in rs]
                for k, rs in rows.items()}

    def ids(self, *names: str) -> list[str]:
        conn = sqlite3.connect(self.db)
        try:
            return [str(conn.execute("SELECT id FROM files WHERE path = ?",
                                     (str(self.images / n),)).fetchone()[0]) for n in names]
        finally:
            conn.close()


def _settings(images: Path) -> Settings:
    return Settings(pipeline=PipelineSettings(roots=[images], batch_size=2, io_workers=2),
                    tagger=TaggerSettings(name="dummy"))


@pytest.fixture
def twins(tmp_path) -> tuple[Tree, Tree]:
    """The workspace indexed once, then copied for each CLI (catalog paths
    and the settings' root rewritten to the copy)."""
    src = tmp_path / "src"
    write_images(src / "images", [f"img_{i}.png" for i in range(N_IMAGES)], seed=11)
    save_settings(_settings(src / "images"), src / "settings.yaml")
    treset()
    assert tcli.main(["--config", str(src / "settings.yaml"), "--data-dir", str(src / "data"),
                      "--device", "cpu", "index"]) == 0
    trees = []
    for name, main, device in (("port", tcli.main, ("--device", "cpu")), ("jax", jcli.main, ())):
        tree = Tree(tmp_path / name, main, device)
        shutil.copytree(src, tree.root, copy_function=shutil.copy2)
        save_settings(_settings(tree.images), tree.cfg)
        conn = sqlite3.connect(tree.db)
        conn.execute("UPDATE files SET path = ? || substr(path, ?)", (str(tree.root), len(str(src)) + 1))
        conn.commit()
        conn.close()
        trees.append(tree)
    treset()
    jreset()
    return trees[0], trees[1]


def both(twins, capsys, *argv: str, rc: int = 0) -> str:
    port, jax_ = twins
    got, want = port.run(capsys, *argv), jax_.run(capsys, *argv)
    assert got == want
    assert got[0] == rc
    return got[1]


def add_images(twins, names, seed: int) -> None:
    """New files in both copies, modification times equal."""
    port, jax_ = twins
    for path in write_images(port.images, names, seed):
        shutil.copy2(path, jax_.images / path.name)


def same_catalogs(twins) -> None:
    port, jax_ = twins
    assert port.catalog() == jax_.catalog()


def test_refresh_and_hard_delete(twins, capsys):
    add_images(twins, ["newcomer.png"], seed=12)
    for tree in twins:
        (tree.images / "img_0.png").unlink()
    out = both(twins, capsys, "refresh", "<images>")  # the stats line, its times masked
    assert '"tagged": 1,' in out and '"missing": 1,' in out
    same_catalogs(twins)
    for tree in twins:
        (tree.images / "img_1.png").unlink()
    assert '"missing": 1,' in both(twins, capsys, "refresh", "--hard-delete", "<images>")
    same_catalogs(twins)


@pytest.mark.parametrize("argv", [("retag",), ("retag", "--force"), ("retag", "--ids")])
def test_retag(twins, capsys, argv):
    if argv[-1] == "--ids":
        for tree in twins:
            assert tree.ids("img_1.png", "img_3.png") == twins[0].ids("img_1.png", "img_3.png")
        argv = (*argv, *twins[0].ids("img_1.png", "img_3.png"))
    out = both(twins, capsys, *argv)
    if "--ids" in argv:
        assert '"tagged": 2,' in out
    else:
        assert json.loads(out) == {"cleared": N_IMAGES}
    same_catalogs(twins)


def test_stats_complete_thresholds(twins, capsys, tmp_path):
    assert "1girl" in both(twins, capsys, "stats")
    both(twins, capsys, "stats", "--category", "0", "--filter", "girl", "--limit", "3")
    exports = []
    for tree in twins:
        capsys.readouterr()
        dest = tmp_path / f"{tree.root.name}_stats.csv"
        assert tree.main(["--config", str(tree.cfg), "--data-dir", str(tree.data), *tree.device,
                          "stats", "--export", str(dest)]) == 0
        exports.append(dest.read_text())
    assert exports[0] == exports[1] and "1girl" in exports[0]
    assert both(twins, capsys, "complete", "1").strip() == f"1girl\t0\t{N_IMAGES}"
    both(twins, capsys, "complete", "zz")
    assert json.loads(both(twins, capsys, "thresholds", "--set", "0=0.5", "--set", "4=0.75")) == {
        "0": 0.5, "4": 0.75}
    both(twins, capsys, "thresholds")


def test_trash_put_list_restore(twins, capsys):
    fid = twins[0].ids("img_2.png")[0]
    assert json.loads(both(twins, capsys, "trash", "--put", fid, "999999", rc=1)) == {
        "trashed": [int(fid)], "failed": [999999]}
    same_catalogs(twins)
    listing = both(twins, capsys, "trash")
    assert '"original": "<tree>/images/img_2.png"' in listing
    assert json.loads(both(twins, capsys, "trash", "--restore", fid)) == {"restored": [int(fid)], "remaining": 0}
    same_catalogs(twins)
    both(twins, capsys, "trash", "--put", *twins[0].ids("img_3.png", "img_4.png"))
    assert json.loads(both(twins, capsys, "trash", "--restore-all"))["remaining"] == 0
    assert all((tree.images / "img_4.png").exists() for tree in twins)
    same_catalogs(twins)
    for tree in twins:
        with pytest.raises(SystemExit, match="restore"):
            tree.run(capsys, "trash", "--restore")


@pytest.mark.parametrize("backup", [True, False])
def test_reset(twins, capsys, backup):
    for tree in twins:
        with pytest.raises(SystemExit, match="--yes"):
            tree.run(capsys, "reset")
    out = json.loads(both(twins, capsys, "reset", "--yes", *(() if backup else ("--no-backup",))))
    assert bool(out["backups"]) is backup
    assert all(b.startswith("<tree>/data/db/catalog.sqlite3") for b in out["backups"])
    for tree in twins:
        assert not tree.db.exists()
        assert sorted(tree.mask(str(p)) for p in tree.db.parent.iterdir()) == sorted(out["backups"])
    assert both(twins, capsys, "stats") == ""  # a fresh, empty catalog
    same_catalogs(twins)


def test_config_show_and_init(twins, capsys, tmp_path):
    assert json.loads(both(twins, capsys, "config"))["tagger"]["name"] == "dummy"
    written = []
    for tree in twins:
        dest = tmp_path / f"{tree.root.name}_init.yaml"
        capsys.readouterr()
        assert tree.main(["--config", str(dest), *tree.device, "config", "--init"]) == 0
        assert capsys.readouterr().out == f"wrote {dest}\n"
        written.append(dest.read_text())
    assert written[0] == written[1]


def test_watch_tags_what_appears(twins, capsys, monkeypatch):
    """``watch`` polls until interrupted: the main loop's sleep is where the
    test waits for the new file's tags, then interrupts."""
    add_images(twins, ["late.png"], seed=13)
    for tree in twins:
        db = tree.db

        def sleep_until_tagged(_seconds, db=db):
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                conn = sqlite3.connect(db)
                try:
                    done = conn.execute("SELECT COUNT(*) FROM files f JOIN file_tags ft ON ft.file_id = f.id "
                                        "WHERE f.path LIKE '%late.png'").fetchone()[0]
                finally:
                    conn.close()
                if done:
                    break
                real_sleep(0.05)
            raise KeyboardInterrupt

        real_sleep = time.sleep
        monkeypatch.setattr(time, "sleep", sleep_until_tagged)
        rc, out = tree.run(capsys, "watch", "--interval", "0.05")
        monkeypatch.setattr(time, "sleep", real_sleep)
        assert rc == 0 and out == ""
    same_catalogs(twins)


def test_inspect_labels_and_onnx(twins, capsys, tmp_path):
    labels = tmp_path / "selected_tags.csv"
    labels.write_text("name,category,count\n" + "\n".join(f"t{i},general,1" for i in range(8000)) + "\n")
    onnx = tmp_path / "w.onnx"
    tonnx.write_onnx_initializers(onnx, {"a.weight": np.ones((3, 4), np.float32), "a.bias": np.zeros(3, np.float32)})
    out = both(twins, capsys, "inspect", "--labels", str(labels), "--checkpoint", str(onnx))
    assert "family: wd14" in out and "onnx weights: 2 initializers" in out
    both(twins, capsys, "inspect", "--checkpoint", str(tmp_path / "missing.onnx"))


# -- the weights a user brings ----------------------------------------------------

N_LABELS = 24


@pytest.fixture
def tiny_base(monkeypatch):
    """The ``base`` preset cut to the tiny one at 64 px, for the CLI's own
    tagger and importer (the CPU run stays short)."""
    vit = tarchs.ARCHS["vit"]
    cut = lambda preset, **kw: vit.preset_config("tiny", **{**kw, "image_size": 64})  # noqa: E731
    monkeypatch.setitem(tarchs.ARCHS, "vit", dataclasses.replace(vit, preset_config=cut))


def test_import_weights_matches_the_jax_importer(tmp_path, capsys, tiny_base):
    """The same ``.safetensors`` through both CLIs: the JAX package's orbax
    checkpoint and the port's directory hold the same weights."""
    tagger = ttagger.WD14Tagger(labels=ttagger.synthetic_labels(N_LABELS), device="cpu", seed=3)
    state = tagger._model.state_dict()
    from safetensors.torch import save_file

    src = tmp_path / "w.safetensors"
    save_file(dict(state), str(src))
    outs = []
    for main, device, out in ((tcli.main, ("--device", "cpu"), tmp_path / "port_ck"),
                              (jcli.main, (), tmp_path / "jax_ck")):
        capsys.readouterr()
        assert main(["--data-dir", str(tmp_path / "d"), *device, "import-weights", str(src), str(out),
                     "--arch", "vit", "--preset", "tiny", "--image-size", "64",
                     "--classes", str(N_LABELS)]) == 0
        outs.append(json.loads(capsys.readouterr().out.replace(str(out), "<out>")))
    assert outs[0] == outs[1] == {"arch": "vit", "preset": "tiny", "out": "<out>"}
    loaded, meta = ttagger.load_checkpoint(tmp_path / "port_ck")
    jax_params = jax.tree.map(np.asarray, jtagger.load_checkpoint(tmp_path / "jax_ck"))
    want = timport.vit_state_from_jax_params(jax_params, tagger.cfg)
    assert loaded.keys() == want.keys()
    assert all(torch.equal(loaded[k], want[k]) and torch.equal(loaded[k], state[k]) for k in want)
    assert meta["source"]["name"] == "w.safetensors" and len(meta["source"]["sha256"]) == 64
    assert (meta["arch"], meta["num_classes"], meta["image_size"], meta["patch_size"]) == ("vit", N_LABELS, 64, 16)


@pytest.mark.parametrize("fmt", ["safetensors", "onnx", "onnx-folded"])
def test_index_with_an_imported_checkpoint_equals_its_weights(tmp_path, capsys, tiny_base, fmt):
    labels = tmp_path / "selected_tags.csv"
    labels.write_text("tag_id,name,category,count\n"
                      + "".join(f"{i},tag_{i},{4 if i % 7 == 0 else 0},{100 - i}\n" for i in range(N_LABELS)))
    images = tmp_path / "images"
    write_images(images, [f"img_{i}.png" for i in range(4)], seed=14)
    random_tagger = ttagger.WD14Tagger(labels_path=labels, device="cpu")
    state = {k: v.numpy() for k, v in random_tagger._model.state_dict().items()}
    src = tmp_path / f"w.{fmt.split('-')[0]}"
    if fmt == "safetensors":
        from safetensors.numpy import save_file

        save_file(state, str(src))
    else:
        from tests.test_torch_checkpoint import _fold

        tonnx.write_onnx_initializers(src, _fold(state) if fmt == "onnx-folded" else state)
    ckpt = tmp_path / "ckpt"
    assert tcli.main(["--data-dir", str(tmp_path / "d"), "--device", "cpu", "import-weights", str(src),
                      str(ckpt), "--arch", "vit", "--image-size", "64", "--classes", str(N_LABELS)]) == 0
    catalogs = []
    for name, model_path in (("random", None), ("ckpt", ckpt)):
        cfg = tmp_path / f"{name}.yaml"
        save_settings(Settings(pipeline=PipelineSettings(roots=[images], batch_size=2, io_workers=2),
                               tagger=TaggerSettings(name="wd14", labels_path=labels, model_path=model_path)), cfg)
        treset()
        capsys.readouterr()
        assert tcli.main(["--config", str(cfg), "--data-dir", str(tmp_path / name), "--device", "cpu", "index"]) == 0
        stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert stats["tagged"] == 4 and stats["tag_failed"] == 0
        catalogs.append(catalog_rows(get_app_paths(tmp_path / name).db_path))
    random_rows, ckpt_rows = catalogs
    assert ckpt_rows["tags"] == random_rows["tags"] and ckpt_rows["tags"]  # bit for bit
    assert ckpt_rows["signatures"] == random_rows["signatures"]
    # the signature names the checkpoint, so a retag tells the two apart
    assert {r[6] for r in ckpt_rows["files"]} != {r[6] for r in random_rows["files"]}


def test_validate_checkpoint_reads_onnx_and_the_checkpoint_directory(tmp_path, capsys, tiny_base):
    state = ttagger.WD14Tagger(labels=ttagger.synthetic_labels(N_LABELS), device="cpu", seed=9)._model.state_dict()
    onnx = tmp_path / "w.onnx"
    tonnx.write_onnx_initializers(onnx, {k: v.numpy() for k, v in state.items()})
    ckpt = tmp_path / "ck"
    base = ["--data-dir", str(tmp_path / "d"), "--device", "cpu"]
    assert tcli.main([*base, "import-weights", str(onnx), str(ckpt), "--arch", "vit", "--image-size", "64",
                      "--classes", str(N_LABELS)]) == 0
    reports = []
    for path in (onnx, ckpt):
        capsys.readouterr()
        rc = tcli.main([*base, "validate-checkpoint", str(path), "--arch", "vit", "--image-size", "64",
                        "--classes", str(N_LABELS), "--images", "2"])
        report = json.loads(capsys.readouterr().out)
        assert rc == (0 if report["ok"] else 1) and report["finite"]
        reports.append(report)
    assert reports[0].pop("import") == "strict-manifest-ok" and reports[1].pop("import") == "checkpoint"
    reports[0].pop("path"), reports[1].pop("path")
    assert reports[0] == reports[1]
