"""The port's CLI over the device query engine, on the CPU.

``search`` with the default backend answers what ``--backend sql`` answers
and what the JAX package's CLI answers on the same data directory (line for
line: the printed relevance and path); ``--export``, ``--copy``,
``--copy-to``, ``--show-tags`` and ``repl``; the snapshot under
``index/epoch.npz`` is written once, reused, shared with the JAX package's
CLI and rebuilt when the catalog moves; and an index run that is given an
``EpochManager`` swaps the epoch, by delta on the second run.
"""

from __future__ import annotations

import csv
import io
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import kobato_eyes_tpu_torch.query.engine as teng
from kobato_eyes_tpu import cli as jcli
from kobato_eyes_tpu.db.connection import reset_bootstrap_cache as jreset
from kobato_eyes_tpu_torch import cli as tcli
from kobato_eyes_tpu_torch.core.config.schema import PipelineSettings, Settings, TaggerSettings
from kobato_eyes_tpu_torch.core.pipeline import run_index_once
from kobato_eyes_tpu_torch.db.connection import bootstrap, reset_bootstrap_cache
from kobato_eyes_tpu_torch.db.repository import TaggingItem, upsert_file, write_tagging_batch
from kobato_eyes_tpu_torch.models.tagger import DummyTagger
from kobato_eyes_tpu_torch.utils.paths import get_app_paths
from tests.test_torch_query_engine import TAG_POOL, _assert_epochs_equal
from tests.torch_native import catalog_fetch_built  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

QUERIES = ["1girl", "1girl OR solo", "1girl -smile", "category:character score>=0.5",
           "( 1girl OR solo ) long_hair", "unknown_tag", ""]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """A data directory whose catalog names 60 real files (so ``--copy-to``
    has something to copy; the last three are missing on disk)."""
    root = tmp_path_factory.mktemp("cli_data")
    files = tmp_path_factory.mktemp("cli_files")
    paths = get_app_paths(root).ensure()
    reset_bootstrap_cache()
    conn = bootstrap(paths.db_path)
    rng = np.random.default_rng(3)
    items = []
    for i in range(60):
        src = files / f"{i % 4}" / f"img_{i:03d}.png"
        if i < 57:
            src.parent.mkdir(exist_ok=True)
            src.write_bytes(b"png %d" % i)
        fid = upsert_file(conn, path=str(src), size=10 + i, mtime=1e9 + (i % 11) * 60)
        picks = rng.choice(len(TAG_POOL), size=int(rng.integers(1, 8)), replace=False)
        items.append(TaggingItem(file_id=fid, tagger_sig="t", tags=[
            (TAG_POOL[p][0], float(rng.uniform(0.05, 1.0)), TAG_POOL[p][1]) for p in picks]))
    write_tagging_batch(conn, items)
    conn.commit()
    conn.close()
    return root


def _run(main, data_dir, argv, capsys, device=("--device", "cpu")):
    capsys.readouterr()
    assert main(["--data-dir", str(data_dir), *device, *argv]) == 0
    captured = capsys.readouterr()
    return captured.out.splitlines(), captured.err


@pytest.mark.parametrize("order", ["relevance", "mtime", "path", "id"])
def test_default_backend_equals_sql_line_for_line(data_dir, capsys, order):
    for query in QUERIES:
        tail = ["--order", order, "--limit", "25", "--offset", "2", query]
        device, _ = _run(tcli.main, data_dir, ["search", *tail], capsys)
        sql, _ = _run(tcli.main, data_dir, ["search", "--backend", "sql", *tail], capsys)
        if order != "relevance":
            # as in the JAX engine, relevance is summed only where it orders
            # the rows; the SQL backend always sums it: the paths are held
            device, sql = ([line.split(None, 1)[1] for line in lines] for lines in (device, sql))
        assert device == sql, (query, order)
    assert device  # the empty query lists files


def test_equals_the_jax_cli_on_the_same_data_dir(data_dir, capsys):
    """Both CLIs read (and write) ``index/epoch.npz`` of one data directory:
    whichever snapshot is there loads in the other package."""
    snap = get_app_paths(data_dir).index_dir / "epoch.npz"
    jreset()
    for first, second in (((tcli.main, ("--device", "cpu")), (jcli.main, ())),
                          ((jcli.main, ()), (tcli.main, ("--device", "cpu")))):
        snap.unlink(missing_ok=True)
        for query in QUERIES[:4]:
            a, _ = _run(first[0], data_dir, ["search", query], capsys, device=first[1])
            assert snap.exists()
            # opening the catalog touches its -shm file: date the snapshot
            # after that, so the second CLI finds it fresh and loads it
            later = time.time() + 3600
            os.utime(snap, (later, later))
            b, _ = _run(second[0], data_dir, ["search", query], capsys, device=second[1])
            assert a == b and a, query
            assert snap.stat().st_mtime == later  # loaded, not written anew
            snap.unlink()


def test_multi_query_batch_equals_the_singles(data_dir, capsys):
    queries = ["1girl", "solo -smile", "category:copyright"]
    out, err = _run(tcli.main, data_dir, ["search", "--limit", "10", *queries], capsys)
    groups, current = {}, None
    for line in out:
        if line.startswith("# query: "):
            current = groups.setdefault(line.removeprefix("# query: "), [])
        else:
            current.append(line)
    assert list(groups) == queries
    for query in queries:
        single, _ = _run(tcli.main, data_dir, ["search", "--limit", "10", query], capsys)
        assert groups[query] == single and single
    assert f"{sum(len(g) for g in groups.values())} results in" in err


def test_snapshot_is_reused_until_the_catalog_moves(data_dir, capsys, monkeypatch):
    paths = get_app_paths(data_dir)
    snap = paths.index_dir / "epoch.npz"
    snap.unlink(missing_ok=True)
    want, _ = _run(tcli.main, data_dir, ["search", "1girl"], capsys)
    assert snap.exists() and snap.with_suffix(".json").exists()

    def no_build(*a, **k):
        raise AssertionError("the snapshot was fresh: no build expected")

    monkeypatch.setattr(teng, "build_epoch", no_build)
    got, _ = _run(tcli.main, data_dir, ["search", "1girl"], capsys)
    assert got == want
    monkeypatch.undo()

    # an unusable snapshot is rebuilt and written anew
    snap.with_suffix(".json").write_text("{}", encoding="utf-8")
    got, _ = _run(tcli.main, data_dir, ["search", "1girl"], capsys)
    assert got == want and "digest" in snap.with_suffix(".json").read_text(encoding="utf-8")

    # a catalog newer than the snapshot: rebuilt
    builds = []
    real = teng.build_epoch
    monkeypatch.setattr(teng, "build_epoch", lambda *a, **k: (builds.append(1), real(*a, **k))[1])
    later = time.time() + 5
    os.utime(paths.db_path, (later, later))
    got, _ = _run(tcli.main, data_dir, ["search", "1girl"], capsys)
    assert got == want and builds == [1]
    os.utime(paths.db_path, (later - 3600, later - 3600))
    for suffix in ("-wal", "-shm"):
        side = Path(str(paths.db_path) + suffix)
        if side.exists():
            os.utime(side, (later - 3600, later - 3600))


def test_export_writes_a_csv(data_dir, tmp_path, capsys):
    out, err = _run(tcli.main, data_dir, ["search", "--export", str(tmp_path / "hits.csv"), "1girl"], capsys)
    with (tmp_path / "hits.csv").open(encoding="utf-8") as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == ["file_id", "path", "relevance"]
    assert [r[1] for r in rows[1:]] == [line.split(None, 1)[1] for line in out] and len(rows) > 1
    assert "exported" in err
    _run(tcli.main, data_dir, ["search", "--export", str(tmp_path / "dir"), "1girl", "solo"], capsys)
    (exported,) = (tmp_path / "dir").glob("search_*.csv")
    assert exported.read_text(encoding="utf-8").splitlines()[0] == "file_id,path,relevance,query"


def test_copy_to_copies_every_hit(data_dir, tmp_path, capsys):
    """The full hit set is copied, not the printed page; missing sources
    count as failures; several queries get a folder each."""
    out, err = _run(tcli.main, data_dir, ["search", "--limit", "3", "--copy-to", str(tmp_path / "one"), ""], capsys)
    assert len(out) == 3
    assert len(list((tmp_path / "one").iterdir())) == 57
    assert "copied 57 file(s), 3 failed" in err
    _run(tcli.main, data_dir, ["search", "--copy-to", str(tmp_path / "two"), "1girl", "solo -smile"], capsys)
    folders = sorted(p.name for p in (tmp_path / "two").iterdir())
    assert len(folders) == 2 and all(any((tmp_path / "two" / f).iterdir()) for f in folders)
    sql_out, sql_err = _run(tcli.main, data_dir, ["search", "--backend", "sql", "--limit", "3", "--copy-to",
                                                   str(tmp_path / "sql"), ""], capsys)
    assert sql_out == out and "copied 57 file(s), 3 failed" in sql_err


def test_copy_uses_the_data_dirs_cache(data_dir, capsys):
    _, err = _run(tcli.main, data_dir, ["search", "--copy", "1girl"], capsys)
    root = get_app_paths(data_dir).cache_dir / "search_results"
    (folder,) = root.iterdir()
    assert any(folder.iterdir()) and str(folder) in err


def test_show_tags_lists_the_hits_tags(data_dir, capsys):
    out, _ = _run(tcli.main, data_dir, ["search", "--limit", "4", "--show-tags", "1girl"], capsys)
    hits = [line for line in out if not line.startswith("# ")]
    tags = [line for line in out if line.startswith("# ")]
    assert len(hits) == 4 and len(tags) == 4 and all("1girl:" in line for line in tags)


def test_repl_serves_from_a_resident_epoch(data_dir, capsys, monkeypatch):
    builds = []
    real = teng.build_epoch
    monkeypatch.setattr(teng, "build_epoch", lambda *a, **k: (builds.append(k.get("device")), real(*a, **k))[1])
    want = {q: _run(tcli.main, data_dir, ["search", "--backend", "sql", "--limit", "5", q], capsys)[0]
            for q in ("1girl", "solo -smile")}
    monkeypatch.setattr("sys.stdin", io.StringIO("1girl\n\nsolo -smile\n( unbalanced\n:reload\n1girl\n:quit\nsolo\n"))
    out, err = _run(tcli.main, data_dir, ["repl", "--limit", "5"], capsys)
    assert out == want["1girl"] + want["solo -smile"] + want["1girl"]
    assert [str(d) for d in builds] == ["cpu", "cpu"]  # the start and ':reload'; no build per query
    assert "epoch v1: 60 files" in err and "epoch v2 rebuilt" in err and "error:" in err


def test_device_backend_raises_without_a_gpu(data_dir, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device resolves")
    (get_app_paths(data_dir).index_dir / "epoch.npz").unlink(missing_ok=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--data-dir", str(data_dir), "search", "1girl"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--data-dir", str(data_dir), "repl"])


def test_index_runs_swap_the_epoch_by_delta(tmp_path):
    """First run: a full build (version 1). Second run over the library with
    one file rewritten, one removed and one added: a delta (version 2) equal
    to a fresh build."""
    lib = tmp_path / "lib"
    lib.mkdir()
    rng = np.random.default_rng(1)
    for i in range(8):
        Image.fromarray(rng.integers(0, 256, size=(40, 48, 3), dtype=np.uint8)).save(lib / f"img_{i}.png")
    db = tmp_path / "catalog.sqlite3"
    settings = Settings(pipeline=PipelineSettings(roots=[lib], batch_size=4, io_workers=2),
                        tagger=TaggerSettings(name="dummy"))
    manager = teng.EpochManager(device="cpu")
    reset_bootstrap_cache()
    stats = run_index_once(db, settings, DummyTagger(), epoch_manager=manager, device="cpu")
    first = manager.current
    assert stats.epoch_version == 1 and first.num_files == 8 and stats.extra["stage_walls"]["epoch"] >= 0

    Image.fromarray(rng.integers(0, 256, size=(52, 44, 3), dtype=np.uint8)).save(lib / "img_0.png")
    (lib / "img_1.png").unlink()
    Image.fromarray(rng.integers(0, 256, size=(30, 30, 3), dtype=np.uint8)).save(lib / "img_new.png")
    deltas = []
    real = teng.update_epoch
    teng.update_epoch = lambda *a, **k: (deltas.append(sorted(k["changed_file_ids"])), real(*a, **k))[1]
    try:
        stats = run_index_once(db, settings, DummyTagger(), epoch_manager=manager, device="cpu")
    finally:
        teng.update_epoch = real
    assert stats.epoch_version == 2 and manager.current.version == 2 and first.version == 1
    assert len(deltas) == 1 and len(deltas[0]) == 3  # rewritten, removed, added
    assert manager.current.num_files == 8
    conn = bootstrap(db)
    try:
        _assert_epochs_equal(manager.current, teng.build_epoch(conn, version=2, device="cpu"), canonical=True)
    finally:
        conn.close()
    names = {Path(r.path).name for r in teng.search_epoch(manager.current, "1girl")}
    assert "img_new.png" in names and "img_1.png" not in names and len(names) == 8
