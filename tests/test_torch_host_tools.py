"""The port's host-only tools against the repository's own
(``tools/bench_decode.py``, ``tools/bench_writer.py``, ``tools/migrate_data.py``,
``tools/coverage_gate.py``), on the CPU at tiny sizes. Rates are never
compared; what the tools compute is.

* ``bench_decode`` over one generated library prints the JAX tool's keys and
  ``images``; ``letterbox_square_rgb`` and ``load_rgb_array`` give bit-equal
  arrays in both packages; the port's ``PrefetchLoader`` yields every record
  once, in the JAX loader's batches with its pixels;
* ``bench_writer`` in both profiles prints the JAX tool's keys and ``rows``,
  and the two catalogs' ``tags`` and ``file_tags`` are equal row for row;
* ``migrate_data`` in each case of the JAX tool's own tests leaves equal trees;
* ``coverage_gate`` finds the JAX tool's executable and excluded lines, and
  measures only the port.
"""

from __future__ import annotations

import os
import sqlite3
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from kobato_eyes_tpu_torch.tools import bench_decode, bench_writer, coverage_gate, migrate_data
from tests.torch_bench_helpers import ROOT, dumps_keys, key_tree, last_json, load_jax_tool, run_main

torch.set_num_threads(1)

DECODE_IMAGES, DECODE_TARGET = 24, 64
WRITER_ARGS = ["--files", "200", "--tags-per-file", "5", "--vocab", "50"]


def _tree(root: Path) -> dict[str, bytes | None]:
    """Every path under ``root`` (relative), with a file's bytes."""
    if not root.exists():
        return {}
    return {p.relative_to(root).as_posix(): (p.read_bytes() if p.is_file() else None)
            for p in sorted(root.rglob("*"))}


# ---------------------------------------------------------------------------
# bench_decode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def decode_runs(tmp_path_factory):
    """Both tools over one library (the JAX tool generates it, the port's
    reuses it through the cache marker of the shared ``_gen_library``)."""
    work = tmp_path_factory.mktemp("decode")
    argv = ["--images", str(DECODE_IMAGES), "--target", str(DECODE_TARGET), "--workdir", str(work)]
    with pytest.MonkeyPatch.context() as mp:
        # the JAX tool puts ``tools/`` on sys.path to import its bench_e2e
        mp.setattr(sys, "path", sys.path[:])
        rc_j, out_j = run_main(load_jax_tool("tools/bench_decode.py").main, argv)
    rc_p, out_p = run_main(bench_decode.main, argv)
    assert rc_j == rc_p == 0
    lib = work / f"lib_{DECODE_IMAGES}_7"
    paths = sorted(p for p in lib.iterdir() if p.suffix in (".png", ".jpg"))
    return last_json(out_j), last_json(out_p), paths


def test_bench_decode_prints_the_jax_keys(decode_runs):
    want, got, paths = decode_runs
    assert key_tree(got) == key_tree(want)
    assert got["metric"] == "decode_ceiling"
    assert got["images"] == want["images"] == len(paths) == DECODE_IMAGES


@pytest.mark.parametrize("target", [DECODE_TARGET, 448], ids=["down64", "up448"])
def test_letterbox_is_bit_equal_across_packages(decode_runs, target):
    from kobato_eyes_tpu.models.preprocess import letterbox_square_rgb as letterbox_j
    from kobato_eyes_tpu.utils.image_io import load_rgb_array as load_j
    from kobato_eyes_tpu_torch.models.preprocess import letterbox_square_rgb as letterbox_p
    from kobato_eyes_tpu_torch.utils.image_io import load_rgb_array as load_p

    for path in decode_runs[2]:
        arr = load_p(path)
        np.testing.assert_array_equal(arr, load_j(path))
        # the library is square: crops of it take the white-pad branch too
        for a in (arr, arr[:, : arr.shape[1] * 2 // 3], arr[: arr.shape[0] // 2]):
            got = letterbox_p(a, target)
            assert got.shape == (target, target, 3) and got.dtype == np.uint8
            np.testing.assert_array_equal(got, letterbox_j(a, target))


def test_prefetch_loader_yields_every_record_once(decode_runs):
    from kobato_eyes_tpu.core.pipeline.contracts import FileRecord as RecordJ
    from kobato_eyes_tpu.core.pipeline.loaders import PrefetchLoader as LoaderJ
    from kobato_eyes_tpu.models.preprocess import letterbox_square_rgb as letterbox_j
    from kobato_eyes_tpu_torch.core.pipeline.contracts import FileRecord
    from kobato_eyes_tpu_torch.core.pipeline.loaders import PrefetchLoader
    from kobato_eyes_tpu_torch.models.preprocess import letterbox_square_rgb

    paths = decode_runs[2]

    def batches(record_cls, loader_cls, letterbox):
        records = [record_cls(file_id=i, path=p, size=p.stat().st_size, mtime=p.stat().st_mtime)
                   for i, p in enumerate(paths)]
        loader = loader_cls(records, prepare=lambda imgs: np.stack([letterbox(a, DECODE_TARGET) for a in imgs]),
                            batch_size=5, prefetch_depth=2, io_workers=4)
        return [([r.file_id for r in b.records], b.pixels) for b in loader]

    got = batches(FileRecord, PrefetchLoader, letterbox_square_rgb)
    want = batches(RecordJ, LoaderJ, letterbox_j)
    ids = [i for b, _ in got for i in b]
    assert sorted(ids) == list(range(len(paths)))
    assert [b for b, _ in got] == [b for b, _ in want]
    for (_, pg), (_, pw) in zip(got, want):
        assert pg.shape[1:] == (DECODE_TARGET, DECODE_TARGET, 3)
        np.testing.assert_array_equal(pg, pw)


# ---------------------------------------------------------------------------
# bench_writer
# ---------------------------------------------------------------------------


def _catalog_rows(db: Path) -> tuple[list, list]:
    conn = sqlite3.connect(db)
    try:
        tags = conn.execute("SELECT id, name, category FROM tags ORDER BY id").fetchall()
        file_tags = conn.execute("SELECT file_id, tag_id, score FROM file_tags ORDER BY file_id, tag_id").fetchall()
        return tags, file_tags
    finally:
        conn.close()


@pytest.mark.parametrize("profile", [[], ["--standard"]], ids=["unsafe_fast", "standard"])
def test_bench_writer_matches_the_jax_tool(tmp_path, monkeypatch, profile):
    made: list[Path] = []
    real = tempfile.mkdtemp

    def mkdtemp(*args, **kwargs):
        made.append(Path(real(*args, dir=tmp_path, **kwargs)))
        return str(made[-1])

    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)
    rc_j, out_j = run_main(load_jax_tool("tools/bench_writer.py").main, WRITER_ARGS + profile)
    rc_p, out_p = run_main(bench_writer.main, WRITER_ARGS + profile)
    assert rc_j == rc_p == 0 and len(made) == 2
    want, got = last_json(out_j), last_json(out_p)
    assert key_tree(got) == key_tree(want) == dumps_keys("tools/bench_writer.py")
    assert got["rows"] == want["rows"] and 5 * 200 * 0.8 < got["rows"] <= 5 * 200
    assert got["files"] == 200 and got["profile"] == want["profile"]
    tags_j, rows_j = _catalog_rows(made[0] / "scale.sqlite")
    tags_p, rows_p = _catalog_rows(made[1] / "scale.sqlite")
    assert len(rows_p) == got["rows"] and len(tags_p) <= 50
    assert tags_p == tags_j
    assert rows_p == rows_j


# ---------------------------------------------------------------------------
# migrate_data: the cases of tests/test_tools.py, each through both tools
# ---------------------------------------------------------------------------


def _flat_db_moves_side_files(tool, paths, tmp):
    paths.root.mkdir(parents=True)
    (paths.root / "catalog.sqlite3").write_bytes(b"db")
    (paths.root / "catalog.sqlite3-wal").write_bytes(b"wal")
    assert tool.migrate_flat_db(paths)
    assert paths.db_path.read_bytes() == b"db"
    assert (paths.db_path.parent / "catalog.sqlite3-wal").read_bytes() == b"wal"
    assert not (paths.root / "catalog.sqlite3").exists()
    assert not tool.migrate_all(paths)  # idempotent


def _flat_db_refuses_overwrite(tool, paths, tmp):
    paths.ensure()
    paths.db_path.write_bytes(b"current")
    (paths.root / "catalog.sqlite3").write_bytes(b"legacy")
    assert not tool.migrate_flat_db(paths)
    assert paths.db_path.read_bytes() == b"current"


def _legacy_home_relocates(tool, paths, tmp):
    legacy = tmp / "old-home"
    (legacy / "db").mkdir(parents=True)
    (legacy / "db" / "catalog.sqlite3").write_bytes(b"old")
    assert tool.migrate_legacy_home(paths, legacy=legacy)
    assert paths.db_path.read_bytes() == b"old"
    assert not legacy.exists()


def _legacy_home_keeps_existing_data(tool, paths, tmp):
    paths.ensure()
    paths.db_path.write_bytes(b"current")
    legacy = tmp / "old-home"
    legacy.mkdir()
    (legacy / "anything").write_text("x")
    assert not tool.migrate_legacy_home(paths, legacy=legacy)
    assert legacy.exists()


MIGRATIONS = [_flat_db_moves_side_files, _flat_db_refuses_overwrite, _legacy_home_relocates,
              _legacy_home_keeps_existing_data]


@pytest.mark.parametrize("case", MIGRATIONS, ids=lambda f: f.__name__.strip("_"))
def test_migrate_data_leaves_the_jax_tools_tree(tmp_path, case):
    from kobato_eyes_tpu.utils.paths import get_app_paths as paths_j
    from kobato_eyes_tpu_torch.utils.paths import get_app_paths as paths_p

    trees = []
    for name, tool, get_paths in (("jax", load_jax_tool("tools/migrate_data.py"), paths_j),
                                  ("port", migrate_data, paths_p)):
        tmp = tmp_path / name
        case(tool, get_paths(tmp / "data"), tmp)
        trees.append(_tree(tmp))
    assert trees[1] == trees[0] and trees[0]


def test_migrate_data_main_moves_the_legacy_home(tmp_path, monkeypatch, capsys):
    """``main`` through ``KET_DATA_DIR`` and ``HOME``: the legacy home and a
    flat catalog in it move in both tools, and each prints its data root."""
    trees, lines = [], []
    for name, tool in (("jax", load_jax_tool("tools/migrate_data.py")), ("port", migrate_data)):
        home = tmp_path / name / "home"
        legacy = home / ".kobato-eyes-tpu"
        legacy.mkdir(parents=True)
        (legacy / "catalog.sqlite3").write_bytes(b"flat")
        (legacy / "catalog.sqlite3-shm").write_bytes(b"shm")
        monkeypatch.setenv("HOME", str(home))
        monkeypatch.setenv("KET_DATA_DIR", str(tmp_path / name / "data"))
        tool.main()
        lines.append(capsys.readouterr().out.replace(str(tmp_path / name), "<tmp>"))
        trees.append(_tree(tmp_path / name))
    assert lines[1] == lines[0] == "Migration completed. Data directory is <tmp>/data\n"
    assert trees[1] == trees[0]
    assert trees[0]["data/db/catalog.sqlite3"] == b"flat"


# ---------------------------------------------------------------------------
# coverage_gate
# ---------------------------------------------------------------------------


# files of both packages and both tools, two with ``# pragma: no cover`` lines
COVERAGE_FILES = ["kobato_eyes_tpu/core/jobs.py", "kobato_eyes_tpu_torch/core/jobs.py",
                  "kobato_eyes_tpu/ops/hamming.py", "kobato_eyes_tpu_torch/ops/hamming.py",
                  "kobato_eyes_tpu_torch/core/pipeline/loaders.py",
                  "tools/coverage_gate.py", "kobato_eyes_tpu_torch/tools/coverage_gate.py"]


@pytest.mark.parametrize("rel", COVERAGE_FILES)
def test_coverage_gate_counts_lines_as_the_jax_tool(rel):
    jtool = load_jax_tool("tools/coverage_gate.py")
    path = ROOT / rel
    lines = coverage_gate.executable_lines(path)
    assert lines and lines == jtool.executable_lines(path)
    assert coverage_gate.pragma_excluded(path) == jtool.pragma_excluded(path)
    if rel.endswith("jobs.py"):
        assert coverage_gate.pragma_excluded(path)


def test_coverage_gate_measures_only_the_port():
    targets = coverage_gate.collect_targets()
    port = str(ROOT / "kobato_eyes_tpu_torch") + os.sep
    assert targets and all(name.startswith(port) for name in targets)
    assert str(ROOT / "kobato_eyes_tpu_torch" / "tools" / "coverage_gate.py") in targets
    jobs = targets[str(ROOT / "kobato_eyes_tpu_torch" / "core" / "jobs.py")]
    assert not jobs & coverage_gate.pragma_excluded(ROOT / "kobato_eyes_tpu_torch" / "core" / "jobs.py")
    args = coverage_gate.default_pytest_args()
    assert args[-1] == "-q" and args[:-1] and all(Path(a).name.startswith("test_torch_") for a in args[:-1])


def test_coverage_gate_runs_a_test_file(tmp_path):
    """The gate as a user runs it, over one small test of ``utils/bits.py``:
    the table lists the port's files, the missed lines of ``bits.py``, and
    a gate of 100% fails with exit 2."""
    test = tmp_path / "test_bits.py"
    test.write_text(
        "import numpy as np\n"
        "from kobato_eyes_tpu_torch.utils.bits import u64_to_u32pair\n\n"
        "def test_pair():\n"
        "    assert u64_to_u32pair(np.array([1], np.uint64)).shape == (1, 2)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-m", "kobato_eyes_tpu_torch.tools.coverage_gate", "--fail-under", "100",
         "--missing", "utils/bits.py", str(test), "-q", "-p", "no:cacheprovider"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "1 passed" in proc.stdout
    rows = {line.split()[0]: line.split()[1:] for line in proc.stdout.splitlines() if line.strip()}
    bits = rows["kobato_eyes_tpu_torch/utils/bits.py"]
    assert 0 < int(bits[1]) < int(bits[0])  # some lines missed, some hit
    assert "kobato_eyes_tpu/utils/bits.py" not in rows and "TOTAL" in rows
    assert any(line.startswith("missing kobato_eyes_tpu_torch/utils/bits.py: ") for line in proc.stdout.splitlines())
    assert "< fail-under 100.0%" in proc.stderr
