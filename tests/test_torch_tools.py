"""The port's query, ANN and whole-system benchmarks against the
repository's own (``tools/bench_query.py``, ``tools/bench_ann.py``,
``tools/bench_e2e.py``), on the CPU at tiny sizes.

* the generators give the JAX originals' bytes: ``build_catalog``'s rows,
  ``QUERY_WORKLOAD``, ``synth_embeddings``, ``_gen_library``'s files and
  planted pairs;
* ``bench_query`` prints the JAX tool's keys over the same catalog with both
  backends agreeing (the tools assert 0 mismatches), and ``--orders-only``
  the same rows by ordering;
* ``bench_ann`` prints the JAX tool's keys and recalls: flat 1.0, IVF the JAX
  tool's (its k-means is seeded alike), HNSW at least 0.9, IVF at least 0.9
  once it probes more lists;
* ``bench_e2e`` (with ``--cached-retag``) prints the JAX tool's keys and its
  ``checks`` dict.
"""

from __future__ import annotations

import sqlite3
from pathlib import Path

import pytest
import torch

from kobato_eyes_tpu_torch.tools import bench_ann, bench_e2e, bench_query
from tests.torch_bench_helpers import key_tree, last_json, load_jax_tool, run_main
from tests.torch_native import catalog_fetch_built, hnsw_built, native_built  # noqa: F401  (autouse fixtures)

torch.set_num_threads(1)

N_FILES, N_TAGS = 2000, 200
ANN_ARGS = ["--n", "2000", "--dim", "64"]
E2E_ARGS = ["--images", "24", "--tagger-preset", "tiny", "--tagger-size", "64",
            "--labels", "64", "--batch-size", "8", "--cached-retag"]


def dump_catalog(db: Path) -> dict[str, list[tuple]]:
    """Every table's rows in rowid (or key) order, time stamps left out."""
    conn = sqlite3.connect(db)
    try:
        out = {}
        tables = [r[0] for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table' ORDER BY name")]
        for table in tables:
            cols = [r[1] for r in conn.execute(f"PRAGMA table_info({table})")
                    if not r[1].endswith("_at")]
            out[table] = conn.execute(
                f"SELECT {', '.join(cols)} FROM {table} ORDER BY {', '.join(cols)}").fetchall()
        return out
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# bench_query
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def catalogs(tmp_path_factory):
    """The same catalog written by each package's ``build_catalog``."""
    root = tmp_path_factory.mktemp("catalogs")
    jtool = load_jax_tool("tools/bench_query.py")
    jtool.build_catalog(root / "jax.sqlite", N_FILES, N_TAGS)
    bench_query.build_catalog(root / "port.sqlite", N_FILES, N_TAGS)
    return jtool, root / "jax.sqlite", root / "port.sqlite"


def test_build_catalog_writes_the_jax_rows(catalogs):
    _, db_j, db_p = catalogs
    want, got = dump_catalog(db_j), dump_catalog(db_p)
    assert set(got) == set(want)
    assert len(got["files"]) == N_FILES and len(got["file_tags"]) > 10 * N_FILES
    for table in want:
        assert got[table] == want[table], table


def test_query_workload_is_the_jax_workload(catalogs):
    assert bench_query.QUERY_WORKLOAD == catalogs[0].QUERY_WORKLOAD


@pytest.mark.parametrize("mode", [[], ["--orders-only"]], ids=["workload", "orders_only"])
def test_bench_query_prints_the_jax_keys(catalogs, mode):
    jtool, db_j, db_p = catalogs
    common = ["--files", str(N_FILES), "--tags", str(N_TAGS), "--repeats", "2", *mode]
    rc_j, out_j = run_main(jtool.main, common + ["--db", str(db_j)])
    rc_p, out_p = run_main(bench_query.main, common + ["--db", str(db_p), "--device", "cpu"])
    want, got = last_json(out_j), last_json(out_p)
    assert rc_j == rc_p == 0  # each tool asserts that its backends agree
    assert key_tree(got) == key_tree(want)
    assert got["metric"] == want["metric"]
    assert got["files"] == want["files"] == N_FILES
    if mode:
        for order, stats in want["orders"].items():
            assert got["orders"][order]["rows"] == stats["rows"], order
    else:
        assert got["value"] > 0 and got["dispatch_only_ms"]["p50"] > 0


# ---------------------------------------------------------------------------
# bench_ann
# ---------------------------------------------------------------------------


def test_synth_embeddings_equal_the_jax_bytes():
    jtool = load_jax_tool("tools/bench_ann.py")
    for want, got in zip(jtool.synth_embeddings(2000, 64), bench_ann.synth_embeddings(2000, 64)):
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("extra", [[], ["--nprobe", "48", "--skip-hnsw"]], ids=["default", "nprobe48"])
def test_bench_ann_prints_the_jax_keys_and_recalls(extra):
    jtool = load_jax_tool("tools/bench_ann.py")
    rc_j, out_j = run_main(jtool.main, ANN_ARGS + extra)
    rc_p, out_p = run_main(bench_ann.main, ANN_ARGS + extra + ["--device", "cpu"])
    want, got = last_json(out_j), last_json(out_p)
    assert rc_j == rc_p == 0
    assert key_tree(got) == key_tree(want)
    assert got["metric"] == want["metric"] == "ann_recall_at_10_2k"
    assert got["flat"]["recall"] == 1.0
    # seeded k-means alike: the JAX tool's IVF recall (0.7863 at 16 of 89
    # lists on this data, where ~2 vectors share each of 1024 centres)
    assert abs(got["ivf"]["recall"] - want["ivf"]["recall"]) <= 0.01
    if "--skip-hnsw" in extra:
        assert got["ivf"]["recall"] >= 0.9
    else:
        assert got["hnsw"]["recall"] >= 0.9 and want["hnsw"]["recall"] >= 0.9


# ---------------------------------------------------------------------------
# bench_e2e
# ---------------------------------------------------------------------------


def test_gen_library_writes_the_jax_files(tmp_path):
    jtool = load_jax_tool("tools/bench_e2e.py")
    want = jtool._gen_library(tmp_path / "jax", 24, 7)
    got = bench_e2e._gen_library(tmp_path / "port", 24, 7)
    assert got == want and want["n"] == 24 and len(want["planted"]) == 3
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


@pytest.fixture(scope="module")
def e2e_runs(tmp_path_factory):
    jtool = load_jax_tool("tools/bench_e2e.py")
    rc_j, out_j = run_main(jtool.main, E2E_ARGS + ["--workdir", str(tmp_path_factory.mktemp("e2e_jax"))])
    rc_p, out_p = run_main(bench_e2e.main, E2E_ARGS + ["--workdir", str(tmp_path_factory.mktemp("e2e_port")),
                                                       "--device", "cpu"])
    return (rc_j, last_json(out_j)), (rc_p, last_json(out_p))


def test_bench_e2e_checks_equal_the_jax_tool(e2e_runs):
    (rc_j, want), (rc_p, got) = e2e_runs
    assert rc_j == rc_p == 0
    assert got["checks"] == want["checks"]
    assert got["checks"]["dup"]["planted_clustered"] == got["checks"]["dup"]["planted_pairs"] == 3
    assert got["checks"]["indexed"]["embedded_fused"] == got["checks"]["indexed"]["tagged"] == 24
    assert got["checks"]["cached_retag"] == {"cold_tagged": 24, "warm_tagged": 24}


def test_bench_e2e_prints_the_jax_keys(e2e_runs):
    (_, want), (_, got) = e2e_runs
    assert got["metric"] == want["metric"] == "e2e_pipeline_5k"
    assert got["images"] == want["images"] == 24
    # the port's index run also times the embedder's construction
    # (``stage_walls.embed_setup``): every other key is the JAX tool's
    walls = "index_stage_walls"
    assert set(want["phases"][walls]) < set(got["phases"][walls])
    for doc in (got, want):
        doc["phases"].pop(walls)
    assert key_tree(got) == key_tree(want)
    # total_s sums the phases' walls, not the images/s rates
    walls_s = [v for k, v in got["phases"].items() if k.endswith("_s") and not k.endswith("_per_s")]
    assert got["total_s"] == round(sum(walls_s), 1)
