"""The port's multi-device dup engine: a mesh-sharded scan gives the
single-device and the reference clusters (``tests/parallel/
test_sharded_engine.py``, case for case, on 8 ``cpu`` mesh entries), and
the JAX package's sharded engine's clusters. Cluster identity is exact."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from kobato_eyes_tpu.dup.engine import TpuDuplicateScanner as JScanner
from kobato_eyes_tpu.dup.types import DuplicateFileMeta as JMeta
from kobato_eyes_tpu.dup.types import DuplicateScanConfig as JConfig
from kobato_eyes_tpu.parallel.mesh import make_mesh as jmake_mesh
from kobato_eyes_tpu_torch.dup.cpu_ref import CpuDuplicateScanner
from kobato_eyes_tpu_torch.dup.engine import TpuDuplicateScanner, cluster_ids
from kobato_eyes_tpu_torch.dup.types import DuplicateFileMeta, DuplicateScanConfig
from kobato_eyes_tpu_torch.parallel.mesh import make_mesh
from tests.test_torch_dup import _cli_env, _summary_lines, dup_library  # noqa: F401  (fixture)
from tests.torch_native import native_built  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

MESH = dict(data=8, model=1)


def _hashes(rng, n):
    n_dups = n // 3
    orig = rng.integers(0, 1 << 64, size=n - n_dups, dtype=np.uint64)
    dups = orig[rng.integers(0, len(orig), size=n_dups)].copy()
    for i in range(n_dups):
        for bit in rng.integers(0, 64, size=int(rng.integers(0, 6))):
            dups[i] ^= np.uint64(1) << np.uint64(bit)
    h = np.concatenate([orig, dups])
    rng.shuffle(h)
    return h, rng.integers(10_000, 5_000_000, size=n)


def _files(h, sizes, cls=DuplicateFileMeta):
    return [cls(file_id=i, path=Path(f"/m/{i:05d}.png"), size=int(sizes[i]), width=None, height=None,
                phash=int(h[i])) for i in range(len(h))]


def _jax_ids(h, sizes, cfg_kw, **scanner_kw):
    clusters = JScanner(JConfig(**cfg_kw), mesh=jmake_mesh(**MESH), **scanner_kw).build_clusters(
        _files(h, sizes, JMeta))
    return _ids(clusters)


def _ids(clusters):
    """(keeper, ordered members) of every cluster, as ``cluster_ids`` gives them."""
    return [(c.keeper_id, [e.file.file_id for e in c.files]) for c in clusters]


def test_mesh_scanner_cluster_identity():
    h, sizes = _hashes(np.random.default_rng(17), 900)
    files = _files(h, sizes)
    cfg_kw = dict(hamming_threshold=8, size_ratio=0.5)
    cfg = DuplicateScanConfig(**cfg_kw)
    sharded = TpuDuplicateScanner(cfg, mesh=make_mesh(**MESH, devices=["cpu"] * 8)).build_clusters(files)
    solo = TpuDuplicateScanner(cfg, device="cpu").build_clusters(files)
    cpu = CpuDuplicateScanner(cfg).build_clusters(files)
    assert cluster_ids(sharded) == cluster_ids(solo) == cluster_ids(cpu)
    assert _ids(sharded) == _jax_ids(h, sizes, cfg_kw)


def test_mesh_scanner_with_pair_cap():
    h, sizes = _hashes(np.random.default_rng(23), 600)
    # a dense bucket: many copies of one hash exercise the cap mask + the
    # overflow-retry loop (tiny starting cap)
    h[:80] = h[0]
    files = _files(h, sizes)
    cfg_kw = dict(hamming_threshold=6, bucket_pair_cap=500)
    sharded = TpuDuplicateScanner(DuplicateScanConfig(**cfg_kw), mesh=make_mesh(**MESH, devices=["cpu"] * 8))
    sharded._scanner.max_edges_hint = 1 << 8  # force at least one retry
    a = sharded.build_clusters(files)
    b = TpuDuplicateScanner(DuplicateScanConfig(**cfg_kw), device="cpu").build_clusters(files)
    assert cluster_ids(a) == cluster_ids(b)
    assert _ids(a) == _jax_ids(h, sizes, cfg_kw)


def test_mesh_scanner_oversized_run_falls_back(caplog):
    """A bucket run beyond max_window must not blow up the sharded compare's
    (bands, window, rows/shard) intermediates — the scan falls back to the
    single-device path (on the mesh's first entry) and keeps cluster
    identity."""
    h, sizes = _hashes(np.random.default_rng(31), 500)
    h[:120] = h[0]  # run of 120 identical hashes
    files = _files(h, sizes)
    cfg = DuplicateScanConfig(hamming_threshold=4)
    sharded = TpuDuplicateScanner(cfg, mesh=make_mesh(**MESH, devices=["cpu"] * 8))
    sharded._scanner.max_window = 64  # force run > max_window
    with caplog.at_level("INFO", logger="kobato_eyes_tpu_torch.ops.hamming"):
        a = sharded.build_clusters(files)
    assert any("falling back to the single-device path" in r.message for r in caplog.records)
    b = TpuDuplicateScanner(cfg, device="cpu").build_clusters(files)
    assert cluster_ids(a) == cluster_ids(b)


def test_cli_dup_reads_settings_mesh(dup_library, tmp_path, capsys, monkeypatch):
    """``ket dup`` shards over ``settings.mesh`` when more than one device of
    ``--device``'s kind is visible, printing the JAX CLI's line: here 8 CPU
    entries stand in for 8 cards, as the JAX CLI's 8 virtual devices do."""
    from kobato_eyes_tpu import cli as jcli
    from kobato_eyes_tpu.db.connection import reset_bootstrap_cache as jreset
    from kobato_eyes_tpu_torch import cli as tcli
    from kobato_eyes_tpu_torch.db.connection import reset_bootstrap_cache as treset
    from kobato_eyes_tpu_torch.parallel import mesh as pmesh

    monkeypatch.setattr(pmesh, "visible_devices", lambda kind="cuda": [torch.device(kind)] * 8)
    jreset()
    treset()
    jbase = _cli_env(tmp_path, dup_library, "jax", True)
    tbase = ["--device", "cpu", *_cli_env(tmp_path, dup_library, "torch", True)]
    assert jcli.main([*jbase, "index"]) == 0
    assert tcli.main([*tbase, "index"]) == 0
    capsys.readouterr()
    assert jcli.main([*jbase, "dup", "--sweep"]) == 0
    jout = capsys.readouterr()
    assert tcli.main([*tbase, "dup", "--sweep"]) == 0
    tout = capsys.readouterr()
    line = "dup scan sharded over OrderedDict({'data': 8, 'model': 1}) mesh"
    assert line in jout.err.splitlines() and line in tout.err.splitlines()
    assert tout.out == jout.out and tout.out.strip()
    assert _summary_lines(tout.err) == _summary_lines(jout.err)
