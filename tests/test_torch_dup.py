"""The port's duplicate path against the JAX package's.

* the scan engine: ``cluster_ids`` (keepers, member order, best Hamming) of
  ``TpuDuplicateScanner`` and its threshold sweep equal the JAX engine's, on
  the host route and on the resident route, and the port's own
  ``CpuDuplicateScanner`` oracle;
* the cohesion audit: ``audit_clusters`` through batch packing, batch
  splits and the row-stripe path equals the JAX audit (Pallas in interpret
  mode) and the numpy spec;
* refinement: tile-aHash words and MAE sums equal the JAX functions and the
  specs; ``refine_by_tilehash`` / ``refine_by_pixels`` decisions equal;
* the CLI: ``index`` then ``dup --sweep --refine --audit`` through the
  port's CLI on the CPU print the same clusters, sweep counts and audit
  summary as the JAX CLI on the same library; ``--export`` writes the same
  rows; ``--trash-duplicates`` moves the non-keepers.

JAX interpret-mode audits stay at a few hundred hashes.
"""

from __future__ import annotations

import csv
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from kobato_eyes_tpu import cli as jcli
from kobato_eyes_tpu.db.connection import reset_bootstrap_cache as jreset
from kobato_eyes_tpu.dup import audit as jaudit
from kobato_eyes_tpu.dup import engine as jengine
from kobato_eyes_tpu.dup import refine_clusters as jrefine
from kobato_eyes_tpu.dup import types as jtypes
from kobato_eyes_tpu.ops import mae as jmae
from kobato_eyes_tpu.ops import tile_hash as jtile
from kobato_eyes_tpu_torch import cli as tcli
from kobato_eyes_tpu_torch.db.connection import reset_bootstrap_cache as treset
from kobato_eyes_tpu_torch.dup import audit as taudit
from kobato_eyes_tpu_torch.dup import cpu_ref as tcpu
from kobato_eyes_tpu_torch.dup import engine as tengine
from kobato_eyes_tpu_torch.dup import refine_clusters as trefine
from kobato_eyes_tpu_torch.dup import types as ttypes
from kobato_eyes_tpu_torch.ops import mae as tmae
from kobato_eyes_tpu_torch.ops import pairwise_hamming as tpw
from kobato_eyes_tpu_torch.ops import tile_hash as ttile
from tests.torch_native import native_built  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# scan engine
# ---------------------------------------------------------------------------


def _population(seed: int, n: int, groups: int, *, group_size: int = 3, flip_bits: int = 4):
    """(hashes, sizes, widths, heights): random 64-bit hashes with planted
    near-duplicate groups (0..flip_bits bits flipped)."""
    rng = np.random.default_rng(seed)
    hashes = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    for g in range(groups):
        base = int(hashes[g * group_size])
        for k in range(1, group_size):
            h = base
            for bit in rng.choice(64, size=rng.integers(0, flip_bits + 1), replace=False):
                h ^= 1 << int(bit)
            hashes[g * group_size + k] = h
    sizes = rng.integers(1_000, 5_000_000, size=n)
    dims = rng.integers(100, 4000, size=(n, 2))
    return hashes, sizes, dims


def _metas(types, pop):
    hashes, sizes, dims = pop
    exts = [".png", ".jpg", ".webp", ".gif", ".bmp"]
    return [
        types.DuplicateFileMeta(
            file_id=1000 + i, path=Path(f"/data/set{i % 7}/img_{i:05d}{exts[i % 5]}"),
            size=int(sizes[i]), width=int(dims[i, 0]), height=int(dims[i, 1]),
            phash=int(hashes[i]),
        )
        for i in range(len(hashes))
    ]


def _full_ids(clusters):
    """cluster_ids plus each entry's best Hamming."""
    return [(c.keeper_id, [(e.file.file_id, e.best_hamming) for e in c.files]) for c in clusters]


CONFIGS = {
    "default": dict(),
    "size_ratio": dict(size_ratio=0.4),
    "pair_cap": dict(bucket_pair_cap=3),
    "bands_8x8": dict(band_bits=8, band_count=8, hamming_threshold=6),
}


@pytest.mark.parametrize("route", ["host", "device"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_engine_clusters_equal_jax(config, route):
    pop = _population(1, 600, 80)
    kw = CONFIGS[config]
    host_scan_max = None if route == "host" else 0
    got = tengine.TpuDuplicateScanner(
        ttypes.DuplicateScanConfig(**kw), host_scan_max=host_scan_max, device="cpu"
    ).build_clusters(_metas(ttypes, pop))
    want = jengine.TpuDuplicateScanner(
        jtypes.DuplicateScanConfig(**kw), host_scan_max=host_scan_max
    ).build_clusters(_metas(jtypes, pop))
    assert len(got) > 10
    assert _full_ids(got) == _full_ids(want)
    assert tengine.cluster_ids(got) == tengine.cluster_ids(
        tcpu.CpuDuplicateScanner(ttypes.DuplicateScanConfig(**kw)).build_clusters(_metas(ttypes, pop))
    )


def test_sweep_equals_jax_and_rescans():
    pop = _population(2, 500, 70, flip_bits=8)
    files = _metas(ttypes, pop)
    port = tengine.TpuDuplicateScanner(host_scan_max=0, device="cpu")
    sweep = port.build_clusters_sweep(files, range(0, 9), files_token="v1")
    jsweep = jengine.TpuDuplicateScanner(host_scan_max=0).build_clusters_sweep(
        _metas(jtypes, pop), range(0, 9))
    host = tengine.TpuDuplicateScanner(device="cpu").build_clusters_sweep(files, range(0, 9))
    assert sorted(sweep) == list(range(9))
    for t in range(9):
        assert _full_ids(sweep[t]) == _full_ids(jsweep[t]) == _full_ids(host[t])
        single = tengine.TpuDuplicateScanner(
            ttypes.DuplicateScanConfig(hamming_threshold=t), host_scan_max=0, device="cpu"
        ).build_clusters(files)
        assert _full_ids(single) == _full_ids(sweep[t])
    # the snapshot caches: same token, same clusters
    again = port.build_clusters(files, files_token="v1")
    assert tengine.cluster_ids(again) == tengine.cluster_ids(sweep[8])


# ---------------------------------------------------------------------------
# cohesion audit
# ---------------------------------------------------------------------------


def _clusters(types, seed: int, sizes: list[int]):
    rng = np.random.default_rng(seed)
    out, fid = [], 0
    for size in sizes:
        base = int(rng.integers(0, 1 << 64, dtype=np.uint64))
        entries = []
        for k in range(size):
            h = base
            for bit in rng.integers(0, 64, size=int(rng.integers(0, 5))):
                h ^= 1 << int(bit)
            meta = types.DuplicateFileMeta(file_id=fid + k, path=Path(f"/a/{fid + k}.png"),
                                           size=1000, width=None, height=None, phash=h)
            entries.append(types.DuplicateClusterEntry(file=meta, best_hamming=None))
        out.append(types.DuplicateCluster(files=entries, keeper_id=fid + int(rng.integers(size))))
        fid += size
    return out


AUDITS = {
    "one_batch": ([2, 3, 7, 2, 12, 5], 4096),
    "batch_splits": ([30, 30, 30, 30, 30], 64),
    "stripes": ([5, 300, 4], 128),
}


@pytest.mark.parametrize("case", list(AUDITS))
def test_audit_equals_jax_and_spec(case):
    sizes, batch = AUDITS[case]
    launches = tpw.launches
    got = taudit.audit_clusters(_clusters(ttypes, 11, sizes), batch_hashes=batch, device="cpu")
    assert tpw.launches == launches  # the CPU takes the plain version
    want = jaudit.audit_clusters(_clusters(jtypes, 11, sizes), batch_hashes=batch)
    spec = taudit.audit_clusters_np(_clusters(ttypes, 11, sizes))
    as_tuples = lambda stats: [(s.keeper_id, s.size, s.diameter, s.mean_distance, s.keeper_max)  # noqa: E731
                               for s in stats]
    assert as_tuples(got) == as_tuples(want) == as_tuples(spec)
    assert taudit.summarize(got) == jaudit.summarize(want)


# ---------------------------------------------------------------------------
# refinement
# ---------------------------------------------------------------------------


def test_tile_ahash_words_equal_jax_and_spec():
    rng = np.random.default_rng(5)
    gray = rng.integers(0, 256, size=(40, 64, 64), dtype=np.uint8)
    gray[0] = 128  # flat: no pixel above its tile mean
    gray[1, :8, :8] = np.arange(64).reshape(8, 8)  # strict > at the boundary
    got = ttile.tile_ahash_batch(gray, grid=8, tile=8, device="cpu")
    assert got.dtype == np.uint32 and got.shape == (40, 128)
    np.testing.assert_array_equal(got, np.asarray(jtile.tile_ahash_batch(gray, grid=8, tile=8)))
    for row, g in zip(got, gray):
        assert ttile.words_to_int(row) == ttile.tile_ahash_np(g, 8, 8)
    got4 = ttile.tile_ahash_batch(gray[:, :16, :16], grid=4, tile=4, device="cpu")
    np.testing.assert_array_equal(got4, np.asarray(jtile.tile_ahash_batch(gray[:, :16, :16], grid=4, tile=4)))
    np.testing.assert_array_equal(ttile.tile_hamming_words(got[:5], got[5:10]),
                                  jtile.tile_hamming_words(got[:5], got[5:10]))


def test_mae_sums_equal_jax_and_spec():
    rng = np.random.default_rng(6)
    a = rng.integers(0, 256, size=(12, 128, 128), dtype=np.uint8)
    b = rng.integers(0, 256, size=(12, 128, 128), dtype=np.uint8)
    b[0] = a[0]
    a[1], b[1] = 255, 0  # the largest sum: 255 * 128 * 128
    got = tmae.abs_diff_sums(a, b, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(jmae.abs_diff_sums(a, b)))
    assert got[0] == 0 and got[1] == 255 * 128 * 128
    maes = (got.astype(np.float64) / (128 * 128)) / 255.0  # refine_by_pixels' normalisation
    np.testing.assert_array_equal(maes, jmae.mae01_batch(a, b))
    assert [float(m) for m in maes] == [tmae.mae01_np(x, y) for x, y in zip(a, b)]


def _smooth(rng, h=96, w=96) -> np.ndarray:
    small = rng.integers(0, 256, size=(6, 6, 3), dtype=np.uint8)
    return np.asarray(Image.fromarray(small).resize((w, h), Image.Resampling.BICUBIC))


@pytest.fixture(scope="module")
def refine_library(tmp_path_factory):
    """Three clusters of files: a base, a JPEG re-encode, a brightened copy
    and an unrelated image; the third cluster's keeper does not decode."""
    root = tmp_path_factory.mktemp("refine")
    rng = np.random.default_rng(7)
    groups = []
    for g in range(3):
        base = _smooth(rng)
        paths = [root / f"g{g}_base.png", root / f"g{g}_jpeg.jpg", root / f"g{g}_bright.png",
                 root / f"g{g}_other.png"]
        Image.fromarray(base).save(paths[0])
        Image.fromarray(base).save(paths[1], quality=85)
        Image.fromarray(np.clip(base.astype(np.int16) + 3 * (g + 1), 0, 255).astype(np.uint8)).save(paths[2])
        Image.fromarray(_smooth(rng)).save(paths[3])
        groups.append(paths)
    groups[2][0].write_bytes(b"not an image")
    return groups


def _refine_clusters(types, groups):
    out, fid = [], 0
    for paths in groups:
        entries = [types.DuplicateClusterEntry(
            file=types.DuplicateFileMeta(file_id=fid + k, path=p, size=p.stat().st_size,
                                         width=None, height=None, phash=0),
            best_hamming=k) for k, p in enumerate(paths)]
        out.append(types.DuplicateCluster(files=tuple(entries), keeper_id=fid))
        fid += len(paths)
    return out


@pytest.mark.parametrize("max_bits", [0, 8, 40])
def test_refine_by_tilehash_decisions_equal_jax(refine_library, max_bits):
    got = trefine.refine_by_tilehash(_refine_clusters(ttypes, refine_library), max_bits=max_bits,
                                     io_workers=2, device="cpu")
    want = jrefine.refine_by_tilehash(_refine_clusters(jtypes, refine_library), max_bits=max_bits,
                                      io_workers=2)
    assert tengine.cluster_ids(got) == jengine.cluster_ids(want)


@pytest.mark.parametrize("mae_thr", [0.0, 0.006, 0.02, 0.2])
def test_refine_by_pixels_decisions_equal_jax(refine_library, mae_thr):
    got = trefine.refine_by_pixels(_refine_clusters(ttypes, refine_library), mae_thr=mae_thr,
                                   io_workers=2, device="cpu")
    want = jrefine.refine_by_pixels(_refine_clusters(jtypes, refine_library), mae_thr=mae_thr,
                                    io_workers=2)
    assert tengine.cluster_ids(got) == jengine.cluster_ids(want)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dup_library(tmp_path_factory):
    """10 smooth base images, JPEG q=85 re-encodes of 4, 0.9x resizes of 2,
    and 2 noise images."""
    root = tmp_path_factory.mktemp("dup_library")
    rng = np.random.default_rng(8)
    for i in range(10):
        w, h = (int(x) for x in rng.integers(80, 220, size=2))
        img = Image.fromarray(_smooth(rng, h, w))
        img.save(root / f"base_{i:02d}.png")
        if i < 4:
            img.save(root / f"base_{i:02d}_q85.jpg", quality=85)
        if i < 2:
            img.resize((int(w * 0.9), int(h * 0.9)), Image.Resampling.LANCZOS).save(root / f"base_{i:02d}_small.png")
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)).save(root / f"noise_{i}.png")
    return root


def _cli_env(tmp_path, library, name, inline):
    cfg = tmp_path / f"{name}.yaml"
    cfg.write_text(
        "pipeline:\n"
        f"  roots: [{library}]\n"
        "  batch_size: 4\n"
        "  io_workers: 2\n"
        f"  inline_signatures: {'true' if inline else 'false'}\n"
        "tagger:\n"
        "  name: dummy\n"
        "refine:\n"  # loose enough that re-encodes survive both passes
        "  max_bits: 128\n"
        "  mae_threshold: 0.03\n"
    )
    return ["--config", str(cfg), "--data-dir", str(tmp_path / f"data_{name}")]


def _summary_lines(err: str) -> list[str]:
    keep = ("hamming<=", "audit:", "diameter:", "  loose:", "computing ")
    return [line for line in err.splitlines() if line.startswith(keep) or line.endswith(" clusters")]


@pytest.mark.parametrize("inline", [True, False], ids=["fused", "standalone"])
def test_cli_dup_sweep_refine_audit_equals_jax(dup_library, tmp_path, capsys, inline):
    jreset()
    treset()
    jbase = _cli_env(tmp_path, dup_library, "jax", inline)
    tbase = ["--device", "cpu", *_cli_env(tmp_path, dup_library, "torch", inline)]
    args = ["dup", "--sweep", "--refine", "--audit"]
    assert jcli.main([*jbase, "index"]) == 0
    capsys.readouterr()
    assert jcli.main([*jbase, *args]) == 0
    jout = capsys.readouterr()
    assert tcli.main([*tbase, "index"]) == 0
    tidx = capsys.readouterr()
    assert tcli.main([*tbase, *args]) == 0
    tout = capsys.readouterr()
    stats = json.loads(tidx.out.strip().splitlines()[-1])
    assert stats["extra"]["signatures_fused"] == (stats["tagged"] if inline else 0)
    assert tout.out == jout.out
    assert tout.out.strip()  # at least one cluster survives refinement
    assert _summary_lines(tout.err) == _summary_lines(jout.err)
    assert ("computing 18 missing signatures..." in tout.err) == (not inline)
    assert any(line.startswith("audit:") for line in tout.err.splitlines())


def test_cli_dup_export_and_trash(dup_library, tmp_path, capsys):
    jreset()
    treset()
    library = tmp_path / "library"
    shutil.copytree(dup_library, library)
    jbase = _cli_env(tmp_path, dup_library, "jax", True)
    tbase = ["--device", "cpu", *_cli_env(tmp_path, library, "torch", True)]
    assert jcli.main([*jbase, "index"]) == 0
    assert tcli.main([*tbase, "index"]) == 0
    assert jcli.main([*jbase, "dup", "--export", str(tmp_path / "jax.csv")]) == 0
    assert tcli.main([*tbase, "dup", "--export", str(tmp_path / "torch.csv")]) == 0
    capsys.readouterr()

    def rows(p):
        with open(p, newline="", encoding="utf-8") as fh:
            return [r[:4] + [Path(r[4]).name] for r in csv.reader(fh)]

    got = rows(tmp_path / "torch.csv")
    assert got == rows(tmp_path / "jax.csv") and len(got) > 3
    non_keepers = [library / r[4] for r in got[1:] if r[2] == "0"]
    assert tcli.main([*tbase, "dup", "--trash-duplicates"]) == 0
    assert f"trashed {len(non_keepers)} duplicates" in capsys.readouterr().err
    assert non_keepers and not any(p.exists() for p in non_keepers)
    assert tcli.main([*tbase, "dup"]) == 0
    assert "0 clusters" in capsys.readouterr().err
