"""The multi-device dry run: every sharded path once, at tiny shapes.

Counterpart of the JAX repository's ``dryrun_multichip`` (``__graft_entry__``):
the same five checks in its order — a data x model train step, the sharded
dup scan, the sharded query engine, sharded flat and IVF search, and the
sharded tagger forward — with its shapes, seeds and assertions, each printing
its ``dryrun_multichip <check> ok: mesh=...`` line. The JAX run re-executes
itself in a subprocess whose platform flags force a virtual CPU mesh; torch
has no such flag to override, so the entries are taken as given: ``devices``
(``["cpu"] * n`` in the tests) or ``n`` entries round robin over the visible
cards (``cuda:0`` ``n`` times on one card). Like every sharded path of this
package it drives one process's entries.
"""

from __future__ import annotations

import tempfile
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from kobato_eyes_tpu_torch.parallel.mesh import make_mesh, visible_devices


def dryrun_multichip(n_devices: int, *, devices: Sequence | None = None) -> float:
    """Run the five checks over ``n_devices`` mesh entries; raises on the
    first that fails. Returns the train step's loss."""
    if devices is None:
        cards = visible_devices()
        devices = [cards[i % len(cards)] for i in range(n_devices)]
    devs = [torch.device(d) for d in devices]
    if len(devs) != n_devices:
        raise ValueError(f"{len(devs)} devices given for a dry run over {n_devices}")
    loss = _dryrun_train_step(devs)
    _dryrun_sharded_scan(devs)
    _dryrun_sharded_query(devs)
    _dryrun_sharded_ann(devs)
    _dryrun_sharded_infer(devs)
    return loss


def _model_par(n_devices: int) -> int:
    return 2 if n_devices % 2 == 0 and n_devices >= 2 else 1


def _dryrun_train_step(devs: list[torch.device]) -> float:
    """One dp x tp sharded train step (``models/train.py``, ``mesh=``) from
    the trainer's seeded init."""
    from kobato_eyes_tpu_torch.models.preprocess import PreprocessSpec
    from kobato_eyes_tpu_torch.models.train import TrainConfig, make_train_step
    from kobato_eyes_tpu_torch.models.vit import vit_config

    n = len(devs)
    model_par = _model_par(n)
    mesh = make_mesh(data=n // model_par, model=model_par, devices=devs)
    n_labels = 256
    cfg = vit_config(
        "tiny", image_size=32, patch_size=16, num_classes=n_labels,
        hidden_dim=128, num_heads=2, mlp_dim=256, depth=2,
    )
    spec = PreprocessSpec(mode="wd14", size=32)
    step, _ = make_train_step(cfg, spec, TrainConfig(), mesh=mesh)

    batch = n * 2
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (batch, 32, 32, 3), dtype=np.uint8))
    labels = torch.from_numpy((rng.uniform(size=(batch, n_labels)) < 0.05).astype(np.float32))
    loss = float(step(images, labels))
    if not np.isfinite(loss):
        raise AssertionError("non-finite loss in multichip dry run")
    print(f"dryrun_multichip train ok: mesh={mesh.shape} loss={loss:.4f}")
    return loss


def _dryrun_sharded_scan(devs: list[torch.device]) -> None:
    """Mesh-sharded dup scan == single-device clusters."""
    from kobato_eyes_tpu_torch.dup.engine import TpuDuplicateScanner, cluster_ids
    from kobato_eyes_tpu_torch.dup.types import DuplicateFileMeta, DuplicateScanConfig

    rng = np.random.default_rng(7)
    n = 600
    n_dups = n // 3
    orig = rng.integers(0, 1 << 64, size=n - n_dups, dtype=np.uint64)
    dups = orig[rng.integers(0, len(orig), size=n_dups)].copy()
    for i in range(n_dups):
        for bit in rng.integers(0, 64, size=int(rng.integers(0, 6))):
            dups[i] ^= np.uint64(1) << np.uint64(bit)
    hashes = np.concatenate([orig, dups])
    rng.shuffle(hashes)
    sizes = rng.integers(10_000, 5_000_000, size=n)
    files = [
        DuplicateFileMeta(
            file_id=i, path=Path(f"/dry/{i:05d}.png"), size=int(sizes[i]),
            width=None, height=None, phash=int(hashes[i]),
        )
        for i in range(n)
    ]

    cfg = DuplicateScanConfig(hamming_threshold=8, size_ratio=0.5)
    mesh = make_mesh(data=len(devs), model=1, devices=devs)
    sharded = TpuDuplicateScanner(cfg, mesh=mesh).build_clusters(files)
    solo = TpuDuplicateScanner(cfg, device=devs[0]).build_clusters(files)
    if cluster_ids(sharded) != cluster_ids(solo):
        raise AssertionError("sharded dup scan diverged from single-chip clusters")
    print(
        f"dryrun_multichip scan ok: mesh=(data={len(devs)}) "
        f"clusters={len(sharded)} identity=single-chip-equal"
    )


def _dryrun_sharded_query(devs: list[torch.device]) -> None:
    """Mesh-sharded query engine == single-device results."""
    from kobato_eyes_tpu_torch.db.connection import bootstrap, reset_bootstrap_cache
    from kobato_eyes_tpu_torch.db.repository import TaggingItem, upsert_file, write_tagging_batch
    from kobato_eyes_tpu_torch.query.engine import build_epoch, search_epoch

    reset_bootstrap_cache()
    rng = np.random.default_rng(13)
    tags = [("1girl", 0), ("solo", 0), ("smile", 0), ("chara", 4), ("work", 3)]
    with tempfile.TemporaryDirectory() as td:
        conn = bootstrap(Path(td) / "dry.sqlite")
        try:
            items = []
            for i in range(200):
                fid = upsert_file(conn, path=f"/dry/q_{i:04d}.png", size=100 + i, mtime=1e9 + i)
                picks = rng.choice(len(tags), size=int(rng.integers(0, 4)), replace=False)
                items.append(TaggingItem(
                    file_id=fid,
                    tags=[(tags[p][0], float(rng.uniform(0.05, 1.0)), tags[p][1]) for p in picks],
                    tagger_sig="t",
                ))
            write_tagging_batch(conn, items)
            epoch = build_epoch(conn, device=devs[0])
        finally:
            conn.close()
    mesh = make_mesh(data=len(devs), model=1, devices=devs)
    n_checked = 0
    for q in ("1girl solo", "1girl OR chara", "-( smile ) score>=0.3", "category:character"):
        solo = search_epoch(epoch, q, limit=100)
        sharded = search_epoch(epoch, q, limit=100, mesh=mesh)
        if [(r.file_id, r.relevance) for r in solo] != [(r.file_id, r.relevance) for r in sharded]:
            raise AssertionError(f"sharded query diverged from single-chip: {q!r}")
        n_checked += len(solo)
    print(
        f"dryrun_multichip query ok: mesh=(data={len(devs)}) "
        f"4 queries / {n_checked} rows identity=single-chip-equal"
    )


def _dryrun_sharded_ann(devs: list[torch.device]) -> None:
    """Mesh-sharded flat and IVF search == single-device top-k ids."""
    from kobato_eyes_tpu_torch.index.flat import FlatIndex
    from kobato_eyes_tpu_torch.index.ivf import IvfFlatIndex, kmeans

    rng = np.random.default_rng(17)
    corpus = rng.standard_normal((500, 32)).astype(np.float32)
    queries = rng.standard_normal((6, 32)).astype(np.float32)
    mesh = make_mesh(data=len(devs), model=1, devices=devs)

    _, flat_solo = FlatIndex(corpus, device=devs[0]).search(queries, k=12)
    _, flat_mesh = FlatIndex(corpus, mesh=mesh).search(queries, k=12)
    if not np.array_equal(flat_solo, flat_mesh):
        raise AssertionError("sharded flat ANN diverged from single-chip ids")

    unit = corpus / np.maximum(np.linalg.norm(corpus, axis=1, keepdims=True), 1e-30)
    quant = kmeans(unit, 16, iters=4, seed=0, device=devs[0])
    _, ivf_solo = IvfFlatIndex(corpus, n_clusters=16, quantizer=quant, device=devs[0]).search(
        queries, k=12, nprobe=4
    )
    _, ivf_mesh = IvfFlatIndex(corpus, n_clusters=16, quantizer=quant, mesh=mesh).search(
        queries, k=12, nprobe=4
    )
    if not np.array_equal(ivf_solo, ivf_mesh):
        raise AssertionError("sharded IVF ANN diverged from single-chip ids")
    print(
        f"dryrun_multichip ann ok: mesh=(data={len(devs)}) "
        f"flat+ivf top-12 identity=single-chip-equal"
    )


def _dryrun_sharded_infer(devs: list[torch.device]) -> None:
    """Mesh-sharded (dp x tp) tagger probabilities against one device's, in
    the exact forward (``fast_math=False``), which the JAX dry run's CPU
    subprocess runs: the tiny preset's heads are 48 wide, which the
    attention kernel does not take (``ops/attention.py``: 32 or 64)."""
    from kobato_eyes_tpu_torch.models.labels import synthetic_labels
    from kobato_eyes_tpu_torch.models.tagger import WD14Tagger
    from kobato_eyes_tpu_torch.models.vit import vit_config

    rng = np.random.default_rng(23)
    imgs = [rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8) for _ in range(8)]

    def tagger(mesh=None):
        return WD14Tagger(
            labels=synthetic_labels(160),
            # 4 heads so the tensor-parallel axis (model=2) divides evenly
            vit=vit_config("tiny", image_size=64, patch_size=16, num_classes=160, num_heads=4),
            image_size=64, seed=0, mesh=mesh, device=None if mesh is not None else devs[0], fast_math=False,
        )

    n = len(devs)
    model_par = _model_par(n)
    mesh = make_mesh(data=n // model_par, model=model_par, devices=devs)
    single = tagger()
    sharded = tagger(mesh=mesh)
    batch = single.prepare_batch_from_rgb(imgs)
    pa = single.forward_probs(batch)
    pb = sharded.forward_probs(batch)
    if not bool(torch.isfinite(pb).all()):
        raise AssertionError("sharded tagger forward produced non-finite probs")
    dev = float((pa.to(pb.device) - pb).abs().max())
    # the tensor-parallel sums run in another order than one device's:
    # identity here means the probability surface, not bit equality
    if dev > 3e-2:
        raise AssertionError(f"sharded tagger probs diverged from single-chip: max dev {dev:.4f}")
    results = sharded.infer_batch(imgs)  # the full select machinery over the mesh
    if len(results) != len(imgs):
        raise AssertionError("sharded tagger select dropped images")
    print(
        f"dryrun_multichip infer ok: mesh=(data={n // model_par},"
        f"model={model_par}) batch=8 max_prob_dev={dev:.4f} "
        "identity=single-chip-equal"
    )
