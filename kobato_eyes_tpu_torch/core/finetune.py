"""Fine-tune a tagger on the indexed library's own labels.

Counterpart of ``kobato_eyes_tpu/core/finetune.py``: catalog (files ⋈
file_tags) -> multi-hot targets over the tag vocabulary -> prefetch-loaded
uint8 batches -> the BCE train step (models/train.py) on ``device`` (default
``cuda``; raises without a GPU) -> the port's checkpoint directory
(``models/tagger.save_checkpoint``: ``model.safetensors`` + ``manifest.json``;
orbax needs JAX) beside the ``<out>_config.json`` arch sidecar and the
``<out>_labels.csv`` label table, which ``TorchTagger(checkpoint_path=...,
labels_path=...)`` loads directly.

``_load_training_set`` and ``FinetuneResult`` are the JAX package's, word
for word. The initial weights are the trainer's seeded init
(``models/train._init_model``): the JAX package draws flax's
``init_params(cfg, seed=0)``, which torch cannot reproduce.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from kobato_eyes_tpu_torch.core.pipeline.contracts import FileRecord
from kobato_eyes_tpu_torch.core.pipeline.loaders import PrefetchLoader
from kobato_eyes_tpu_torch.db.connection import bootstrap
from kobato_eyes_tpu_torch.device import resolve_device
from kobato_eyes_tpu_torch.models.base import TagCategory
from kobato_eyes_tpu_torch.models.preprocess import PreprocessSpec, prepare_batch
from kobato_eyes_tpu_torch.models.tagger import save_checkpoint
from kobato_eyes_tpu_torch.models.train import TrainConfig, make_train_step
from kobato_eyes_tpu_torch.models.vit import vit_config

logger = logging.getLogger(__name__)


@dataclass
class FinetuneResult:
    files: int = 0
    labels: int = 0
    steps: int = 0
    epochs: int = 0
    first_loss: float | None = None
    final_loss: float | None = None
    checkpoint: str | None = None
    labels_csv: str | None = None
    elapsed_sec: float = 0.0
    loss_history: list[float] = field(default_factory=list)


def _load_training_set(db_path: str | Path, *, min_tag_count: int, limit: int | None):
    """-> (records, targets (N, V) float32, vocab [(name, category)])."""
    conn = bootstrap(db_path)
    try:
        vocab_rows = conn.execute(
            """
            SELECT t.id, t.name, t.category, COUNT(ft.file_id) AS n
            FROM tags t JOIN file_tags ft ON ft.tag_id = t.id
            GROUP BY t.id HAVING n >= ? ORDER BY t.id
            """,
            (min_tag_count,),
        ).fetchall()
        vocab_ids = np.array([int(r["id"]) for r in vocab_rows], dtype=np.int64)
        vocab = [(r["name"], int(r["category"]), int(r["n"])) for r in vocab_rows]

        limit_sql = "" if limit is None else f"LIMIT {int(limit)}"
        file_rows = conn.execute(
            f"""
            SELECT DISTINCT f.id, f.path, f.size, f.mtime FROM files f
            JOIN file_tags ft ON ft.file_id = f.id
            WHERE f.is_present = 1 ORDER BY f.id {limit_sql}
            """
        ).fetchall()
        file_ids = np.array([int(r["id"]) for r in file_rows], dtype=np.int64)

        # postings restricted to the selected files, fetched as raw tuples
        # (the vectorized pattern from query/engine.py: sqlite3.Row access
        # dominates at multi-million-row scale)
        cur = conn.cursor()
        cur.row_factory = None  # type: ignore[assignment]
        targets = np.zeros((len(file_rows), len(vocab)), dtype=np.float32)
        if not len(vocab_ids):
            file_ids = file_ids[:0]  # nothing trainable; skip the posting scan
        for start in range(0, len(file_ids), 900):
            chunk = file_ids[start : start + 900]
            ph = ",".join("?" * len(chunk))
            rows = cur.execute(
                f"SELECT file_id, tag_id FROM file_tags WHERE file_id IN ({ph})",
                chunk.tolist(),
            ).fetchall()
            if not rows:
                continue
            fid = np.fromiter((r[0] for r in rows), dtype=np.int64, count=len(rows))
            tid = np.fromiter((r[1] for r in rows), dtype=np.int64, count=len(rows))
            fi = np.searchsorted(file_ids, fid)
            ti = np.searchsorted(vocab_ids, tid)
            ok = (fi < len(file_ids)) & (ti < len(vocab_ids))
            ok &= file_ids[np.minimum(fi, len(file_ids) - 1)] == fid
            ok &= vocab_ids[np.minimum(ti, max(len(vocab_ids) - 1, 0))] == tid
            targets[fi[ok], ti[ok]] = 1.0

        records = [
            FileRecord(
                file_id=int(r["id"]), path=Path(r["path"]),
                size=int(r["size"] or 0), mtime=float(r["mtime"] or 0.0),
                needs_tagging=True,
            )
            for r in file_rows
        ]
    finally:
        conn.close()
    return records, targets, vocab


def finetune_from_catalog(
    db_path: str | Path,
    *,
    preset: str = "base",
    image_size: int = 448,
    epochs: int = 1,
    batch_size: int = 16,
    learning_rate: float = 1e-4,
    min_tag_count: int = 1,
    limit: int | None = None,
    io_workers: int = 4,
    checkpoint_out: str | Path | None = None,
    vit_overrides: dict | None = None,
    is_cancelled: Callable[[], bool] | None = None,
    device=None,
) -> FinetuneResult:
    """Train a WD14-convention ViT on the catalog's tags; save a checkpoint."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    cancelled = is_cancelled or (lambda: False)
    records, targets, vocab = _load_training_set(
        db_path, min_tag_count=min_tag_count, limit=limit
    )
    result = FinetuneResult(files=len(records), labels=len(vocab))
    if not records or not vocab:
        logger.warning("finetune: nothing to train on (files=%d labels=%d)",
                       len(records), len(vocab))
        return result

    cfg = vit_config(preset, image_size=image_size, num_classes=len(vocab),
                     **(vit_overrides or {}))
    spec = PreprocessSpec(mode="wd14", size=image_size)
    step, _ = make_train_step(cfg, spec, TrainConfig(learning_rate=learning_rate), device=dev)

    target_of_id = {r.file_id: targets[i] for i, r in enumerate(records)}
    for epoch in range(epochs):
        if cancelled():
            break
        loader = PrefetchLoader(
            list(records),
            prepare=lambda arrs: prepare_batch(arrs, spec),
            batch_size=batch_size,
            io_workers=io_workers,
            is_cancelled=cancelled,
        )
        for batch in loader:
            if cancelled():
                break
            if batch.pixels.shape[0] < 2:
                continue  # skip degenerate batches (batch-size-1 noise)
            y = np.stack([target_of_id[r.file_id] for r in batch.records])
            loss = step(torch.from_numpy(batch.pixels), torch.from_numpy(y))
            loss_f = float(loss)
            result.loss_history.append(loss_f)
            if result.first_loss is None:
                result.first_loss = loss_f
            result.steps += 1
        result.epochs = epoch + 1
        if result.loss_history:
            logger.info("finetune epoch %d: %d steps, loss=%.4f",
                        epoch + 1, result.steps, result.loss_history[-1])
        else:
            logger.warning("finetune epoch %d completed zero steps", epoch + 1)
    result.final_loss = result.loss_history[-1] if result.loss_history else None

    if checkpoint_out is not None and result.steps:
        out = Path(checkpoint_out)
        manifest = {
            "arch": "vit", "preset": preset, "image_size": cfg.image_size,
            "patch_size": cfg.patch_size, "num_classes": cfg.num_classes, "clip_variant": None,
            "source": {"name": f"finetune of {Path(db_path).name}", "sha256": None},
        }
        save_checkpoint(out, step.model.state_dict(), manifest=manifest)
        # architecture sidecar so operators can reconstruct the exact config
        arch_path = out.parent / f"{out.name}_config.json"
        arch = {k: v for k, v in dataclasses.asdict(cfg).items()
                if isinstance(v, (int, float, str, bool))}
        arch_path.write_text(json.dumps({"arch": "vit", **arch}), encoding="utf-8")
        csv_path = out.parent / f"{out.name}_labels.csv"
        with csv_path.open("w", newline="", encoding="utf-8") as fh:
            writer = csv.writer(fh)
            writer.writerow(["name", "category", "count"])
            for name, category, count in vocab:
                try:
                    cat_name: str | int = TagCategory(category).name.lower()
                except ValueError:
                    cat_name = category  # out-of-enum categories round-trip numerically
                writer.writerow([name, cat_name, count])
        result.checkpoint = str(out)
        result.labels_csv = str(csv_path)
    result.elapsed_sec = time.perf_counter() - t0
    return result
