"""Embed stage: CLIP-style vectors for ANN, computed during indexing.

Activates the reference's dormant vector path (``src/index/`` stub) as a
first-class pipeline stage: new/changed files get an embedding in the same
pass that tags them, stored in the catalog's ``embeddings`` table; the ANN
index (``index/hnsw.py`` / ``index/ivf.py``) builds from those vectors
without re-decoding the library.
"""

from __future__ import annotations

import logging
import sqlite3
import time
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from kobato_eyes_tpu_torch.core.pipeline.contracts import FileRecord
from kobato_eyes_tpu_torch.db.repository import upsert_embeddings
from kobato_eyes_tpu_torch.core.pipeline.loaders import PrefetchLoader
from kobato_eyes_tpu_torch.core.progress import IndexPhase, IndexProgress, ProgressEmitter

logger = logging.getLogger(__name__)

EMBED_MODEL_NAME = "clip-vit"  # catalog key (embeddings.model column)


@dataclass
class EmbedStageResult:
    embedded: int = 0
    failed: int = 0
    elapsed_sec: float = 0.0


def store_embeddings(
    conn: sqlite3.Connection,
    rows: Sequence[tuple[int, np.ndarray]],
    *,
    model: str = EMBED_MODEL_NAME,
) -> None:
    upsert_embeddings(conn, rows, model=model)


def load_embeddings(
    conn: sqlite3.Connection, *, model: str = EMBED_MODEL_NAME
) -> tuple[np.ndarray, np.ndarray]:
    """-> (file_ids (N,), vectors (N, D)) for present files."""
    rows = conn.execute(
        """
        SELECT e.file_id, e.dim, e.vector FROM embeddings e
        JOIN files f ON f.id = e.file_id
        WHERE e.model = ? AND f.is_present = 1 ORDER BY e.file_id
        """,
        (model,),
    ).fetchall()
    if not rows:
        return np.empty(0, np.int64), np.empty((0, 0), np.float32)
    # rows may mix dimensions after an embed_dim config change: keep the
    # majority dim, skip the rest with a warning (never crash or truncate)
    dims = np.fromiter((r[1] for r in rows), dtype=np.int64, count=len(rows))
    uniq, counts = np.unique(dims, return_counts=True)
    dim = int(uniq[np.argmax(counts)])
    if len(uniq) > 1:
        skipped = int((dims != dim).sum())
        logger.warning(
            "embeddings table mixes dims %s; keeping dim=%d, skipping %d rows "
            "(re-index with index.enabled to refresh them)",
            uniq.tolist(), dim, skipped,
        )
    kept = [r for r, d in zip(rows, dims) if d == dim]
    ids = np.fromiter((r[0] for r in kept), dtype=np.int64, count=len(kept))
    vecs = np.stack([np.frombuffer(r[2], dtype=np.float32, count=dim) for r in kept])
    return ids, vecs


def load_embedding(
    conn: sqlite3.Connection, file_id: int, *, model: str = EMBED_MODEL_NAME
) -> np.ndarray | None:
    """One file's stored vector (point query — find-similar surfaces use
    this instead of retaining a host copy of the whole corpus)."""
    row = conn.execute(
        "SELECT dim, vector FROM embeddings WHERE model = ? AND file_id = ?",
        (model, int(file_id)),
    ).fetchone()
    if row is None:
        return None
    return np.frombuffer(row[1], dtype=np.float32, count=int(row[0]))


def missing_embedding_records(
    conn: sqlite3.Connection,
    records: Sequence[FileRecord],
    *,
    model: str = EMBED_MODEL_NAME,
    expected_dim: int | None = None,
) -> list[FileRecord]:
    """Records needing a vector: no row yet, the file's bytes changed (stale
    vectors would silently poison ANN results forever), or the stored row has
    a different dimensionality than the configured embedder (embed_dim config
    changes re-embed the library instead of stranding mixed dims). Records
    whose vector was already stored THIS run by the fused tag+embed path
    (``FileRecord.embedded``) are excluded — their stored row is fresh even
    though the file's content changed."""
    ids = [r.file_id for r in records]
    have: set[int] = set()
    for start in range(0, len(ids), 900):
        chunk = ids[start : start + 900]
        ph = ",".join("?" * len(chunk))
        rows = conn.execute(
            f"SELECT file_id, dim FROM embeddings WHERE model = ? AND file_id IN ({ph})",
            [model, *chunk],
        ).fetchall()
        have.update(
            int(r[0]) for r in rows
            if expected_dim is None or int(r[1]) == expected_dim
        )
    return [
        r for r in records
        if not r.embedded and (r.file_id not in have or r.content_changed)
    ]


class EmbedStage:
    """Prefetch-loaded batches through the image embedder into the catalog."""

    def __init__(
        self,
        embedder,  # index.embedder.ImageEmbedder
        *,
        batch_size: int = 32,
        io_workers: int = 8,
        model: str | None = None,
        is_cancelled: Callable[[], bool] | None = None,
    ) -> None:
        self._embedder = embedder
        self._batch_size = batch_size
        self._io_workers = io_workers
        self._model = model or getattr(embedder, "model_key", EMBED_MODEL_NAME)
        self._is_cancelled = is_cancelled or (lambda: False)

    def run(
        self,
        conn: sqlite3.Connection,
        records: Sequence[FileRecord],
        progress: ProgressEmitter,
    ) -> EmbedStageResult:
        t0 = time.perf_counter()
        todo = missing_embedding_records(
            conn, list(records), model=self._model,
            expected_dim=getattr(self._embedder, "embed_dim", None),
        )
        result = EmbedStageResult()
        if not todo:
            return result
        progress.phase(IndexPhase.PREPARE, 0, len(todo), "embedding")
        loader = PrefetchLoader(
            todo,
            prepare=self._embedder.prepare_batch_from_rgb,
            batch_size=self._batch_size,
            io_workers=self._io_workers,
            is_cancelled=self._is_cancelled,
        )
        done = 0
        for batch in loader:
            if self._is_cancelled():
                break
            vectors = self._embedder.embed_batch_prepared(batch.pixels)
            with conn:
                store_embeddings(
                    conn,
                    [(r.file_id, v) for r, v in zip(batch.records, vectors)],
                    model=self._model,
                )
            result.embedded += len(batch.records)
            done += len(batch.records)
            progress.emit(IndexProgress(IndexPhase.PREPARE, done, len(todo), "embedding"))
        result.failed = sum(1 for r in todo if r.failed)
        result.elapsed_sec = time.perf_counter() - t0
        logger.info(
            "embed: %d embedded, %d failed in %.2fs",
            result.embedded, result.failed, result.elapsed_sec,
        )
        return result
