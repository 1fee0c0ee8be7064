"""Scale-aware ANN index selection.

Counterpart of ``kobato_eyes_tpu/index/auto.py``, with the same routing and
the same files on disk, so a graph or ``.npz`` saved by either package loads
in the other. The native HNSW graph build is host pointer-chasing and stops
being interactive past ~300k vectors; the device indexes (``FlatIndex`` /
``IvfFlatIndex``) build in seconds at 1M x 512 because construction is
matmuls and k-means on the device. So the build routes by corpus size:

- ``n <= hnsw_max`` (default 300k, env ``KET_ANN_HNSW_MAX``): HNSW, whose
  graph persists to disk;
- ``n > hnsw_max``: IVF-flat on the device (exact flat below ``flat_min``).

All three classes share the ``search(queries, k) -> (scores, ids)``
surface, so callers (cli ``ket ann``) don't branch. ``device`` places the
device indexes (default ``cuda``); HNSW runs on the host.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger(__name__)

DEFAULT_HNSW_MAX = 300_000  # the host graph build's interactive cap
DEFAULT_FLAT_MIN = 65_536  # below this exact flat beats IVF's probe overhead


def hnsw_max_vectors() -> int:
    raw = os.environ.get("KET_ANN_HNSW_MAX", "")
    try:
        return int(raw) if raw else DEFAULT_HNSW_MAX
    except ValueError:
        logger.warning("KET_ANN_HNSW_MAX=%r not an int; using default", raw)
        return DEFAULT_HNSW_MAX


def build_auto_index(
    vectors: np.ndarray,
    ids: np.ndarray | None = None,
    *,
    hnsw_max: int | None = None,
    mesh=None,
    device=None,
):
    """Route to HNSW / IVF / flat by corpus size; see module docstring."""
    n = len(vectors)
    cap = hnsw_max_vectors() if hnsw_max is None else int(hnsw_max)
    if n <= cap and mesh is None:
        from kobato_eyes_tpu_torch.index.hnsw import HnswIndex

        idx = HnswIndex(dim=int(np.asarray(vectors).shape[1]))
        idx.add(np.asarray(vectors), ids)
        return idx
    if n <= DEFAULT_FLAT_MIN:
        from kobato_eyes_tpu_torch.index.flat import FlatIndex

        return FlatIndex(vectors, ids, mesh=mesh, device=device)
    from kobato_eyes_tpu_torch.index.ivf import IvfFlatIndex

    logger.info(
        "ann: %d vectors > hnsw cap %d -> device IVF (recall-1.0 lane)", n, cap
    )
    return IvfFlatIndex(vectors, ids=ids, mesh=mesh, device=device)


def save_auto_index(index, path: str | Path) -> None:
    """Persist any auto-index: HNSW graph natively; device indexes as the
    (vectors, ids) npz they rebuild from in seconds. A sidecar
    ``.meta.json`` records the kind for load-time routing."""
    from kobato_eyes_tpu_torch.index.hnsw import HnswIndex

    path = Path(path)
    if isinstance(index, HnswIndex):
        index.save(path)
        kind = "hnsw"
        normalize = True
    else:
        vecs, ids = _corpus_of(index)
        np.savez(path.with_suffix(".npz"), vectors=vecs, ids=ids)
        kind = type(index).__name__
        # FlatIndex(normalize=False) corpora must NOT be re-normalized on
        # reload; IVF always normalizes (its stored corpus is already unit)
        normalize = bool(getattr(index, "normalize", True))
    path.with_suffix(".meta.json").write_text(
        json.dumps(
            {
                "kind": kind,
                "n": len(index),
                "dim": int(index.dim),
                "normalize": normalize,
            }
        )
    )


def load_auto_index(path: str | Path, *, dim: int, mesh=None, device=None):
    """Counterpart of :func:`save_auto_index`; legacy graphs (no sidecar)
    load as plain HNSW."""
    from kobato_eyes_tpu_torch.index.hnsw import HnswIndex

    path = Path(path)
    meta_path = path.with_suffix(".meta.json")
    meta: dict = {}
    if meta_path.exists():
        meta = json.loads(meta_path.read_text())
    kind = meta.get("kind", "hnsw")
    if kind == "hnsw":
        return HnswIndex.load(path, dim=dim)
    data = np.load(path.with_suffix(".npz"))
    vectors, ids = data["vectors"], data["ids"]
    # Route by the RECORDED kind (an IvfFlatIndex saved below the flat cap —
    # or a FlatIndex above it under a custom cap — must round-trip to the
    # same class); size-based routing only for sidecars without a device kind.
    if kind == "FlatIndex" or (
        kind not in ("IvfFlatIndex",) and len(vectors) <= DEFAULT_FLAT_MIN
    ):
        from kobato_eyes_tpu_torch.index.flat import FlatIndex

        return FlatIndex(
            vectors, ids, mesh=mesh, normalize=bool(meta.get("normalize", True)), device=device
        )
    from kobato_eyes_tpu_torch.index.ivf import IvfFlatIndex

    return IvfFlatIndex(vectors, ids=ids, mesh=mesh, device=device)


def _corpus_of(index) -> tuple[np.ndarray, np.ndarray]:
    """(vectors, ids) living on the device index (unit-normalized copy),
    read back to the host."""
    n = len(index)
    if getattr(index, "_corpus_t", None) is not None:
        corpus = index._corpus_t.t()
    elif isinstance(index._corpus, list):  # row shards over a mesh
        corpus = torch.cat([s.cpu() for s in index._corpus])
    else:
        corpus = index._corpus
    return corpus[:n].cpu().numpy().astype(np.float32), np.asarray(index.ids[:n], np.int64)
