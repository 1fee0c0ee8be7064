"""Multi-device tag-query evaluation: file-row-sharded masks.

Counterpart of ``kobato_eyes_tpu/query/sharded.py``. The epoch's padded
file-row axis splits contiguously over the mesh's ``data`` axis, so device
memory and mask work scale 1/D:

- Each data row holds, on its first mesh entry, ONLY its row shard of the
  postings CSR (entries whose file row lands in the shard, still tag-major,
  rows made shard-local), its rows of the category and score-extrema
  panels, and evaluates the whole query over its local rows with the
  single-device evaluator (``query/engine._mask_words``).
- Per-shard CSR offsets differ, so every shard has its own slot table
  (starts, lengths) for a query; the gates are shared.
- The packed result words come back in shard order: the only traffic
  between devices is the n_pad/8-byte bitmask.

Identity with the single-device engine is exact (the host-side relevance
and ordering code is shared, not re-implemented). ``n_pad % D == 0`` and
``(n_pad / D) % 32 == 0`` must hold, as in the JAX package; otherwise
:func:`sharded_mask_words` raises ``ValueError`` and ``search_epoch`` serves
the query on one device (and remembers the verdict).

What differs from the JAX module: its shard_map needs a rectangular (D,
nnz_sh_pad) posting table, every shard padded to the busiest shard's count,
so it refuses to shard an epoch whose postings skew onto one row shard
(``KET_QUERY_SHARD_AMP_CAP``). Here each shard holds exactly its own
postings, so skew costs no memory and no such refusal exists. And, as in
``query/engine.py``, evaluation is eager: the JAX module's compiled
per-structure programs (``_sharded_structure_fn``, cached in
``_SHARDED_STRUCTURE_CACHE`` under ``_CACHE_CAP``) have no counterpart.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

# epoch -> {mesh: _ShardedArrays}; weak keys so superseded epochs free their
# sharded device copies as soon as they go
_SHARDED_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


@dataclass(frozen=True, eq=False)
class _Shard:
    """One row shard, laid out as ``_mask_words`` reads an epoch."""

    rows_dev: torch.Tensor  # (nnz_s,) int32 shard-local rows, tag-major
    scores_dev: torch.Tensor  # (nnz_s,) float32
    cat_max_dev: torch.Tensor  # (rps, 6) float32
    cat_present_dev: torch.Tensor  # (rps, 6) bool
    smax_dev: torch.Tensor  # (rps,) float32
    smin_dev: torch.Tensor  # (rps,) float32
    n_pad: int  # rows in the shard
    offsets: np.ndarray  # (T+1,) int64 host CSR offsets into this shard's postings

    @property
    def device(self) -> torch.device:
        return self.rows_dev.device


@dataclass(frozen=True, eq=False)
class _ShardedArrays:
    """An epoch's row shards over one mesh."""

    mesh: object
    n_shards: int
    rps: int
    shards: tuple[_Shard, ...]


def _shard_epoch(epoch, mesh) -> _ShardedArrays:
    per_epoch = _SHARDED_CACHE.setdefault(epoch, {})
    hit = per_epoch.get(mesh)
    if hit is not None:
        return hit

    devices = mesh.local_devices[:, 0]
    d = len(devices)
    n_pad = int(epoch.n_pad)
    if n_pad % d or (n_pad // d) % 32:
        raise ValueError(
            f"n_pad {n_pad} not shardable over {d} devices in 32-bit words"
        )
    rps = n_pad // d

    t_count = epoch.num_tags
    counts = np.diff(epoch.offsets).astype(np.int64)
    t_idx = np.repeat(np.arange(t_count, dtype=np.int64), counts)
    rows = epoch.rows_np.astype(np.int64, copy=False)
    sc = epoch.scores_np.astype(np.float32)

    shard_of = rows // rps
    order = np.argsort(shard_of, kind="stable")  # tag-major within shard
    rows_s, sc_s, t_s = rows[order], sc[order], t_idx[order]
    starts = np.concatenate([[0], np.cumsum(np.bincount(shard_of, minlength=d))])
    shards = []
    for s, dev in enumerate(devices):
        lo, hi = int(starts[s]), int(starts[s + 1])
        offsets = np.zeros(t_count + 1, dtype=np.int64)
        offsets[1:] = np.cumsum(np.bincount(t_s[lo:hi], minlength=t_count))
        panel = slice(s * rps, (s + 1) * rps)
        shards.append(_Shard(
            rows_dev=torch.from_numpy((rows_s[lo:hi] - s * rps).astype(np.int32)).to(dev),
            scores_dev=torch.from_numpy(np.ascontiguousarray(sc_s[lo:hi])).to(dev),
            # panels re-shard from the epoch's single-device copies
            cat_max_dev=epoch.cat_max_dev[panel].to(dev),
            cat_present_dev=epoch.cat_present_dev[panel].to(dev),
            smax_dev=epoch.smax_dev[panel].to(dev),
            smin_dev=epoch.smin_dev[panel].to(dev),
            n_pad=rps,
            offsets=offsets,
        ))
    out = _ShardedArrays(mesh=mesh, n_shards=d, rps=rps, shards=tuple(shards))
    per_epoch[mesh] = out
    return out


def _sharded_tables(sharded: _ShardedArrays, epoch, expr, thr) -> list[tuple]:
    """A query's operand tables for each shard: its own posting slices,
    the shared gates and thresholds (a few host numbers, never uploaded)."""
    from kobato_eyes_tpu_torch.query.engine import _slot_tables_np

    return [_slot_tables_np(epoch, expr, thr, offsets=shard.offsets) for shard in sharded.shards]


def sharded_mask_words(epoch, mesh, query: str, expr, thr: Mapping[int, float]) -> np.ndarray:
    """Packed (n_pad/8,) uint8 result-mask words, computed on the mesh.
    ``query`` is the text ``expr`` was parsed from (the JAX module keys its
    table cache by it; the tables here are rebuilt per call)."""
    from kobato_eyes_tpu_torch.query.engine import _mask_words

    sharded = _shard_epoch(epoch, mesh)
    words = [_mask_words(shard, tables) for shard, tables in zip(sharded.shards, _sharded_tables(sharded, epoch, expr, thr))]
    # gather the shards' words in shard order: one copy each
    return torch.cat([w.cpu() for w in words]).numpy()
