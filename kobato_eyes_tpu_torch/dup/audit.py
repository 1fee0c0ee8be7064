"""Cluster cohesion audit: dense pairwise Hamming over cluster members.

Counterpart of ``kobato_eyes_tpu/dup/audit.py``. The production candidate
scan (ops/hamming.py) only retains per-edge minima (``best_hamming``), so a
cluster's true tightness is invisible — members can be chained together
through a keeper while sitting far apart from each other.  The audit
computes each cluster's full intra-member Hamming matrix with the CUDA
all-pairs kernel (ops/pairwise_hamming.py, on ``device``) and summarizes
cohesion:

* ``diameter``   — max pairwise distance (worst intra-cluster pair),
* ``mean_distance`` — mean over unordered member pairs,
* ``keeper_max`` — keeper eccentricity (max keeper->member distance).

``ket dup --audit`` surfaces these for hamming-threshold tuning (the
reference exposes no equivalent; its calibration tool covers only the
refinement metrics, ``tools/calibrate_ndup.py``).

Clusters are packed into batches so each batch is ONE kernel launch;
oversized clusters fall back to row-stripe accumulation against the full
member set, so no (m, m) matrix beyond the batch bound ever materializes.
Each batch matrix is copied to the host, where the per-cluster reductions
run in numpy, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from kobato_eyes_tpu_torch.dup.types import DuplicateCluster
from kobato_eyes_tpu_torch.ops.pairwise_hamming import pairwise_hamming
from kobato_eyes_tpu_torch.utils.bits import U64_MASK


@dataclass(frozen=True)
class ClusterCohesion:
    keeper_id: int
    size: int
    diameter: int
    mean_distance: float
    keeper_max: int


def _cohesion_from_matrix(
    mat: np.ndarray, keeper_row: int, keeper_id: int
) -> ClusterCohesion:
    m = mat.shape[0]
    off_sum = int(mat.sum()) - int(np.trace(mat))
    pairs = m * (m - 1)
    return ClusterCohesion(
        keeper_id=keeper_id,
        size=m,
        diameter=int(mat.max()),
        mean_distance=(off_sum / pairs) if pairs else 0.0,
        keeper_max=int(mat[keeper_row].max()),
    )


def _audit_large(
    hashes: np.ndarray, keeper_row: int, keeper_id: int, stripe: int, *, device=None
) -> ClusterCohesion:
    """Row-striped accumulation for clusters larger than the batch bound."""
    m = len(hashes)
    diameter = 0
    total = 0
    keeper_max = 0
    for s in range(0, m, stripe):
        block = pairwise_hamming(hashes[s : s + stripe], hashes, device=device)
        diameter = max(diameter, int(block.max()))
        total += int(block.sum())
        if s <= keeper_row < s + stripe:
            keeper_max = int(block[keeper_row - s].max())
    pairs = m * (m - 1)
    return ClusterCohesion(
        keeper_id=keeper_id,
        size=m,
        diameter=diameter,
        mean_distance=(total / pairs) if pairs else 0.0,
        keeper_max=keeper_max,
    )


def audit_clusters(
    clusters: Sequence[DuplicateCluster], *, batch_hashes: int = 4096, device=None
) -> list[ClusterCohesion]:
    """One :class:`ClusterCohesion` per cluster, in input order.

    Batches pack whole clusters up to ``batch_hashes`` members so the kernel
    is launched once per batch ((4096)^2 int32 = 64 MB peak), with
    per-cluster stats read out of the batch matrix's diagonal blocks.
    """
    out: list[ClusterCohesion] = []
    batch: list[tuple[np.ndarray, int, int]] = []  # (hashes, keeper_row, keeper_id)
    batch_total = 0

    def flush() -> None:
        nonlocal batch, batch_total
        if not batch:
            return
        all_h = np.concatenate([h for h, _, _ in batch])
        mat = pairwise_hamming(all_h, device=device)
        start = 0
        for h, keeper_row, keeper_id in batch:
            m = len(h)
            block = mat[start : start + m, start : start + m]
            out.append(_cohesion_from_matrix(block, keeper_row, keeper_id))
            start += m
        batch = []
        batch_total = 0

    for cl in clusters:
        hashes = np.array(
            [e.file.phash & U64_MASK for e in cl.files], dtype=np.uint64
        )
        keeper_row = next(
            i for i, e in enumerate(cl.files) if e.file.file_id == cl.keeper_id
        )
        if len(hashes) > batch_hashes:
            flush()  # keep output order: drain pending smaller clusters first
            out.append(
                _audit_large(hashes, keeper_row, cl.keeper_id, stripe=batch_hashes, device=device)
            )
            continue
        if batch_total + len(hashes) > batch_hashes:
            flush()
        batch.append((hashes, keeper_row, cl.keeper_id))
        batch_total += len(hashes)
    flush()
    return out


def audit_clusters_np(clusters: Sequence[DuplicateCluster]) -> list[ClusterCohesion]:
    """numpy executable spec (parity oracle for :func:`audit_clusters`)."""
    from kobato_eyes_tpu_torch.ops.pairwise_hamming import pairwise_hamming_np

    out = []
    for cl in clusters:
        hashes = np.array(
            [e.file.phash & U64_MASK for e in cl.files], dtype=np.uint64
        )
        keeper_row = next(
            i for i, e in enumerate(cl.files) if e.file.file_id == cl.keeper_id
        )
        out.append(
            _cohesion_from_matrix(
                pairwise_hamming_np(hashes), keeper_row, cl.keeper_id
            )
        )
    return out


def summarize(stats: Sequence[ClusterCohesion], *, worst: int = 5) -> str:
    """Human-readable audit summary for the CLI."""
    if not stats:
        return "audit: no clusters"
    diam = np.array([s.diameter for s in stats])
    lines = [
        f"audit: {len(stats)} clusters, {int(sum(s.size for s in stats))} members",
        f"diameter: max={int(diam.max())} p95={int(np.percentile(diam, 95))} "
        f"mean={diam.mean():.2f}",
    ]
    loosest = sorted(stats, key=lambda s: -s.diameter)[:worst]
    for s in loosest:
        lines.append(
            f"  loose: keeper={s.keeper_id} size={s.size} diameter={s.diameter} "
            f"mean={s.mean_distance:.2f} keeper_max={s.keeper_max}"
        )
    return "\n".join(lines)
