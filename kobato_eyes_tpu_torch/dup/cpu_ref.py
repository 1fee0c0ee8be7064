"""CPU baseline duplicate scanner (bucket-loop algorithm).

A faithful re-implementation of the reference's host algorithm
(``src/dup/scanner.py:211-318``: dict LSH buckets, per-bucket Python pair
loops, int.bit_count Hamming) kept for two purposes:

1. the benchmark baseline the TPU engine is measured against
   (BASELINE.md: >=10x dup-scan throughput target), and
2. cluster-parity tests -- the TPU engine must produce identical clusters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

from kobato_eyes_tpu_torch.dup.types import (
    DuplicateCluster,
    DuplicateFileMeta,
    DuplicateScanConfig,
    assemble_clusters_py,
)
from kobato_eyes_tpu_torch.utils.bits import U64_MASK, hamming64_int


@dataclass
class ScanFunnel:
    """Pair-filter funnel counters (reference scanner.py:292-299 log line)."""

    pair_total: int = 0
    pair_after_size: int = 0
    pair_after_ham: int = 0
    edges: int = 0


class CpuDuplicateScanner:
    """Bucketed pairwise scanner running entirely on the host."""

    def __init__(self, config: DuplicateScanConfig | None = None) -> None:
        self._config = config or DuplicateScanConfig()
        self.last_funnel = ScanFunnel()
        # coarse per-phase walls of the last run (bucket/pairs/assemble):
        # three perf_counter reads total, so the baseline itself is not
        # distorted — lets the bench ledger diagnose degraded-VM captures
        self.last_phases: dict[str, float] = {}

    def build_clusters(self, files: Iterable[DuplicateFileMeta]) -> list[DuplicateCluster]:
        import time as _time

        cfg = self._config
        _t0 = _time.perf_counter()
        candidates = [f for f in files if f.phash is not None]
        if not candidates:
            return []

        band_mask = (1 << cfg.band_bits) - 1
        buckets: dict[tuple[int, int], list[int]] = {}
        for idx, f in enumerate(candidates):
            ph = int(f.phash) & U64_MASK
            for band in range(cfg.band_count):
                key = (band, (ph >> (band * cfg.band_bits)) & band_mask)
                buckets.setdefault(key, []).append(idx)

        _t_bucket = _time.perf_counter()
        funnel = ScanFunnel()
        edges: dict[tuple[int, int], int] = {}
        cap = cfg.bucket_pair_cap
        for indices in buckets.values():
            if len(indices) < 2:
                continue
            if cap is not None and len(indices) * (len(indices) - 1) // 2 > cap:
                continue
            for i in range(len(indices) - 1):
                a = candidates[indices[i]]
                for j in range(i + 1, len(indices)):
                    b = candidates[indices[j]]
                    if a.file_id == b.file_id:
                        continue
                    funnel.pair_total += 1
                    if not _passes_size_ratio(a, b, cfg.size_ratio):
                        continue
                    funnel.pair_after_size += 1
                    h = hamming64_int(a.phash, b.phash)
                    if h > cfg.hamming_threshold:
                        continue
                    funnel.pair_after_ham += 1
                    if not _passes_cosine(a, b, cfg.cosine_threshold):
                        continue
                    key = (a.file_id, b.file_id) if a.file_id < b.file_id else (b.file_id, a.file_id)
                    if key not in edges:
                        edges[key] = h
        funnel.edges = len(edges)
        self.last_funnel = funnel
        _t_pairs = _time.perf_counter()

        files_by_id = {f.file_id: f for f in candidates}
        # reference-shaped assembly (Python DSU + tuple-key sorts): this class
        # is the *baseline*, so it must not borrow the vectorized assembly.
        out = assemble_clusters_py(
            files_by_id, [(a, b, h) for (a, b), h in edges.items()]
        )
        _t_end = _time.perf_counter()
        self.last_phases = {
            "bucket": round(_t_bucket - _t0, 4),
            "pairs": round(_t_pairs - _t_bucket, 4),
            "assemble": round(_t_end - _t_pairs, 4),
        }
        return out


def _passes_size_ratio(a: DuplicateFileMeta, b: DuplicateFileMeta, ratio: float | None) -> bool:
    if ratio is None or ratio <= 0:
        return True
    sa, sb = a.size or 0, b.size or 0
    if sa <= 0 or sb <= 0:
        return True
    smaller, larger = min(sa, sb), max(sa, sb)
    return larger == 0 or smaller / larger >= ratio


def _passes_cosine(a: DuplicateFileMeta, b: DuplicateFileMeta, threshold: float | None) -> bool:
    if threshold is None:
        return True
    va, vb = a.embedding, b.embedding
    if not va or not vb or len(va) != len(vb):
        return True
    dot = sum(x * y for x, y in zip(va, vb))
    na = sum(x * x for x in va) ** 0.5
    nb = sum(y * y for y in vb) ** 0.5
    if na == 0.0 or nb == 0.0:
        return True
    return dot / (na * nb) >= threshold
