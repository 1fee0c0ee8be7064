"""Cluster refinement: batched tile-aHash and pixel-MAE passes.

Counterpart of ``kobato_eyes_tpu/dup/refine_clusters.py``: the production
refinement path of the reference app (``src/ui/dup_refine_parallel.py``):
phase 1 computes a tile-aHash per unique
file, phase 2 drops members whose tile-Hamming to the keeper exceeds
``max_bits``; the optional pixel pass drops members whose 128x128 grayscale
MAE against the keeper exceeds ``mae_thr``.  Decisions are bit-identical to
the reference; the hash/MAE math runs as batched device passes on ``device``
(ops/tile_hash.py, ops/mae.py) instead of per-file Python.

Decode semantics match the reference helpers exactly: plain ``Image.open``
with EXIF transpose, ``convert("L")`` (alpha ignored), BILINEAR resize.
"""

from __future__ import annotations

import logging
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
from PIL import Image, ImageOps

from kobato_eyes_tpu_torch.dup.types import DuplicateCluster, DuplicateClusterEntry
from kobato_eyes_tpu_torch.ops.mae import abs_diff_sums
from kobato_eyes_tpu_torch.ops.tile_hash import tile_ahash_batch, tile_hamming_words

logger = logging.getLogger(__name__)

TileTick = Callable[..., None]
CancelFn = Callable[[], bool]


def _load_small_gray(path: Path, side: int) -> np.ndarray | None:
    """(side, side) uint8 grayscale, reference decode semantics; None on error."""
    try:
        with Image.open(path) as opened:
            transposed = ImageOps.exif_transpose(opened)
            gray = transposed.convert("L").resize((side, side), Image.Resampling.BILINEAR)
        return np.asarray(gray, dtype=np.uint8)
    except Exception as exc:
        # Failure policy: per-file decode errors exclude the file from
        # refinement, never abort the pass (reference phase-1 semantics).
        logger.debug("tile/pixel decode failed for %s: %s", path, exc)
        return None


def _decode_unique(
    paths: Sequence[Path],
    side: int,
    io_workers: int,
    is_cancelled: CancelFn | None,
    tick: Callable[[int], None] | None = None,
) -> tuple[dict[Path, int], np.ndarray]:
    """Decode unique paths in a thread pool; returns path->row index + stack."""
    index: dict[Path, int] = {}
    arrays: list[np.ndarray] = []
    failures: Counter[str] = Counter()
    with ThreadPoolExecutor(max_workers=io_workers) as pool:
        for i, (p, arr) in enumerate(zip(paths, pool.map(lambda p: _load_small_gray(p, side), paths))):
            if is_cancelled is not None and is_cancelled():
                return {}, np.empty((0, side, side), np.uint8)
            if arr is None:
                failures["decode"] += 1
                continue
            index[p] = len(arrays)
            arrays.append(arr)
            if tick is not None:
                tick(i + 1)
    if failures:
        logger.warning("refinement skipped %d file(s) due to decode errors", sum(failures.values()))
    stack = np.stack(arrays) if arrays else np.empty((0, side, side), np.uint8)
    return index, stack


def _norm_path(p: Path) -> Path:
    try:
        return Path(p).resolve(strict=False)
    except OSError:
        return Path(p)


def refine_by_tilehash(
    clusters: Sequence[DuplicateCluster],
    *,
    grid: int = 8,
    tile: int = 8,
    max_bits: int = 8,
    io_workers: int = 8,
    tick: TileTick | None = None,
    is_cancelled: CancelFn | None = None,
    device=None,
) -> list[DuplicateCluster]:
    """Drop members whose tile-Hamming to the keeper exceeds ``max_bits``.

    Decision parity with reference ``refine_by_tilehash_parallel``
    (dup_refine_parallel.py:113-200); clusters that lose the keeper or fall
    below 2 members are removed.
    """
    if is_cancelled is not None and is_cancelled():
        return []
    side = grid * tile
    all_paths = sorted(
        {_norm_path(e.file.path) for cl in clusters for e in cl.files},
        key=lambda p: (p.anchor, str(p.parent)),
    )
    index, stack = _decode_unique(
        all_paths, side, io_workers, is_cancelled,
        tick=(lambda done: tick(done, len(all_paths), phase=1)) if tick else None,
    )
    if is_cancelled is not None and is_cancelled():
        return []
    words = (
        tile_ahash_batch(stack, grid=grid, tile=tile, device=device)
        if stack.shape[0]
        else np.empty((0, side * side // 32), np.uint32)
    )

    out: list[DuplicateCluster] = []
    for i, cl in enumerate(clusters, 1):
        if is_cancelled is not None and is_cancelled():
            return []
        keeper = next((e for e in cl.files if e.file.file_id == cl.keeper_id), None)
        if keeper is None:
            continue
        base_row = index.get(_norm_path(keeper.file.path))
        if base_row is None:
            continue
        kept: list[DuplicateClusterEntry] = []
        member_rows = []
        member_entries = []
        for e in cl.files:
            row = index.get(_norm_path(e.file.path))
            if row is None:
                continue
            member_rows.append(row)
            member_entries.append(e)
        if member_rows:
            dists = tile_hamming_words(words[member_rows], words[base_row][None, :])
            kept = [e for e, d in zip(member_entries, dists) if int(d) <= max_bits]
        if len(kept) >= 2:
            out.append(DuplicateCluster(files=tuple(kept), keeper_id=cl.keeper_id))
        if tick is not None and (i % 16 == 0 or i == len(clusters)):
            tick(i, len(clusters), phase=2)
    return out


def refine_by_pixels(
    clusters: Sequence[DuplicateCluster],
    *,
    mae_thr: float = 0.006,
    thumb_size: int = 128,
    io_workers: int = 8,
    tick: Callable[[int, int], None] | None = None,
    is_cancelled: CancelFn | None = None,
    device=None,
) -> list[DuplicateCluster]:
    """Drop members whose grayscale-thumbnail MAE vs the keeper exceeds thr.

    Decision parity with reference ``refine_by_pixels_parallel``
    (dup_refine_parallel.py:215-263): clusters whose keeper fails to decode
    are dropped entirely; members failing to decode are excluded.
    """
    all_paths = sorted(
        {_norm_path(e.file.path) for cl in clusters for e in cl.files},
        key=lambda p: (p.anchor, str(p.parent)),
    )
    index, stack = _decode_unique(all_paths, thumb_size, io_workers, is_cancelled)
    if is_cancelled is not None and is_cancelled():
        return []

    # Build the full (member, keeper) pair list across clusters, evaluate all
    # absolute-difference sums in one device batch, then apply decisions.
    pair_member_rows: list[int] = []
    pair_keeper_rows: list[int] = []
    pair_owner: list[tuple[int, DuplicateClusterEntry]] = []
    keeper_ok: dict[int, bool] = {}
    for ci, cl in enumerate(clusters):
        keeper = next((e for e in cl.files if e.file.file_id == cl.keeper_id), None)
        if keeper is None:
            keeper_ok[ci] = False
            continue
        base_row = index.get(_norm_path(keeper.file.path))
        if base_row is None:
            keeper_ok[ci] = False
            continue
        keeper_ok[ci] = True
        for e in cl.files:
            row = index.get(_norm_path(e.file.path))
            if row is None:
                continue
            pair_member_rows.append(row)
            pair_keeper_rows.append(base_row)
            pair_owner.append((ci, e))

    decisions: dict[int, list[DuplicateClusterEntry]] = {}
    if pair_member_rows:
        sums = np.asarray(
            abs_diff_sums(stack[pair_member_rows], stack[pair_keeper_rows], device=device),
            dtype=np.float64,
        )
        n = thumb_size * thumb_size
        maes = (sums / n) / 255.0
        for (ci, entry), mae in zip(pair_owner, maes):
            if mae <= mae_thr:
                decisions.setdefault(ci, []).append(entry)

    out: list[DuplicateCluster] = []
    for ci, cl in enumerate(clusters):
        if not keeper_ok.get(ci, False):
            continue
        kept = decisions.get(ci, [])
        if len(kept) >= 2:
            out.append(DuplicateCluster(files=tuple(kept), keeper_id=cl.keeper_id))
        if tick is not None and ((ci + 1) % 16 == 0 or ci + 1 == len(clusters)):
            tick(ci + 1, len(clusters))
    return out
