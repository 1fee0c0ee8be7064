"""Multi-device duplicate candidate scan: row-sharded windowed compare.

Counterpart of ``kobato_eyes_tpu/parallel/sharded_scan.py`` ("shard by
file-id; all-gather candidate edges"): the per-band sorted hash arrays are
copied whole to every data row (they are small: 70k hashes = 0.5 MB), each
row evaluates the windowed compare for its own contiguous block of sorted
rows (plus a window-sized halo it reads from the whole arrays) on its first
mesh entry, and the fixed-size edge blocks are gathered back in row order.
Work scales 1/D per device with no redistribution, since the compare is
embarrassingly parallel over rows.

As in the JAX package, torch tensor code on each shard (no popcount in
torch: ``ops/hamming.popcount32``, a SWAR over 32-bit halves held in int64).
"""

from __future__ import annotations

import numpy as np
import torch

from kobato_eyes_tpu_torch.ops.hamming import popcount32


def _shard_body(
    sk: torch.Tensor,  # (B, N) int64 sorted band keys, whole
    shi: torch.Tensor,  # (B, N) int64 high 32 bits of the hashes in sorted order
    slo: torch.Tensor,  # (B, N) int64 low 32 bits
    sok: torch.Tensor,  # (B, N) bool bucket mask
    hamming_threshold: int,
    *,
    shard: int,
    window: int,
    rows_per_shard: int,
    max_edges_per_shard: int,
) -> torch.Tensor:
    """Evaluate sorted rows [shard * rows, shard * rows + rows) -> (4, cap)
    int32 block: band, i_sorted, j_sorted, dist, padded with -1; the shard's
    edge count rides in the reserved last slot of row 0, so the caller can
    detect truncation (edges beyond the cap would silently vanish otherwise)."""
    nb, n = sk.shape
    dev = sk.device
    start = shard * rows_per_shard
    col = torch.arange(rows_per_shard, device=dev) + start  # (rps,)
    dd = torch.arange(1, window + 1, device=dev)[:, None]  # (window, 1)
    jj = col[None, :] + dd  # (window, rps)
    valid = (jj < n) & (col[None, :] < n)
    jjc = torch.clamp_max(jj, n - 1).expand(nb, window, rows_per_shard)
    colc = torch.clamp_max(col, n - 1)[None, None, :].expand(nb, window, rows_per_shard)

    def take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return torch.gather(arr[:, None, :].expand(nb, window, n), 2, idx)

    eq = (take(sk, colc) == take(sk, jjc)) & valid
    eq &= take(sok, colc) & take(sok, jjc)
    dist = popcount32(take(shi, colc) ^ take(shi, jjc)) + popcount32(take(slo, colc) ^ take(slo, jjc))
    mask = eq & (dist <= hamming_threshold)

    n_edges = int(mask.sum())
    b_idx, w_idx, i_local = torch.nonzero(mask, as_tuple=True)  # row-major, as jnp.nonzero
    keep = min(n_edges, max_edges_per_shard)
    out = torch.full((4, max_edges_per_shard), -1, dtype=torch.int32, device=dev)
    out[0, :keep] = b_idx[:keep].to(torch.int32)
    out[1, :keep] = (i_local[:keep] + start).to(torch.int32)
    out[2, :keep] = (i_local[:keep] + start + w_idx[:keep] + 1).to(torch.int32)
    out[3, :keep] = dist[b_idx[:keep], w_idx[:keep], i_local[:keep]].to(torch.int32)
    out[0, max_edges_per_shard - 1] = n_edges
    return out


def sharded_window_scan(
    mesh,
    sk: np.ndarray,  # (B, N) sorted band keys
    sph: np.ndarray,  # (B, N, 2) uint32 sorted hashes
    sok: np.ndarray,  # (B, N) bool
    *,
    hamming_threshold: int,
    window: int,
    max_edges_per_shard: int = 1 << 15,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Run the windowed compare across the mesh's data axis.

    Returns (band, i_sorted, j_sorted, dist) edge arrays in per-band sorted
    coordinates (mapping back through each band's sort order and pair
    deduplication are the caller's job, identical to the single-device path).
    """
    rows = mesh.local_devices[:, 0]
    n_devices = len(rows)
    nb, n = sk.shape
    rows_per_shard = -(-n // n_devices)  # cdiv

    sk_h = torch.from_numpy(np.ascontiguousarray(sk, dtype=np.int64))
    sph_h = torch.from_numpy(np.ascontiguousarray(sph, dtype=np.int64))
    sok_h = torch.from_numpy(np.ascontiguousarray(sok, dtype=bool))
    blocks = []
    with torch.inference_mode():
        for shard, dev in enumerate(rows):
            blocks.append(_shard_body(
                sk_h.to(dev), sph_h[..., 0].to(dev), sph_h[..., 1].to(dev), sok_h.to(dev),
                int(hamming_threshold), shard=shard, window=window, rows_per_shard=rows_per_shard,
                max_edges_per_shard=max_edges_per_shard,
            ))
        # gather the per-shard edge blocks in shard order -> (D, 4, cap)
        gathered = torch.stack([b.cpu() for b in blocks]).numpy()
    counts = gathered[:, 0, -1]
    worst = int(counts.max()) if len(counts) else 0
    if worst > max_edges_per_shard - 1:
        raise ValueError(
            f"sharded scan overflow: a shard produced {worst} edges "
            f"(cap {max_edges_per_shard - 1}); retry with a larger "
            f"max_edges_per_shard"
        )
    # the count slot is excluded by the keep mask below: its i/j entries are
    # -1 padding whenever count <= cap-1 (enforced above)
    b = gathered[:, 0, :].ravel()
    i = gathered[:, 1, :].ravel()
    j = gathered[:, 2, :].ravel()
    d = gathered[:, 3, :].ravel()
    keep = (b >= 0) & (i >= 0) & (j >= 0)
    return (
        b[keep].astype(np.int64),
        i[keep].astype(np.int64),
        j[keep].astype(np.int64),
        d[keep].astype(np.int64),
    )
