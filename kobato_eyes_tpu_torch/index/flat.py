"""Exact (brute-force) vector search: one f32 matmul and a top-k.

Counterpart of ``kobato_eyes_tpu/index/flat.py``. The recall ground truth of
every ANN structure, and a good production index below ~1M vectors: one
(Q, D) x (D, N) product per query batch in IEEE f32 (TF32 stays off: this
is the exact index) and a top-k on the device.

Ties keep the JAX package's order. ``lax.top_k`` returns equal scores lowest
index first; ``torch.topk`` promises no order among ties, and exact
duplicates (the same image twice) give equal scores. So the final top-k
runs over one 64-bit key per entry: the score's f32 bits made to sort as an
integer in the high word, the inverted column in the low word
(``topk_rows``), over 2k candidates a row when they hold every tie.

With ``mesh``, the corpus row-shards over the mesh's ``data`` axis, one
block a data row on its first entry: each shard runs its (Q, N/D) product
and local top-k, padding rows masked to -inf, and the shard-major gathered
candidates merge through the same keyed top-k (``merged_topk``), which
orders ties as the single index does.
"""

from __future__ import annotations

import numpy as np
import torch

from kobato_eyes_tpu_torch.device import resolve_device

_LOW_WORD = 0xFFFFFFFF


def topk_rows(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` of each row of the f32 ``scores`` -> (scores, columns),
    descending, equal scores lowest column first (``lax.top_k``'s order).

    ``torch.topk`` first takes 2k candidates a row. When each row's last
    candidate scores strictly below its k-th, every entry tied with the k-th
    is a candidate, and the keyed top-k below orders the candidates alone;
    otherwise (a tie group wider than the candidates, as -inf rows of a
    masked IVF search make) it orders the whole row. The check reads one
    flag back from the device."""
    n = scores.shape[-1]
    m = min(n, 2 * k)
    if 0 < k and m < n:
        cand_s, cand_c = torch.topk(scores, m, dim=-1)
        if bool((cand_s[..., m - 1] < cand_s[..., k - 1]).all()):
            cols = torch.gather(cand_c, -1, _keyed_topk(cand_s, cand_c, k))
            return torch.gather(scores, -1, cols), cols
    cols = _keyed_topk(scores, torch.arange(n, device=scores.device), k)
    return torch.gather(scores, -1, cols), cols


def _keyed_topk(scores: torch.Tensor, cols: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the top ``k`` by one 64-bit key an entry: the score's f32
    bits, the negative half flipped so they order as the floats do, in the
    high word; ``2**32 - 1 - column`` in the low word, so of two equal
    scores the lower column has the larger key. Every key is distinct, so
    any top-k returns the same set in the same order."""
    bits = scores.contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    keys = (ordered << 32) | (_LOW_WORD - cols)
    return torch.topk(keys, k, dim=-1).indices


def merged_topk(scores_g: torch.Tensor, rows_g: torch.Tensor, k: int):
    """Final top-k over shard-major gathered (scores, global rows): equal
    scores keep their gathered order, earliest position first, as
    ``lax.top_k`` does, so the lowest global row wins a tie."""
    top_s, pos = topk_rows(scores_g, k)
    return top_s, torch.gather(rows_g, 1, pos)


def _search_kernel(queries: torch.Tensor, corpus_t: torch.Tensor, *, k: int):
    # f32 product: the exact index, so no reduced-precision operands
    sims = torch.matmul(queries, corpus_t)
    return topk_rows(sims, k)


def shard_rows(vecs: np.ndarray, mesh) -> list[torch.Tensor]:
    """(N, D) host rows padded with zero rows to a multiple of the data axis,
    one contiguous block a data row on its first entry."""
    rows = mesh.local_devices[:, 0]
    rps = -(-len(vecs) // len(rows))
    pad = rps * len(rows) - len(vecs)
    if pad:
        vecs = np.concatenate([vecs, np.zeros((pad, *vecs.shape[1:]), vecs.dtype)])
    return [torch.from_numpy(np.ascontiguousarray(vecs[s * rps : (s + 1) * rps])).to(dev)
            for s, dev in enumerate(rows)]


def gather_merge(parts: list[tuple[torch.Tensor, torch.Tensor]], k: int, device: torch.device):
    """Shard-major gathered per-shard (scores, global rows) candidates on
    ``device`` -> the final top-k (scores, rows)."""
    s_flat = torch.cat([s.to(device) for s, _ in parts], dim=1)
    r_flat = torch.cat([r.to(device) for _, r in parts], dim=1)
    return merged_topk(s_flat, r_flat, k)


def _sharded_flat_search(shards: list[torch.Tensor], n: int, q: torch.Tensor, k: int):
    """Row-sharded exact search: per-shard matmul + top-k, gathered merge."""
    rps = shards[0].shape[0]
    k_local = min(k, rps)
    parts = []
    for shard, corpus_local in enumerate(shards):
        sims = torch.matmul(q.to(corpus_local.device), corpus_local.t())  # (Q, rps)
        col = torch.arange(rps, device=sims.device) + shard * rps
        sims = torch.where(col < n, sims, -torch.inf)  # mask the padding rows
        s, idx = topk_rows(sims, k_local)
        parts.append((s, torch.where(torch.isfinite(s), idx + shard * rps, -1)))
    return gather_merge(parts, k, q.device)


class FlatIndex:
    """Device-resident exact cosine/IP index over an (N, D) f32 corpus on
    ``device`` (default ``cuda``; raises without a GPU), or row-sharded over
    ``mesh``'s data axis (results on its first entry)."""

    def __init__(
        self,
        vectors: np.ndarray,
        ids: np.ndarray | None = None,
        *,
        normalize: bool = True,
        mesh=None,
        device: str | torch.device | None = None,
    ) -> None:
        vecs = np.asarray(vectors, dtype=np.float32)
        self.normalize = bool(normalize)  # persisted by index/auto.py sidecar
        if normalize:
            norms = np.linalg.norm(vecs, axis=1, keepdims=True)
            vecs = vecs / np.maximum(norms, 1e-30)
        self.ids = np.arange(len(vecs), dtype=np.int64) if ids is None else np.asarray(ids, np.int64)
        self._n = len(vecs)
        self._corpus = None  # the row shards, with a mesh
        self.device = mesh.local_devices[0, 0] if mesh is not None and device is None else resolve_device(device)
        if mesh is not None and int(mesh.shape.get("data", 1)) > 1:
            self._corpus = shard_rows(vecs, mesh)  # (N_pad / D, D) a data row
            self._corpus_t = None
        else:
            self._corpus_t = torch.from_numpy(np.ascontiguousarray(vecs)).to(self.device).t()  # (D, N)
        self.dim = vecs.shape[1]

    def __len__(self) -> int:
        return self._n

    def search(self, queries: np.ndarray, k: int = 10) -> tuple[np.ndarray, np.ndarray]:
        """(Q, D) queries -> (scores, ids) of shape (Q, k), score-descending."""
        q = np.asarray(queries, dtype=np.float32)
        norms = np.linalg.norm(q, axis=1, keepdims=True)
        q = q / np.maximum(norms, 1e-30)
        k = min(k, len(self))
        with torch.inference_mode():
            qd = torch.from_numpy(q).to(self.device)
            if self._corpus is not None:
                scores, idx = _sharded_flat_search(self._corpus, self._n, qd, k)
            else:
                scores, idx = _search_kernel(qd, self._corpus_t, k=k)
            scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        return scores, self.ids[idx]


def find_similar(
    index: FlatIndex, query_vec: np.ndarray, *, exclude_id: int, k: int
) -> list[tuple[int, float]]:
    """Top-k (file_id, score) neighbors of one vector, the query excluded —
    the ranking behind `ket ann --similar-to`."""
    scores, nn = index.search(np.asarray(query_vec)[None, :], k=min(k + 1, len(index)))
    out: list[tuple[int, float]] = []
    for score, fid in zip(scores[0].tolist(), nn[0].tolist()):
        if int(fid) == int(exclude_id):
            continue
        out.append((int(fid), float(score)))
        if len(out) >= k:
            break
    return out
