"""IVF-Flat index: k-means coarse quantizer + per-list exact re-rank.

Counterpart of ``kobato_eyes_tpu/index/ivf.py``. Build: Lloyd iterations on
the device (an assignment matmul, then segment sums by ``index_add_``).
Search: one (Q, K) centroid matmul -> top-nprobe lists -> ONE dense (Q, N)
corpus matmul masked to the probed lists -> top-k, with the JAX package's
tie order (``flat.topk_rows``).

``index_add_`` adds with atomics on the card, so centroids can differ in
the last bit from run to run there: a differently rounded quantizer, not a
bug. The ``quantizer=`` seam takes precomputed (centroids, assignments) for
search identity; the port's own training is held by recall.

With ``mesh``, the corpus and its list assignment row-shard over the mesh's
``data`` axis (``flat.shard_rows``). Training runs the Lloyd step on each
shard's real rows and sums the per-shard centroid sums and counts on the
first entry in shard order (the psums GSPMD inserts for the JAX package);
search probes the lists on every shard from the same centroids, takes each
shard's masked top-k and merges the shard-major candidates
(``flat.gather_merge``).

A build records the timers ``ivf.upload`` (the corpus to the device),
``ivf.train`` (the Lloyd steps and the copy of their result) and
``ivf.lists`` (list assembly and its upload).
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from kobato_eyes_tpu_torch.device import resolve_device
from kobato_eyes_tpu_torch.index.flat import gather_merge, shard_rows, topk_rows
from kobato_eyes_tpu_torch.utils.metrics import metrics

logger = logging.getLogger(__name__)


def _lloyd_step(shards: list[torch.Tensor], centroids: torch.Tensor, *, n_clusters: int):
    """One Lloyd step over the corpus's row shards (one on a single device):
    per-shard assignment and partial sums (``index_add_``), summed on the
    centroids' device in shard order, as GSPMD's psums do for the JAX
    package's sharded corpus."""
    sums = counts = None
    assigns = []
    for data in shards:
        assign = torch.argmax(torch.matmul(data, centroids.to(data.device).t()), dim=1)  # first of equal maxima
        part = torch.zeros((n_clusters, data.shape[1]), dtype=data.dtype, device=data.device)
        part = part.index_add_(0, assign, data).to(centroids.device)
        count = torch.bincount(assign, minlength=n_clusters).to(centroids.device, torch.float32)
        sums, counts = (part, count) if sums is None else (sums + part, counts + count)
        assigns.append(assign.to(centroids.device))
    new = sums / torch.clamp(counts, min=1.0)[:, None]
    # empty clusters keep their previous centroid
    new = torch.where(counts[:, None] > 0, new, centroids)
    norms = torch.linalg.vector_norm(new, dim=1, keepdim=True)
    return new / torch.clamp(norms, min=1e-30), torch.cat(assigns)


def kmeans(
    data: np.ndarray,
    n_clusters: int,
    *,
    iters: int = 10,
    seed: int = 0,
    data_dev: torch.Tensor | list[torch.Tensor] | None = None,
    device: str | torch.device | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Spherical k-means on ``device`` (default ``cuda``). Returns
    (centroids, assignments).

    ``data_dev``: an already-uploaded (and normalized) copy of ``data``;
    callers that keep the corpus resident (IvfFlatIndex) pass it so the
    build does not pay a second host-to-device transfer, and it sets the
    device. A list of row shards (in row order, real rows only) trains over
    them, the centroids on the first shard's device."""
    vecs = np.asarray(data, dtype=np.float32)
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(vecs), size=n_clusters, replace=False)
    if data_dev is None:
        norms = np.linalg.norm(vecs, axis=1, keepdims=True)
        vecs = vecs / np.maximum(norms, 1e-30)
        data_dev = torch.from_numpy(vecs).to(resolve_device(device))
        init = vecs[pick]
    else:
        # the caller normalized the resident corpus; normalize only the
        # n_clusters init rows instead of the whole host array again
        init = vecs[pick]
        init = init / np.maximum(np.linalg.norm(init, axis=1, keepdims=True), 1e-30)
    shards = data_dev if isinstance(data_dev, list) else [data_dev]
    cent = torch.from_numpy(np.ascontiguousarray(init)).to(shards[0].device)
    assign = None
    with torch.inference_mode():
        for _ in range(iters):
            cent, assign = _lloyd_step(shards, cent, n_clusters=n_clusters)
        return cent.cpu().numpy(), assign.cpu().numpy()


def _ivf_search_kernel(
    queries: torch.Tensor,  # (Q, D) unit vectors
    centroids: torch.Tensor,  # (L, D) one row per (possibly replica) list
    assign_list: torch.Tensor,  # (N,) int64 list id of each corpus row
    corpus: torch.Tensor,  # (N, D)
    *,
    nprobe: int,
    k: int,
):
    """Probe top-nprobe lists, then ONE (Q, N) corpus matmul masked to them:
    eligibility (only probed lists compete, the defining IVF semantic) is a
    mask on the full score matrix, as in the JAX package."""
    cs = torch.matmul(queries, centroids.t())
    _, probe = topk_rows(cs, nprobe)  # (Q, nprobe)
    allowed = torch.zeros((queries.shape[0], centroids.shape[0]), dtype=torch.bool, device=queries.device)
    allowed.scatter_(1, probe, True)
    scores = torch.matmul(queries, corpus.t())
    scores = torch.where(allowed[:, assign_list], scores, -torch.inf)  # (Q, N)
    top_s, rows = topk_rows(scores, k)
    rows = torch.where(torch.isfinite(top_s), rows, -1)
    return top_s, rows


def _sharded_ivf_search(
    shards: list[torch.Tensor], assign_shards: list[torch.Tensor], centroids: list[torch.Tensor], n: int,
    q: torch.Tensor, *, nprobe: int, k: int,
):
    """Row-sharded IVF search: per-shard masked matmul + top-k, gathered
    merge. The coarse probe (queries x centroids) is tiny and recomputed on
    every shard from its copy of the centroids."""
    rps = shards[0].shape[0]
    k_local = min(k, rps)
    parts = []
    for shard, (corpus_local, assign_local, cents) in enumerate(zip(shards, assign_shards, centroids)):
        qd = q.to(corpus_local.device)
        _, probe = topk_rows(torch.matmul(qd, cents.t()), nprobe)
        allowed = torch.zeros((qd.shape[0], cents.shape[0]), dtype=torch.bool, device=qd.device)
        allowed.scatter_(1, probe, True)
        sims = torch.matmul(qd, corpus_local.t())  # (Q, rps)
        col = torch.arange(rps, device=qd.device) + shard * rps
        sims = torch.where(allowed[:, assign_local] & (col < n), sims, -torch.inf)
        s, idx = topk_rows(sims, k_local)
        parts.append((s, torch.where(torch.isfinite(s), idx + shard * rps, -1)))
    top_s, rows = gather_merge(parts, k, q.device)
    return top_s, torch.where(torch.isfinite(top_s), rows, -1)


class IvfFlatIndex:
    """Inverted-file flat index over unit vectors (cosine / inner product),
    its corpus resident on ``device`` (default ``cuda``), or row-sharded over
    ``mesh``'s data axis (results on its first entry)."""

    def __init__(
        self,
        vectors: np.ndarray,
        ids: np.ndarray | None = None,
        *,
        n_clusters: int | None = None,
        train_iters: int = 10,
        seed: int = 0,
        max_list_pad: int | None = None,
        mesh=None,
        quantizer: tuple[np.ndarray, np.ndarray] | None = None,  # (centroids, assign)
        device: str | torch.device | None = None,
    ) -> None:
        vecs = np.asarray(vectors, dtype=np.float32)
        norms = np.linalg.norm(vecs, axis=1, keepdims=True)
        vecs = vecs / np.maximum(norms, 1e-30)
        n = len(vecs)
        self.ids = np.arange(n, dtype=np.int64) if ids is None else np.asarray(ids, np.int64)
        if n_clusters is None:
            n_clusters = max(1, int(np.sqrt(n)))
        n_clusters = min(n_clusters, n)
        self.n_clusters = n_clusters
        self.device = mesh.local_devices[0, 0] if mesh is not None and device is None else resolve_device(device)
        self._mesh = mesh if mesh is not None and int(mesh.shape.get("data", 1)) > 1 else None
        with metrics.timer("ivf.upload"):
            if self._mesh is not None:
                corpus_dev = shard_rows(vecs, self._mesh)  # one upload, reused by the search
                rps = corpus_dev[0].shape[0]
                # train on the REAL rows: zero padding rows would all assign to
                # one cluster and drag its centroid toward zero
                train_dev = [c[: max(0, min(rps, n - s * rps))] for s, c in enumerate(corpus_dev)]
            else:
                corpus_dev = torch.from_numpy(vecs).to(self.device)  # one upload, reused by the search
                train_dev = corpus_dev
        if quantizer is not None:
            # precomputed (centroids, assignments): index restore, or a
            # quantizer trained elsewhere when search identity is asserted
            centroids, assign = quantizer
            centroids = np.asarray(centroids, dtype=np.float32)
            assign = np.asarray(assign)
        else:
            with metrics.timer("ivf.train"):
                centroids, assign = kmeans(
                    vecs, n_clusters, iters=train_iters, seed=seed, data_dev=train_dev
                )
        t_lists = time.perf_counter()
        counts = np.bincount(assign, minlength=n_clusters)
        pad = int(counts.max()) if max_list_pad is None else min(int(counts.max()), max_list_pad)
        pad = max(pad, 1)
        # Skewed k-means must not lose vectors: lists larger than the pad are
        # SPLIT into replica lists sharing the centroid (bounded memory, no
        # silent recall loss).
        n_lists_per = np.maximum(1, np.ceil(counts / pad).astype(np.int64))
        n_lists = int(n_lists_per.sum())
        members = np.full((n_lists, pad), -1, dtype=np.int32)
        list_cluster = np.empty(n_lists, dtype=np.int64)
        order = np.argsort(assign, kind="stable")
        starts = np.concatenate([[0], np.cumsum(counts)])
        li = 0
        for c in range(n_clusters):
            rows = order[starts[c] : starts[c + 1]]
            if len(rows) == 0:
                list_cluster[li] = c
                li += 1
                continue
            for off in range(0, len(rows), pad):
                chunk = rows[off : off + pad]
                members[li, : len(chunk)] = chunk
                list_cluster[li] = c
                li += 1
        assert li == n_lists
        n_split = n_lists - n_clusters
        if n_split:
            logger.info(
                "ivf: %d oversized lists split into replicas (pad=%d, lists=%d)",
                n_split, pad, n_lists,
            )

        # row -> list id (replica-aware; every row is in exactly one list)
        assign_list = np.empty(n, dtype=np.int64)
        for li_, row_chunk in enumerate(members):
            valid_rows = row_chunk[row_chunk >= 0]
            assign_list[valid_rows] = li_

        self.n_lists = n_lists
        self._n = n
        list_centroids = np.ascontiguousarray(centroids[list_cluster])
        if self._mesh is not None:
            rows = self._mesh.local_devices[:, 0]
            self._centroids = [torch.from_numpy(list_centroids).to(dev) for dev in rows]
            # padding rows take list 0; the search masks them by position
            self._assign_list = [a.view(-1) for a in shard_rows(assign_list[:, None], self._mesh)]
        else:
            self._centroids = torch.from_numpy(list_centroids).to(self.device)
            self._assign_list = torch.from_numpy(assign_list).to(self.device)
        metrics.observe("ivf.lists", time.perf_counter() - t_lists)
        # host-only: the search reads assign_list, not the member table
        self._members = members
        self._corpus = corpus_dev
        self.dim = vecs.shape[1]

    def __len__(self) -> int:
        return self._n

    def search(
        self, queries: np.ndarray, k: int = 10, *, nprobe: int = 8
    ) -> tuple[np.ndarray, np.ndarray]:
        q = np.asarray(queries, dtype=np.float32)
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
        nprobe = min(nprobe, self.n_lists)
        k = min(k, len(self))
        with torch.inference_mode():
            qd = torch.from_numpy(q).to(self.device)
            if self._mesh is not None:
                scores, rows = _sharded_ivf_search(
                    self._corpus, self._assign_list, self._centroids, self._n, qd, nprobe=nprobe, k=k,
                )
            else:
                scores, rows = _ivf_search_kernel(
                    qd, self._centroids, self._assign_list, self._corpus, nprobe=nprobe, k=k,
                )
            rows, scores = rows.cpu().numpy(), scores.cpu().numpy()
        ids = np.where(rows >= 0, self.ids[np.maximum(rows, 0)], -1)
        return scores, ids


def recall_at_k(
    approx_ids: np.ndarray, exact_ids: np.ndarray, k: int = 10
) -> float:
    """Mean overlap@k between an ANN result and the exact result."""
    hits = 0
    total = 0
    for a, e in zip(approx_ids, exact_ids):
        truth = set(int(x) for x in e[:k])
        hits += len(truth & set(int(x) for x in a[:k]))
        total += len(truth)
    return hits / max(total, 1)
