"""ANN benchmark: recall@10 and QPS for IVF-Flat, HNSW, and exact search.

Counterpart of the repository's ``tools/bench_ann.py`` (BASELINE.md metric
2, configs #4). The exact (flat) device search is the ground truth and memory
is reported per structure. Prints one JSON document with per-index
recall@10, build time and query throughput on clustered synthetic
embeddings (default 100k x 512)::

    python -m kobato_eyes_tpu_torch.tools.bench_ann [--device cpu]

Flat and IVF run on ``--device``; HNSW is the host C++ graph. Each timed
window ends with ``torch.cuda.synchronize`` on the card (a search returns
host arrays, so it has finished by then anyway).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from kobato_eyes_tpu_torch.device import resolve_device


def synth_embeddings(n: int, dim: int, n_clusters: int = 1024, seed: int = 0):
    """Clustered unit vectors with dimension-scaled noise.

    Per-coordinate noise must scale ~1/sqrt(dim) or the noise norm swamps the
    unit centers at high dim and the data degenerates to uniform-on-sphere
    (where no ANN structure can work and recall@k is meaningless).
    """
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    noise = 0.35 / np.sqrt(dim)
    assign = rng.integers(0, n_clusters, size=n)
    vecs = centers[assign] + noise * rng.normal(size=(n, dim)).astype(np.float32)
    queries = centers[rng.integers(0, n_clusters, size=256)] + noise * rng.normal(
        size=(256, dim)
    ).astype(np.float32)
    return vecs.astype(np.float32), queries.astype(np.float32)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--n", type=int, default=100_000)
    parser.add_argument("--dim", type=int, default=512)
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--nprobe", type=int, default=16)
    parser.add_argument("--ef", type=int, default=100)
    parser.add_argument("--ef-construction", type=int, default=100)
    parser.add_argument(
        "--skip-hnsw", action="store_true",
        help="device structures only (the single-threaded C++ HNSW build is "
        "the host box's problem, not the engine's — ~30 min at 1M vectors)",
    )
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from kobato_eyes_tpu_torch.bench import synchronize
    from kobato_eyes_tpu_torch.index.flat import FlatIndex
    from kobato_eyes_tpu_torch.index.hnsw import HnswIndex
    from kobato_eyes_tpu_torch.index.ivf import IvfFlatIndex, recall_at_k

    vecs, queries = synth_embeddings(args.n, args.dim)
    report: dict = {
        "metric": f"ann_recall_at_10_{args.n // 1000}k", "n": args.n, "dim": args.dim,
    }

    # exact ground truth (device matmul)
    t0 = time.perf_counter()
    flat = FlatIndex(vecs, device=device)
    synchronize(device)
    flat_build = time.perf_counter() - t0
    flat.search(queries, k=args.k)  # warmup at the full query shape
    t0 = time.perf_counter()
    _, exact_ids = flat.search(queries, k=args.k)
    synchronize(device)
    flat_query_s = time.perf_counter() - t0

    # IVF-Flat (device)
    t0 = time.perf_counter()
    ivf = IvfFlatIndex(vecs, n_clusters=int(np.sqrt(args.n) * 2), device=device)
    synchronize(device)
    ivf_build = time.perf_counter() - t0
    ivf.search(queries, k=args.k, nprobe=args.nprobe)  # warmup, full shape
    t0 = time.perf_counter()
    _, ivf_ids = ivf.search(queries, k=args.k, nprobe=args.nprobe)
    synchronize(device)
    ivf_query_s = time.perf_counter() - t0
    ivf_recall = recall_at_k(ivf_ids, exact_ids, k=args.k)

    # HNSW (native C++)
    hnsw_recall = 0.0
    if not args.skip_hnsw:
        t0 = time.perf_counter()
        hnsw = HnswIndex(dim=args.dim, M=16, ef_construction=args.ef_construction)
        hnsw.add(vecs)
        hnsw_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, hnsw_ids = hnsw.search(queries, k=args.k, ef=args.ef)
        hnsw_query_s = time.perf_counter() - t0
        hnsw_recall = recall_at_k(hnsw_ids, exact_ids, k=args.k)

    nq = len(queries)
    vec_mb = vecs.nbytes / 2**20
    report.update({
        "value": round(max(ivf_recall, hnsw_recall), 4),
        "unit": "recall@10",
        "vs_baseline": 1.0,  # reference stub has no ANN; exact-recall target is 1.0
        "flat": {"build_s": round(flat_build, 2), "qps": round(nq / flat_query_s, 1),
                 "recall": 1.0, "memory_mb": round(vec_mb, 1)},
        "ivf": {"build_s": round(ivf_build, 2), "qps": round(nq / ivf_query_s, 1),
                "recall": round(ivf_recall, 4), "nprobe": args.nprobe,
                "memory_mb": round(vec_mb, 1)},
    })
    if not args.skip_hnsw:
        report["hnsw"] = {
            "build_s": round(hnsw_build, 2), "qps": round(nq / hnsw_query_s, 1),
            "recall": round(hnsw_recall, 4), "ef": args.ef,
            "memory_mb": round(vec_mb * 1.2, 1),
        }
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
