"""Banded Hamming candidate scan: host C++ band scan or the resident device scan.

Counterpart of the production scan of ``kobato_eyes_tpu/ops/hamming.py``.
The candidate predicate is the reference's LSH bucket loop
(``src/dup/scanner.py:227-298``): two hashes are an edge iff they share a
band slice in a bucket under the pair cap, their Hamming distance is at most
the threshold and (optionally) their sizes pass the ratio filter. The edge
set, and therefore the DSU clusters, is identical to the reference's.

Populations up to ``host_scan_max`` (``KET_DUP_HOST_SCAN_MAX``, 262144 by
default, or ``probe``: the crossover :func:`probe_crossover` measures on
this host and device) run the host scan (``native/hamming_scan.cpp``, numpy
spec beside it). Larger ones keep the hashes resident on the device: per
band, sort by band key so buckets become runs, then compare each sorted row
with the next ``window`` rows as dense shifted compares that write a per-row
bitmask; the host expands the bitmask to pairs. Oversized buckets (runs
longer than the capped window) take an exact host pass. With a ``mesh``
whose data axis is above 1, the windowed compare shards over its data rows
(``parallel/sharded_scan.py``) at every population size.

Beside the production scan, the JAX module's other scans: the dense
all-pairs :func:`edge_scan` (row blocks against every column, with the
optional size and cosine filters) and :func:`edge_scan_banded` (the windowed
compare as a gather with an edge cap and retry), both held to
:func:`edge_scan_np`.

The device functions here are plain torch tensor code, not kernels. Torch
has no popcount and its unsigned types lack shifts, so the resident
population is the uint64 hashes viewed as int64, and the popcount is a SWAR
over 32-bit halves held in int64 (``>>`` on int64 is arithmetic: every shift
is masked). The host-side functions are the JAX module's numpy, unchanged.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from kobato_eyes_tpu_torch.device import resolve_device
from kobato_eyes_tpu_torch.utils.bits import popcount64_np, u32pair_to_u64, u64_to_u32pair

logger = logging.getLogger(__name__)

_LO32 = 0xFFFFFFFF


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 values in [0, 2^32); no step overflows int64."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def split_halves(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 (uint64 bits) -> its (hi, lo) 32-bit halves as int64 in [0, 2^32)."""
    return (x >> 32) & _LO32, x & _LO32


def band_keys_np(ph_u64: np.ndarray, band_bits: int, band_count: int) -> np.ndarray:
    """(N,) uint64 -> (N, band_count) band keys (scanner.py:227-233 layout)."""
    if band_bits * band_count > 64:
        raise ValueError("band config too large")
    mask = np.uint64((1 << band_bits) - 1)
    keys = np.empty((ph_u64.shape[0], band_count), dtype=np.uint64)
    for b in range(band_count):
        keys[:, b] = (ph_u64 >> np.uint64(b * band_bits)) & mask
    return keys


def bucket_ok_np(keys: np.ndarray, pair_cap: int | None) -> np.ndarray:
    """Per-(file, band) mask: False when the bucket's pair count exceeds cap.

    Mirrors scanner.py:265-267 (skip whole bucket when
    len*(len-1)/2 > KE_DUP_BUCKET_PAIR_CAP).
    """
    n, bands = keys.shape
    ok = np.ones((n, bands), dtype=bool)
    if pair_cap is None:
        return ok
    for b in range(bands):
        _, inverse, counts = np.unique(keys[:, b], return_inverse=True, return_counts=True)
        sizes = counts[inverse]
        pair_counts = sizes.astype(np.int64) * (sizes.astype(np.int64) - 1) // 2
        ok[:, b] = pair_counts <= pair_cap
    return ok


def _stable_band_argsort(kb: np.ndarray) -> np.ndarray:
    """Stable argsort of one band's keys, picking the fastest exact kernel.

    uint16 keys hit numpy's radix sort (~10x quicksort at 70k); wider bands
    pack (key << 32 | index) into uint64 so the default quicksort IS the
    stable order.  Both are exact — order only matters up to run grouping
    (equal keys must be contiguous), but stability keeps the order
    deterministic across paths.
    """
    if kb.size and int(kb.max()) < (1 << 16):
        return np.argsort(kb.astype(np.uint16), kind="stable").astype(np.int64)
    packed = (kb.astype(np.uint64) << np.uint64(32)) | np.arange(
        kb.shape[0], dtype=np.uint64
    )
    return np.argsort(packed).astype(np.int64)


def _host_band_pairs(
    kb: np.ndarray, ok_b: np.ndarray | None, *, d_limit: int = 256
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """All intra-bucket pairs of one band, vectorized on host.

    Runs of equal keys in the band-sorted order are the LSH buckets; the
    d-loop emits every within-run pair at sorted distance d (runs of length
    <= d_limit+1), and pathologically large runs fall back to an exact
    per-run all-pairs block — the same split the device path makes between
    the windowed bitmask kernel and its oversized-bucket fallback.
    """
    n = kb.shape[0]
    out_i: list[np.ndarray] = []
    out_j: list[np.ndarray] = []
    if n < 2:
        return out_i, out_j
    order = _stable_band_argsort(kb)
    sk = kb[order]
    bounds = np.flatnonzero(sk[1:] != sk[:-1])
    starts = np.concatenate(([0], bounds + 1))
    ends = np.concatenate((bounds + 1, [n]))
    lens = ends - starts
    max_run = int(lens.max())
    okk = ok_b[order] if ok_b is not None else None
    D = min(max_run - 1, d_limit)
    if D > 0:
        if max_run - 1 > d_limit:
            small = np.repeat(lens <= d_limit + 1, lens)
            base = small if okk is None else (small & okk)
        else:
            base = okk  # no oversized runs: skip the run-length expansion
        for d in range(1, D + 1):
            m = sk[:-d] == sk[d:]
            if base is not None:
                m &= base[:-d]
            if okk is not None:
                m &= okk[d:]
            p = np.flatnonzero(m)
            if p.size:
                out_i.append(order[p])
                out_j.append(order[p + d])
    for r in np.flatnonzero(lens - 1 > d_limit):
        members = order[starts[r] : ends[r]]
        if ok_b is not None:
            members = members[ok_b[members]]
        m = members.shape[0]
        if m < 2:
            continue
        iu = np.triu_indices(m, k=1)
        out_i.append(members[iu[0]])
        out_j.append(members[iu[1]])
    return out_i, out_j


_NATIVE_SCAN_UNAVAILABLE = False
_CROSSOVER_PROBE: dict | None = None


def probe_crossover(n_probe: int = 20000, seed: int = 0, device=None) -> dict:
    """Measure THIS host and device's host/device dup-scan crossover, once.

    The static ``KET_DUP_HOST_SCAN_MAX`` default encodes the transfer
    economics of one machine; this probe times the host band scan at
    ``n_probe`` hashes and the device round-trip costs on ``device``
    (default ``cuda``): upload bandwidth and the round trip of one tiny op,
    and derives the population where the device path starts winning:
    host_cost(n) ~= a*n vs device_cost(n) ~= b*n + c.

    Cached per process. ``KET_DUP_HOST_SCAN_MAX=probe`` makes scanners use
    the derived value.
    """
    global _CROSSOVER_PROBE
    if _CROSSOVER_PROBE is not None:
        return _CROSSOVER_PROBE
    import time

    device = resolve_device(device)

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rng = np.random.default_rng(seed)
    ph = rng.integers(0, 1 << 63, size=n_probe).astype(np.uint64)

    # host side: min of 3 (first call may pay the native build)
    host_s = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        host_window_scan(ph, band_bits=16, band_count=4, hamming_threshold=8)
        host_s = min(host_s, time.perf_counter() - t0)
    a = host_s / n_probe  # s/item, host

    # device side: round trip of a tiny op (its result read back) + upload
    tiny = torch.zeros(8, dtype=torch.int32, device=device)
    (tiny + 1).cpu()  # warm
    t0 = time.perf_counter()
    for _ in range(3):
        (tiny + 1).cpu()
    rtt = (time.perf_counter() - t0) / 3

    host = torch.from_numpy(ph.view(np.int64))
    host.to(device)  # warm the transfer path
    sync()
    t0 = time.perf_counter()
    host.to(device)
    sync()
    upload_s = time.perf_counter() - t0
    b = upload_s / n_probe  # s/item, device transfer
    # device fixed cost: a handful of round trips per scan
    c = 6 * rtt

    if a > b:
        derived = int(c / (a - b))
    else:
        derived = 1 << 22  # transfers never win at sane sizes: keep host
    derived = max(4096, min(derived, 1 << 22))
    _CROSSOVER_PROBE = {
        "derived_host_scan_max": derived,
        "host_s_per_item": a,
        "device_s_per_item": b,
        "device_rtt_s": rtt,
        "upload_mb_per_s": (n_probe * 8 / 1e6) / max(upload_s, 1e-9),
        "n_probe": n_probe,
    }
    return _CROSSOVER_PROBE


def _native_band_scan(
    ph_u64: np.ndarray,
    *,
    band_bits: int,
    band_count: int,
    hamming_threshold: int,
    sizes: np.ndarray | None,
    size_ratio: float | None,
    bucket_pair_cap: int | None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """C++ band scan (native/hamming_scan.cpp); None -> use the numpy spec.

    Same edge set/order by construction, fuzz-pinned against the numpy path
    (tests/ops/test_hamming_native.py).  Falls back silently on a
    toolchain-less host or populations past int32 indexing.
    """
    global _NATIVE_SCAN_UNAVAILABLE
    if _NATIVE_SCAN_UNAVAILABLE or ph_u64.shape[0] > 0x7FFFFFFF:
        return None
    try:
        from kobato_eyes_tpu_torch.native.build import load_extension_module

        mod = load_extension_module("hamming_scan")
    except Exception:
        _NATIVE_SCAN_UNAVAILABLE = True
        logger.debug("native band scan unavailable; numpy fallback", exc_info=True)
        return None
    use_size = size_ratio is not None and size_ratio > 0 and sizes is not None
    sizes64 = (
        np.ascontiguousarray(sizes, dtype=np.float64) if use_size else None
    )
    ei_b, ej_b, d_b = mod.band_scan(
        np.ascontiguousarray(ph_u64, dtype=np.uint64),
        int(band_bits),
        int(band_count),
        int(hamming_threshold),
        -1 if bucket_pair_cap is None else int(bucket_pair_cap),
        sizes64 if sizes64 is not None else None,
        float(size_ratio) if use_size else 0.0,
    )
    return (
        np.frombuffer(ei_b, dtype=np.int64),
        np.frombuffer(ej_b, dtype=np.int64),
        np.frombuffer(d_b, dtype=np.int64),
    )


def host_window_scan(
    ph_u64: np.ndarray,
    *,
    band_bits: int,
    band_count: int,
    hamming_threshold: int,
    sizes: np.ndarray | None = None,
    size_ratio: float | None = None,
    bucket_pair_cap: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized host candidate scan — same edge set as the device path.

    At small populations the device path's upload and sort cost more than
    the entire vectorized host scan, so the scanner routes
    n <= host_scan_max here.  Semantics are identical: band keys,
    intra-bucket pairs, pair cap, Hamming threshold, exact f64 size-ratio.
    """
    empty = (np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.int64))
    n = ph_u64.shape[0]
    if n < 2:
        return empty
    native = _native_band_scan(
        ph_u64,
        band_bits=band_bits,
        band_count=band_count,
        hamming_threshold=hamming_threshold,
        sizes=sizes,
        size_ratio=size_ratio,
        bucket_pair_cap=bucket_pair_cap,
    )
    if native is not None:
        return native
    keys = band_keys_np(ph_u64, band_bits, band_count)
    ok = bucket_ok_np(keys, bucket_pair_cap) if bucket_pair_cap is not None else None
    out_i: list[np.ndarray] = []
    out_j: list[np.ndarray] = []
    for b in range(band_count):
        pi, pj = _host_band_pairs(keys[:, b], ok[:, b] if ok is not None else None)
        out_i.extend(pi)
        out_j.extend(pj)
    if not out_i:
        return empty
    gi = np.concatenate(out_i)
    gj = np.concatenate(out_j)
    lo = np.minimum(gi, gj)
    hi = np.maximum(gi, gj)
    # dedup WITHOUT return_index (which forces a slow stable sort): (lo, hi)
    # is recoverable from the packed key, and duplicates are exact duplicates
    key_u = np.unique(lo * np.int64(n) + hi)
    ei = key_u // np.int64(n)
    ej = key_u - ei * np.int64(n)
    dist = popcount64_np(ph_u64[ei] ^ ph_u64[ej]).astype(np.int64)
    keep = dist <= hamming_threshold
    if size_ratio is not None and size_ratio > 0 and sizes is not None:
        keep &= _exact_size_ratio_keep(ei, ej, sizes.astype(np.float64), float(size_ratio))
    return ei[keep].astype(np.int64), ej[keep].astype(np.int64), dist[keep]


def _exact_size_ratio_keep(
    ei: np.ndarray, ej: np.ndarray, sizes64: np.ndarray, size_ratio: float
) -> np.ndarray:
    """Exact f64 re-check of the reference's _passes_size_ratio on an edge list."""
    s_i = sizes64[ei]
    s_j = sizes64[ej]
    smaller = np.minimum(s_i, s_j)
    larger = np.maximum(s_i, s_j)
    return (smaller <= 0) | (smaller / np.maximum(larger, 1.0) >= size_ratio)


# The device filters compare sizes in f32 (sizes > 2^24 bytes quantize),
# while the reference and edge_scan_np compare in f64. Device filters
# therefore run with the threshold relaxed by this margin (so f32 rounding
# can never DROP a pair the exact check keeps) and the surviving edge list —
# tiny after Hamming pruning — is re-checked on host in exact f64.
_SIZE_RATIO_F32_SLACK = 1e-5


def _pairs_halves(ph_pairs: np.ndarray, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, 2) uint32 [hi, lo] pairs -> their halves as int64 tensors on ``device``."""
    pairs = torch.from_numpy(np.ascontiguousarray(ph_pairs, dtype=np.int64)).to(device)
    return pairs[:, 0], pairs[:, 1]


def _size_ok(si: torch.Tensor, sj: torch.Tensor, size_ratio: float) -> torch.Tensor:
    """The reference's ratio filter in f32 (unknown/zero sizes pass)."""
    smaller = torch.minimum(si, sj)
    larger = torch.maximum(si, sj)
    return (smaller <= 0) | (smaller / torch.clamp_min(larger, 1.0) >= size_ratio)


def _edge_scan_block(
    hi: torch.Tensor,  # (N,) int64 high 32 bits
    lo: torch.Tensor,  # (N,) int64 low 32 bits
    keys: torch.Tensor,  # (N, B) int64 band keys (band_bits <= 32)
    ok: torch.Tensor,  # (N, B) bool bucket-cap mask
    sizes: torch.Tensor,  # (N,) float32 file sizes (0 = unknown)
    emb: torch.Tensor,  # (N, D) float32 L2-normalized embeddings (D=1 dummy when unused)
    emb_valid: torch.Tensor,  # (N,) bool
    row_start: int,
    hamming_threshold: int,
    size_ratio: float,  # already an f32 value
    cosine_threshold: float,  # already an f32 value
    *,
    block: int,
    max_edges: int,
    use_size: bool,
    use_cosine: bool,
):
    """Scan rows [row_start, row_start+block) against all columns.

    Returns (rows_local, cols, dists, n_edges): index tensors of shape
    (max_edges,) padded with -1, plus the true edge count (for overflow
    detection by the caller).
    """
    n = hi.shape[0]
    rows = slice(row_start, row_start + block)
    dist = popcount32(hi[rows, None] ^ hi[None, :]) + popcount32(lo[rows, None] ^ lo[None, :])
    # LSH band parity: candidate iff any band slice matches within an
    # un-capped bucket (both sides share the bucket, so one mask suffices)
    band_hit = ((keys[rows, None, :] == keys[None, :, :]) & ok[rows, None, :]).any(dim=-1)
    edge = band_hit & (dist <= hamming_threshold)
    if use_size:
        edge &= _size_ok(sizes[rows, None], sizes[None, :], size_ratio)
    if use_cosine:
        cos = torch.matmul(emb[rows], emb.t())
        # reference semantics: missing/zero-norm embeddings pass the filter
        both_valid = emb_valid[rows, None] & emb_valid[None, :]
        edge &= ~both_valid | (cos >= cosine_threshold)
    # upper triangle in global coordinates: j > i
    gi = row_start + torch.arange(block, device=hi.device)[:, None]
    gj = torch.arange(n, device=hi.device)[None, :]
    edge &= gj > gi

    n_edges = int(edge.sum())
    r_hit, c_hit = torch.nonzero(edge, as_tuple=True)  # row-major, as jnp.nonzero
    keep = min(n_edges, max_edges)
    rows_local = torch.full((max_edges,), -1, dtype=torch.int64, device=hi.device)
    cols = torch.full_like(rows_local, -1)
    dists = torch.full_like(rows_local, -1)
    rows_local[:keep] = r_hit[:keep]
    cols[:keep] = c_hit[:keep]
    dists[:keep] = dist[r_hit[:keep], c_hit[:keep]]
    return rows_local, cols, dists, n_edges


def edge_scan(
    ph_pairs: np.ndarray,
    keys_u64: np.ndarray,
    bucket_ok: np.ndarray,
    *,
    hamming_threshold: int,
    sizes: np.ndarray | None = None,
    size_ratio: float | None = None,
    embeddings: np.ndarray | None = None,
    cosine_threshold: float | None = None,
    block: int = 1024,
    max_edges_per_block: int | None = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full (dense, all-pairs) candidate scan on ``device`` (default
    ``cuda``). Returns (i, j, dist) with i < j, deduplicated.

    ``keys_u64`` must have band_bits <= 32 values (the default config is 16);
    wider single-band configs should use exact-hash grouping instead.
    """
    n = ph_pairs.shape[0]
    if n < 2:
        return (np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.int64))
    if np.any(keys_u64 > 0xFFFFFFFF):
        raise ValueError("band keys wider than 32 bits are not supported on device")
    device = resolve_device(device)

    block = min(block, n)
    use_size = size_ratio is not None and size_ratio > 0
    use_cosine = embeddings is not None and cosine_threshold is not None

    hi, lo = _pairs_halves(ph_pairs, device)
    keys_dev = torch.from_numpy(np.ascontiguousarray(keys_u64, dtype=np.int64)).to(device)
    ok_dev = torch.from_numpy(np.ascontiguousarray(bucket_ok, dtype=bool)).to(device)
    sizes_dev = torch.from_numpy(
        (sizes if sizes is not None else np.zeros(n)).astype(np.float32)
    ).to(device)
    if use_cosine:
        emb = np.asarray(embeddings, dtype=np.float32)
        norms = np.linalg.norm(emb, axis=1)
        valid = norms > 0
        emb = np.where(valid[:, None], emb / np.maximum(norms, 1e-30)[:, None], 0.0).astype(np.float32)
        emb_dev = torch.from_numpy(emb).to(device)
        valid_dev = torch.from_numpy(valid).to(device)
    else:
        emb_dev = torch.zeros((n, 1), dtype=torch.float32, device=device)
        valid_dev = torch.zeros(n, dtype=torch.bool, device=device)

    if max_edges_per_block is None:
        max_edges_per_block = max(4096, block * 64)

    out_i: list[np.ndarray] = []
    out_j: list[np.ndarray] = []
    out_d: list[np.ndarray] = []
    ratio = float(np.float32((size_ratio or 0.0) * (1.0 - _SIZE_RATIO_F32_SLACK)))
    cos_thr = float(np.float32(cosine_threshold if cosine_threshold is not None else -2.0))
    sizes64 = (sizes if sizes is not None else np.zeros(n)).astype(np.float64)

    with torch.inference_mode():
        for start in range(0, n, block):
            # ragged tail: shift the window back so the block shape stays
            # fixed; the re-scanned rows would re-emit their edges, so they
            # are dropped explicitly
            actual_start = min(start, n - block)
            overlap = start - actual_start
            cap = max_edges_per_block
            while True:
                rows_l, cols, dists, count = _edge_scan_block(
                    hi, lo, keys_dev, ok_dev, sizes_dev, emb_dev, valid_dev,
                    actual_start, int(hamming_threshold), ratio, cos_thr,
                    block=block, max_edges=cap, use_size=use_size, use_cosine=use_cosine,
                )
                if count <= cap:
                    break
                cap = int(2 ** np.ceil(np.log2(count + 1)))
            rows_l = rows_l[:count].cpu().numpy()
            cols = cols[:count].cpu().numpy()
            dists = dists[:count].cpu().numpy()
            keep = rows_l >= overlap
            out_i.append(actual_start + rows_l[keep].astype(np.int64))
            out_j.append(cols[keep].astype(np.int64))
            out_d.append(dists[keep].astype(np.int64))

    if not out_i:
        return (np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.int64))
    ei = np.concatenate(out_i)
    ej = np.concatenate(out_j)
    ed = np.concatenate(out_d)
    if use_size:
        keep = _exact_size_ratio_keep(ei, ej, sizes64, float(size_ratio))
        ei, ej, ed = ei[keep], ej[keep], ed[keep]
    return ei, ej, ed


# ---------------------------------------------------------------------------
# banded windowed scan (gather formulation)
# ---------------------------------------------------------------------------
#
# The dense scan above evaluates all N^2 pairs; the reference only ever
# touches pairs that share an LSH bucket. Per band, sort by band key so
# buckets become contiguous runs, then compare each row only against the
# next W sorted rows (W >= the largest run; rare oversized buckets fall back
# to an exact per-bucket host pass): O(N * W * bands) work, the same edge
# set as the reference's bucket loops.


def _windowed_scan_bands(
    sk: torch.Tensor,  # (B, N) int64 sorted band keys
    shi: torch.Tensor,  # (B, N) int64 high 32 bits of the hashes in per-band sorted order
    slo: torch.Tensor,  # (B, N) int64 low 32 bits
    sok: torch.Tensor,  # (B, N) bool bucket-cap mask in sorted order
    ssz: torch.Tensor,  # (B, N) float32 sizes in sorted order
    hamming_threshold: int,
    size_ratio: float,  # already an f32 value
    *,
    window: int,
    max_edges: int,
    use_size: bool,
):
    """Compare row i against rows i+1..i+window where band keys match, all
    bands in one pass.

    Returns (band, i_sorted, j_sorted, dist, n_edges), padded with -1.
    """
    nb, n = sk.shape
    dev = sk.device
    col = torch.arange(n, device=dev)[None, :]
    dd = torch.arange(1, window + 1, device=dev)[:, None]
    jj = col + dd  # (window, N)
    valid = jj < n
    jjc = torch.clamp_max(jj, n - 1).expand(nb, window, n)

    def gather(arr: torch.Tensor) -> torch.Tensor:
        return torch.gather(arr[:, None, :].expand(nb, window, n), 2, jjc)

    eq = (sk[:, None, :] == gather(sk)) & valid
    eq &= sok[:, None, :] & gather(sok)
    dist = popcount32(shi[:, None, :] ^ gather(shi)) + popcount32(slo[:, None, :] ^ gather(slo))
    mask = eq & (dist <= hamming_threshold)
    if use_size:
        mask &= _size_ok(ssz[:, None, :], gather(ssz), size_ratio)

    n_edges = int(mask.sum())
    b_hit, w_hit, i_hit = torch.nonzero(mask, as_tuple=True)  # row-major, as jnp.nonzero
    keep = min(n_edges, max_edges)
    out = torch.full((4, max_edges), -1, dtype=torch.int64, device=dev)
    out[0, :keep] = b_hit[:keep]
    out[1, :keep] = i_hit[:keep]
    out[2, :keep] = i_hit[:keep] + w_hit[:keep] + 1
    out[3, :keep] = dist[b_hit[:keep], w_hit[:keep], i_hit[:keep]]
    return out[0], out[1], out[2], out[3], n_edges


def _run_lengths(sorted_keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Starts and lengths of equal-key runs in a sorted array."""
    n = sorted_keys.shape[0]
    boundaries = np.nonzero(np.diff(sorted_keys))[0] + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [n]])
    return starts, ends - starts


def _oversized_bucket_edges(
    members_by_band,
    ph64: np.ndarray,
    hamming_threshold: int,
    sizes64: np.ndarray,
    size_ratio: float | None,
    use_size: bool,
) -> tuple[list[np.ndarray], list[np.ndarray], list[np.ndarray]]:
    """Exact host all-pairs over each oversized bucket's members."""
    out_i: list[np.ndarray] = []
    out_j: list[np.ndarray] = []
    out_d: list[np.ndarray] = []
    for members in members_by_band:
        m = members.shape[0]
        if m < 2:
            continue
        h = ph64[members]
        dist = popcount64_np(h[:, None] ^ h[None, :]).astype(np.int64)
        mask = dist <= hamming_threshold
        if use_size:
            s = sizes64[members]
            smaller = np.minimum(s[:, None], s[None, :])
            larger = np.maximum(s[:, None], s[None, :])
            mask &= (smaller <= 0) | (smaller / np.maximum(larger, 1.0) >= size_ratio)
        iu = np.triu_indices(m, k=1)
        sel = mask[iu]
        out_i.append(members[iu[0][sel]].astype(np.int64))
        out_j.append(members[iu[1][sel]].astype(np.int64))
        out_d.append(dist[iu][sel])
    return out_i, out_j, out_d


def edge_scan_banded(
    ph_pairs: np.ndarray,
    keys_u64: np.ndarray,
    bucket_ok: np.ndarray,
    *,
    hamming_threshold: int,
    sizes: np.ndarray | None = None,
    size_ratio: float | None = None,
    max_window: int = 256,
    max_edges_hint: int = 1 << 16,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """LSH-pruned candidate scan on ``device`` (default ``cuda``). Returns
    deduplicated (i, j, dist), i < j.

    Identical edge set to :func:`edge_scan_np` / the reference bucket loops.
    Cosine filtering is not applied here (callers with embeddings post-filter
    the edge list — it is tiny after Hamming pruning).
    """
    n = ph_pairs.shape[0]
    if n < 2:
        return (np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.int64))
    device = resolve_device(device)
    bands = keys_u64.shape[1]
    use_size = size_ratio is not None and size_ratio > 0 and sizes is not None
    sizes64 = (sizes if sizes is not None else np.zeros(n)).astype(np.float64)
    sizes_f = sizes64.astype(np.float32)
    ph64 = u32pair_to_u64(ph_pairs)
    ratio = float(np.float32((size_ratio or 0.0) * (1.0 - _SIZE_RATIO_F32_SLACK)))

    out_i: list[np.ndarray] = []
    out_j: list[np.ndarray] = []
    out_d: list[np.ndarray] = []

    # per-band sort on host (cheap), then one device pass for the windowed
    # compare across all bands
    orders = np.empty((bands, n), dtype=np.int64)
    sks = np.empty((bands, n), dtype=np.uint32)
    windows = []
    runs_by_band = []
    for b in range(bands):
        keys_b = keys_u64[:, b].astype(np.uint32)
        order = np.argsort(keys_b, kind="stable")
        orders[b] = order
        sks[b] = keys_b[order]
        starts, lengths = _run_lengths(sks[b])
        runs_by_band.append((starts, lengths))
        max_run = int(lengths.max()) if lengths.size else 1
        windows.append(min(max_run - 1, max_window, n - 1))
    window = max(windows)
    if window > 0:
        # round up to a power of two (>= 8): extra rows are masked by the
        # key-equality check, and a bounded set of window sizes keeps the
        # shapes few
        window = min(max(8, int(2 ** np.ceil(np.log2(window)))), max_window, n - 1)

    if window > 0:
        sph = ph_pairs[orders].astype(np.int64)  # (B, N, 2)
        sok = np.take_along_axis(bucket_ok.T, orders, axis=1)  # (B, N)
        ssz = sizes_f[orders]
        with torch.inference_mode():
            sk_dev = torch.from_numpy(sks.astype(np.int64)).to(device)
            shi = torch.from_numpy(np.ascontiguousarray(sph[..., 0])).to(device)
            slo = torch.from_numpy(np.ascontiguousarray(sph[..., 1])).to(device)
            sok_dev = torch.from_numpy(np.ascontiguousarray(sok)).to(device)
            ssz_dev = torch.from_numpy(np.ascontiguousarray(ssz)).to(device)
            cap = max(max_edges_hint, 4096)
            while True:
                b_s, i_s, j_s, d_s, count = _windowed_scan_bands(
                    sk_dev, shi, slo, sok_dev, ssz_dev, int(hamming_threshold), ratio,
                    window=window, max_edges=cap, use_size=use_size,
                )
                if count <= cap:
                    break
                cap = int(2 ** np.ceil(np.log2(count + 1)))
            b_s = b_s[:count].cpu().numpy()
            i_s = i_s[:count].cpu().numpy()
            j_s = j_s[:count].cpu().numpy()
            d_s = d_s[:count].cpu().numpy()
        gi = orders[b_s, i_s]
        gj = orders[b_s, j_s]
        ei_w = np.minimum(gi, gj).astype(np.int64)
        ej_w = np.maximum(gi, gj).astype(np.int64)
        ed_w = d_s.astype(np.int64)
        if use_size:
            keep = _exact_size_ratio_keep(ei_w, ej_w, sizes64, float(size_ratio))
            ei_w, ej_w, ed_w = ei_w[keep], ej_w[keep], ed_w[keep]
        out_i.append(ei_w)
        out_j.append(ej_w)
        out_d.append(ed_w)

    # oversized buckets (> window pairs apart) fall back to an exact host
    # pass; windowed hits inside them are re-found here and deduped below
    members_by_band = []
    for b in range(bands):
        starts, lengths = runs_by_band[b]
        for run in np.nonzero(lengths - 1 > window)[0]:
            members = orders[b, starts[run] : starts[run] + lengths[run]]
            members_by_band.append(members[bucket_ok[members, b]])
    big_i, big_j, big_d = _oversized_bucket_edges(
        members_by_band, ph64, hamming_threshold, sizes64, size_ratio, use_size
    )
    out_i += big_i
    out_j += big_j
    out_d += big_d

    if not out_i:
        return (np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.int64))
    ei = np.concatenate(out_i)
    ej = np.concatenate(out_j)
    ed = np.concatenate(out_d)
    # dedup pairs discovered via multiple bands (or fallback re-finds)
    key = ei * np.int64(n) + ej
    _, first = np.unique(key, return_index=True)
    return ei[first], ej[first], ed[first]


# ---------------------------------------------------------------------------
# resident scanner (steady-state service path)
# ---------------------------------------------------------------------------


def _band_sort_kernel(
    ph: torch.Tensor, *, band_bits: int, band_count: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Band-key extraction + per-band stable sort of the (N,) int64 hashes.

    Split out of the scan so the sort runs ONCE per resident population:
    threshold sweeps and re-scans reuse the cached (order, sk) device
    tensors. Returns (order, sk), both (B, N) int64. ``band_bits <= 32`` and
    ``band_bits * band_count <= 64``, so the mask after each arithmetic shift
    keeps only the band's own bits."""
    key_mask = (1 << band_bits) - 1
    sk_all = torch.stack([(ph >> (b * band_bits)) & key_mask for b in range(band_count)])
    order = torch.argsort(sk_all, dim=1, stable=True)
    sk = torch.gather(sk_all, 1, order)
    return order, sk


def _max_run_kernel(sk: torch.Tensor) -> torch.Tensor:
    """Longest equal-key run across the per-band sorted key rows (B, N).

    Window sizing needs only this one scalar; computing it where the sorted
    keys already live avoids re-deriving band keys on the host."""
    nb, n = sk.shape
    iota = torch.arange(n, device=sk.device).expand(nb, n)
    is_start = torch.ones((nb, n), dtype=torch.bool, device=sk.device)
    is_start[:, 1:] = sk[:, 1:] != sk[:, :-1]
    run_start = torch.cummax(torch.where(is_start, iota, 0), dim=1).values
    return (iota - run_start).max() + 1


def _shifted_hits(
    shi: torch.Tensor, slo: torch.Tensor, sk: torch.Tensor, d: int, hamming_threshold: int
) -> torch.Tensor:
    """(B, N - d) bool: sorted row i against sorted row i + d of its band."""
    dist = popcount32(shi[:, :-d] ^ shi[:, d:]) + popcount32(slo[:, :-d] ^ slo[:, d:])
    return (sk[:, :-d] == sk[:, d:]) & (dist <= hamming_threshold)


def _scan_bitmask_kernel(
    ph: torch.Tensor,  # (N,) int64 — device-resident
    order: torch.Tensor,  # (B, N) int64 per-band sort order (digest-cached)
    sk: torch.Tensor,  # (B, N) int64 sorted band keys (digest-cached)
    hamming_threshold: int,
    *,
    window: int,
) -> torch.Tensor:
    """Windowed candidate scan as DENSE shifted compares -> per-row bitmask.

    Output is a (B, N) int64 bitmask of values below 2^32 (bit d-1 set =
    edge to the d-th next sorted row): fixed shape, one small transfer,
    expanded to (i, j) pairs on the host. Size-ratio / bucket-cap filtering
    and exact distances are host post-passes over the tiny edge list."""
    nb, n = sk.shape
    shi, slo = split_halves(ph[order])
    bits = torch.zeros((nb, n), dtype=torch.int64, device=ph.device)
    for d in range(1, min(window, n - 1) + 1):
        bits[:, : n - d] |= _shifted_hits(shi, slo, sk, d, hamming_threshold).to(torch.int64) << (d - 1)
    return bits


def _scan_bitmask_words_kernel(
    ph: torch.Tensor,  # (N,) int64 — device-resident
    order: torch.Tensor,  # (B, N) int64 per-band sort order (digest-cached)
    sk: torch.Tensor,  # (B, N) int64 sorted band keys (digest-cached)
    hamming_threshold: int,
    *,
    window: int,
) -> torch.Tensor:
    """Wide-window (>32) variant of :func:`_scan_bitmask_kernel`: the per-row
    match mask spans ceil(window/32) planes of 32-bit words — plane w's bit b
    set means an edge to the (w*32 + b + 1)-th next sorted row. Returns
    (n_words, B, N) int64 of values below 2^32."""
    nb, n = sk.shape
    shi, slo = split_halves(ph[order])
    planes = torch.zeros(((window + 31) // 32, nb, n), dtype=torch.int64, device=ph.device)
    for d in range(1, min(window, n - 1) + 1):
        w, b = divmod(d - 1, 32)
        planes[w, :, : n - d] |= _shifted_hits(shi, slo, sk, d, hamming_threshold).to(torch.int64) << b
    return planes


class BandedHammingScanner:
    """Stateful scanner keeping the hash population device-resident.

    The service steady state: signatures live on ``device`` between scans
    (like posting lists in the query epoch); re-scans after config changes
    or incremental updates skip the host->device upload entirely.
    """

    def __init__(
        self,
        *,
        band_bits: int = 16,
        band_count: int = 4,
        max_window: int = 256,
        max_edges_hint: int = 1 << 16,
        mesh=None,  # parallel.mesh.Mesh: shard the compare over its data axis
        host_scan_max: int | None = None,
        device=None,  # the resident scan's device (the mesh's first entry with a mesh)
    ) -> None:
        if band_bits * band_count > 64 or band_bits > 32:
            raise ValueError("band config too large")
        self.band_bits = band_bits
        self.band_count = band_count
        self.max_window = max_window
        self.max_edges_hint = max_edges_hint
        self._mesh = mesh
        self.device = (
            mesh.local_devices[0, 0] if mesh is not None and device is None else resolve_device(device)
        )
        # Below this population the vectorized host scan beats the device
        # path's transfer+sort cost; above it the bitmask scan's
        # O(n*window) compare wins. Env override for other host speeds.
        if host_scan_max is not None:
            self.host_scan_max = host_scan_max
        else:
            env = os.environ.get("KET_DUP_HOST_SCAN_MAX", "262144")
            # "probe": derive the crossover from a one-shot measurement of
            # this host and device
            self.host_scan_max = (
                probe_crossover(device=self.device)["derived_host_scan_max"]
                if env.strip().lower() == "probe"
                else int(env)
            )
        self._digest: bytes | None = None
        self._ph_dev: torch.Tensor | None = None
        self._order_dev: torch.Tensor | None = None
        self._sk_dev: torch.Tensor | None = None
        self._order_host: np.ndarray | None = None
        self._max_run: int = 1
        self.last_window = 0  # the bitmask window of the last device scan

    def _ensure_resident(self, ph_u64: np.ndarray, sizes: np.ndarray) -> None:
        import hashlib

        digest = hashlib.sha1(ph_u64.tobytes() + sizes.tobytes()).digest()
        if digest == self._digest:
            return
        self._ph_dev = torch.from_numpy(
            np.ascontiguousarray(ph_u64, dtype=np.uint64).view(np.int64)
        ).to(self.device)
        # per-band sort is population-only: compute once, reuse across
        # thresholds/sweeps (the scan's largest device cost)
        self._order_dev, self._sk_dev = _band_sort_kernel(
            self._ph_dev, band_bits=self.band_bits, band_count=self.band_count
        )
        self._order_host = None  # fetched lazily, once per population
        self._max_run = 0  # unknown for this population; recomputed lazily
        self._digest = digest

    def _order_np(self) -> np.ndarray:
        """Host copy of the per-band sort order (one fetch per population)."""
        if self._order_host is None:
            self._order_host = self._order_dev.cpu().numpy()
        return self._order_host

    def _sharded(self) -> bool:
        return self._mesh is not None and int(self._mesh.shape.get("data", 1)) > 1

    def _scan_sharded(
        self,
        ph_u64: np.ndarray,
        *,
        hamming_threshold: int,
        sizes_f: np.ndarray,
        use_size: bool,
        size_ratio: float | None,
        bucket_pair_cap: int | None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
        """Multi-device scan: the windowed compare sharded over the mesh's
        data axis (parallel/sharded_scan.py), identical candidate semantics
        to the single-device path (same band sort, same exact host
        post-filters). Returns None when the largest bucket run exceeds
        ``max_window`` — the caller falls back to the single-device path,
        whose capped window + exact oversized-bucket host pass handle it."""
        from kobato_eyes_tpu_torch.parallel.sharded_scan import sharded_window_scan

        n = ph_u64.shape[0]
        keys = band_keys_np(ph_u64, self.band_bits, self.band_count)
        ok = bucket_ok_np(keys, bucket_pair_cap)
        pairs = u64_to_u32pair(ph_u64)
        orders = np.stack([
            np.argsort(keys[:, b].astype(np.uint32), kind="stable")
            for b in range(self.band_count)
        ])
        sk = np.take_along_axis(keys.T.astype(np.uint32), orders, axis=1)
        sph = pairs[orders]
        sok = np.take_along_axis(ok.T, orders, axis=1)

        max_run = 1
        for b in range(self.band_count):
            _, counts = np.unique(keys[:, b], return_counts=True)
            max_run = max(max_run, int(counts.max()))
        window = min(max_run - 1, n - 1)
        if window <= 0:
            empty = np.empty(0, np.int64)
            return empty, empty, empty
        if window > self.max_window:
            logger.info(
                "sharded scan: bucket run %d exceeds max_window %d; "
                "falling back to the single-device path", max_run, self.max_window,
            )
            return None

        cap = max(self.max_edges_hint, 1 << 12)
        while True:
            try:
                b, i_s, j_s, d = sharded_window_scan(
                    self._mesh, sk, sph, sok,
                    hamming_threshold=hamming_threshold, window=window,
                    max_edges_per_shard=cap,
                )
                break
            except ValueError:
                cap *= 4  # overflow: retry with headroom (bounded by n*window)
                if cap > 4 * n * window:
                    raise

        gi = orders[b, i_s]
        gj = orders[b, j_s]
        lo = np.minimum(gi, gj)
        hi = np.maximum(gi, gj)
        _, first = np.unique(lo * np.int64(n) + hi, return_index=True)
        ei, ej, dist = lo[first], hi[first], d[first]
        if use_size and size_ratio is not None:
            keep = _exact_size_ratio_keep(ei, ej, sizes_f, float(size_ratio))
            ei, ej, dist = ei[keep], ej[keep], dist[keep]
        return ei.astype(np.int64), ej.astype(np.int64), dist.astype(np.int64)

    def scan(
        self,
        ph_u64: np.ndarray,
        *,
        hamming_threshold: int,
        sizes: np.ndarray | None = None,
        size_ratio: float | None = None,
        bucket_pair_cap: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Full scan -> deduplicated (i, j, dist) with i < j."""
        from kobato_eyes_tpu_torch.utils.metrics import metrics

        n = ph_u64.shape[0]
        if n < 2:
            return (np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.int64))
        sizes_f = (sizes if sizes is not None else np.zeros(n)).astype(np.float64)
        use_size = size_ratio is not None and size_ratio > 0 and sizes is not None
        use_ok = bucket_pair_cap is not None

        if n <= self.host_scan_max and not self._sharded():
            with metrics.timer("dup.scan.host"):
                return host_window_scan(
                    ph_u64,
                    band_bits=self.band_bits,
                    band_count=self.band_count,
                    hamming_threshold=hamming_threshold,
                    sizes=sizes_f if use_size else None,
                    size_ratio=size_ratio,
                    bucket_pair_cap=bucket_pair_cap,
                )

        if self._sharded():
            sharded = self._scan_sharded(
                ph_u64, hamming_threshold=hamming_threshold, sizes_f=sizes_f,
                use_size=use_size, size_ratio=size_ratio,
                bucket_pair_cap=bucket_pair_cap,
            )
            if sharded is not None:
                return sharded
            # a bucket run beyond max_window: the sharded compare would hold
            # (bands, window, rows/shard) intermediates of many GB — the
            # single-device path caps the window and handles oversized
            # buckets exactly

        with metrics.timer("dup.scan.upload"):
            self._ensure_resident(ph_u64, sizes_f)

        # bucket stats: max-run window sizing comes off the device-resident
        # sorted keys (once per population); the host cap mask only when a
        # pair cap is set
        with metrics.timer("dup.scan.bucket_stats"):
            keys = None
            if use_ok:
                keys = band_keys_np(ph_u64, self.band_bits, self.band_count)
            if self._max_run == 0:
                self._max_run = int(_max_run_kernel(self._sk_dev))
            max_run = self._max_run
            ok = bucket_ok_np(keys, bucket_pair_cap) if use_ok else None
        window = min(max_run - 1, self.max_window, n - 1)
        if window > 0:
            window = min(max(8, int(2 ** np.ceil(np.log2(window)))), self.max_window, n - 1)
        self.last_window = window

        out_i: list[np.ndarray] = []
        out_j: list[np.ndarray] = []
        out_d: list[np.ndarray] = []
        if window > 0:
            # dense bitmask path: fixed-shape output, no caps, no gathers;
            # windows beyond one mask word emit ceil(window/32) planes
            with metrics.timer("dup.scan.device"):
                if window <= 32:
                    planes = _scan_bitmask_kernel(
                        self._ph_dev, self._order_dev, self._sk_dev, int(hamming_threshold),
                        window=window,
                    )[None]
                else:
                    planes = _scan_bitmask_words_kernel(
                        self._ph_dev, self._order_dev, self._sk_dev, int(hamming_threshold),
                        window=window,
                    )
                planes = planes.cpu().numpy().astype(np.uint32)
            with metrics.timer("dup.scan.expand"):
                order_h = self._order_np()
                for wi in range(planes.shape[0]):
                    bits = planes[wi]
                    b_hit, i_hit = np.nonzero(bits)
                    if b_hit.size == 0:
                        continue
                    w_hit = bits[b_hit, i_hit]
                    for bit in range(min(32, window - wi * 32)):
                        sel = (w_hit >> np.uint32(bit)) & 1 == 1
                        if not sel.any():
                            continue
                        d = wi * 32 + bit + 1
                        bsel = b_hit[sel]
                        isel = i_hit[sel]
                        gi = order_h[bsel, isel]
                        gj = order_h[bsel, isel + d]
                        ei_w = np.minimum(gi, gj)
                        ej_w = np.maximum(gi, gj)
                        if use_ok:
                            keep = ok[ei_w, bsel] & ok[ej_w, bsel]
                            ei_w, ej_w = ei_w[keep], ej_w[keep]
                        out_i.append(ei_w)
                        out_j.append(ej_w)
                if out_i:
                    ei_all = np.concatenate(out_i)
                    ej_all = np.concatenate(out_j)
                    if use_size:
                        keep = _exact_size_ratio_keep(
                            ei_all, ej_all, sizes_f, float(size_ratio)
                        )
                        ei_all, ej_all = ei_all[keep], ej_all[keep]
                    d_all = popcount64_np(ph_u64[ei_all] ^ ph_u64[ej_all]).astype(np.int64)
                    out_i, out_j, out_d = [ei_all], [ej_all], [d_all]

        # oversized buckets -> exact host fallback
        if max_run - 1 > window:
            if keys is None:
                keys = band_keys_np(ph_u64, self.band_bits, self.band_count)
            members_by_band = []
            for b in range(self.band_count):
                keys_b = keys[:, b]
                order = np.argsort(keys_b, kind="stable")
                starts, lengths = _run_lengths(keys_b[order])
                for run in np.nonzero(lengths - 1 > window)[0]:
                    members = order[starts[run] : starts[run] + lengths[run]]
                    members_by_band.append(members[ok[members, b]] if use_ok else members)
            big_i, big_j, big_d = _oversized_bucket_edges(
                members_by_band, ph_u64, hamming_threshold, sizes_f, size_ratio, use_size
            )
            out_i += big_i
            out_j += big_j
            out_d += big_d

        if not out_i:
            return (np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.int64))
        with metrics.timer("dup.scan.dedup"):
            ei = np.concatenate(out_i)
            ej = np.concatenate(out_j)
            ed = np.concatenate(out_d)
            key = ei * np.int64(n) + ej
            _, first = np.unique(key, return_index=True)
            return ei[first], ej[first], ed[first]


# ---------------------------------------------------------------------------
# numpy reference (executable spec for parity tests)
# ---------------------------------------------------------------------------


def edge_scan_np(
    ph_u64: np.ndarray,
    keys_u64: np.ndarray,
    bucket_ok: np.ndarray,
    *,
    hamming_threshold: int,
    sizes: np.ndarray | None = None,
    size_ratio: float | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Brute-force numpy implementation of the same edge predicate."""
    n = ph_u64.shape[0]
    xor = ph_u64[:, None] ^ ph_u64[None, :]
    dist = popcount64_np(xor).astype(np.int64)
    band_hit = np.any(
        (keys_u64[:, None, :] == keys_u64[None, :, :]) & bucket_ok[:, None, :], axis=-1
    )
    edge = band_hit & (dist <= hamming_threshold)
    if size_ratio is not None and size_ratio > 0 and sizes is not None:
        s = sizes.astype(np.float64)
        smaller = np.minimum(s[:, None], s[None, :])
        larger = np.maximum(s[:, None], s[None, :])
        edge &= (smaller <= 0) | (smaller / np.maximum(larger, 1.0) >= size_ratio)
    iu = np.triu_indices(n, k=1)
    mask = edge[iu]
    return iu[0][mask], iu[1][mask], dist[iu][mask]


def hamming_distance_pairs(a_pairs: np.ndarray, b_pairs: np.ndarray) -> np.ndarray:
    """Element-wise Hamming distance between two (N, 2) uint32 hash arrays."""
    a = u32pair_to_u64(a_pairs)
    b = u32pair_to_u64(b_pairs)
    return popcount64_np(a ^ b)
