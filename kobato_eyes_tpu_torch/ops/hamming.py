"""Banded Hamming candidate scan: host C++ band scan or the resident device scan.

Counterpart of the production scan of ``kobato_eyes_tpu/ops/hamming.py``.
The candidate predicate is the reference's LSH bucket loop
(``src/dup/scanner.py:227-298``): two hashes are an edge iff they share a
band slice in a bucket under the pair cap, their Hamming distance is at most
the threshold and (optionally) their sizes pass the ratio filter. The edge
set, and therefore the DSU clusters, is identical to the reference's.

Populations up to ``host_scan_max`` (``KET_DUP_HOST_SCAN_MAX``, 262144 by
default) run the host scan (``native/hamming_scan.cpp``, numpy spec beside
it). Larger ones keep the hashes resident on the device: per band, sort by
band key so buckets become runs, then compare each sorted row with the next
``window`` rows as dense shifted compares that write a per-row bitmask; the
host expands the bitmask to pairs. Oversized buckets (runs longer than the
capped window) take an exact host pass.

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
from kobato_eyes_tpu_torch.utils.bits import popcount64_np

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


def _run_lengths(sorted_keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Starts and lengths of equal-key runs in a sorted array."""
    n = sorted_keys.shape[0]
    boundaries = np.nonzero(np.diff(sorted_keys))[0] + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [n]])
    return starts, ends - starts


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
        mesh=None,
        host_scan_max: int | None = None,
        device=None,
    ) -> None:
        if band_bits * band_count > 64 or band_bits > 32:
            raise ValueError("band config too large")
        if mesh is not None:
            raise NotImplementedError("the sharded scan comes with the multi-device slice of the port")
        self.band_bits = band_bits
        self.band_count = band_count
        self.max_window = max_window
        self.max_edges_hint = max_edges_hint
        self.device = resolve_device(device)
        # Below this population the vectorized host scan beats the device
        # path's transfer+sort cost; above it the bitmask scan's
        # O(n*window) compare wins. Env override for other host speeds.
        if host_scan_max is not None:
            self.host_scan_max = host_scan_max
        else:
            env = os.environ.get("KET_DUP_HOST_SCAN_MAX", "262144")
            if env.strip().lower() == "probe":
                raise NotImplementedError(
                    "KET_DUP_HOST_SCAN_MAX=probe: the crossover probe is not ported yet"
                )
            self.host_scan_max = int(env)
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

        if n <= self.host_scan_max:
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
            ph64 = ph_u64
            if keys is None:
                keys = band_keys_np(ph_u64, self.band_bits, self.band_count)
            for b in range(self.band_count):
                keys_b = keys[:, b]
                order = np.argsort(keys_b, kind="stable")
                starts, lengths = _run_lengths(keys_b[order])
                for run in np.nonzero(lengths - 1 > window)[0]:
                    members = order[starts[run] : starts[run] + lengths[run]]
                    if use_ok:
                        members = members[ok[members, b]]
                    m = members.shape[0]
                    if m < 2:
                        continue
                    h = ph64[members]
                    dist = popcount64_np(h[:, None] ^ h[None, :]).astype(np.int64)
                    mask = dist <= hamming_threshold
                    if use_size:
                        s = sizes_f[members]
                        smaller = np.minimum(s[:, None], s[None, :])
                        larger = np.maximum(s[:, None], s[None, :])
                        mask &= (smaller <= 0) | (
                            smaller / np.maximum(larger, 1.0) >= size_ratio
                        )
                    iu = np.triu_indices(m, k=1)
                    sel = mask[iu]
                    out_i.append(members[iu[0][sel]].astype(np.int64))
                    out_j.append(members[iu[1][sel]].astype(np.int64))
                    out_d.append(dist[iu][sel])

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
