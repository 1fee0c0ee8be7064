"""Headline benchmark of the port: dup-scan throughput at 70k images.

Counterpart of the repository's root ``bench.py`` (BASELINE.json #2), with
its data, its windows and its JSON keys. Run it as::

    python -m kobato_eyes_tpu_torch.bench                 # on the card
    python -m kobato_eyes_tpu_torch.bench --device cpu    # on the CPU

``KET_BENCH_N`` sets the population (70 000 by default) and
``KET_BENCH_CPU_BUDGET_S`` the CPU reference's time budget (600 s), as for
the root script. It prints ONE JSON line::

    {"metric": "dup_scan_pairs_per_sec_70k", "value": N, "unit": "pairs/s",
     "vs_baseline": R, ...}

``value`` is the warm-engine NON-memoized scan rate (total pair space / wall
time): the engine is warm, but one hash is flipped between timed runs so the
snapshot token changes and the full pipeline (columnar prep, candidate scan,
edge extraction, DSU cluster assembly) executes every iteration, as the CPU
baseline does each run. The memoized re-scan is reported as
``warm_memo_pairs_per_sec``, the cold first scan as ``cold_scan_s``, and the
device route's scan alone as ``device_dispatch_pairs_per_sec``.

``vs_baseline`` is value / the rate of the CPU reference implementation
(``dup/cpu_ref.py``, the reference's bucketed Python pair loops) on the same
hashes, with a cluster-identity assertion. The CPU side runs on a 10k subset,
its rate scaled, when the full run would exceed the budget.

Each timed window ends with ``torch.cuda.synchronize`` on the card; the
engine's result is host clusters, so the scan has finished by then anyway.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from kobato_eyes_tpu_torch.device import resolve_device

SEED = 1234
HAMMING_THRESHOLD = 8
DUP_FRACTION = 0.3  # fraction of images that are near-dups of an original


def synth_hashes(n: int, seed: int) -> np.ndarray:
    """Synthetic pHash population with planted near-duplicate clusters."""
    rng = np.random.default_rng(seed)
    n_dups = int(n * DUP_FRACTION)
    n_orig = n - n_dups
    originals = rng.integers(0, 1 << 64, size=n_orig, dtype=np.uint64)
    # each dup flips 0..6 random bits of a random original
    src = rng.integers(0, n_orig, size=n_dups)
    dups = originals[src].copy()
    for i in range(n_dups):
        k = int(rng.integers(0, 7))
        for bit in rng.integers(0, 64, size=k):
            dups[i] ^= np.uint64(1) << np.uint64(bit)
    out = np.concatenate([originals, dups])
    rng.shuffle(out)
    return out


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from kobato_eyes_tpu_torch.dup.cpu_ref import CpuDuplicateScanner
    from kobato_eyes_tpu_torch.dup.engine import TpuDuplicateScanner, cluster_ids
    from kobato_eyes_tpu_torch.dup.types import DuplicateFileMeta, DuplicateScanConfig
    from kobato_eyes_tpu_torch.utils.metrics import metrics

    n = int(os.environ.get("KET_BENCH_N", "70000"))
    cpu_budget_s = float(os.environ.get("KET_BENCH_CPU_BUDGET_S", "600"))
    hashes = synth_hashes(n, SEED)
    sizes = np.random.default_rng(SEED + 1).integers(10_000, 5_000_000, size=n)
    files = [
        DuplicateFileMeta(
            file_id=i, path=Path(f"/bench/img_{i:07d}.png"), size=int(sizes[i]),
            width=None, height=None, phash=int(hashes[i]),
        )
        for i in range(n)
    ]
    config = DuplicateScanConfig(hamming_threshold=HAMMING_THRESHOLD)
    pair_space = n * (n - 1) / 2

    def timed(scanner, fs, token=None):
        t0 = time.perf_counter()
        clusters = scanner.build_clusters(fs, files_token=token)
        synchronize(device)
        return clusters, time.perf_counter() - t0

    # warm-up run at the same shapes, so the timed runs exclude first-use costs
    scanner = TpuDuplicateScanner(config, block=4096, device=device)
    token = ("bench", SEED, n)
    device_clusters = scanner.build_clusters(files, files_token=token)

    # HEADLINE: warm non-memoized scan. A snapshot with ONE flipped hash bit
    # alternates with the real one, so every timed run sees a changed token
    # and edge set: prep, scan and full assembly all execute (no memo hit).
    files_b = list(files)
    files_b[0] = dataclasses.replace(files_b[0], phash=int(hashes[0]) ^ 1)
    token_b = ("bench-b", SEED, n)
    # median of 3 timed runs; the disjoint top-level phases (dup.scan.* and
    # dup.assemble.* are children of dup.scan.call / dup.assemble)
    top_phases = ("dup.scan.prep", "dup.scan.call", "dup.assemble")
    runs: list[tuple[float, dict]] = []
    for _ in range(3):
        scanner.build_clusters(files_b, files_token=token_b)  # invalidate memo
        metrics.reset()
        device_clusters, elapsed = timed(scanner, files, token)
        runs.append((elapsed, {
            name: round(stats["total"], 4)
            for name, stats in metrics.snapshot()["timers"].items()
        }))
    runs.sort(key=lambda r: r[0])
    device_s, phase_report = runs[len(runs) // 2]
    device_s_min = runs[0][0]
    device_pps = pair_space / device_s
    # which route produced the headline, and the engine's routing constant
    headline_path = "host" if n <= scanner._scanner.host_scan_max else "device"
    top_sum = sum(phase_report.get(p, 0.0) for p in top_phases)
    residual = device_s - top_sum
    print(
        f"warm non-memo scan {device_s:.3f}s (median of 3), phases: {phase_report}; "
        f"top-phase sum {top_sum:.3f}s, residual {residual * 1e3:.1f}ms "
        f"({100 * residual / device_s:.1f}% of wall)",
        file=sys.stderr,
    )

    # attribution: the resident scan on an EXPLICIT device-route scanner
    # (the engine routes populations up to host_scan_max to the host scan);
    # its clusters are asserted identical to the host route's
    dev_scanner = TpuDuplicateScanner(config, block=4096, host_scan_max=0, device=device)
    dev_clusters = dev_scanner.build_clusters(files, files_token=token)  # warm
    if cluster_ids(dev_clusters) != cluster_ids(device_clusters):
        raise SystemExit("device-path clusters != host-path clusters")
    dev_scanner.build_clusters(files_b, files_token=token_b)
    metrics.reset()
    _, dev_wall = timed(dev_scanner, files, token)
    dev_phases = {
        name: round(stats["total"], 4)
        for name, stats in metrics.snapshot()["timers"].items()
    }
    kernel_s = dev_phases.get("dup.scan.device", dev_wall)
    print(
        f"device-path scan {dev_wall:.3f}s (kernel dispatch {kernel_s:.3f}s = "
        f"{pair_space / kernel_s:.3g} pairs/s), phases: {dev_phases}",
        file=sys.stderr,
    )

    # secondary: memoized re-scan of an unchanged snapshot (assembly memo hit)
    memo_times = [timed(scanner, files, token)[1] for _ in range(3)]
    memo_s = sorted(memo_times)[1]
    print(
        f"warm memoized re-scan {memo_s:.3f}s = {pair_space / memo_s:.3g} pairs/s",
        file=sys.stderr,
    )

    # cold path: a fresh engine with no snapshot caches (what the FIRST scan
    # of a new catalog pays)
    cold_scanner = TpuDuplicateScanner(config, block=4096, device=device)
    metrics.reset()
    cold_clusters, cold_s = timed(cold_scanner, files)
    cold_phases = {
        name: round(stats["total"], 4)
        for name, stats in metrics.snapshot()["timers"].items()
    }
    assert cluster_ids(cold_clusters) == cluster_ids(device_clusters)
    print(
        f"cold scan (fresh engine) {cold_s:.3f}s "
        f"= {pair_space / cold_s:.3g} pairs/s, phases: {cold_phases}",
        file=sys.stderr,
    )

    # CPU reference on the same data: probe on 10k to estimate the full
    # cost; scale the probe's rate if the full run would exceed the budget
    probe_n = min(10_000, n)
    cpu_scanner = CpuDuplicateScanner(config)
    t0 = time.perf_counter()
    cpu_scanner.build_clusters(files[:probe_n])
    probe_s = time.perf_counter() - t0
    est = probe_s * (n / probe_n) ** 2  # bucket pair work scales ~quadratically
    if est > cpu_budget_s:
        cpu_pps = (probe_n * (probe_n - 1) / 2) / probe_s
        cpu_s_min = probe_s
        cpu_ref_phases = dict(cpu_scanner.last_phases)
        parity_files = files[:probe_n]
    else:
        cpu_times = []
        for _ in range(3):
            t0 = time.perf_counter()
            cpu_clusters = cpu_scanner.build_clusters(files)
            cpu_times.append(time.perf_counter() - t0)
        cpu_s = sorted(cpu_times)[1]  # median of 3, as the device side
        cpu_s_min = min(cpu_times)
        cpu_pps = pair_space / cpu_s
        cpu_ref_phases = dict(cpu_scanner.last_phases)
        parity_files = None
        assert cluster_ids(device_clusters) == cluster_ids(cpu_clusters), (
            "device clusters diverge from CPU reference"
        )
    if parity_files is not None:
        # parity asserted on the probe subset when the full CPU run is skipped
        sub_dev = scanner.build_clusters(parity_files)
        sub_cpu = CpuDuplicateScanner(config).build_clusters(parity_files)
        assert cluster_ids(sub_dev) == cluster_ids(sub_cpu), (
            "device clusters diverge from CPU reference (probe)"
        )

    # crossover provenance: what THIS host and device measure the host/device
    # routing constant to be; provenance, never a bench failure
    try:
        from kobato_eyes_tpu_torch.ops.hamming import probe_crossover

        probe = probe_crossover(device=device)
        crossover = {
            "derived_host_scan_max": probe["derived_host_scan_max"],
            "upload_mb_per_s": round(probe["upload_mb_per_s"], 1),
            "device_rtt_ms": round(probe["device_rtt_s"] * 1e3, 2),
        }
    except Exception as exc:
        crossover = {"error": str(exc)}

    print(
        json.dumps(
            {
                "metric": f"dup_scan_pairs_per_sec_{n // 1000}k",
                "value": round(device_pps, 1),
                "unit": "pairs/s",
                "vs_baseline": round(device_pps / cpu_pps, 2),
                "headline_path": headline_path,
                "host_scan_max": scanner._scanner.host_scan_max,
                "crossover_probe": crossover,
                # min-wall aggregation beside the median headline, both sides
                "value_min_wall": round(pair_space / device_s_min, 1),
                # min-vs-min only when the CPU side ran the full population
                "vs_baseline_min_wall": (
                    round(cpu_s_min / device_s_min, 2)
                    if parity_files is None
                    else None
                ),
                "cpu_ref_min_wall_s": round(cpu_s_min, 3),
                "cpu_ref_phases": cpu_ref_phases,
                "warm_memo_pairs_per_sec": round(pair_space / memo_s, 1),
                "device_dispatch_pairs_per_sec": round(pair_space / kernel_s, 1),
                "cold_scan_s": round(cold_s, 3),
                "cpu_ref_pairs_per_sec": round(cpu_pps, 1),
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
