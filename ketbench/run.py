"""Run one cell of ``BENCHMARK.json`` on the card and print its result line.

    python3 -m ketbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up builds the cell's system under test and
its inputs from the seed and warms every shape the window uses; the window
runs ``--seconds``; afterwards what the window produced is held to the plain
reference. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared beside its limit).
Without a CUDA card, or with fewer cards than the cell asks for, it prints no
result and exits 2.
"""

from __future__ import annotations

from ketbench.core import process_start_perf

T_START = process_start_perf()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from ketbench.core import (  # noqa: E402
    ROOT, BenchError, RunContext, RunRecord, cell_metrics, device_ops, find_cell, idle_gaps, load_benchmark,
    load_config, load_driver, load_reader, load_traffic, loaded_forbidden_modules, require_cards,
)


def configure_environment(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout; keep
    libraries that could load JAX from doing so."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"


def run_cell(
    workload: str, *, seed: int, seconds: float, trace: bool, device: str = "cuda", root: Path = ROOT,
    t_start: float | None = None, fault=None, calibrate: bool = False, edit=None, bench: dict | None = None,
) -> tuple[RunRecord, RunContext]:
    """Set up, run and check one cell; ``edit(config, traffic)`` may change
    the two documents in place first (tests shrink them); ``bench`` stands
    in for ``BENCHMARK.json`` (tests add cells to it)."""
    bench = load_benchmark(root) if bench is None else bench
    cell = find_cell(bench, workload)
    config = load_config(bench, cell["config"], root)
    traffic = load_traffic(cell["traffic"], root)
    if edit is not None:
        edit(config, traffic)
    ctx = RunContext(bench=bench, cell=cell, config=config, traffic=traffic, seed=seed, seconds=seconds,
                     trace=trace, device=device, root=root, t_start=t_start)
    ctx.fault = fault
    ctx.calibrate = calibrate
    record = load_driver(traffic).run(ctx)
    record.trace = ctx.trace_result
    record.counters["device_name"] = device_name(device)
    return record, ctx


def device_name(device: str) -> str:
    if device.startswith("cuda"):
        import torch

        return torch.cuda.get_device_name(0)
    return "cpu"


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        )
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unread ({exc})"


def result_line(bench: dict, ctx: RunContext, record: RunRecord, *, root: Path = ROOT) -> dict:
    metrics = {}
    for m in cell_metrics(bench, ctx.cell["name"], trace=ctx.trace):
        if ctx.trace:
            value = load_reader(m["name"], root)(record)
        elif m["name"] == "setup_s":
            value = ctx.setup_s
        else:
            value = record.e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {
        "platform": "gpu" if ctx.device.startswith("cuda") else "cpu",
        "kind": record.counters.get("device_name", "cpu"),
        "count": int(ctx.cell["chips"]),
        "memory_peak_bytes": int(record.memory_peak_bytes),
    }
    line = {"correct": bool(record.correct), "attempted": int(record.attempted), "failed": int(record.failed),
            "metrics": metrics, "device": device}
    if record.trace is not None:
        device["busy_s"] = record.trace.busy_s()
        device["window_s"] = record.trace.window_s()
        line["breakdown"] = {"device_ops": device_ops(record.trace), "idle_gaps": idle_gaps(record.trace)}
    line["checks"] = {name: {"value": float(value), "limit": float(limit)} for name, (value, limit) in record.checks.items()}
    return line


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        bench = load_benchmark(ROOT)
        cell = find_cell(bench, args.workload)
        require_cards(cell["chips"])
    except (BenchError, ImportError) as exc:
        print(f"ketbench: {exc}", file=sys.stderr)
        return 2
    configure_environment(ROOT)
    print(f"ketbench: card {power_limit()}", file=sys.stderr, flush=True)
    record, ctx = run_cell(args.workload, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                           t_start=T_START)
    found = loaded_forbidden_modules()
    if found:
        print(f"ketbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    line = result_line(bench, ctx, record)
    print(f"ketbench: counters {json.dumps(record.counters, default=str)}", file=sys.stderr)
    print(f"ketbench: reference {sum(record.host_spans.get('reference', [])):.3f} s", file=sys.stderr)
    for name, (value, limit) in record.checks.items():
        print(f"check {name} {float(value)!r} limit {float(limit)!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
