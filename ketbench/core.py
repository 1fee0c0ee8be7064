"""The harness's shared machinery: finding a cell's files by name, the
run context (set-up clock, spans, the traced window), the device's
description and the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; both
are data files found by name (``configs/<config>.json`` through the entry's
``file``, ``traffic/<mix>.json``). The mix names its ``driver``, a module of
``ketbench.drivers`` that generates the traffic from the mix's parameters and
the seed, runs the window and checks what the window produced. A per-layer
metric is ``metrics/<metric>.py`` with ``read(run) -> float | None``.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import re
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Iterator

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

# whole top-level module names that may not be loaded in a run
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "kobato_eyes_tpu")


class BenchError(RuntimeError):
    """A run that cannot produce a result (no card, unknown cell, bad files)."""


# ---------------------------------------------------------------------------
# Finding things by name
# ---------------------------------------------------------------------------


def load_benchmark(root: Path = ROOT) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise BenchError(f"{path} not found")
    return json.loads(path.read_text(encoding="utf-8"))


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise BenchError(f"no workload {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for entry in bench["configs"]:
        if entry["name"] == name:
            doc = json.loads((Path(root) / entry["file"]).read_text(encoding="utf-8"))
            return {**doc, "name": name}
    raise BenchError(f"no configuration {name!r} in BENCHMARK.json")


def load_traffic(name: str, root: Path = ROOT) -> dict:
    path = Path(root) / "ketbench" / "traffic" / f"{name}.json"
    if not path.is_file():
        raise BenchError(f"no traffic mix {path}")
    return {**json.loads(path.read_text(encoding="utf-8")), "name": name}


def load_driver(traffic: dict):
    return importlib.import_module(f"ketbench.drivers.{traffic['driver']}")


def cell_metrics(bench: dict, cell: str, *, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``trace`` off, its per-layer metrics with ``trace`` on. A metric without
    ``workloads`` belongs to every cell that reports the metric it moves."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [
        m for m in bench["per_layer"]
        if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)
    ]


def load_reader(metric: str, root: Path = ROOT) -> Callable[["RunRecord"], float | None]:
    """``metrics/<metric>.py``'s ``read``, loaded from its path (a metric's
    name may hold dots)."""
    path = Path(root) / "ketbench" / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise BenchError(f"no reader {path} for metric {metric!r}")
    module_name = "ketbench_metric_" + re.sub(r"\W", "_", metric)
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


# ---------------------------------------------------------------------------
# Clocks
# ---------------------------------------------------------------------------


def process_start_perf() -> float:
    """The process's start on the ``time.perf_counter`` clock: its start
    time from ``/proc/self/stat`` against ``CLOCK_BOOTTIME``, where both
    exist; else now (the set-up then leaves out the interpreter's start)."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start_s = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - start_s
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter()


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------


@dataclass
class Trace:
    """What the profiler saw in the traced window, on one clock (ns):
    device operations (kernels, copies, sets) and the harness's spans."""

    window: tuple[int, int]
    ops: list[tuple[str, int, int]]  # (name, start, end)
    spans: list[tuple[str, int, int]]

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device operations' intervals, clipped to the window."""
        lo, hi = self.window
        merged: list[list[int]] = []
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def matching(self, pattern: str) -> list[tuple[str, int, int]]:
        rx = re.compile(pattern)
        return [o for o in self.ops if rx.search(o[0])]

    def span_at(self, t: int) -> str:
        """The innermost harness span open at ``t``; outside every span,
        where ``t`` lies against them (``"(before spans)"``,
        ``"(between spans)"``, ``"(after spans)"``)."""
        best = None
        for name, s, e in self.spans:
            if s <= t < e and (best is None or s >= best[1]):
                best = (name, s)
        if best:
            return best[0]
        if not self.spans or t < min(s for _, s, _ in self.spans):
            return "(before spans)"
        return "(after spans)" if t >= max(e for _, _, e in self.spans) else "(between spans)"


@dataclass
class RunRecord:
    """What a driver hands back: the end-to-end numbers, the checks, the
    counters and spans per-layer readers read, and the trace."""

    correct: bool
    attempted: int
    failed: int
    e2e: dict[str, float]
    checks: dict[str, tuple[float, float]]  # name -> (value, limit)
    counters: dict[str, Any] = field(default_factory=dict)
    host_spans: dict[str, list[float]] = field(default_factory=dict)  # name -> seconds
    trace: Trace | None = None
    config: dict = field(default_factory=dict)
    memory_peak_bytes: int = 0


class RunContext:
    """One run of one cell: its files, its seed, its clocks and spans."""

    def __init__(
        self, *, bench: dict, cell: dict, config: dict, traffic: dict,
        seed: int, seconds: float, trace: bool, device: str, root: Path = ROOT,
        t_start: float | None = None, log: Callable[[str], None] | None = None,
    ) -> None:
        self.bench, self.cell, self.config, self.traffic = bench, cell, config, traffic
        self.seed, self.seconds, self.trace, self.device = int(seed), float(seconds), bool(trace), device
        self.root = Path(root)
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.setup_s: float | None = None
        self.host_spans: dict[str, list[float]] = {}
        self.trace_result: Trace | None = None
        self._log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
        # test seam: a function (stage, value) -> value that breaks the timed path
        self.fault: Callable[[str, Any], Any] | None = None
        # ``ketbench.calibrate``: also read the control and the planted faults
        self.calibrate = False
        self.setup_parts: dict[str, float] = {}

    def log(self, msg: str) -> None:
        self._log(f"[ketbench {self.cell['name']}] {msg}")

    def seed_words(self, *extra: int) -> list[int]:
        """The seed as non-negative 32-bit words (any whole number), for
        ``numpy.random.default_rng``, followed by ``extra``."""
        s = self.seed % (1 << 64)
        return [s & 0xFFFFFFFF, s >> 32, *extra]

    def torch_seed(self, stream: int) -> int:
        """A 63-bit seed for a ``torch.Generator``, from the seed and a stream."""
        import numpy as np

        return int(np.random.default_rng(self.seed_words(stream)).integers(0, 2**63 - 1))

    def apply_fault(self, stage: str, value):
        return value if self.fault is None else self.fault(stage, value)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        """Time a call into a layer on the host clock; in a traced run also
        mark it in the trace (``record_function``), where idle gaps are
        named by it."""
        t0 = time.perf_counter()
        if self.trace:
            from torch.profiler import record_function

            with record_function(name):
                yield
        else:
            yield
        self.host_spans.setdefault(name, []).append(time.perf_counter() - t0)

    @contextlib.contextmanager
    def part(self, name: str) -> Iterator[None]:
        """Time one part of the set-up (reported on standard error)."""
        t0 = time.perf_counter()
        yield
        self.synchronize()
        self.setup_parts[name] = time.perf_counter() - t0

    @contextlib.contextmanager
    def window(self) -> Iterator[None]:
        """The measured window: set-up ends where it starts; with ``trace``
        the profiler records device operations and spans through it."""
        self.synchronize()
        self.setup_s = time.perf_counter() - self.t_start
        parts = ", ".join(f"{k} {v:.3f}" for k, v in self.setup_parts.items())
        self.log(f"set-up {self.setup_s:.3f} s ({parts}); window of {self.seconds:g} s")
        if not self.trace:
            yield
            self.synchronize()
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if self.device.startswith("cuda"):
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            with record_function("window"):
                yield
                self.synchronize()
        self.trace_result = reduce_trace(prof)

    def synchronize(self) -> None:
        if self.device.startswith("cuda"):
            import torch

            torch.cuda.synchronize()


def reduce_trace(prof) -> Trace:
    """The profiler's events as a :class:`Trace`: device operations (kernels,
    copies and sets on the card) and the harness's ``record_function`` spans
    (their host side; the profiler's device-side copies of them are left out)."""
    ops: list[tuple[str, int, int]] = []
    spans: list[tuple[str, int, int]] = []
    window = None
    for ev in prof.profiler.kineto_results.events():
        on_device = str(ev.device_type()).endswith("CUDA")
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if ev.is_user_annotation():
            if on_device:
                continue
            if ev.name() == "window":
                window = (start, end)
            else:
                spans.append((ev.name(), start, end))
        elif on_device:
            ops.append((ev.name(), start, end))
    if window is None:
        raise BenchError("the trace holds no window span")
    return Trace(window=window, ops=ops, spans=spans)


def idle_gaps(trace: Trace, top: int = 10) -> list[list]:
    """The longest stretches of the window with no device operation, each
    named by the harness span open at its middle."""
    lo, hi = trace.window
    gaps = []
    cursor = lo
    for s, e in trace.busy_intervals():
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if hi > cursor:
        gaps.append((cursor, hi))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    return [[trace.span_at((s + e) // 2), (e - s) / 1e9] for s, e in gaps[:top]]


def device_ops(trace: Trace, top: int = 10) -> list[list]:
    """Device time by operation name, the largest first."""
    total: dict[str, int] = {}
    for name, s, e in trace.ops:
        total[name] = total.get(name, 0) + (e - s)
    ranked = sorted(total.items(), key=lambda kv: kv[1], reverse=True)[:top]
    return [[name, ns / 1e9] for name, ns in ranked]


# ---------------------------------------------------------------------------
# The device and the result
# ---------------------------------------------------------------------------


def require_cards(count: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise BenchError("no CUDA device: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < count:
        raise BenchError(f"the cell asks for {count} cards; {torch.cuda.device_count()} visible")


def loaded_forbidden_modules() -> list[str]:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES})


def percent(numerator: float, denominator: float) -> float | None:
    if denominator <= 0 or numerator <= 0:
        return None
    return 100.0 * numerator / denominator
