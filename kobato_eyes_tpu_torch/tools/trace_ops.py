"""Summarize a torch.profiler trace: time by op name, grouped and ranked.

Counterpart of the repository's ``tools/trace_ops.py``. Reads the Chrome
trace that ``utils/profiling.device_trace`` writes (``trace.json``, or its
``.gz``) under a profile directory (``bench_tagger --profile DIR``,
``mfu_probe --profile DIR``, ``bench_swin --profile DIR``) and prints the
total time by op name, so that a gap can be put down to named kernels::

    python -m kobato_eyes_tpu_torch.tools.trace_ops DIR [--top 25] [--raw]

``--device cuda`` (the default) sums the card's events (categories
``kernel``, ``gpu_memcpy``, ``gpu_memset``); a kernel's name is shortened to
its name and template arguments (``attn_wgmma_kernel<64,1,0>``), mangled or
demangled as the trace gives it. ``--device cpu`` sums the outermost
``cpu_op`` events of each thread instead, for a trace taken on the CPU.
"""

from __future__ import annotations

import argparse
import collections
import gzip
import json
import re
import sys
from pathlib import Path

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def load_trace(profile_dir: Path) -> dict:
    paths = sorted(
        p for pattern in ("*trace.json", "*trace.json.gz") for p in Path(profile_dir).rglob(pattern)
    )
    if not paths:
        raise SystemExit(f"no trace.json or trace.json.gz under {profile_dir}")
    path = max(paths, key=lambda p: p.stat().st_mtime)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt", encoding="utf-8") as fh:
        return json.load(fh)


def device_events(trace: dict, device: str = "cuda") -> list[dict]:
    """Complete ('X') events of the card, or of the host's outermost ops."""
    events = [ev for ev in trace.get("traceEvents", []) if ev.get("ph") == "X"]
    if device != "cpu":
        return [ev for ev in events if ev.get("cat") in DEVICE_CATEGORIES]
    # host ops nest (aten::matmul holds aten::mm): keep each thread's outermost
    ops = sorted(
        (ev for ev in events if ev.get("cat") == "cpu_op"),
        key=lambda ev: (ev.get("pid"), ev.get("tid"), ev.get("ts", 0), -ev.get("dur", 0)),
    )
    out, thread, end = [], None, float("-inf")
    for ev in ops:
        if (ev.get("pid"), ev.get("tid")) != thread:
            thread, end = (ev.get("pid"), ev.get("tid")), float("-inf")
        if ev.get("ts", 0) >= end:
            out.append(ev)
            end = ev.get("ts", 0) + ev.get("dur", 0)
    return out


def short_kernel_name(mangled: str) -> str:
    """``attn_wgmma_kernel<64,1,1>`` for the mangled name of a kernel whose
    template arguments are ints, bools and element types."""
    hit = re.search(r"\d([a-z][a-z_]*_kernel)I(.*?)EEv", mangled)
    if hit:
        parts = re.findall(r"L[ib](\d+)|13__nv_(bfloat16)|^(f)|(?<=E)(f)", hit.group(2))
        return f"{hit.group(1)}<{','.join(next(a for a in g if a) for g in parts)}>"
    return mangled


def _group(name: str) -> str:
    """One group per kernel and template instance: ``void k<64, true>(args)``
    -> ``k<64,true>``, a mangled name as :func:`short_kernel_name` shortens
    it; other names lose a trailing instance number (``fusion.123``)."""
    if name.startswith("_Z"):
        return short_kernel_name(name)
    if name.startswith("void "):
        name = name[len("void "):]
        depth = 0
        for i in range(len(name) - 1, -1, -1):  # cut the trailing (argument list)
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0 and name[i] == "(":
                name = name[:i]
                break
        return re.sub(r",\s+", ",", name)
    return re.sub(r"[.\d]+$", "", name)


def summarize(trace: dict, *, device: str = "cuda", raw: bool = False) -> list[tuple[str, float, int]]:
    """(name, total microseconds, count) by op name, longest first."""
    total_us: collections.Counter = collections.Counter()
    count: collections.Counter = collections.Counter()
    for ev in device_events(trace, device):
        key = ev.get("name", "?") if raw else _group(ev.get("name", "?"))
        total_us[key] += ev.get("dur", 0)
        count[key] += 1
    return [(name, us, count[name]) for name, us in total_us.most_common()]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("profile_dir", type=Path)
    parser.add_argument("--top", type=int, default=25)
    parser.add_argument("--raw", action="store_true", help="no name grouping")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default): the card's events; cpu: the host's ops")
    args = parser.parse_args(argv)

    trace = load_trace(args.profile_dir)
    rows = summarize(trace, device=args.device, raw=args.raw)
    if not rows:
        print(f"no {args.device} events found; event categories in trace:", file=sys.stderr)
        cats = collections.Counter(ev.get("cat") for ev in trace.get("traceEvents", []))
        for cat, n in cats.most_common():
            print("  ", cat, n, file=sys.stderr)
        return 1

    grand = sum(us for _, us, _ in rows)
    print(f"device events: {sum(n for _, _, n in rows)}, total {grand / 1e3:.2f} ms")
    for name, us, n in rows[: args.top]:
        print(f"{us / 1e3:9.2f} ms  {100 * us / grand:5.1f}%  x{n:<5d} {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
