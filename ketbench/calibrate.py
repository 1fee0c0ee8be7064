"""Readings that a cell's limits are set from, several seeds in one process.

    python3 -m ketbench.calibrate --workload <cell> --seeds 1 2 3 [--seconds 3]

For each seed: the cell's set-up, a short window at the cell's own load and
its check, printing one JSON line with the program's compared numbers, the
control's (the plain reference in the next lower precision put in the
program's place: fp8 for the bf16 taggers, bf16 scores for the query) and
the planted faults' (an answer altered where it is made; half of a batch
answered with the other half's rows). The benchmark's own runs never run
the control.
"""

from __future__ import annotations

import argparse
import json
import sys

from ketbench.core import BenchError, find_cell, load_benchmark, require_cards
from ketbench.run import ROOT, configure_environment, power_limit, run_cell


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    try:
        require_cards(find_cell(load_benchmark(ROOT), args.workload)["chips"])
    except BenchError as exc:
        print(f"ketbench: {exc}", file=sys.stderr)
        return 2
    configure_environment(ROOT)
    print(f"ketbench: card {power_limit()}", file=sys.stderr, flush=True)
    for seed in args.seeds:
        record, _ = run_cell(args.workload, seed=seed, seconds=args.seconds, trace=False, calibrate=True)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "correct": record.correct,
            "checks": {k: v for k, (v, _) in record.checks.items()},
            "control": record.counters.get("control"), "faults": record.counters.get("faults"),
            "e2e": record.e2e, "reference_s": sum(record.host_spans.get("reference", [])),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
