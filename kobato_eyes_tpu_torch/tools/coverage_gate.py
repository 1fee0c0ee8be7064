"""Line-coverage gate for the port's tests (reference: pyproject.toml:92-96,
``fail_under = 80`` via pytest-cov).

Counterpart of the repository's ``tools/coverage_gate.py``, measuring the
port (``kobato_eyes_tpu_torch/``) under its own CPU tests. pytest-cov is not
available in this environment, so this harness measures line coverage with
the stdlib ``sys.monitoring`` API (PEP 669, Python 3.12+): a LINE callback
records each (file, line) the first time it executes and then returns
``sys.monitoring.DISABLE`` for that location, so steady-state overhead is
near zero.

Executable lines are derived from the compiled code objects of every module
under ``kobato_eyes_tpu_torch/`` (recursively walking ``co_consts`` and
collecting ``co_lines()``), which is exactly the set of lines the
interpreter can attribute events to.  Lines marked ``# pragma: no cover``
(and any line inside a function/class whose ``def``/``class`` line is
marked) are excluded, matching coverage.py's contract.

Usage (from the repository's root)::

    python -m kobato_eyes_tpu_torch.tools.coverage_gate [--fail-under PCT] [pytest args...]

With no pytest arguments it runs ``tests/test_torch_*.py``. Exit status is
non-zero when total coverage is below the gate or when the test run itself
fails.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
PACKAGE = REPO / "kobato_eyes_tpu_torch"
TOOL_ID = sys.monitoring.COVERAGE_ID


def executable_lines(path: Path) -> set[int]:
    """All line numbers the interpreter can execute in ``path``."""
    source = path.read_text(encoding="utf-8")
    try:
        top = compile(source, str(path), "exec")
    except SyntaxError:
        return set()
    lines: set[int] = set()
    stack = [top]
    while stack:
        code = stack.pop()
        for _, _, lineno in code.co_lines():
            if lineno is not None:
                lines.add(lineno)
        for const in code.co_consts:
            if type(const).__name__ == "code":
                stack.append(const)
    return lines


def pragma_excluded(path: Path) -> set[int]:
    """Lines excluded by ``# pragma: no cover`` (block-aware for def/class)."""
    import ast

    source = path.read_text(encoding="utf-8")
    marked = {
        i
        for i, text in enumerate(source.splitlines(), start=1)
        if "pragma: no cover" in text
    }
    if not marked:
        return set()
    excluded = set(marked)
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return excluded
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            header = set(range(node.lineno, node.body[0].lineno))
            if header & marked:
                excluded.update(range(node.lineno, node.end_lineno + 1))
    return excluded


def collect_targets() -> dict[str, set[int]]:
    targets: dict[str, set[int]] = {}
    for path in sorted(PACKAGE.rglob("*.py")):
        lines = executable_lines(path) - pragma_excluded(path)
        if lines:
            targets[str(path)] = lines
    return targets


def default_pytest_args() -> list[str]:
    """The port's own tests, quietly."""
    return [str(p) for p in sorted((REPO / "tests").glob("test_torch_*.py"))] + ["-q"]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--fail-under", type=float, default=80.0)
    parser.add_argument(
        "--missing", metavar="SUBSTR", action="append", default=[],
        help="print missed line numbers for modules whose path contains SUBSTR "
             "(coverage.py's 'Missing' column equivalent); repeatable",
    )
    parser.add_argument("pytest_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))  # the tests import ``tests.*``, as under `pytest` from the root

    targets = collect_targets()
    prefix = str(PACKAGE) + os.sep
    hits: dict[str, set[int]] = {name: set() for name in targets}

    def on_line(code, lineno):
        filename = code.co_filename
        if filename.startswith(prefix):
            got = hits.get(filename)
            if got is not None:
                got.add(lineno)
        return sys.monitoring.DISABLE

    sys.monitoring.use_tool_id(TOOL_ID, "ket-coverage-gate")
    sys.monitoring.register_callback(TOOL_ID, sys.monitoring.events.LINE, on_line)
    sys.monitoring.set_events(TOOL_ID, sys.monitoring.events.LINE)

    import pytest

    pytest_args = [a for a in args.pytest_args if a != "--"] or default_pytest_args()
    rc = pytest.main(pytest_args)

    sys.monitoring.set_events(TOOL_ID, 0)
    sys.monitoring.free_tool_id(TOOL_ID)

    total_exec = 0
    total_hit = 0
    rows = []
    for name in sorted(targets):
        n_exec = len(targets[name])
        n_hit = len(hits[name] & targets[name])
        total_exec += n_exec
        total_hit += n_hit
        rows.append((name, n_exec, n_hit))

    width = max(len(os.path.relpath(name, REPO)) for name, _, _ in rows)
    print(f"\n{'file':<{width}}  lines  miss  cover")
    for name, n_exec, n_hit in rows:
        pct = 100.0 * n_hit / n_exec if n_exec else 100.0
        rel = os.path.relpath(name, REPO)
        print(f"{rel:<{width}}  {n_exec:5d}  {n_exec - n_hit:4d}  {pct:5.1f}%")
    total_pct = 100.0 * total_hit / total_exec if total_exec else 100.0
    print(f"{'TOTAL':<{width}}  {total_exec:5d}  {total_exec - total_hit:4d}  {total_pct:5.1f}%")

    def _ranges(lines: list[int]) -> str:
        out, start, prev = [], None, None
        for n in lines:
            if start is None:
                start = prev = n
            elif n == prev + 1:
                prev = n
            else:
                out.append(f"{start}-{prev}" if prev > start else str(start))
                start = prev = n
        if start is not None:
            out.append(f"{start}-{prev}" if prev > start else str(start))
        return ", ".join(out)

    for substr in args.missing:
        for name in sorted(targets):
            rel = os.path.relpath(name, REPO)
            if substr in rel:
                missed = sorted(targets[name] - hits[name])
                if missed:
                    print(f"missing {rel}: {_ranges(missed)}")

    if rc != 0:
        print(f"coverage gate: test run failed (rc={rc})", file=sys.stderr)
        return int(rc)
    if total_pct < args.fail_under:
        print(
            f"coverage gate: {total_pct:.1f}% < fail-under {args.fail_under:.1f}%",
            file=sys.stderr,
        )
        return 2
    print(f"coverage gate: {total_pct:.1f}% >= {args.fail_under:.1f}% (pass)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
