"""Shared helpers of the tests that hold the port's measuring entry points
(``kobato_eyes_tpu_torch/bench.py``, ``kobato_eyes_tpu_torch/tools/``)
against the repository's own (``bench.py``, ``tools/``): load a JAX tool by
path, run a tool's ``main`` with its standard output captured, and compare
JSON documents by their keys."""

from __future__ import annotations

import ast
import contextlib
import importlib.util
import io
import json
from pathlib import Path

ROOT = Path(__file__).parent.parent


def load_jax_tool(rel: str):
    """A JAX entry point (root ``bench.py`` or ``tools/*.py``) by path."""
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_main(main, argv: list[str] | None) -> tuple[object, str]:
    """(return value, stdout) of a tool's ``main``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main() if argv is None else main(argv)
    return rc, out.getvalue()


def last_json(out: str) -> dict:
    return json.loads([line for line in out.splitlines() if line.startswith("{")][-1])


def key_tree(doc) -> dict:
    """The keys of a JSON document, nested dicts as subtrees."""
    if not isinstance(doc, dict):
        return {}
    return {k: key_tree(v) for k, v in doc.items()}


def dumps_keys(rel: str) -> dict:
    """The key tree of the dict literal that a JAX tool passes to
    ``json.dumps`` (its one JSON document)."""
    tree = ast.parse((ROOT / rel).read_text(encoding="utf-8"))
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "attr", None) == "dumps" and n.args
             and isinstance(n.args[0], ast.Dict)]
    assert len(calls) == 1, rel

    def walk(node) -> dict:
        return {k.value: (walk(v) if isinstance(v, ast.Dict) else {})
                for k, v in zip(node.keys, node.values)}

    return walk(calls[0].args[0])
