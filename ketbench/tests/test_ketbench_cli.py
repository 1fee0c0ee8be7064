"""The command without a card, and in a directory without the program."""

import shutil
import subprocess
import sys

import pytest

ARGS = ["-m", "ketbench.run", "--workload", "vit-tag", "--seed", "5", "--seconds", "1", "--trace", "0"]


def run(cwd):
    return subprocess.run([sys.executable, *ARGS], cwd=cwd, capture_output=True, text=True, timeout=120)


def test_exits_nonzero_without_a_card():
    import torch

    from ketbench.core import ROOT

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = run(ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_exits_nonzero_with_only_the_benchmark(tmp_path):
    from ketbench.core import ROOT

    shutil.copytree(ROOT / "ketbench", tmp_path / "ketbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = run(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""


def test_benchmark_file_keeps_to_the_contract():
    import json
    import re

    from ketbench.core import ROOT

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert name.match(m["name"]) and 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert name.match(m["name"]) and m["moves"] in e2e and set(m["workloads"]) <= cells
        assert (ROOT / "ketbench" / "metrics" / f"{m['name']}.py").is_file()
    for w in bench["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
        assert (ROOT / "ketbench" / "traffic" / f"{w['traffic']}.json").is_file()
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("ketbench/")
