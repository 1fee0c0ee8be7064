"""On a card: one short run of a cell through the command, its line read back."""

import json
import subprocess
import sys

import pytest


@pytest.mark.card
def test_short_run_on_the_card():
    import torch

    from ketbench.core import ROOT

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "ketbench.run", "--workload", "vit-tag", "--seed", "2147483700", "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=1200,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert line["metrics"]["tag_images_per_s"]["value"] > 0
