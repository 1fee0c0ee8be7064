"""Each cell's traffic through the harness's inner functions on the CPU, at
tiny sizes: set-up, window, check, result line."""

import pytest

from ketbench.core import load_benchmark
from ketbench.run import result_line, run_cell
from ketbench.tests.tiny import tiny

SEED = 2**33 + 17  # over 32 bits, as the driver's seeds are

CELLS = ["vit-tag", "swin-tag", "vit-query"]
E2E = {"vit-tag": "tag_images_per_s", "swin-tag": "tag_images_per_s", "vit-query": "query_p95_ms"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell):
    bench = load_benchmark()
    record, ctx = run_cell(cell, seed=SEED, seconds=0.5, trace=False, device="cpu", edit=tiny, bench=bench)
    line = result_line(bench, ctx, record)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {E2E[cell], "setup_s"}
    assert line["metrics"][E2E[cell]]["value"] > 0
    assert list(line)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("cell,metric", [("vit-tag", "tag.complete_ms"), ("vit-query", "query.p50_ms")])
def test_traced_run_reports_host_metrics(cell, metric):
    """On the CPU the trace holds no device operation: the device metrics
    are left out, the host ones are read."""
    bench = load_benchmark()
    record, ctx = run_cell(cell, seed=SEED, seconds=0.3, trace=True, device="cpu", edit=tiny, bench=bench)
    line = result_line(bench, ctx, record)
    assert set(line["metrics"]) == {metric}
    assert line["device"]["window_s"] > 0
    assert len(line["breakdown"]["idle_gaps"]) >= 1


def test_same_seed_same_inputs():
    from ketbench import images

    shapes = images.assign_sizes([5, 1], images.picture_sizes(8, 40, 300, 0.5, 2.0))
    a = images.picture([5, 1], 3, *shapes[3])
    b = images.picture([5, 1], 3, *shapes[3])
    c = images.picture([6, 1], 3, *shapes[3])
    assert (a == b).all() and not (a == c).all()
    other = images.assign_sizes([6, 1], images.picture_sizes(8, 40, 300, 0.5, 2.0))
    assert sorted(map(tuple, shapes)) == sorted(map(tuple, other))  # same sizes, another order


@pytest.mark.parametrize("alpha", [0.32, 0.14, 0.5, 0.001, 0.999])
def test_blend_equals_pil(alpha):
    """The pictures' NumPy blend gives PIL's ``Image.blend`` value for value."""
    import numpy as np
    from PIL import Image

    from ketbench import images

    rng = np.random.default_rng(7)
    a, b = (rng.integers(0, 256, (300, 200, 3), dtype=np.uint8) for _ in range(2))
    want = np.asarray(Image.blend(Image.fromarray(a), Image.fromarray(b), alpha))
    assert (images._blend(a, b, alpha) == want).all()


def test_reservoir_keeps_a_seeded_uniform_sample():
    """The tagging window keeps ``size`` completions, the same for a seed,
    late ones as often as early ones, and counts every row offered."""
    import numpy as np

    from ketbench.drivers.tag import Reservoir

    def sample(seed):
        r = Reservoir(3, [seed, 0])
        for j in range(100):
            r.offer(j, [None] * (j % 4))
        return r

    r = sample(5)
    assert r.seen == 100 and r.rows == sum(j % 4 for j in range(100))
    assert len(r.kept) == 3 and [j for j, _ in r.kept] == [j for j, _ in sample(5).kept]
    picked = np.concatenate([[j for j, _ in sample(s).kept] for s in range(600)])
    assert abs((picked < 50).mean() - 0.5) < 0.05
