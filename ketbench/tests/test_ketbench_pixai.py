"""The PixAI cell (``pixai-tag``: EVA02 under ``tag-prepared-pixai``) on the
CPU at a tiny size of its own: correct, its traced run's host metrics, the
planted faults and the control caught, the check's semantics against a
plain selection, and the EVA02 roofline counts by hand."""

import numpy as np
import pytest

from ketbench import check, check_pixai, roofline, roofline_eva02
from ketbench.core import load_benchmark, load_config
from ketbench.run import result_line, run_cell

SEED = 2**33 + 23
H100 = "NVIDIA H100 80GB HBM3"

# at these sizes the bf16 program reads a logit gap of 0.02-0.04 against the
# float32 reference and the fp8 control 0.08-0.25
TINY_LIMITS = {"logit_gap": 0.08}


def tiny_pixai(config: dict, traffic: dict) -> None:
    """Cut the PixAI cell's two documents to CPU size, in place: 4 x 4
    patches, 2 blocks of width 64, 36 labels (6 characters over 3
    copyrights), batches of 4."""
    config.update(image_size=56, hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=170,
                  num_labels=36, labels={"general": 30, "character": 6}, copyrights=3, batch_size=4,
                  head_bias={"sure": {"general": 5, "character": 1},
                             "sure_bias": {"general": [1.0, 4.0], "character": [3.0, 5.5]},
                             "borderline": {"general": 2, "character": 1},
                             "borderline_below_threshold": [0.0, 1.0], "rest": -8.0},
                  check_limits=dict(TINY_LIMITS))
    traffic.update(batches=2, long_side=[40, 300], threads=2, warm_batches=2, check_batches=2)


def test_cell_runs_and_is_correct():
    bench = load_benchmark()
    record, ctx = run_cell("pixai-tag", seed=SEED, seconds=0.5, trace=False, device="cpu", edit=tiny_pixai,
                           bench=bench)
    line = result_line(bench, ctx, record)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"tag_images_per_s", "setup_s"}
    assert record.counters["copyright_rows_per_row"] > 0 and record.counters["tags_per_row"] > 0
    assert list(line["checks"]) == ["logit_gap", "bad_rows", "rows_missing"]


def test_traced_run_reports_the_host_metrics():
    """On the CPU the trace holds no device operation: the device metrics
    (EVA02's MFU, the two rooflines, the idle share) are left out, the
    host's are read."""
    bench = load_benchmark()
    record, ctx = run_cell("pixai-tag", seed=SEED, seconds=0.3, trace=True, device="cpu", edit=tiny_pixai,
                           bench=bench)
    line = result_line(bench, ctx, record)
    assert set(line["metrics"]) == {"tag.complete_ms"}
    assert line["device"]["window_s"] > 0


def tag_fault(kind):
    def fault(stage, rows):
        if stage != "tag_rows":
            return rows
        return {"altered": check.alter_one_answer, "half": check.half_batch_left_out,
                "copyright": check_pixai.drop_one_copyright}[kind](rows)
    return fault


@pytest.mark.parametrize("kind,fails", [("altered", "logit_gap"), ("half", "rows_missing"),
                                        ("copyright", "logit_gap")])
def test_fault_is_caught(kind, fails):
    record, _ = run_cell("pixai-tag", seed=29, seconds=0.3, trace=False, device="cpu", edit=tiny_pixai,
                         fault=tag_fault(kind))
    assert record.correct is False
    value, limit = record.checks[fails]
    assert value > limit


def test_control_is_caught():
    """The fp8 reference in the program's place reads over the limit; the
    planted faults read in the calibration's counters too."""
    record, _ = run_cell("pixai-tag", seed=31, seconds=0.3, trace=False, device="cpu", edit=tiny_pixai,
                         calibrate=True)
    assert record.correct is True
    assert record.counters["control"]["logit_gap"] > TINY_LIMITS["logit_gap"]
    faults = record.counters["faults"]
    assert faults["answer_altered"]["logit_gap"] > TINY_LIMITS["logit_gap"]
    assert faults["half_batch_left_out"]["rows_missing"] > 0
    assert faults["copyright_dropped"]["logit_gap"] > TINY_LIMITS["logit_gap"]


@pytest.mark.parametrize("term", ["attn.q_proj.bias", "attn.v_proj.bias", "mlp.norm.weight", "fc_norm.bias"])
def test_a_port_that_leaves_out_an_affine_term_is_caught(term):
    """The driver moves every bias, norm scale and the class token off its
    init, so a port that leaves one of these terms out (here: holds it at
    its init in every block) reads over the limit, where the whole state
    reads under it."""
    import torch

    from ketbench import images
    from ketbench.drivers import tag_pixai
    from ketbench.reference.pixai_pictures import shortside_centercrop
    from kobato_eyes_tpu_torch.models.eva02 import EVA02
    from kobato_eyes_tpu_torch.models.preprocess import PreprocessSpec, normalize_on_device

    cfg = load_config(load_benchmark(), "pixai-eva02-l14-448")
    tiny_pixai(cfg, {})
    table = tag_pixai.label_table(cfg)
    state = tag_pixai.make_state(cfg, table, SEED, "cpu")
    for key, value in state.items():
        if key != "head.bias" and (value.dim() == 1 or key == "cls_token"):
            assert not torch.equal(value, torch.full_like(value, float(key.endswith("weight")))), key
    pics = np.stack([shortside_centercrop(images.picture([5, 0], i, 60 + 9 * i, 90 - 7 * i), cfg["image_size"])
                     for i in range(4)])
    ref = tag_pixai.reference_logits(cfg, state, pics, "cpu")
    model = EVA02(tag_pixai.port_config(cfg)).eval()
    x = normalize_on_device(torch.from_numpy(pics), PreprocessSpec(mode="pixai", size=cfg["image_size"],
                                                                   mean=tuple(cfg["mean"]), std=tuple(cfg["std"])))

    def gap(weights):
        model.load_state_dict(weights)
        with torch.inference_mode():
            rows = check_pixai.select_rows(model(x).double().numpy(), table)
        return check_pixai.compare_pixai_rows(rows, ref, table)["logit_gap"]

    init = float(term.endswith("weight"))
    assert gap(state) < TINY_LIMITS["logit_gap"]
    assert gap({k: torch.full_like(v, init) if k.endswith(term) else v for k, v in state.items()}) > TINY_LIMITS["logit_gap"]


def small_table(limits=None):
    names = [f"g{i}" for i in range(8)] + [f"c{i}" for i in range(4)]
    cats = np.array([0] * 8 + [4] * 4, dtype=np.int32)
    ips = {8: ("s0",), 9: ("s0",), 10: ("s1",), 11: ("s1", "s2")}
    return check_pixai.PixaiTable(names=names, cats=cats, ips=ips, thresholds={0: 0.4, 4: 0.8, 3: 0.8}, floor=0.1,
                                  limits=limits or {0: 128, 4: 10, 3: 10}, cap=128)


def test_plain_selection_matches_its_own_check():
    """Rows the plain selection makes from some logits read no gap and no
    bad row against those logits; copyrights take their best character's
    score; dropping a copyright or a label, or a full category's cut, is
    seen."""
    table = small_table()
    logits = np.array([[2.0, 1.0, -0.3, -0.5, -3, -3, -3, -3, 3.0, 2.5, 1.2, 2.0]])
    (row,) = check_pixai.select_rows(logits, table)
    by_name = {n: (s, c) for n, s, c in row}
    assert set(by_name) == {"g0", "g1", "g2", "c0", "c1", "c3", "s0", "s1", "s2"}
    assert by_name["s0"] == (by_name["c0"][0], 3) and by_name["s1"] == (by_name["c3"][0], 3)
    numbers = check_pixai.compare_pixai_rows([row], logits, table)
    assert numbers["logit_gap"] < 1e-6 and numbers["bad_rows"] == 0
    assert numbers["copyright_rows_per_row"] == 3
    dropped = [[e for e in row if e[0] != "s2"]]
    assert check_pixai.compare_pixai_rows(dropped, logits, table)["logit_gap"] == pytest.approx(2.0 - float(check.logit(0.8)))
    orphan = [[e for e in row if e[0] != "c3"]]  # s1 and s2 left with no character of theirs
    assert check_pixai.compare_pixai_rows(orphan, logits, table)["bad_rows"] == 1
    capped = small_table({0: 2, 4: 10, 3: 10})
    (row2,) = check_pixai.select_rows(logits, capped)
    assert [n for n, _, c in row2 if c == 0] == ["g0", "g1"]
    assert check_pixai.compare_pixai_rows([row2], logits, capped)["logit_gap"] < 1e-6


def test_roofline_counts_at_eva02_l_448():
    """By hand at batch 32: the forward 723.5 GFLOP an image; kernel 1 4 B H T^2 D =
    137.7 GFLOP and 4 B T H D x 2 bytes = 268.7 MB a launch, 0.1392 ms
    (operations); the rotation 2 x 2 x B x 1024 x 2 x 16 x 64 bytes of q and k
    plus 2 x 1024 x 32 x 4 of tables = 268.7 MB, 0.0802 ms (bytes); 24 each
    a forward."""
    from kobato_eyes_tpu_torch.models.eva02 import EVA02Config, eva02_forward_flops

    cfg = load_config(load_benchmark(), "pixai-eva02-l14-448")
    assert round(roofline_eva02.eva02_forward_flops(cfg, 1) / 1e9, 1) == 723.5
    assert roofline_eva02.eva02_forward_flops(cfg, 32) == eva02_forward_flops(EVA02Config(), 32)
    attn = roofline_eva02.eva02_attention_launches(cfg, 32)
    assert len(attn) == 24 and attn[0] == (4.0 * 32 * 16 * 1025**2 * 64, 4.0 * 32 * 1025 * 16 * 64 * 2)
    assert round(attn[0][0] / 1e9, 1) == 137.7 and round(attn[0][1] / 1e6, 1) == 268.7
    assert round(roofline.bound_seconds(attn[:1], H100) * 1e3, 4) == 0.1392
    rope = roofline_eva02.rope_launches(cfg, 32)
    assert len(rope) == 24 and rope[0][1] == 2 * 2 * 32 * 1024 * 2 * 16 * 64 + 2 * 1024 * 32 * 4
    assert round(rope[0][1] / 1e6, 1) == 268.7
    assert round(roofline.bound_seconds(rope[:1], H100) * 1e3, 4) == 0.0802
