"""A run with its timed path broken underneath (the card's look skipped: on
the CPU) comes out not correct, once for each fault the cell can have."""

import pytest

from ketbench.check import alter_one_answer, half_batch_left_out
from ketbench.run import run_cell
from ketbench.tests.tiny import tiny


def tag_fault(kind):
    def fault(stage, rows):
        if stage != "tag_rows":
            return rows
        return alter_one_answer(rows) if kind == "altered" else half_batch_left_out(rows)
    return fault


def query_fault(kind):
    def fault(stage, ids):
        return ids[:-1] if kind == "altered" else ids[: len(ids) // 2]
    return fault


@pytest.mark.parametrize("cell,fault,fails", [
    ("vit-tag", tag_fault("altered"), "logit_gap"),
    ("vit-tag", tag_fault("half"), "rows_missing"),
    ("swin-tag", tag_fault("altered"), "logit_gap"),
    ("swin-tag", tag_fault("half"), "rows_missing"),
    ("vit-query", query_fault("altered"), "answers_differing"),
    ("vit-query", query_fault("half"), "answers_differing"),
])
def test_fault_is_caught(cell, fault, fails):
    record, _ = run_cell(cell, seed=29, seconds=0.3, trace=False, device="cpu", edit=tiny, fault=fault)
    assert record.correct is False
    value, limit = record.checks[fails]
    assert value > limit


@pytest.mark.parametrize("cell", ["vit-tag", "vit-query"])
def test_control_is_caught(cell):
    """The control (the reference in the next lower precision in the
    program's place) reads over every limit it is held to."""
    record, _ = run_cell(cell, seed=31, seconds=0.3, trace=False, device="cpu", edit=tiny, calibrate=True)
    assert record.correct is True
    control = record.counters["control"]
    assert any(control[k] > limit for k, (_, limit) in record.checks.items() if k in control)
