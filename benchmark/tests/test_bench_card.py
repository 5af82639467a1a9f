"""On the card (skipped without one): one short run of each cell comes out
correct and reports its end-to-end metrics; the control fails on the card
at the cell's own size."""

import pytest
import torch

from benchmark import check, control, run, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name):
    need_card()
    cell = spec.cell(name)
    r = run.run_cell(cell, 2**31 + 99, 3.0, False)
    assert r["correct"], r["check"]
    assert {m["name"] for m in cell.end_to_end} <= set(r["metrics"])


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name):
    need_card()
    cell = spec.cell(name)
    precision = control.LOWER[cell.config["model"]["compute_dtype"]]
    numbers = control.readings(cell, 2**31 + 98, precision, torch.device("cuda"))
    assert not check.verdict(numbers, cell.limits)[0], numbers
