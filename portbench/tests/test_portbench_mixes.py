"""Each traffic mix at a tiny size on the CPU through the port's plain
path: it agrees with the plain reference (``correct``), the control does
not, and neither does a run whose timed path carries one of the faults a
cell can have."""

import pytest
import torch

from portbench.faults import Faulty, freeze_optimizers
from portbench.reference.control import Control

from ._small import CELLS, run_small, small_cell


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_agrees_with_the_reference(cell):
    result, lines = run_small(cell)
    assert result["correct"], lines[-4:]
    assert result["attempted"] >= 1
    for name, check in result["checks"].items():
        assert check["value"] < check["limit"] / 3, (name, check)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_comes_out_not_correct(cell):
    c = small_cell(cell)
    result, lines = run_small(cell, backend=Control(c.config, "cpu"), cell=c)
    assert not result["correct"], lines[-4:]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["half_batch", "altered"])
def test_a_faulty_timed_path_comes_out_not_correct(cell, fault):
    c = small_cell(cell)
    result, lines = run_small(cell, backend=Faulty(c.config, "cpu", fault), cell=c)
    assert not result["correct"], (fault, lines[-4:])


@pytest.mark.parametrize("cell", ["d2.train", "d1.learn"])
def test_a_step_that_leaves_the_state_unchanged_comes_out_not_correct(cell):
    undo = freeze_optimizers()
    try:
        result, lines = run_small(cell)
    finally:
        undo()
    assert not result["correct"], lines[-4:]
    assert result["checks"]["change"]["value"] > 0.9
