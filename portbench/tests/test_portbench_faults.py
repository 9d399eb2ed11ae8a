"""Whole runs with the timed path broken underneath, or with the control
in the program's place, come out not correct; the same runs unbroken come
out correct. The harness's look for a card is skipped (the CPU)."""

from __future__ import annotations

import time

import pytest

from portbench import faults, loop
from portbench.tests import tiny

CELLS = ("chol16k-1p", "gemm8k-r4")


def _run(tmp_path, cell, plant, **mix):
    return loop.run_cell(cell, 2 ** 31 + 77, 0.3, False,
                         start_epoch=time.time(), device="cpu",
                         bench=tiny.bench(tmp_path), plant=plant,
                         mix_overrides=dict(tiny.MIX, **mix))


@pytest.mark.parametrize("plant", ("control",) + faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_not_correct_in_one_process(tmp_path, cell, plant):
    # both configurations' code paths in one process: the cells' own
    # executor, bodies, check and limits
    out = _run(tmp_path, cell, plant, processes=1)
    assert not out["correct"] and out["failed"] >= 1, out["checked"]


@pytest.mark.parametrize("plant", ("control", "no_exchange"))
def test_a_broken_step_is_not_correct_on_ranks(tmp_path, plant):
    out = _run(tmp_path, "gemm8k-r4", plant)
    assert not out["correct"] and out["failed"] >= 1, out["checked"]


def test_an_unknown_fault_is_refused(tmp_path):
    with pytest.raises(ValueError):
        _run(tmp_path, "chol16k-1p", "no_such_fault")
