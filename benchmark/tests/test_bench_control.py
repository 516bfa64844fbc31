"""Each cell's control, the reference one precision below the
configuration's put in the program's place, fails the cell's limits: TF32
operands for the float32 FX step, int4 samples for IChar, a bfloat16
product for PackedXY.  At a tiny size on the CPU; ``benchmark.calibrate``
reads the same on the card at the cells' own sizes."""

from __future__ import annotations

import time

import pytest

from benchmark import harness
from benchmark.card import Card
from benchmark.tests.helpers import SEED, CpuCard, tiny_cell

WORKLOADS = [w["name"] for w in harness.load_spec()["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_control_fails_the_limits(workload, seed):
    cell = tiny_cell(workload)
    out = harness.run(cell, seed, 0.0, False, CpuCard(), time.perf_counter(),
                      control=True)
    assert out["failed"] == 0 and not out["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_on_card(workload):
    """A short run of each cell at its own size on the card (``-m cuda``
    there; skips without a card)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.find_cell(harness.load_spec(), workload)
    out = harness.run(cell, SEED, 2.0, False, Card("cuda:0"),
                      time.perf_counter())
    assert out["correct"], out["checks"]
