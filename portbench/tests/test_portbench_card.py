"""On the card (marked `gpu`): the control and the faults at each cell's own
size, three seeds each, read through the whole run: every one has to come
out not correct.  Run on the chip with

    python -m pytest portbench/tests/test_portbench_card.py -m gpu -s

which prints each run's numbers beside their limits (the upper readings of
`PERF.md`'s limits)."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import run
from portbench.tests.conftest import REPO
from portbench.tests.test_portbench_runs import FAULTS, fault_patched

CELLS = ["copd512.pair300", "copd512.landmarks300"]
SEEDS = [3_000_000_001, 3_000_000_002, 3_000_000_003]


def _show(label, line):
    print(json.dumps({"run": label, "correct": line["correct"], "checks": line["checks"]}),
          flush=True)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(card, cell):
    for seed in SEEDS:
        line, _ = run.run_cell(REPO, cell, seed, 1.0, False, card, control=True)
        _show(f"{cell} control {seed}", line)
        assert not line["correct"]


@pytest.mark.gpu
@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_on_the_card(card, cell, fault):
    for seed in SEEDS:
        with fault_patched(fault):
            line, _ = run.run_cell(REPO, cell, seed, 1.0, False, card)
        torch.cuda.synchronize()
        _show(f"{cell} {fault} {seed}", line)
        assert not line["correct"]
