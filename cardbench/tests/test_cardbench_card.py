"""The control and the state fault on the card, at each cell's own size: one
cycle of the cell's mix served by the program, then the output check on a
sample of it.  The program's widest gap lies within the cell's limit, and
the float8 control's and that of the cycle served again with a decode step
that leaves its state unchanged beyond it.  Run on the card with

    PYTHONPATH=src python3 -m pytest -q -m cuda cardbench/tests/test_cardbench_card.py
"""
import json

import pytest
import torch

from cardbench import calibrate
from cardbench.tests.tiny import BENCH, REPO

CELLS = [c["name"] for c in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limit(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    limit = json.loads((BENCH / "limits" / f"{cell}.json").read_text())["max_gap"]["limit"]
    seed = 424242
    r, = calibrate.readings(REPO, cell, [seed], {seed}, {seed})
    assert r["max_gap"] <= limit < min(r["control_max_gap"], r["fault_max_gap"]), r
