"""The control of each cell comes out not correct: the reference put in
the program's place, computed with TF32 on (the nearest precision below
the cells' f32 with TF32 off), at the cell's own size on the card,
judged against the cell's limits. Card only:

    python -m pytest -m cuda benchmark/tests/test_benchmark_control.py
"""

import json
import os

import pytest
import torch

from benchmark import core

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
with open(os.path.join(REPO, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 77, 2 ** 33 + 5])
@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_is_not_correct(cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = core.Cell(REPO, cell)
    readings = c.driver().Driver(c, seed, "cuda").control("tf32")
    _, correct = core.check_entries(readings, c.limits)
    assert not correct, readings
