"""The control: the reference in the precision below the configuration's
(float32 with every product's operands rounded to TF32) put in the
program's place fails the cell's limits. The same check runs at the
cells' own sizes on the card (benchmark/readings.py --control); here at a
size a test run holds."""

import math

import pytest
import torch

from benchmark import readings
from benchmark.reference import plain
from benchmark.tests.conftest import CELLS, small_files


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      1.0 + 2 ** -10 + 2 ** -12, float("inf"),
                      -3.0000001], dtype=torch.float32)
    r = plain.tf32(x)
    # ties to even on the 10th mantissa bit, inf kept
    assert r.tolist()[:5] == [1.0, 1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10,
                              float("inf")]
    assert float(r[5]) == -3.0


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [1, 2])
def test_control_is_not_correct(workload, seed):
    files = small_files(workload, t_hist=440, horizon=92)
    numbers = readings.control_numbers(files, seed, torch.device("cpu"))
    limits = files["limits"]
    failed = [n for n in numbers
              if not (math.isfinite(numbers[n]) and numbers[n] <= limits[n])]
    assert failed, numbers


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import run
    from benchmark.tests.conftest import ROOT
    files = run.cell_files(ROOT, workload)
    for seed in (1, 2, 3):
        numbers = readings.control_numbers(files, seed,
                                           torch.device("cuda", 0))
        limits = files["limits"]
        assert any(not numbers[n] <= limits[n] for n in numbers)
