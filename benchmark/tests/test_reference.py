"""The reference against the port at a small size: with the program run in
float64 on the CPU (the kernels' plain versions), every compared number
is at rounding level, so the reference computes what the program
computes."""

import pytest
import torch

from benchmark import run
from benchmark.entries import _xprize
from benchmark.tests.conftest import PAIRS, cut, files_of


@pytest.mark.parametrize("pair", PAIRS, ids="/".join)
def test_reference_equals_the_port_in_float64(pair, workdir, monkeypatch):
    monkeypatch.setattr(_xprize, "F32", torch.float64)
    torch.manual_seed(0)
    res = run.run_cell(cut(files_of(*pair)), 7, 0.0, 0,
                       torch.device("cpu"), workdir)
    numbers = res["numbers"]
    assert res["correct"]
    assert max(numbers.values()) < 1e-12, numbers
