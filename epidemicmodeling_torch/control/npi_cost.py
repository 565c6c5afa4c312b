"""Bi-objective NPI cost (Tools/NPICost.m:5-10).

J0 (human cost)   = mean of the new-case series
J1 (NPI burden)   = mean over all (npi, day) entries of weights .* inputs

Counterpart of epidemicmodeling_tpu/control/npi_cost.py:15, vectorized over
any leading batch axes.
"""

from __future__ import annotations

import torch


def npi_cost(newcases: torch.Tensor, inputs: torch.Tensor, weights):
    """newcases: (..., T); inputs: (..., P, T) or (..., T, P); weights
    broadcastable to inputs. Returns (J0, J1) with the batch shape."""
    J0 = torch.mean(newcases, dim=-1)
    J1 = torch.mean(weights * inputs, dim=(-2, -1))
    return J0, J1
