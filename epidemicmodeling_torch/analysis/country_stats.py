"""Country-level comparative statistics.

Counterpart of epidemicmodeling_tpu/analysis/country_stats.py:
testScripts/testCountryStatistics01-04.m, mortality ratios, active-case
curves (confirmed - deaths - recovered) and the R0 estimate from
generation ratios R0(t) = (I(t)/I(t-p))^(1/p) (testCountryStatistics03.m).
Each function runs on ``device``, else where its first tensor argument
lies, else on the CUDA card.
"""

from __future__ import annotations

import torch

from ..utils.math import causal_moving_average as _ma
from ..utils.math import float_args


def mortality_rate(confirmed_deaths, confirmed_cases, device=None):
    """Deaths / cases with the non-finite ratios (0/0, x/0) mapped to 0
    (TrainNPIPrescriptor.m:264-266)."""
    d, c = float_args(device, confirmed_deaths, confirmed_cases)
    r = d / c
    return torch.where(torch.isfinite(r), r, torch.zeros_like(r))


def active_cases(total, deceased, recovered, device=None):
    """Infected = cases - deaths - recovered (Tools/ReadCOVID19Data.m:29)."""
    total, deceased, recovered = float_args(device, total, deceased,
                                            recovered)
    return total - deceased - recovered


def r0_generation_ratio(infected, generation_period: int, device=None):
    """R0(t) = (I(t) / I(t - p))^(1/p); the first p samples are 1
    (testCountryStatistics03.m)."""
    x = float_args(device, infected)[0].reshape(-1)
    p = generation_period
    ratio = (x[p:] / x[:-p]) ** (1.0 / p)
    return torch.cat([torch.ones(p, dtype=x.dtype, device=x.device), ratio])


def causal_moving_average(x, wlen: int = 7, clip_negative: bool = True,
                          device=None):
    """MATLAB ``filter(ones(1, wlen), wlen, x')'`` over the trailing time
    axis with negatives then clamped to 0 (testCountryStatistics04.m:25-30):
    the shared FIR filter of utils.math plus the clamp (NaN stays NaN)."""
    y = _ma(float_args(device, x)[0], wlen)
    return torch.clamp(y, min=0.0) if clip_negative else y


def lagged_case_rate(total_cases, infected, lag: int = 0,
                     smoothed: bool = False, wlen: int = 7, device=None):
    """``Rate = NewCases(:, 1+lag:end) ./ Infected(:, 1:end-1-lag)`` with
    negatives clamped to 0 (testCountryStatistics04.m:24-34): the lagged
    new-cases-per-active-infection curve family. With ``smoothed=True``
    both series first pass the causal moving average of length ``wlen``
    (the commented variant at :32).

    total_cases, infected: (..., T). Returns (..., T-1-lag)."""
    total, inf = float_args(device, total_cases, infected)
    new_cases = torch.diff(total, dim=-1)
    if smoothed:
        new_cases = causal_moving_average(new_cases, wlen)
        inf = causal_moving_average(inf, wlen)
    T1 = new_cases.shape[-1]
    rate = new_cases[..., lag:] / inf[..., : T1 - lag]
    return torch.clamp(rate, min=0.0)
