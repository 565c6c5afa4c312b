"""Pareto-front utilities for the epsilon sweep.

Counterpart of epidemicmodeling_tpu/control/pareto.py:19,33,45,57:
- the epsilon grid: 250-point log + linear mixture
  (testScripts/testPrescribeXPRIZE02.m:49-53);
- Pareto-front membership, of one point set or per region: a point is on
  the front iff no other point strictly dominates it in both objectives
  (Tools/TrainPredictPrescribeNPI.m:624-628);
- the Monte-Carlo baseline's random NPI schedules, half constant over time,
  half redrawn daily (Tools/TrainPredictPrescribeNPI.m:496-522).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def epsilon_grid(n_points: int = 250, dtype=torch.float64,
                 device=None) -> torch.Tensor:
    """Half the points logarithmic, logspace(-12, -eps, n/2) ~ [1e-12, 1],
    then half linear, linspace(eps, 1-eps, n/2). eps is the float64 machine
    epsilon whatever ``dtype`` is (as in the reference). epsilon = 0
    neglects the NPI cost; epsilon = 1 neglects the human cost."""
    n_log = n_points // 2
    n_lin = n_points - n_log
    meps = float(np.finfo(np.float64).eps)
    kw = dict(dtype=torch.float64, device=device)
    log_part = 10.0 ** torch.linspace(-12.0, -meps, n_log, **kw)
    lin_part = torch.linspace(meps, 1.0 - meps, n_lin, **kw)
    return torch.cat([log_part, lin_part]).to(dtype)


def pareto_front_mask(J0: torch.Tensor, J1: torch.Tensor) -> torch.Tensor:
    """J0, J1 (N,) -> (N,) bool, True where no other point has strictly
    smaller J0 AND strictly smaller J1 (both minimized)."""
    dominated = (J0[None, :] < J0[:, None]) & (J1[None, :] < J1[:, None])
    return ~torch.any(dominated, dim=1)


def pareto_front_mask_batched(J0: torch.Tensor,
                              J1: torch.Tensor) -> torch.Tensor:
    """Per-region front membership: J0, J1 (E, R) -> (E, R) bool, True where
    no other epsilon's point has strictly smaller J0 AND strictly smaller
    J1."""
    dominated = ((J0[None, :, :] < J0[:, None, :])
                 & (J1[None, :, :] < J1[:, None, :]))   # (E, E, R)
    return ~torch.any(dominated, dim=1)


def random_npi_schedules(generator: Optional[torch.Generator], n_scenarios,
                         npi_mins, npi_maxes, T, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """Draw the Monte-Carlo baseline's NPI schedules: scenario s < N/2 holds
    one random level per NPI constant over time, the rest redraw every day.
    Integer levels are inclusive of both bounds, like MATLAB randi. The draws
    come from ``generator`` (on its own device) and are moved to ``device``.
    Returns (N, T, P)."""
    draw = lambda shape: npi_level_draws(generator, shape, npi_mins,
                                         npi_maxes)
    gdev = generator.device if generator is not None else torch.device("cpu")
    P = len(np.asarray(npi_mins).reshape(-1))
    const_draw = draw((n_scenarios, 1, P)).expand(n_scenarios, T, P)
    daily_draw = draw((n_scenarios, T, P))
    is_const = (torch.arange(n_scenarios, device=gdev)
                < n_scenarios // 2)[:, None, None]
    return torch.where(is_const, const_draw, daily_draw).to(
        dtype=dtype, device=device)


def npi_level_draws(generator: Optional[torch.Generator], shape, npi_mins,
                    npi_maxes) -> torch.Tensor:
    """Uniform integer NPI levels of ``shape`` (..., P), each in
    [min, max] inclusive like MATLAB randi, as int64 on the generator's
    device (torch's default generator on the CPU when None)."""
    gdev = generator.device if generator is not None else torch.device("cpu")
    lo = torch.as_tensor(np.asarray(npi_mins, np.int64).reshape(-1),
                         device=gdev)
    hi = torch.as_tensor(np.asarray(npi_maxes, np.int64).reshape(-1),
                         device=gdev)
    span = (hi - lo + 1).to(torch.float64)
    r = torch.rand(shape, generator=generator, dtype=torch.float64,
                   device=gdev)
    return torch.minimum(lo + torch.floor(r * span).to(torch.int64), hi)
