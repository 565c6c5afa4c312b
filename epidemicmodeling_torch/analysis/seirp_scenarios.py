"""The five named SEIRP scenario studies.

Counterpart of epidemicmodeling_tpu/analysis/seirp_scenarios.py:
testScripts/testSEIRP01.m:18-74, scenarios A (immunizing disease), B
(non-immunizing), C (declining contact rates), D (slow incubation), E
(one-year immunity), each a set of constant or scheduled rates. The table is
the port's own copy of the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.seirp import seirp_rollout
from ..utils.device import resolve_device

N_POP = 84.0e6

SEIRP_SCENARIOS = {
    # name: (T_days, rates: numbers or ("declining", initial value))
    "A": dict(T=50, alpha_e=0.65, alpha_i=0.005, kappa=0.05, rho=0.08,
              beta=0.1, mu=0.02, gamma=0.0),
    "B": dict(T=4000, alpha_e=0.65, alpha_i=0.005, kappa=0.05, rho=0.08,
              beta=0.1, mu=0.02, gamma=0.001),
    "C": dict(T=120, alpha_e=("declining", 0.65), alpha_i=("declining", 0.005),
              kappa=0.05, rho=0.08, beta=0.1, mu=0.02, gamma=0.001),
    "D": dict(T=4000, alpha_e=0.65, alpha_i=0.005, kappa=0.005, rho=0.08,
              beta=0.1, mu=0.02, gamma=0.001),
    "E": dict(T=4000, alpha_e=0.65, alpha_i=0.005, kappa=0.05, rho=0.08,
              beta=0.1, mu=0.02, gamma=1.0 / 365.0),
}

RATE_NAMES = ("alpha_e", "alpha_i", "kappa", "rho", "beta", "mu", "gamma")


def _schedule(spec, K):
    if isinstance(spec, tuple) and spec[0] == "declining":
        # alpha * linspace(1, 0.01, K)   (testSEIRP01.m:44-45)
        return spec[1] * np.linspace(1.0, 0.01, K)
    return np.full(K, float(spec))


def scenario_schedules(name: str, dt: float = 0.1):
    """(T, rates): a named scenario's horizon in days and its seven rate
    schedules (NumPy, K = round(T/dt) samples each), for batching scenarios
    of one T through seirp_rollout's leading dimensions."""
    spec = SEIRP_SCENARIOS[name]
    K = int(round(spec["T"] / dt))
    return spec["T"], {k: _schedule(spec[k], K) for k in RATE_NAMES}


def run_seirp_scenario(name: str, dt: float = 0.1, N: float = N_POP,
                       device=None):
    """Run one named scenario with e(0) = 1/N (testSEIRP01.m:76-78).
    Returns a dict with t, s, e, i, r, p (tensors on ``device``, else on
    the CUDA card), the rate schedules (NumPy), N and dt."""
    dev = resolve_device(device)
    T, rates = scenario_schedules(name, dt)
    e0 = 1.0 / N
    s, e, i, r, p = seirp_rollout(
        *(torch.as_tensor(rates[k], device=dev) for k in RATE_NAMES),
        1.0 - e0, e0, 0.0, 0.0, 0.0, T, dt)
    t = dt * torch.arange(s.shape[-1], dtype=torch.float64, device=dev)
    return dict(t=t, s=s, e=e, i=i, r=r, p=p, rates=rates, N=N, dt=dt)
