"""SIR compartmental model (Euler discretization).

Counterpart of epidemicmodeling_tpu/models/sir.py: the 3-compartment Euler
loop of testScripts/testSIR01.m:32-36 with time-invariant contact rate
alpha, recovery rate beta and immunity-loss rate gamma, step dt. The loop
runs over (..., 3) states, so a batch of parameter sets is leading
dimensions on the parameters and initial states.
"""

from __future__ import annotations

import torch

from ..utils.math import float_args


def sir_step(state, params, _t=None):
    """One Euler step of ds/dt = -a s i + g r ; di/dt = a s i - b i ;
    dr/dt = b i - g r.

    state: (..., 3) [s, i, r]; params: dict with alpha, beta, gamma, dt
    (numbers or tensors broadcasting against the state's batch)."""
    s, i, r = state.unbind(-1)
    a, b, g, dt = params["alpha"], params["beta"], params["gamma"], params["dt"]
    ds = -a * s * i + g * r
    di = a * s * i - b * i
    dr = b * i - g * r
    return torch.stack([s + dt * ds, i + dt * di, r + dt * dr], dim=-1)


def sir_rollout(s0, i0, r0, alpha, beta, gamma, T, dt, device=None):
    """Roll the SIR model for K = round(T/dt) samples; returns (s, i, r),
    each (..., K), the first sample the initial condition (K - 1 Euler
    updates, testScripts/testSIR01.m). Runs on ``device``, else where the
    first tensor argument lies, else on the CUDA card."""
    K = int(round(T / dt))
    s0, i0, r0, alpha, beta, gamma = float_args(
        device, s0, i0, r0, alpha, beta, gamma)
    params = {"alpha": alpha, "beta": beta, "gamma": gamma, "dt": dt}
    x = torch.stack(torch.broadcast_tensors(s0, i0, r0, alpha, beta,
                                            gamma)[:3], dim=-1)
    traj = []
    for _ in range(K):
        traj.append(x)
        x = sir_step(x, params)
    return torch.stack(traj, dim=-2).unbind(-1)
