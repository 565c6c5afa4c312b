"""Filter-health diagnostics (the failure-detection layer).

Counterpart of epidemicmodeling_tpu/ops/diagnostics.py, a NumPy copy (the
JAX module is NumPy, but importing it pulls in jax) that also takes tensors
on any device. The reference's only online health metric is the
innovation-whiteness monitor rho (GenericExtendedKalmanFilter.m:171-179,
plotted per region at TrainPredictPrescribeNPI.m:708-713) plus NaN/Inf
covariance guards (GEKF.m:211-216); here those signals form a per-region
report for gating batch runs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..utils.math import host_array


class FilterHealth(NamedTuple):
    """Per-region filter-health report (NaN/explosion/whiteness checks)."""
    nan_states: np.ndarray        # (R,) bool: any non-finite state estimate
    rho_mean: np.ndarray          # (R,) innovation-whiteness mean (tail)
    rho_consistent: np.ndarray    # (R,) bool: rho in [lo, hi] (filter tuned)
    state_explosion: np.ndarray   # (R,) bool: |state| exceeded bound
    healthy: np.ndarray           # (R,) bool: all checks pass


def filter_health(s_smooth, rho=None, rho_band=(0.1, 10.0),
                  state_bound: float = 1e6, tail_fraction: float = 0.5
                  ) -> FilterHealth:
    """Assess a batch of filter runs. s_smooth: (R, T, m) smoothed states;
    rho: optional (R, T) whiteness monitor (tensors or arrays). A
    consistent filter has rho near 1: rho >> 1 means the observation noise
    is underestimated, rho << 1 overestimated."""
    S = host_array(s_smooth)
    R, T, m = S.shape
    nan_states = ~np.isfinite(S).all(axis=(1, 2))
    explosion = (np.abs(np.nan_to_num(S)) > state_bound).any(axis=(1, 2))
    if rho is not None:
        rho = host_array(rho)
        t0 = int(T * (1 - tail_fraction))
        rho_mean = np.nanmean(rho[:, t0:], axis=1)
        consistent = ((rho_mean >= rho_band[0])
                      & (rho_mean <= rho_band[1])
                      & np.isfinite(rho_mean))
    else:
        rho_mean = np.full(R, np.nan)
        consistent = np.ones(R, bool)
    healthy = (~nan_states) & (~explosion) & consistent
    return FilterHealth(nan_states, rho_mean, consistent, explosion, healthy)


def summarize_health(health: FilterHealth, names=None) -> str:
    """One-line-per-problem summary for logs."""
    lines = [f"{int(health.healthy.sum())}/{len(health.healthy)} regions "
             f"healthy"]
    for r in np.flatnonzero(~health.healthy):
        name = names[r] if names is not None else f"region {r}"
        problems = []
        if health.nan_states[r]:
            problems.append("non-finite states")
        if health.state_explosion[r]:
            problems.append("state explosion")
        if not health.rho_consistent[r]:
            problems.append(f"rho={health.rho_mean[r]:.2f} (inconsistent)")
        lines.append(f"  {name}: " + ", ".join(problems))
    return "\n".join(lines)
