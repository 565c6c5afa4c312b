"""Time-series smoothing filters with a selectable filter type.

Counterpart of epidemicmodeling_tpu/ops/smoothing.py: the filter_type switch
of testScripts/testSIModelOptimalControl04EKS.m:118-135 (BYPASS | TIKHONOV |
MOVINGAVERAGE-CAUSAL | MOVINGAVERAGE-NONCAUSAL | MOVINGMEDIAN), where the
OSET toolbox supplies TikhonovRegularization (2nd-order roughness-penalized
least squares) and BaseLine1 (sliding mean 'mn' / median 'md' baselines,
also used by testScripts/testCountryStatistics03.m:28). The sliding
filters are NumPy in the JAX package and are NumPy copies here; the
Tikhonov solve and the causal average are tensor ops.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.math import (as_device_tensor, causal_moving_average,
                          host_array)


def _host(x) -> np.ndarray:
    return np.asarray(host_array(x), float).reshape(-1)


def tikhonov_smooth(x, order: int = 2, gamma: float = 25.0, device=None):
    """Tikhonov-regularized smoothing: argmin_y ||y - x||^2 +
    gamma ||D^order y||^2, solved in closed form (a dense T x T solve) with
    the difference operator D; OSET TikhonovRegularization(x, order,
    gamma). Runs on ``device``, else where ``x`` lies when it is a tensor,
    else on the CUDA card."""
    x = as_device_tensor(x, device).reshape(-1)
    T = x.shape[0]
    D = torch.eye(T, dtype=x.dtype, device=x.device)
    for _ in range(order):
        D = D[1:] - D[:-1]                 # successive differences
    A = torch.eye(T, dtype=x.dtype, device=x.device) + gamma * (D.T @ D)
    return torch.linalg.solve(A, x)


def sliding_mean(x, half_win: int) -> np.ndarray:
    """Centered sliding mean with truncated windows at the edges (OSET
    BaseLine1(x, w, 'mn'): window w centered, shrinking near the
    boundaries). Host NumPy; takes a tensor or an array."""
    x = _host(x)
    T = len(x)
    out = np.empty(T)
    w = int(half_win)
    for t in range(T):
        lo = max(0, t - w // 2)
        hi = min(T, t + (w + 1) // 2)
        out[t] = x[lo:hi].mean()
    return out


def sliding_median(x, half_win: int) -> np.ndarray:
    """Centered sliding median with truncated edge windows (BaseLine1
    'md'). Host NumPy; takes a tensor or an array."""
    x = _host(x)
    T = len(x)
    out = np.empty(T)
    w = int(half_win)
    for t in range(T):
        lo = max(0, t - w // 2)
        hi = min(T, t + (w + 1) // 2)
        out[t] = np.median(x[lo:hi])
    return out


def smooth_series(x, filter_type: str = "MOVINGAVERAGE-CAUSAL",
                  win: int = 7, tikhonov_order: int = 2,
                  tikhonov_gamma: float = 25.0, device=None):
    """Dispatch on the reference's filter_type
    (testSIModelOptimalControl04EKS.m:118-135); an unknown type raises a
    ValueError. Returns a tensor on ``device``, else where ``x`` lies when
    it is a tensor, else on the CUDA card."""
    if filter_type == "BYPASS":
        return as_device_tensor(x, device)
    if filter_type == "TIKHONOV":
        return tikhonov_smooth(x, tikhonov_order, tikhonov_gamma, device)
    if filter_type == "MOVINGAVERAGE-CAUSAL":
        return causal_moving_average(x, win, device=device)
    if filter_type == "MOVINGAVERAGE-NONCAUSAL":
        return as_device_tensor(sliding_mean(x, win),
                                resolve_device(device, x))
    if filter_type == "MOVINGMEDIAN":
        # median pass with half window, then mean pass (:131-132)
        med = sliding_median(x, win // 2)
        return as_device_tensor(sliding_mean(med, win),
                                resolve_device(device, x))
    raise ValueError(f"Unknown filter type {filter_type!r}")
