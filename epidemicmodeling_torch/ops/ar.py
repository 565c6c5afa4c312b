"""Autoregressive (AR) model fitting and stochastic forecasting.

Counterpart of epidemicmodeling_tpu/ops/ar.py (Tools/PrescribeNPI.m:202-214,
testScripts/testSIModelOptimalControl04EKS.m:217-228: MATLAB ``ar(y,
order)``, forward-backward least squares by default, then ``filtic`` +
``filter`` to roll a noise-driven forecast of the contact rate alpha
forward from its training history): closed-form forward-backward (or
forward-only) least squares and Burg fits, and the recursive forecaster.
The forecast's noise is passed in (the JAX package's normal draws, for
parity) or drawn from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.math import as_device_tensor, float_tensor


def _series(y, device):
    return float_tensor(y, device).reshape(-1)


def ar_design(y, order: int, method: str = "fb", device=None):
    """The least-squares design of ar_fit: (X, t) such that y[t] is
    predicted from y[t-1..t-p] (t = p..T-1), and with "fb" also from
    y[t+1..t+p] (t = 0..T-p-1), stacked."""
    y = _series(y, device)
    T, p = y.shape[0], order
    idx = torch.arange(p, T, device=y.device)
    F = torch.stack([y[idx - i] for i in range(1, p + 1)], dim=1)
    if method == "ls":
        return F, y[idx]
    if method != "fb":
        raise ValueError(f"unknown AR method {method!r}")
    idx_b = torch.arange(0, T - p, device=y.device)
    Bm = torch.stack([y[idx_b + i] for i in range(1, p + 1)], dim=1)
    return torch.cat([F, Bm], dim=0), torch.cat([y[idx], y[idx_b]], dim=0)


def ar_normal_matrix(X, order: int):
    """X'X plus ar_fit's ridge, 1e-12 tr(X'X) / p on the diagonal."""
    G = X.T @ X
    return G + 1e-12 * torch.trace(G) / order * torch.eye(
        order, dtype=X.dtype, device=X.device)


def ar_fit(y, order: int, method: str = "fb", device=None):
    """Fit an AR(p) model A(q) y = e with A = [1, a_1..a_p].

    Returns (a (p,), noise_var). method: "fb" (forward-backward least
    squares, the MATLAB ``ar`` default) or "ls" (forward only). The normal
    equations carry the JAX package's 1e-12 tr(G) / p ridge. Runs on
    ``device``, else where ``y`` lies when it is a tensor, else on the CUDA
    card."""
    X, t_vec = ar_design(y, order, method, device)
    # y[t] = sum_i c_i y[t-i] + e  =>  a_i = -c_i; solve_ex does not raise
    # on a singular matrix (JAX's LU returns inf/NaN there)
    c = torch.linalg.solve_ex(ar_normal_matrix(X, order),
                              (X.T @ t_vec)[:, None]).result[:, 0]
    resid = t_vec - X @ c
    return -c, torch.mean(resid ** 2)


def ar_fit_burg(y, order: int, device=None):
    """Burg's method (an alternative to "fb"; better on short segments):
    the Levinson recursion over reflection coefficients. Returns
    (a (p,), prediction-error power)."""
    y = _series(y, device)
    f, b = y[1:], y[:-1]
    a = y.new_zeros(order)
    E = torch.mean(y ** 2)
    for m in range(order):
        num = -2.0 * torch.sum(f * b)
        den = torch.sum(f * f) + torch.sum(b * b)
        k = num / torch.where(den > 0, den, 1.0)
        a_prev = a[:m]
        a = torch.cat([a_prev + k * a_prev.flip(0), k[None], a[m + 1:]])
        # the update reads the old f and b together
        f, b = (f + k * b)[1:], (b + k * f)[:-1]
        E = E * (1 - k ** 2)
    return a, E


def ar_forecast(y_hist, a, noise_var, n_ahead: int,
                generator: Optional[torch.Generator] = None, noise=None,
                device=None):
    """Roll the AR recursion y[t] = -sum_i a_i y[t-i] + e[t] forward.

    y_hist: (>= p,) training tail. e = sqrt(noise_var) * z with z the
    (n_ahead,) standard normal draws ``noise`` (e.g. the JAX package's),
    else drawn from ``generator``; with neither, e = 0 (the conditional
    mean forecast, as with key=None). Returns (n_ahead,) predictions."""
    y_hist = _series(y_hist, device)
    dev, fd = y_hist.device, y_hist.dtype
    a = as_device_tensor(a, dev).to(fd).reshape(-1)
    p = a.shape[0]
    state = y_hist[-p:].flip(0)  # state[0] = most recent
    if noise is None and generator is not None:
        noise = torch.randn(n_ahead, generator=generator, dtype=fd,
                            device=generator.device)
    if noise is None:
        e = y_hist.new_zeros(n_ahead)
    else:
        e = torch.sqrt(as_device_tensor(noise_var, dev).to(fd)) \
            * as_device_tensor(noise, dev).to(fd).reshape(-1)
    pred = []
    for t in range(n_ahead):
        y_t = -torch.dot(a, state) + e[t]
        state = torch.cat([y_t[None], state[:-1]])
        pred.append(y_t)
    return torch.stack(pred) if pred else y_hist.new_zeros(0)
