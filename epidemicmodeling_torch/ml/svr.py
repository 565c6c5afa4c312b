"""Epsilon-insensitive support vector regression (linear and gaussian).

Counterpart of epidemicmodeling_tpu/ml/svr.py: MATLAB ``fitrsvm`` with
linear and gaussian kernels for lambda-vs-NPI regression
(testScripts/test03ExpfitVsIPRegression.m:198-246,
test04FullFeatureExtMLpipeline.m:435-445), as the primal epsilon-SVR
minimized by Adam. Three modes:

- ``linear``: the standardized features themselves.
- ``rbf``: random Fourier features, cos(X omega + phase) sqrt(2 / D), with
  omega ~ sqrt(2 gamma) N(0, 1) (F, D) and phase ~ U(0, 2 pi) (D,): the
  draws ``omega`` / ``phase`` when given (e.g. the JAX package's), else
  drawn on the CPU from ``generator``.
- ``rbf-exact``: the exact gaussian kernel through the representer theorem,
  f(x) = sum_i beta_i k(x_i, x) + b with the kernel-norm regularizer
  0.5 beta' K beta (the n x n kernel is small at the reference's size).

The optimizer is a hand-written Adam in optax's operation order (see
ml/optim.py), so from the same draws the iterates follow the JAX
package's to rounding.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..utils.math import float_args
from .optim import AdamState, adam_update


class SVRModel(NamedTuple):
    """Fitted epsilon-SVR (the fitrsvm linear/gaussian usage of
    test03ExpfitVsIPRegression.m:198-246); pass to ``svr_predict``."""
    w: torch.Tensor                 # weights (D,); dual coefs for rbf-exact
    b: torch.Tensor
    kernel: str
    omega: Optional[torch.Tensor]   # RFF frequencies (F, D) for rbf
    phase: Optional[torch.Tensor]   # RFF phases (D,)
    mu: torch.Tensor
    sd: torch.Tensor
    X_train: Optional[torch.Tensor] = None   # standardized anchors
    gamma: Optional[float] = None            # kernel width (rbf-exact)


def _features(X, model: SVRModel):
    Xs = (X - model.mu) / model.sd
    if model.kernel == "linear":
        return Xs
    if model.kernel == "rbf-exact":
        d2 = (torch.sum(Xs ** 2, dim=1)[:, None]
              + torch.sum(model.X_train ** 2, dim=1)[None, :]
              - 2.0 * Xs @ model.X_train.T)
        return torch.exp(-model.gamma * torch.clamp(d2, min=0.0))
    z = Xs @ model.omega + model.phase
    return math.sqrt(2.0 / model.omega.shape[1]) * torch.cos(z)


def _objective(Phi, w, b, y, kernel, C, epsilon):
    """reg / (C n) + mean(max(|Phi w + b - y| - epsilon, 0)): the primal
    SVR objective reg + C sum(hinge) scaled by 1 / (C n), reg the RKHS norm
    0.5 beta' K beta for rbf-exact (representer theorem), else 0.5 |w|^2."""
    r = Phi @ w + b - y
    hinge = torch.clamp(torch.abs(r) - epsilon, min=0.0)
    if kernel == "rbf-exact":
        reg = 0.5 * w @ (Phi @ w)
    else:
        reg = 0.5 * torch.sum(w ** 2)
    return reg / (C * y.shape[0]) + torch.mean(hinge)


def svr_fit(X, y, kernel: str = "linear", C: float = 1.0,
            epsilon: float = 0.01, gamma: Optional[float] = None,
            n_rff: int = 256, n_steps: int = 2000, lr: float = 1e-2,
            generator: Optional[torch.Generator] = None, omega=None,
            phase=None, device=None) -> SVRModel:
    """Fit epsilon-SVR. kernel: "linear" | "rbf" (random Fourier features)
    | "rbf-exact" (exact gaussian kernel, representer form). Runs on
    ``device``, else where ``X`` lies when it is a tensor, else on the CUDA
    card."""
    X, y = float_args(device, X, y)
    y = y.reshape(-1)
    dev, fd = X.device, X.dtype
    mu = X.mean(dim=0)
    std = X.std(dim=0, correction=0)
    sd = torch.where(std > 0, std, torch.ones_like(std))
    n, F = X.shape
    X_anchor = None
    if kernel in ("rbf", "rbf-exact") and gamma is None:
        gamma = 1.0 / F
    if kernel == "rbf":
        if omega is None or phase is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            z = torch.randn((F, n_rff), generator=generator, dtype=fd)
            u = torch.rand((n_rff,), generator=generator, dtype=fd)
            omega = math.sqrt(2.0 * gamma) * z if omega is None else omega
            phase = 2 * math.pi * u if phase is None else phase
        omega, phase = (float_args(dev, v)[0].to(fd) for v in (omega, phase))
        D = omega.shape[1]
    elif kernel == "rbf-exact":
        X_anchor = (X - mu) / sd
        D = n
    elif kernel == "linear":
        omega = phase = None
        D = F
    else:
        raise ValueError(f"unknown kernel {kernel!r}")

    model0 = SVRModel(X.new_zeros(D), y.mean(), kernel, omega, phase, mu, sd,
                      X_anchor, None if gamma is None else float(gamma))
    Phi = _features(X, model0)     # the kernel matrix K itself for rbf-exact

    params = [model0.w.clone().requires_grad_(True),
              model0.b.clone().requires_grad_(True)]
    state = AdamState(params)
    for _ in range(n_steps):
        loss = _objective(Phi, *params, y, kernel, C, epsilon)
        adam_update(params, torch.autograd.grad(loss, params), state, lr)
    return model0._replace(w=params[0].detach(), b=params[1].detach())


def svr_objective(model: SVRModel, X, y, C: float = 1.0,
                  epsilon: float = 0.01):
    """The scaled primal objective svr_fit minimizes, at ``model``'s
    weights, on the model's device."""
    X, y = float_args(model.mu.device, X, y)
    return _objective(_features(X, model), model.w, model.b, y.reshape(-1),
                      model.kernel, C, epsilon)


def svr_predict(model: SVRModel, X):
    """Predict targets for rows of ``X`` with a fitted ``SVRModel`` (on the
    model's device)."""
    X = float_args(model.mu.device, X)[0].to(model.mu.dtype)
    return _features(X, model) @ model.w + model.b
