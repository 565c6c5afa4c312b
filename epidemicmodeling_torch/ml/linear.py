"""Linear baselines of the ML pipeline: ridge regression and ARX.

Counterpart of epidemicmodeling_tpu/ml/linear.py:
testScripts/test04FullFeatureExtMLpipeline.m, the ridge-regularized linear
regression of lambda from lagged NPI features (:398-405) and the ARX model
of MATLAB ``ar``/iddata (:383-396).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.ar import ar_fit, ar_forecast
from ..utils.math import float_args


def ridge_regression(X, y, lam: float = 1e-3, fit_intercept: bool = True,
                     device=None):
    """Closed-form ridge: returns (w (F,), b). Standardizes nothing: the
    caller controls feature scaling (ml.features.standardize). Runs on
    ``device``, else where ``X`` lies when it is a tensor, else on the CUDA
    card."""
    X, y = float_args(device, X, y)
    y = y.reshape(-1)
    F = X.shape[1]
    if fit_intercept:
        mx = X.mean(dim=0)
        my = y.mean()
        Xc = X - mx
        yc = y - my
    else:
        mx = X.new_zeros(F)
        my = X.new_zeros(())
        Xc, yc = X, y
    eye = torch.eye(F, dtype=X.dtype, device=X.device)
    w = torch.linalg.solve(Xc.T @ Xc + lam * eye, Xc.T @ yc)
    b = my - torch.dot(w, mx)
    return w, b


def arx_fit_predict(y, order: int, n_ahead: int,
                    generator: Optional[torch.Generator] = None, noise=None,
                    device=None):
    """AR model fit + forecast (the test04 ARX baseline; exogenous terms
    are folded into the residual there as well). The forecast's noise is
    sqrt(noise_var) times the (n_ahead,) standard normal draws ``noise``
    (e.g. the JAX package's), else drawn from ``generator``, else zero (as
    with key=None). Returns (coeffs, forecast)."""
    a, nv = ar_fit(y, order, device=device)
    pred = ar_forecast(y, a, nv, n_ahead, generator=generator, noise=noise,
                       device=device)
    return a, pred
