"""Element-wise robust affine fits with a non-negative slope bound.

Counterpart of epidemicmodeling_tpu/regression/robust.py
(REGRESSION_TYPE='NONNEGATIVELS-ELEMENT-WISE',
Tools/TrainPredictPrescribeNPI.m:279-292): for each NPI column k, fit
y ~ a_k x_k + c_k by IRLS with Tukey bisquare weights (tuning 4.685,
robust scale MAD / 0.6745) and the slope clamped to a_k >= 0; the shared
intercept is b = mean(y - X a). Every (problem, column) pair is one lane of
a batch, with a fixed 50 iterations (no host sync).
"""

from __future__ import annotations

import torch


def _weighted_affine(x, y, w):
    """Weighted LS fit of y ~ a x + c over the last axis. Returns (a, c).
    A column x that is constant has no slope: a = 0. The JAX code tests
    var > 0 for that, but there its var is a rounding residue (the weighted
    mean of a constant differs from it in the last bit when the two sums
    run in different orders), and the slope it then divides out is
    rounding noise; here the column's values are compared instead."""
    sw = w.sum(dim=-1)
    mx = (w * x).sum(dim=-1) / sw
    my = (w * y).sum(dim=-1) / sw
    cov = (w * ((x - mx[..., None]) * (y - my[..., None]))).sum(dim=-1)
    var = (w * (x - mx[..., None]) ** 2).sum(dim=-1)
    ok = (var > 0) & (x != x[..., :1]).any(dim=-1)
    a = torch.where(ok, cov / torch.where(ok, var, 1.0), 0.0)
    return a, my - a * mx


def _median(v):
    """Median over the last axis: the mean of the two middle values of an
    even count, as jnp.median (torch.median takes the lower one)."""
    n = v.shape[-1]
    srt = torch.sort(v, dim=-1).values
    return (srt[..., (n - 1) // 2] + srt[..., n // 2]) * 0.5


def robust_affine_fit_elementwise(X, y, n_iter: int = 50,
                                  tune: float = 4.685):
    """For each column x_k of X (..., n, p), robustly fit y ~ a_k x_k + c_k
    with a_k >= 0; y: (..., n). Returns (a (..., p), b (...)) with
    b = mean(y - X a), as the reference does (:291)."""
    dtype = torch.promote_types(X.dtype, y.dtype)
    X, y = X.to(dtype), y.to(dtype)
    tiny, eps = torch.finfo(dtype).tiny, torch.finfo(dtype).eps
    x = X.transpose(-1, -2)                           # (..., p, n) lanes
    yl = y[..., None, :].expand_as(x)
    a, c = _weighted_affine(x, yl, torch.ones_like(x))
    a = torch.clamp_min(a, 0.0)
    for _ in range(n_iter):
        r = yl - a[..., None] * x - c[..., None]
        mad = _median(torch.abs(r - _median(r)[..., None]))
        s = torch.clamp_min(mad / 0.6745, tiny)
        u = r / (tune * s)[..., None]
        w = torch.where(torch.abs(u) < 1.0, (1.0 - u ** 2) ** 2, 0.0)
        w = torch.clamp_min(w, eps)
        a, _ = _weighted_affine(x, yl, w)
        a = torch.clamp_min(a, 0.0)  # slope lower bound
        # the intercept refit at the clamped slope
        c = (w * (yl - a[..., None] * x)).sum(dim=-1) / w.sum(dim=-1)
    b = torch.mean(y - (X @ a[..., None])[..., 0], dim=-1)
    return a, b
