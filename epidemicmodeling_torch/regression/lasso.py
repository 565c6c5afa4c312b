"""Batched LASSO by cyclic coordinate descent along a warm-started lambda
path, with K-fold cross-validation.

Counterpart of epidemicmodeling_tpu/regression/lasso.py (MATLAB
``lasso(X, y, 'CV', 50)`` of Tools/TrainPredictPrescribeNPI.m:254-262):
standardized predictors, objective (1/(2N))||y - b0 - X b||^2 +
lambda ||b||_1, a geometric path (NumLambda 100, LambdaRatio 1e-4), the
minimum-mean-MSE lambda of K folds, coefficients refit on the full data.

Every function takes a batch of problems in its leading dimensions (regions,
and folds inside lasso_cv). The JAX code runs a ``while_loop`` of sweeps per
lambda under ``vmap``, so each problem stops at its own sweep. Here the
sweeps run over the whole batch with finished problems frozen by
``torch.where`` until every problem is done, the same coefficients as the
per-problem loops (see _cd_solve for the host syncs this costs; each goes
through utils.profiling.host_sync, and the sweeps count as
``lasso.sweeps`` in the recording in force).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.profiling import count, host_sync


# sweeps a CUDA graph replays between two checks for finished problems
GRAPH_SWEEPS = 10


def _cd_solve(Xs, yc, lambdas, max_sweeps, tol):
    """Coordinate descent along a descending lambda path with warm starts
    from zero. Xs: (..., n, p) standardized predictors, yc: (..., n)
    centered targets, lambdas: (..., L). Returns B (..., L, p).

    Each coordinate's correlation with the residual, x_j . r, is formed
    from the Gram matrix as c_j - G_j . b (c = Xs' yc, G = Xs' Xs), the
    quantity the JAX code keeps as a running residual, so an update touches
    (..., p) values instead of (..., n). A sweep is ~90 small launches; on a
    card GRAPH_SWEEPS of them are captured once in a CUDA graph and
    replayed, and the done flags are read once a replay. A finished
    problem is frozen, so the sweeps run after it finished change nothing:
    the coefficients are those of one sweep per check."""
    n, p = Xs.shape[-2:]
    inv_n = 1.0 / n
    Xt = Xs.transpose(-1, -2)
    G = (Xt @ Xs).unbind(-2)                                # p x (..., p)
    c = (Xt @ yc[..., None])[..., 0].unbind(-1)             # p x (...)
    b = Xs.new_zeros(Xs.shape[:-2] + (p,))
    lam = lambdas[..., 0].clone()
    neg_lam = -lam
    active = torch.zeros(b.shape[:-1], dtype=torch.bool, device=b.device)
    it = torch.zeros(b.shape[:-1], dtype=torch.int64, device=b.device)

    def sweep():
        b_new = b.clone()
        for j in range(p):
            g = c[j] - torch.sum(G[j] * b_new, dim=-1)
            z = torch.add(b_new[..., j], g, alpha=inv_n)
            # the soft threshold sign(z) max(|z| - lam, 0), exactly
            b_new[..., j] = z - torch.clamp(z, neg_lam, lam)
        delta = torch.amax(torch.abs(b_new - b), dim=-1)
        b.copy_(torch.where(active[..., None], b_new, b))
        it.add_(active)
        active.copy_(active & (delta > tol) & (it < max_sweeps))

    run, per_run = sweep, 1
    if b.is_cuda:
        # warm up and capture with every problem frozen: no state changes
        side = torch.cuda.Stream(device=b.device)
        side.wait_stream(torch.cuda.current_stream(b.device))
        with torch.cuda.stream(side):
            sweep()
        torch.cuda.current_stream(b.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(GRAPH_SWEEPS):
                sweep()
        run, per_run = graph.replay, GRAPH_SWEEPS
    out = []
    for li in range(lambdas.shape[-1] if max_sweeps > 0 else 0):
        lam.copy_(lambdas[..., li])
        torch.neg(lam, out=neg_lam)
        active.fill_(True)
        it.zero_()
        while True:
            run()
            count("lasso.sweeps", per_run)
            if not host_sync(bool, active.any()):
                break
        out.append(b.clone())
    if not out:
        return b[..., None, :].expand(b.shape[:-1] + lambdas.shape[-1:]
                                      + (p,))
    return torch.stack(out, dim=-2)


def _standardize(X, y, w=None):
    """Column means and 1/N standard deviations of X, and the mean of y,
    over all rows or the rows weighted 1 in w (..., n)."""
    if w is None:
        mu_x = X.mean(dim=-2)
        sd_x = torch.sqrt(((X - mu_x[..., None, :]) ** 2).mean(dim=-2))
        return mu_x, sd_x, y.mean(dim=-1)
    n_tr = w.sum(dim=-1, keepdim=True)
    mu_x = (w[..., None, :] @ X)[..., 0, :] / n_tr
    sd_x = torch.sqrt(
        (w[..., None, :] @ (X - mu_x[..., None, :]) ** 2)[..., 0, :] / n_tr)
    return mu_x, sd_x, (w * y).sum(dim=-1) / n_tr[..., 0]


def lasso_path(X, y, lambdas=None, n_lambda: int = 100,
               lambda_ratio: float = 1e-4, max_sweeps: int = 1000,
               tol: float = 1e-10):
    """Fit the full lasso path of every problem. X: (..., n, p), y: (..., n).

    Returns (B (..., L, p) coefficients on the ORIGINAL scale, intercepts
    (..., L), lambdas (..., L) descending)."""
    dtype = torch.promote_types(X.dtype, y.dtype)
    X, y = X.to(dtype), y.to(dtype)
    mu_x, sd_x, mu_y = _standardize(X, y)
    sd_safe = torch.where(sd_x > 0, sd_x, 1.0)
    Xs = (X - mu_x[..., None, :]) / sd_safe[..., None, :]
    yc = y - mu_y[..., None]
    if lambdas is None:
        lambdas = lambda_grid(Xs, yc, n_lambda, lambda_ratio)
    lambdas = torch.as_tensor(lambdas, dtype=dtype, device=X.device)
    lambdas = lambdas.expand(X.shape[:-2] + lambdas.shape[-1:])
    B_std = _cd_solve(Xs, yc, lambdas, max_sweeps, tol)
    # columns with zero variance carry no signal; force their coefs to 0
    B_std = torch.where(sd_x[..., None, :] > 0, B_std, 0.0)
    B = B_std / sd_safe[..., None, :]
    intercepts = mu_y[..., None] - (B @ mu_x[..., None])[..., 0]
    return B, intercepts, lambdas


def lambda_grid(Xs, yc, n_lambda, lambda_ratio):
    """The geometric path from lambda_max = max |Xs' yc| / n down by
    ``lambda_ratio`` (lasso.py:92-96)."""
    n = Xs.shape[-2]
    lam_max = torch.amax(torch.abs(
        (Xs.transpose(-1, -2) @ yc[..., None])[..., 0]), dim=-1) / n
    lam_max = torch.clamp_min(lam_max, torch.finfo(Xs.dtype).tiny)
    # the factors in float64, then the product cast, as JAX promotes them
    steps = torch.exp(torch.linspace(0.0, math.log(lambda_ratio), n_lambda,
                                     dtype=torch.float64, device=Xs.device))
    return (lam_max[..., None].double() * steps).to(Xs.dtype)


def lasso_cv(X, y, n_folds: int = 50, n_lambda: int = 100,
             lambda_ratio: float = 1e-4, max_sweeps: int = 1000,
             tol: float = 1e-10, perm=None):
    """K-fold cross-validated lasso of every problem: X (..., n, p),
    y (..., n). Returns (coef (..., p), intercept (...), info dict).

    Row i goes to fold i mod K, or, with ``perm`` (a permutation of
    range(n), e.g. the JAX package's jax.random.permutation draw, or a
    torch.randperm one), row perm[i] does. The folds of all problems run
    as one batch."""
    dtype = torch.promote_types(X.dtype, y.dtype)
    X, y = X.to(dtype), y.to(dtype)
    n = X.shape[-2]
    dev = X.device
    fold_of = torch.arange(n, device=dev) % n_folds
    if perm is not None:
        if not isinstance(perm, torch.Tensor):
            perm = np.array(perm)       # a copy: JAX hands over read-only
        perm = torch.as_tensor(perm, device=dev).to(torch.int64)
        fold_of = torch.empty_like(fold_of).scatter_(0, perm, fold_of)

    # common lambda grid from the full data (as MATLAB does)
    mu_x, sd_x, mu_y = _standardize(X, y)
    Xs_full = (X - mu_x[..., None, :]) / torch.where(sd_x > 0, sd_x,
                                                     1.0)[..., None, :]
    lambdas = lambda_grid(Xs_full, y - mu_y[..., None], n_lambda,
                          lambda_ratio)

    # every fold at once: a fold axis before the rows, (..., K, n, p)
    folds = torch.arange(n_folds, device=dev)
    w = (fold_of[None, :] != folds[:, None]).to(dtype)        # (K, n)
    Xk, yk = X[..., None, :, :], y[..., None, :]
    n_tr = w.sum(dim=-1)                                      # (K,)
    mu_xk, sd_xk, mu_yk = _standardize(Xk, yk, w)
    sd_safe = torch.where(sd_xk > 0, sd_xk, 1.0)
    # CD on the zero-padded training rows: scaling the columns by
    # sqrt(n / n_tr) keeps lambda exact (lasso.py:144-153)
    scale = torch.sqrt(n / n_tr)[:, None]
    Xs = ((Xk - mu_xk[..., None, :]) / sd_safe[..., None, :]) \
        * w[..., None] * scale[..., None]
    yc = (yk - mu_yk[..., None]) * w * scale
    B_std = _cd_solve(Xs, yc, lambdas[..., None, :], max_sweeps, tol)
    B_std = torch.where(sd_xk[..., None, :] > 0, B_std, 0.0)
    B = B_std / sd_safe[..., None, :]                         # (..., K, L, p)
    b0 = mu_yk[..., None] - (B @ mu_xk[..., None])[..., 0]    # (..., K, L)
    pred = Xk @ B.transpose(-1, -2) + b0[..., None, :]        # (..., K, n, L)
    err2 = (yk[..., None] - pred) ** 2
    test_w = (1.0 - w)[..., None]
    mse = (err2 * test_w).sum(dim=-2) / (1.0 - w).sum(dim=-1)[:, None]
    mean_mse = mse.mean(dim=-2)                               # (..., L)
    idx_min = torch.argmin(mean_mse, dim=-1)

    B_full, b0_full, _ = lasso_path(X, y, lambdas=lambdas,
                                    max_sweeps=max_sweeps, tol=tol)
    coef = torch.take_along_dim(B_full, idx_min[..., None, None],
                                dim=-2)[..., 0, :]
    intercept = torch.take_along_dim(b0_full, idx_min[..., None],
                                     dim=-1)[..., 0]
    info = {"lambdas": lambdas, "mean_mse": mean_mse, "index_min": idx_min,
            "B_path": B_full, "intercepts": b0_full}
    return coef, intercept, info
