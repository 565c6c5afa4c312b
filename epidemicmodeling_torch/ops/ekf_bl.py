"""Batch-last EKF/EKS core in plain PyTorch tensor ops.

Counterpart of epidemicmodeling_tpu/ops/ekf_bl.py:137 (ekf_smoother_bl). Every
quantity keeps the lane (filter) axis B last: s (m, B), P (m, m, B), stacks
(T, m, m, B). The tiny matrix algebra is unrolled over the static state
dimension, so each operation is one elementwise op across all lanes, in the
same order as the JAX core.

Features: order 1, one scalar observation per step (NaN = predict only),
the Joseph covariance update (the only form the pipelines use), the gain
discount gamma, terminal conditions for the smoother (NaN = unconstrained),
the Cholesky smoother gain with pivots floored at ``finfo(dtype).tiny``,
fixed-R adaptation (``beta != 1``) with the reset to the prior on NaN
steps, and the innovation whiteness monitor rho
(Tools/GenericExtendedKalmanFilter.m:171-185).

This is the plain reference that both CUDA kernels (ops/cuda/) are held
against, and what their wrappers run for CPU tensors. The time loop is a
Python loop: on a card each step is a few hundred small launches, which is
why the pipelines run the hand-written kernels there.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch


@dataclasses.dataclass(frozen=True)
class EKFSystemBL:
    """Batch-last system equations: all callbacks take/return tensors with a
    trailing lane axis B. The observation dimension is fixed to 1."""

    state_dim: int
    input_dim: int
    # (u (p,B), s (m,B), params, k) -> (u_filled (p,B), s_next (m,B))
    nlin_state_update: Callable[..., Any]
    # (u (p,B), s (m,B), params, k) -> A (m,m,B)
    state_jacobian: Callable[..., Any]
    # (s (m,B), params, k) -> x (B,)
    nlin_obs_update: Callable[..., Any]
    # (s (m,B), params, k) -> C (m,B)   [the single observation row]
    obs_jacobian_row: Callable[..., Any]
    # (s (m,B), params, k) -> s (m,B)
    state_hard_margins: Callable[..., Any]
    # (x (B,), params, k) -> x (B,)
    obs_hard_margins: Callable[..., Any]


def _mm(A, Bm, m):
    """C[i,k,b] = sum_j A[i,j,b] * B[j,k,b]; j unrolled."""
    acc = A[:, 0, None, :] * Bm[None, 0, :, :]
    for j in range(1, m):
        acc = acc + A[:, j, None, :] * Bm[None, j, :, :]
    return acc


def _mmT(A, Bm, m):
    """C[i,k,b] = sum_j A[i,j,b] * B[k,j,b]  (A @ B^T)."""
    acc = A[:, 0, None, :] * Bm[:, 0, :][None, :, :]
    for j in range(1, m):
        acc = acc + A[:, j, None, :] * Bm[:, j, :][None, :, :]
    return acc


def _mv(A, x, m):
    """y[i,b] = sum_j A[i,j,b] x[j,b]."""
    acc = A[:, 0, :] * x[0][None, :]
    for j in range(1, m):
        acc = acc + A[:, j, :] * x[j][None, :]
    return acc


def _sym(P):
    return 0.5 * (P + P.transpose(0, 1))


def _chol_bl(P, m, jitter=0.0):
    """Unrolled Cholesky of (m, m, B) SPD stacks: lower L (m, m, B). Each
    pivot is floored at ``jitter`` before its square root."""
    jit = torch.as_tensor(jitter, dtype=P.dtype, device=P.device)
    L = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i + 1):
            s = P[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.maximum(s, jit))
            else:
                L[i][j] = s / L[j][j]
    zero = torch.zeros_like(P[0, 0])
    return torch.stack([torch.stack([L[i][j] if j <= i else zero
                                     for j in range(m)]) for i in range(m)])


def _chol_solve_mat_bl(L, Bmat, m):
    """Solve (L L^T) X = Bmat for X, all (m, m, B): forward then backward
    substitution, every right-hand column at once (the arithmetic per column
    is that of the JAX core's column loop)."""
    y = [None] * m
    for i in range(m):                  # forward: L y = b
        s = Bmat[i]
        for k in range(i):
            s = s - L[i, k] * y[k]
        y[i] = s / L[i, i]
    xr = [None] * m
    for i in range(m - 1, -1, -1):      # backward: L^T x = y
        s = y[i]
        for k in range(i + 1, m):
            s = s - L[k, i] * xr[k]
        xr[i] = s / L[i, i]
    return torch.stack(xr)              # X[i, c, :]


class EKFResultBL(NamedTuple):
    """Batch-last results (lane axis B last everywhere)."""
    u_opt: torch.Tensor          # (T, p, B)
    u_opt_smooth: torch.Tensor   # (T, p, B)
    s_minus: torch.Tensor        # (T, m, B)
    s_plus: torch.Tensor         # (T, m, B)
    s_smooth: torch.Tensor       # (T, m, B)
    rho: Optional[torch.Tensor] = None   # (T, B) innovation whiteness monitor


def ekf_smoother_bl(
    system: EKFSystemBL,
    u: torch.Tensor,           # (T, p, B), NaN => in-model optimal control
    x: torch.Tensor,           # (T, B) scalar observations, NaN => predict
    params: dict,              # tensors, scalar or (..., B)
    s_init: torch.Tensor,      # (m, B)
    Ps_init: torch.Tensor,     # (m, m, B)
    s_final: Optional[torch.Tensor] = None,   # (m, B), NaN = unconstrained
    Ps_final: Optional[torch.Tensor] = None,  # (m, m, B)
    Q: Optional[torch.Tensor] = None,         # (m, m, B)
    R: Optional[torch.Tensor] = None,         # (T, B) obs noise variance
    gamma_discount: float = 1.0,
    inv_monitor_len: int = 0,  # > 0: compute rho (GEKF.m:171-179)
    beta: float = 1.0,         # != 1: adapt the fixed prior R[0] from the
                               # innovation window (GEKF.m:180-185)
) -> EKFResultBL:
    """Order-1, n=1 batch-last EKF/EKS (adaptive R via ``beta``)."""
    m = system.state_dim
    T, B = x.shape
    dtype, dev = x.dtype, x.device
    gam = gamma_discount
    if s_final is None:
        s_final = torch.full((m, B), float("nan"), dtype=dtype, device=dev)
    if Ps_final is None:
        Ps_final = torch.full((m, m, B), float("nan"), dtype=dtype,
                              device=dev)

    adaptive = beta != 1.0
    L_mon = int(inv_monitor_len)
    if adaptive and L_mon <= 0:
        raise ValueError("adaptive R (beta != 1) needs inv_monitor_len > 0 "
                         "(the R_hat window, GEKF.m:180-185)")
    eps_mon = torch.finfo(dtype).eps
    eye = torch.eye(m, dtype=dtype, device=dev)[:, :, None]
    zero = torch.zeros((), dtype=dtype, device=dev)

    s_minus, P_minus = s_init, Ps_init
    if L_mon:
        mean_buf = torch.zeros((L_mon, B), dtype=dtype, device=dev)
        covn_buf = torch.zeros_like(mean_buf)
        cov_buf = torch.zeros_like(mean_buf)
    R_carry = R[0] if adaptive else None
    S_MINUS, P_MINUS, S_PLUS, P_PLUS, U_OPT, RHO = [], [], [], [], [], []
    for k in range(T):
        u_k, x_k = u[k], x[k]
        R_k = R_carry if adaptive else R[k]

        C = system.obs_jacobian_row(s_minus, params, k)            # (m, B)
        x_pred = system.obs_hard_margins(
            system.nlin_obs_update(s_minus, params, k), params, k)

        valid = ~torch.isnan(x_k)
        innov = torch.where(valid, x_k - x_pred, zero)

        PCt = _mv(P_minus, C, m)                                   # (m, B)
        S = torch.sum(C * PCt, dim=0) + gam * R_k                  # (B,)
        K = torch.where(valid[None, :], PCt / S[None, :], zero)    # (m, B)

        IKC = eye - K[:, None, :] * C[None, :, :]
        P_upd = (_mmT(_mm(IKC, P_minus, m), IKC, m)       # Joseph form
                 + (K[:, None, :] * K[None, :, :]) * R_k[None, None, :]
                 ) / gam
        P_plus = _sym(torch.where(valid[None, None, :], P_upd, P_minus))
        s_plus = torch.where(valid[None, :], s_minus + K * innov[None, :],
                             s_minus)
        s_plus = system.state_hard_margins(s_plus, params, k)

        u_opt_k, s_next = system.nlin_state_update(u_k, s_plus, params, k)
        A = system.state_jacobian(u_k, s_plus, params, k)
        P_next = _sym(_mmT(_mm(A, P_plus, m), A, m) + Q)
        s_next = system.state_hard_margins(s_next, params, k)

        if L_mon:
            cnt = float(min(k + 1, L_mon))
            mean_buf = torch.cat([innov[None], mean_buf[:-1]])
            mu = torch.sum(mean_buf, dim=0) / cnt
            cc = (innov - mu) ** 2
            covn_buf = torch.cat([(cc / (R_k + eps_mon))[None],
                                  covn_buf[:-1]])
            RHO.append(torch.sum(covn_buf, dim=0) / cnt)
            if adaptive:
                cov_buf = torch.cat([cc[None], cov_buf[:-1]])
                R_estim = torch.sum(cov_buf, dim=0) / cnt
                # NaN step: GEKF.m:180-185 skips the R(:,:,k+1) write, so
                # the cell keeps the fixed prior R[0]
                R_carry = torch.where(
                    valid, beta * R_k + (1.0 - beta) * R_estim, R[0])

        S_MINUS.append(s_minus); P_MINUS.append(P_minus)
        S_PLUS.append(s_plus); P_PLUS.append(P_plus)
        U_OPT.append(u_opt_k)
        s_minus, P_minus = s_next, P_next

    sT = torch.where(torch.isnan(s_final), S_PLUS[-1], s_final)
    PT = torch.where(torch.isnan(Ps_final), P_PLUS[-1], Ps_final)

    tiny = torch.finfo(dtype).tiny
    s_sm, P_sm = sT, PT
    S_SM = [None] * T
    U_SM = [None] * T
    S_SM[T - 1] = sT
    U_SM[T - 1] = torch.zeros_like(u[0])
    for k in range(T - 2, -1, -1):
        s_plus_k, P_plus_k = S_PLUS[k], P_PLUS[k]
        P_minus_next = P_MINUS[k + 1]
        A = system.state_jacobian(u[k], s_plus_k, params, k)
        PAt = _mmT(P_plus_k, A, m)
        # J = PAt @ inv(Pm) with Pm SPD: solve Pm X = PAt^T, J = X^T
        Lc = _chol_bl(P_minus_next, m, jitter=tiny)
        J = _chol_solve_mat_bl(Lc, PAt.transpose(0, 1), m).transpose(0, 1)
        s_new = s_plus_k + _mv(J, s_sm - S_MINUS[k + 1], m)
        s_new = system.state_hard_margins(s_new, params, k)
        P_sm = _sym(P_plus_k - _mmT(_mm(J, P_minus_next - P_sm, m), J, m))
        s_sm = s_new
        S_SM[k] = s_sm
        U_SM[k], _ = system.nlin_state_update(u[k], s_sm, params, k)

    return EKFResultBL(
        u_opt=torch.stack(U_OPT), u_opt_smooth=torch.stack(U_SM),
        s_minus=torch.stack(S_MINUS), s_plus=torch.stack(S_PLUS),
        s_smooth=torch.stack(S_SM),
        rho=torch.stack(RHO) if L_mon else None)
