"""Reproduction-number (Rt) estimators: the four methods.

Counterpart of epidemicmodeling_tpu/rt/estimators.py (SURVEY.md §2.4):
- Tools/Rt_ExpFitGenRatios.m:9-15: lambda from log-ratios of cases one
  generation period apart, Rt = exp(lambda dt), and a causal moving-average
  smoothed variant;
- Tools/Rt_ExpFitLogLinReg.m:21-47: sliding-window linear regression on
  log(NewCases) in closed form, causal and non-causal, as window
  correlations;
- Tools/Rt_ExpFitNonlinLS.m:20-61: sliding-window nonlinear least squares
  fit of A exp(lambda t), every window's Levenberg-Marquardt run as one
  batch; windows containing a zero keep A = the raw count and lambda = 0;
- Tools/Rt_ExpFitEKF.m: a 2-state EKF/EKS over new cases, x = A(t),
  A(t+1) = A exp(ts lambda), lambda(t+1) = sigma tanh((a lambda + w) /
  sigma), the reference's only second-order EKF (trace-based Hessian
  terms, :157-227), plugged into the generic core (ops/ekf.py) with the
  pre-generic options: no Joseph form, no symmetrization, the solve
  smoother gain, R adapted on every valid step.

Each runs on ``device``, else where its series lies when it is a tensor,
else on the CUDA card.
"""

from __future__ import annotations

import torch

from ..models.base import EKFSystem, stack_matrix
from ..ops.ekf import ekf_smoother
from ..utils.device import resolve_device
from ..utils.math import as_device_tensor, convolve_valid, float_tensor


def _series(new_cases, device):
    return float_tensor(new_cases, device).reshape(-1)


def rt_expfit_gen_ratios(new_cases, wlen: int, generation_period: int,
                         time_unit: float, device=None):
    """Returns (Rt, Lambda, RtSmoothed, LambdaSmoothed), each (T,)."""
    x = _series(new_cases, device)
    T, g = x.shape[0], generation_period
    lam = torch.cat([x.new_zeros(g), torch.log(x[g:] / x[:T - g]) / g])
    kernel = x.new_ones(wlen) / wlen
    lam_smooth = convolve_valid(torch.cat([x.new_zeros(wlen - 1), lam]),
                                kernel)
    return (torch.exp(lam * time_unit), lam,
            torch.exp(lam_smooth * time_unit), lam_smooth)


def rt_expfit_log_lin_reg(new_cases, wlen: int, time_unit: float,
                          causal: bool = True, device=None):
    """Returns (Rt, A, Lambda, ExpFit), each (T,). Entries outside the
    valid window range keep the fill values (ALog = 0, r = 0, so A = 1,
    Rt = 1), like the reference's zero-initialized arrays."""
    x = _series(new_cases, device)
    T = x.shape[0]
    logx = torch.log(x)
    if causal:
        n = torch.arange(-wlen + 1, 1, dtype=x.dtype, device=x.device)
        lo_valid = wlen - 1  # first 0-based index with a full window
    else:
        half = wlen // 2
        n = torch.arange(-half, half + 1, dtype=x.dtype, device=x.device)
        lo_valid = half
    w = n.shape[0]
    En = torch.mean(n)
    En2 = torch.mean(n ** 2)
    Det = En2 - En ** 2
    # sliding means: 'valid' correlations (convolutions with flipped taps)
    mean_seg = convolve_valid(logx, x.new_ones(w) / w)
    mean_nseg = convolve_valid(logx, (n / w).flip(0))
    alog_v = (mean_seg * En2 - mean_nseg * En) / Det
    r_v = (mean_nseg - mean_seg * En) / Det
    hi = T - (w - 1 - lo_valid)
    alog, r = x.new_zeros(T), x.new_zeros(T)
    alog[lo_valid:hi] = alog_v
    r[lo_valid:hi] = r_v
    A = torch.exp(alog)
    Rt = torch.exp(r)
    return Rt, A, r / time_unit, A * Rt


def _lm_expfit(t, y, A0, r0, n_iter=60):
    """Levenberg-Marquardt fits of y ~ A exp(r t), one per row of y
    (W, w), all rows a step at a time. A step whose normal matrix is
    singular is rejected (torch.linalg.solve_ex does not raise; JAX's LU
    returns inf/NaN there, so its new_cost < old_cost test rejects it).
    Returns (A, r), each (W,)."""
    A, r = A0, r0
    damp = torch.full_like(A0, 1e-3)
    for _ in range(n_iter):
        e = torch.exp(r[:, None] * t)
        res = y - A[:, None] * e
        J = torch.stack([e, A[:, None] * t * e], dim=-1)      # (W, w, 2)
        JtJ = J.transpose(-1, -2) @ J
        g = (J.transpose(-1, -2) @ res[..., None])[..., 0]
        H = JtJ + damp[:, None, None] * torch.diag_embed(
            torch.diagonal(JtJ, dim1=-2, dim2=-1))
        step, info = torch.linalg.solve_ex(H, g[..., None])
        A_new, r_new = A + step[:, 0, 0], r + step[:, 1, 0]
        new_cost = torch.sum((y - A_new[:, None]
                              * torch.exp(r_new[:, None] * t)) ** 2, dim=-1)
        old_cost = torch.sum(res ** 2, dim=-1)
        better = (info == 0) & (new_cost < old_cost)
        A = torch.where(better, A_new, A)
        r = torch.where(better, r_new, r)
        damp = torch.clamp(torch.where(better, damp * 0.5, damp * 4.0),
                           1e-12, 1e12)
    return A, r


def rt_expfit_nonlin_ls(new_cases, wlen: int, time_unit: float,
                        causal: bool = True, device=None):
    """Returns (Rt, A, Lambda, ExpFit), each (T,). Windows containing any
    zero sample are skipped: A = raw count, lambda = 0 (:27-29);
    out-of-range entries keep (A = raw cases, r = 0) like the reference's
    causal-lag prefill (:22, :39)."""
    x = _series(new_cases, device)
    T = x.shape[0]
    if causal:
        w, lo = wlen, wlen - 1
        n = torch.arange(-wlen + 1, 1, dtype=x.dtype, device=x.device)
    else:
        half = wlen // 2
        w, lo = 2 * half + 1, half
        n = torch.arange(-half, half + 1, dtype=x.dtype, device=x.device)
    windows = x.unfold(0, w, 1)                                # (W, w)
    out_idx = torch.arange(windows.shape[0], device=x.device) + lo
    has_zero = torch.any(windows == 0, dim=1)
    y_end = x[out_idx]   # the window's last sample when causal
    A_fit, r_fit = _lm_expfit(n / time_unit, windows, x[out_idx],
                              torch.zeros_like(y_end))
    A = x.clone()
    r = x.new_zeros(T)
    A[out_idx] = torch.where(has_zero, y_end, A_fit)
    r[out_idx] = torch.where(has_zero, 0.0, r_fit)
    Rt = torch.exp(r)
    return Rt, A, r / time_unit, A * Rt


def _trace(M):
    return torch.diagonal(M, dim1=-2, dim2=-1).sum(dim=-1)


def rt_ekf_system() -> EKFSystem:
    """2-state system of Tools/Rt_ExpFitEKF.m:119-227. params: time_scale,
    alpha, sigma."""

    def nlin_state_update(u, s_k, w_bar, params, k):
        ts, al, sig = params["time_scale"], params["alpha"], params["sigma"]
        s1 = s_k[..., 0] * torch.exp(ts * s_k[..., 1]) + w_bar[..., 0]
        s2 = sig * torch.tanh((al * s_k[..., 1] + w_bar[..., 1]) / sig)
        return u, torch.stack([s1, s2], dim=-1)

    def state_jacobians(u, s_k, w_bar, params, k):
        ts, al, sig = params["time_scale"], params["alpha"], params["sigma"]
        e = torch.exp(ts * s_k[..., 1])
        tnh = torch.tanh((al * s_k[..., 1] + w_bar[..., 1]) / sig)
        A = stack_matrix([[e, ts * s_k[..., 0] * e],
                          [0.0 * e, al * (1.0 - tnh ** 2)]])
        B = stack_matrix([[1.0 + 0.0 * e, 0.0 * e],
                          [0.0 * e, 1.0 - tnh ** 2]])
        return A, B

    def nlin_obs_update(u, s_k, v_bar, params, k):
        return (s_k[..., 0] + v_bar[..., 0])[..., None]

    def obs_jacobian(u, s_k, v_bar, params, k):
        kw = dict(dtype=s_k.dtype, device=s_k.device)
        return torch.tensor([[1.0, 0.0]], **kw), torch.eye(1, **kw)

    def identity_margins(v, params, k):
        return v

    def state_hessian_terms(u, s_k, Pk, w_bar, Qk, params, k):
        # trace-based second-order corrections (Rt_ExpFitEKF.m:158-197)
        ts, al, sig = params["time_scale"], params["alpha"], params["sigma"]
        e = torch.exp(ts * s_k[..., 1])
        tnh = torch.tanh((al * s_k[..., 1] + w_bar[..., 1]) / sig)
        z = s_k.new_zeros(())
        Fs1 = stack_matrix([[z, ts * e], [ts * e, ts ** 2 * s_k[..., 0] * e]])
        Fs2 = stack_matrix([[z, z],
                            [z, -2 * al ** 2 / sig * tnh * (1 - tnh ** 2)]])
        Fw1 = torch.zeros(2, 2, dtype=s_k.dtype, device=s_k.device)
        Fw2 = stack_matrix([[z, z], [z, -2 / sig * tnh * (1 - tnh ** 2)]])

        def trace_terms(M, Hs):
            f = torch.stack([_trace(M @ H) / 2 for H in Hs], dim=-1)
            C = torch.stack([
                torch.stack([_trace(M @ Hi @ M @ Hj) / 2 for Hj in Hs],
                            dim=-1)
                for Hi in Hs], dim=-2)
            return f, C

        fs, Cs = trace_terms(Pk, [Fs1, Fs2])
        fw, Cw = trace_terms(Qk, [Fw1, Fw2])
        return fs, Cs, fw, Cw

    def obs_hessian_terms(u, s_k, Pk, v_bar, Rk, params, k):
        # linear observation => all zero (Rt_ExpFitEKF.m:200-227)
        z1 = s_k.new_zeros(1)
        z2 = s_k.new_zeros(1, 1)
        return z1, z2, z1, z2

    return EKFSystem(
        state_dim=2, obs_dim=1, input_dim=1,
        nlin_state_update=nlin_state_update,
        state_jacobians=state_jacobians,
        nlin_obs_update=nlin_obs_update,
        obs_jacobian=obs_jacobian,
        state_hard_margins=identity_margins,
        obs_hard_margins=identity_margins,
        state_hessian_terms=state_hessian_terms,
        obs_hessian_terms=obs_hessian_terms,
    )


def rt_expfit_ekf(x, s_init, time_scale, alpha, sigma, w_bar, v_bar, Ps_init,
                  Q_w, R_v, beta=1.0, gamma=1.0, inv_monitor_len=21, order=1,
                  device=None):
    """EKF/EKS exponential-fit Rt estimator (Tools/Rt_ExpFitEKF.m:1).

    x: (T,) new-case series (NaN = missing), or (..., T) for a batch of
    series (s_init (..., 2) etc.). Returns the EKFResult; the growth rate is
    s_smooth[..., 1] (lambda) and Rt = exp(time_scale * lambda). Uses the
    pre-generic estimator's numerics: simple covariance update, no
    symmetrization, solve-based smoother gain, R adapted on every valid
    step. Runs on ``device``, else where ``x`` lies when it is a tensor,
    else on the CUDA card."""
    dev = resolve_device(device, x)
    x = as_device_tensor(x, dev)
    params = {"time_scale": as_device_tensor(time_scale, dev),
              "alpha": as_device_tensor(alpha, dev),
              "sigma": as_device_tensor(sigma, dev)}
    return ekf_smoother(
        rt_ekf_system(), torch.zeros(x.shape + (1,), dtype=x.dtype,
                                     device=dev),
        x, params, s_init, Ps_init, w_bar=w_bar, v_bar=v_bar, Q=Q_w, R=R_v,
        beta=beta, gamma_discount=gamma, inv_monitor_len=inv_monitor_len,
        order=order, joseph=False, smoother_gain="solve",
        symmetrize_covs=False, adaptive_R_always=True, device=dev)
