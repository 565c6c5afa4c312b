"""The exponential-fit EKF/EKS reproduction-number (Rt) estimator.

Counterpart of epidemicmodeling_tpu/rt/estimators.py:187-293
(Tools/Rt_ExpFitEKF.m): a 2-state EKF/EKS over new cases, x = A(t),
A(t+1) = A exp(ts lambda), lambda(t+1) = sigma tanh((a lambda + w) / sigma),
the reference's only second-order EKF (trace-based Hessian terms,
:157-227), plugged into the generic core (ops/ekf.py) with the pre-generic
options: no Joseph form, no symmetrization, the solve smoother gain, R
adapted on every valid step. The other three estimators of the JAX module
are not ported yet (ROADMAP A14).
"""

from __future__ import annotations

import torch

from ..models.base import EKFSystem, stack_matrix
from ..ops.ekf import _as_tensor, ekf_smoother
from ..utils.device import resolve_device


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
    x = _as_tensor(x, dev)
    params = {"time_scale": _as_tensor(time_scale, dev),
              "alpha": _as_tensor(alpha, dev),
              "sigma": _as_tensor(sigma, dev)}
    return ekf_smoother(
        rt_ekf_system(), torch.zeros(x.shape + (1,), dtype=x.dtype,
                                     device=dev),
        x, params, s_init, Ps_init, w_bar=w_bar, v_bar=v_bar, Q=Q_w, R=R_v,
        beta=beta, gamma_discount=gamma, inv_monitor_len=inv_monitor_len,
        order=order, joseph=False, smoother_gain="solve",
        symmetrize_covs=False, adaptive_R_always=True, device=dev)
