"""Time-reversed SI-alpha EKF systems (backward filtering).

Counterpart of epidemicmodeling_tpu/models/backward.py
(Tools/SIAlphaModelBackwardEKF.m, Tools/SIAlphaModelBackwardEKFOpt
Controlled.m): the Euler step integrated backward in time, i.e. the forward
systems with the dynamics' signs flipped (BackwardEKF.m:65-67); run them
through ops.ekf.backward_ekf_smoother, which flips the sequences and swaps
the initial and terminal conditions. The backward 3-state margins clip s and
i to [0, 1], not [s_min, 1] (BackwardEKF.m:48-52).
"""

from __future__ import annotations

import torch

from ..utils.math import clip_lo_hi
from .base import EKFSystem, stack_matrix
from .costate import band_term, bang_bang_fill, costate_margins
from .si_alpha import (_obs_jacobian_row, _obs_update, check_obs_type,
                       npi_drive)


def _backward_system(m, obs_type, input_dim, margins, nlin_state_update,
                     state_jacobians):
    check_obs_type(obs_type)
    return EKFSystem(
        state_dim=m, obs_dim=1, input_dim=input_dim,
        nlin_state_update=nlin_state_update,
        state_jacobians=state_jacobians,
        nlin_obs_update=lambda u, s_k, v_bar, params, k: _obs_update(
            obs_type, s_k, v_bar),
        obs_jacobian=lambda u, s_k, v_bar, params, k: (
            _obs_jacobian_row(obs_type, s_k, m),
            torch.eye(1, dtype=s_k.dtype, device=s_k.device)),
        state_hard_margins=lambda s_k, params, k: margins(s_k, params),
        obs_hard_margins=lambda x_k, params, k: torch.clamp_min(x_k, 0.0),
    )


def _backward_sia(s, i, al, u, params):
    """The time-reversed SI-alpha step of (s, i, alpha) under input u."""
    dt = params["dt"]
    s1 = clip_lo_hi(s + dt * al * s * i, 0.0, 1.0)
    i1 = clip_lo_hi(i - dt * (al * s * i - params["beta"] * i), 0.0, 1.0)
    drive = (-params["gamma"] * al + params["gamma"] * params["b"]
             + npi_drive(params, u))
    a1 = clip_lo_hi(al - dt * drive, params["alpha_min"], params["alpha_max"])
    return s1, i1, a1


def si_alpha_backward_ekf_system(obs_type: str = "NEWCASES",
                                 input_dim: int = 12) -> EKFSystem:
    """3-state time-reversed system (SIAlphaModelBackwardEKF.m:48-110)."""

    def nlin_state_update(u, s_k, w_bar, params, k):
        s, i, al = s_k.unbind(-1)
        return u, torch.stack(_backward_sia(s, i, al, u, params), dim=-1)

    def state_jacobians(u, s_k, w_bar, params, k):
        dt = params["dt"]
        s, i, al = s_k.unbind(-1)
        z = s_k.new_zeros(())
        A = stack_matrix([
            [1.0 + dt * al * i, dt * al * s, dt * s * i],
            [-dt * i * al, 1.0 - dt * (s * al - params["beta"]), -dt * s * i],
            [z, z, 1.0 + dt * params["gamma"]],
        ])
        return A, torch.eye(3, dtype=s_k.dtype, device=s_k.device)

    return _backward_system(3, obs_type, input_dim, costate_margins,
                            nlin_state_update, state_jacobians)


def si_alpha_costate_backward_ekf_system(obs_type: str = "NEWCASES",
                                         input_dim: int = 12) -> EKFSystem:
    """6-state time-reversed optimal-control system
    (SIAlphaModelBackwardEKFOptControlled.m:81-156): sign-flipped SI-alpha
    and costate dynamics with the same in-filter bang-bang NaN fill."""

    def nlin_state_update(u, s_k, w_bar, params, k):
        dt = params["dt"]
        s, i, al, l1, l2, l3 = s_k.unbind(-1)
        u_filled, _ = bang_bang_fill(u, l3, params)
        rho = l1 - l2 - (1.0 - params["epsilon"])
        s1, i1, a1 = _backward_sia(s, i, al, u_filled, params)
        n1 = l1 - dt * rho * al * i
        n2 = l2 - dt * (rho * al * s + params["beta"] * l2)
        n3 = l3 - dt * (rho * s * i + params["gamma"] * l3)
        return u_filled, torch.stack([s1, i1, a1, n1, n2, n3], dim=-1)

    def state_jacobians(u, s_k, w_bar, params, k):
        dt, beta, gamma = params["dt"], params["beta"], params["gamma"]
        s, i, al, l1, l2, l3 = s_k.unbind(-1)
        rho = l1 - l2 - (1.0 - params["epsilon"])
        z = s_k.new_zeros(())
        A = stack_matrix([
            [1.0 + dt * al * i, dt * al * s, dt * s * i, z, z, z],
            [-dt * i * al, 1.0 - dt * (s * al - beta), -dt * s * i, z, z, z],
            [z, z, 1.0 + dt * gamma, z, z, band_term(u, s_k, params)],
            [z, -dt * al * rho, -dt * i * rho, 1.0 - dt * i * al,
             dt * i * al, z],
            [-dt * al * rho, z, -dt * s * rho, -dt * s * al,
             1.0 + dt * (s * al - beta), z],
            [-dt * i * rho, -dt * s * rho, z, -dt * s * i, dt * s * i,
             1.0 - dt * gamma],
        ])
        return A, torch.eye(6, dtype=s_k.dtype, device=s_k.device)

    return _backward_system(6, obs_type, input_dim, costate_margins,
                            nlin_state_update, state_jacobians)
