"""6-state SI-alpha + Pontryagin costate EKF system with in-filter bang-bang
optimal control.

Counterpart of epidemicmodeling_tpu/models/costate.py
(Tools/SIAlphaModelEKFOptControlled.m), in the batched callback convention
of models/base.py:
- state (s, i, alpha, lambda1, lambda2, lambda3);
- NaN entries of the input u are replaced in the filter by the bang-bang
  control: switching function phi = epsilon w - gamma lambda3 a, u = u_min
  where phi > 0, else u_max (:48-58);
- costate dynamics (:69-72) with rho = lambda1 - lambda2 - (1 - epsilon);
- a finite-slope (width 2/sigma) approximation of the switch in A[2, 5]
  (:106-114).
"""

from __future__ import annotations

import torch

from ..utils.math import clip_hi_lo, clip_lo_hi
from .base import EKFSystem, stack_matrix
from .si_alpha import (_obs_jacobian_row, _obs_update, check_obs_type,
                       npi_drive)


def bang_bang_fill(u, s6, params):
    """Replace NaN inputs by the bang-bang optimal control law
    (SIAlphaModelEKFOptControlled.m:48-58). u: (..., p) possibly holding
    NaN; s6: the costate lambda3 (...). Returns (u_filled, phi)."""
    phi = (params["epsilon"][..., None] * params["w"]
           - params["gamma"][..., None] * s6[..., None] * params["a"])
    u_candidate = torch.where(phi > 0, params["u_min"], params["u_max"])
    return torch.where(torch.isnan(u), u_candidate, u), phi


def costate_margins(s_k, params):
    """s, i clipped to [0, 1], alpha to its bounds, the costates (if any)
    unconstrained (SIAlphaModelEKFOptControlled.m:27-31; the backward
    systems' margins, BackwardEKF.m:48-52)."""
    return torch.cat([torch.stack([
        clip_hi_lo(s_k[..., 0], 0.0, 1.0),
        clip_hi_lo(s_k[..., 1], 0.0, 1.0),
        clip_hi_lo(s_k[..., 2], params["alpha_min"], params["alpha_max"]),
    ], dim=-1), s_k[..., 3:6]], dim=-1)


def band_term(u, s_k, params):
    """sum over the NPIs in the switching band (NaN input, |phi| < 1/sigma)
    of gamma dt (sigma / 2) a (u_max - u_min): the band's contribution to
    A[2, 5] up to its sign (SIAlphaModelEKFOptControlled.m:106-114)."""
    phi = (params["epsilon"][..., None] * params["w"]
           - params["gamma"][..., None] * s_k[..., 5, None] * params["a"])
    inv_sigma = (1.0 / params["sigma"])[..., None]
    band = torch.isnan(u) & (phi > -inv_sigma) & (phi < inv_sigma)
    slope = (params["gamma"] * params["dt"] * (params["sigma"] / 2.0))
    return torch.sum(torch.where(
        band, slope[..., None] * params["a"]
        * (params["u_max"] - params["u_min"]), 0.0), dim=-1)


def si_alpha_costate_ekf_system(obs_type: str = "NEWCASES",
                                input_dim: int = 12) -> EKFSystem:
    """The 6-state optimal-control EKF system."""
    check_obs_type(obs_type)

    def state_hard_margins(s_k, params, k):
        return costate_margins(s_k, params)

    def obs_hard_margins(x_k, params, k):
        return torch.clamp_min(x_k, 0.0)

    def nlin_state_update(u, s_k, w_bar, params, k):
        # SIAlphaModelEKFOptControlled.m:39-74
        dt = params["dt"]
        s, i, al, l1, l2, l3 = s_k.unbind(-1)
        u_filled, _ = bang_bang_fill(u, l3, params)
        rho = l1 - l2 - (1.0 - params["epsilon"])
        s1 = clip_lo_hi(s - dt * al * s * i, 0.0, 1.0)
        i1 = clip_lo_hi(i + dt * (al * s * i - params["beta"] * i), 0.0, 1.0)
        drive = (-params["gamma"] * al + params["gamma"] * params["b"]
                 + npi_drive(params, u_filled))
        a1 = clip_lo_hi(al + dt * drive, params["alpha_min"],
                        params["alpha_max"])
        n1 = l1 + dt * rho * al * i
        n2 = l2 + dt * (rho * al * s + params["beta"] * l2)
        n3 = l3 + dt * (rho * s * i + params["gamma"] * l3)
        return u_filled, torch.stack([s1, i1, a1, n1, n2, n3], dim=-1)

    def state_jacobians(u, s_k, w_bar, params, k):
        # SIAlphaModelEKFOptControlled.m:88-135
        dt, beta, gamma = params["dt"], params["beta"], params["gamma"]
        s, i, al, l1, l2, l3 = s_k.unbind(-1)
        rho = l1 - l2 - (1.0 - params["epsilon"])
        z = s_k.new_zeros(())
        A = stack_matrix([
            [1.0 - dt * al * i, -dt * al * s, -dt * s * i, z, z, z],
            [dt * i * al, 1.0 + dt * (s * al - beta), dt * s * i, z, z, z],
            [z, z, 1.0 - dt * gamma, z, z, -band_term(u, s_k, params)],
            [z, dt * al * rho, dt * i * rho, 1.0 + dt * i * al,
             -dt * i * al, z],
            [dt * al * rho, z, dt * s * rho, dt * s * al,
             1.0 - dt * (s * al - beta), z],
            [dt * i * rho, dt * s * rho, z, dt * s * i, -dt * s * i,
             1.0 + dt * gamma],
        ])
        return A, torch.eye(6, dtype=s_k.dtype, device=s_k.device)

    def nlin_obs_update(u, s_k, v_bar, params, k):
        return _obs_update(obs_type, s_k, v_bar)

    def obs_jacobian(u, s_k, v_bar, params, k):
        return (_obs_jacobian_row(obs_type, s_k, 6),
                torch.eye(1, dtype=s_k.dtype, device=s_k.device))

    return EKFSystem(
        state_dim=6, obs_dim=1, input_dim=input_dim,
        nlin_state_update=nlin_state_update,
        state_jacobians=state_jacobians,
        nlin_obs_update=nlin_obs_update,
        obs_jacobian=obs_jacobian,
        state_hard_margins=state_hard_margins,
        obs_hard_margins=obs_hard_margins,
    )
