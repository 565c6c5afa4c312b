"""SI-alpha model: the controlled rollout step and the 3-state EKF system.

Counterpart of epidemicmodeling_tpu/models/si_alpha.py:46,138-231. The state
is (s, i, alpha); alpha relaxes towards b + a'(u_max - u) with rate gamma
(Tools/SIalpha_Controlled.m:24-28). The EKF system is
Tools/SIAlphaModelEKF.m: state update, Jacobian, the NEWCASES (x = s i alpha)
and TOTALCASES (x = 1 - s) observations and the hard margins, in the
batched callback convention of models/base.py.
"""

from __future__ import annotations

import torch

from ..utils.math import clip_hi_lo, clip_lo_hi
from .base import EKFSystem, stack_matrix


def si_alpha_step_fields(s, i, al, u_t, n_s, n_i, n_al, params):
    """One Euler step on unpacked state fields. The fields and noise draws
    are (...,) batches; u_t and params["a"] / ["u_max"] are (..., p).
    Returns (s1, i1, alpha1)."""
    dt = params["dt"]
    s1 = clip_lo_hi(
        s - dt * (al * s * i + n_s * params["s_noise_std"]), 0.0, 1.0)
    i1 = clip_lo_hi(
        i + dt * (al * s * i - params["beta"] * i
                  + n_i * params["i_noise_std"]), 0.0, 1.0)
    drive = (-params["gamma"] * al + params["gamma"] * params["b"]
             + params["gamma"] * torch.sum(
                 params["a"] * (params["u_max"] - u_t), dim=-1)
             + n_al * params["alpha_noise_std"])
    a1 = clip_lo_hi(al + dt * drive, params["alpha_min"], params["alpha_max"])
    return s1, i1, a1


def check_obs_type(obs_type):
    """Validate at system-construction time (SIAlphaModelEKF.m:51-59 errors
    on unknown types), so a typo fails before any work."""
    if obs_type not in ("NEWCASES", "TOTALCASES"):
        raise ValueError(f"unknown observation type {obs_type!r}; "
                         "expected 'NEWCASES' or 'TOTALCASES'")


def _obs_update(obs_type, s_k, v_bar):
    """The observation (..., 1) of state s_k (..., m)."""
    if obs_type == "NEWCASES":
        x = s_k[..., 0] * s_k[..., 1] * s_k[..., 2] + v_bar[..., 0]
    elif obs_type == "TOTALCASES":
        x = 1.0 - s_k[..., 0] + v_bar[..., 0]
    else:
        raise ValueError(f"unknown observation type {obs_type!r}")
    return x[..., None]


def _obs_jacobian_row(obs_type, s_k, m):
    """The observation Jacobian C (..., 1, m)."""
    z = s_k.new_zeros(())
    if obs_type == "NEWCASES":
        row = [s_k[..., 1] * s_k[..., 2], s_k[..., 0] * s_k[..., 2],
               s_k[..., 0] * s_k[..., 1]] + [z] * (m - 3)
    elif obs_type == "TOTALCASES":
        row = [s_k.new_full((), -1.0)] + [z] * (m - 1)
    else:
        raise ValueError(f"unknown observation type {obs_type!r}")
    return stack_matrix([row])


def npi_drive(params, u):
    """gamma a'(u_max - u), the NPIs' pull on alpha (sum over the NPI
    axis)."""
    return params["gamma"] * torch.sum(params["a"] * (params["u_max"] - u),
                                       dim=-1)


def si_alpha_ekf_system(obs_type: str = "NEWCASES",
                        input_dim: int = 12) -> EKFSystem:
    """3-state (s, i, alpha) EKF system, Tools/SIAlphaModelEKF.m. obs_type:
    NEWCASES (x = s i alpha) or TOTALCASES (x = 1 - s), :51-59."""
    check_obs_type(obs_type)

    def state_hard_margins(s_k, params, k):
        # SIAlphaModelEKF.m:27-31
        return torch.stack([
            clip_hi_lo(s_k[..., 0], params["s_min"], 1.0),
            clip_hi_lo(s_k[..., 1], params["i_min"], 1.0),
            clip_hi_lo(s_k[..., 2], params["alpha_min"], params["alpha_max"]),
        ], dim=-1)

    def obs_hard_margins(x_k, params, k):
        return torch.clamp_min(x_k, 0.0)  # SIAlphaModelEKF.m:34-36

    def nlin_state_update(u, s_k, w_bar, params, k):
        # SIAlphaModelEKF.m:39-48 (margins are applied inside the update too)
        dt = params["dt"]
        s, i, al = s_k[..., 0], s_k[..., 1], s_k[..., 2]
        s1 = clip_lo_hi(s - dt * al * s * i, params["s_min"], 1.0)
        i1 = clip_lo_hi(i + dt * (al * s * i - params["beta"] * i),
                        params["i_min"], 1.0)
        drive = (-params["gamma"] * al + params["gamma"] * params["b"]
                 + npi_drive(params, u))
        a1 = clip_lo_hi(al + dt * drive, params["alpha_min"],
                        params["alpha_max"])
        return u, torch.stack([s1, i1, a1], dim=-1)

    def state_jacobians(u, s_k, w_bar, params, k):
        # SIAlphaModelEKF.m:62-76
        dt = params["dt"]
        s, i, al = s_k[..., 0], s_k[..., 1], s_k[..., 2]
        z = s_k.new_zeros(())
        A = stack_matrix([
            [1.0 - dt * al * i, -dt * al * s, -dt * s * i],
            [dt * i * al, 1.0 + dt * (s * al - params["beta"]), dt * s * i],
            [z, z, 1.0 - dt * params["gamma"]],
        ])
        return A, torch.eye(3, dtype=s_k.dtype, device=s_k.device)

    def nlin_obs_update(u, s_k, v_bar, params, k):
        return _obs_update(obs_type, s_k, v_bar)

    def obs_jacobian(u, s_k, v_bar, params, k):
        return (_obs_jacobian_row(obs_type, s_k, 3),
                torch.eye(1, dtype=s_k.dtype, device=s_k.device))

    return EKFSystem(
        state_dim=3, obs_dim=1, input_dim=input_dim,
        nlin_state_update=nlin_state_update,
        state_jacobians=state_jacobians,
        nlin_obs_update=nlin_obs_update,
        obs_jacobian=obs_jacobian,
        state_hard_margins=state_hard_margins,
        obs_hard_margins=obs_hard_margins,
    )
