"""Batch-last SI-alpha system equations.

Counterpart of epidemicmodeling_tpu/models/batch_last.py:17-194. Same
semantics as Tools/SIAlphaModelEKF.m (3 states) and
Tools/SIAlphaModelEKFOptControlled.m (6 states: SI-alpha plus three
costates, with the bang-bang law filling NaN inputs), but every callback
carries a trailing lane axis B: states (m, B), inputs (p, B), params scalar,
(B,) or (p, B).
"""

from __future__ import annotations

import torch

from ..utils.math import clip_lo_hi, clip_hi_lo
from ..ops.ekf_bl import EKFSystemBL


def _dot_p(a, v):
    """Sum over the NPI axis: a (p, B) or (p,), v (p, B) -> (B,)."""
    return torch.sum(a * v, dim=0)


def _check_obs_type(obs_type):
    if obs_type not in ("NEWCASES", "TOTALCASES"):
        raise ValueError(f"unknown observation type {obs_type!r}")


def _obs_fns(obs_type, m):
    """Observation model x = s0*s1*s2 (NEWCASES) or x = 1 - s0 (TOTALCASES)
    and its single Jacobian row, padded with zeros to m states."""
    _check_obs_type(obs_type)

    def pad(row, s):
        zero = torch.zeros_like(s[0])
        return torch.stack(row + [zero] * (m - len(row)))

    if obs_type == "NEWCASES":
        def nlin_obs_update(s, params, k):
            return s[0] * s[1] * s[2]

        def obs_jacobian_row(s, params, k):
            return pad([s[1] * s[2], s[0] * s[2], s[0] * s[1]], s)
    else:
        def nlin_obs_update(s, params, k):
            return 1.0 - s[0]

        def obs_jacobian_row(s, params, k):
            zero = torch.zeros_like(s[0])
            return pad([-torch.ones_like(s[0]), zero, zero], s)
    return nlin_obs_update, obs_jacobian_row


def _obs_hard_margins(x, params, k):
    return torch.maximum(x, torch.zeros_like(x))


def si_alpha_ekf_system_bl(obs_type: str = "NEWCASES",
                           input_dim: int = 12) -> EKFSystemBL:
    """3-state batch-last system (Tools/SIAlphaModelEKF.m:27-89)."""
    nlin_obs_update, obs_jacobian_row = _obs_fns(obs_type, 3)

    def state_hard_margins(s, params, k):
        return torch.stack([
            clip_hi_lo(s[0], params["s_min"], 1.0),
            clip_hi_lo(s[1], params["i_min"], 1.0),
            clip_hi_lo(s[2], params["alpha_min"], params["alpha_max"]),
        ])

    def nlin_state_update(u, s, params, k):
        dt = params["dt"]
        s1 = clip_lo_hi(s[0] - dt * s[2] * s[0] * s[1], params["s_min"], 1.0)
        i1 = clip_lo_hi(s[1] + dt * (s[2] * s[0] * s[1]
                                     - params["beta"] * s[1]),
                        params["i_min"], 1.0)
        drive = (-params["gamma"] * s[2] + params["gamma"] * params["b"]
                 + params["gamma"] * _dot_p(params["a"],
                                            params["u_max"] - u))
        a1 = clip_lo_hi(s[2] + dt * drive, params["alpha_min"],
                        params["alpha_max"])
        return u, torch.stack([s1, i1, a1])

    def state_jacobian(u, s, params, k):
        dt = params["dt"]
        one = torch.ones_like(s[0])
        zero = torch.zeros_like(s[0])
        return torch.stack([
            torch.stack([one - dt * s[2] * s[1], -dt * s[2] * s[0],
                         -dt * s[0] * s[1]]),
            torch.stack([dt * s[1] * s[2],
                         one + dt * (s[0] * s[2] - params["beta"]),
                         dt * s[0] * s[1]]),
            torch.stack([zero, zero, one - dt * params["gamma"]]),
        ])

    return EKFSystemBL(
        state_dim=3, input_dim=input_dim,
        nlin_state_update=nlin_state_update,
        state_jacobian=state_jacobian,
        nlin_obs_update=nlin_obs_update,
        obs_jacobian_row=obs_jacobian_row,
        state_hard_margins=state_hard_margins,
        obs_hard_margins=_obs_hard_margins,
    )


def si_alpha_costate_ekf_system_bl(obs_type: str = "NEWCASES",
                                   input_dim: int = 12) -> EKFSystemBL:
    """6-state optimal-control batch-last system
    (Tools/SIAlphaModelEKFOptControlled.m:27-148)."""
    nlin_obs_update, obs_jacobian_row = _obs_fns(obs_type, 6)

    def state_hard_margins(s, params, k):
        return torch.stack([
            clip_hi_lo(s[0], 0.0, 1.0),
            clip_hi_lo(s[1], 0.0, 1.0),
            clip_hi_lo(s[2], params["alpha_min"], params["alpha_max"]),
            s[3], s[4], s[5],
        ])

    def _phi(s5, params):
        # (p, B): switching function epsilon*w - gamma*lambda3*a
        return (params["epsilon"] * params["w"]
                - params["gamma"] * s5[None, :] * params["a"])

    def nlin_state_update(u, s, params, k):
        dt = params["dt"]
        phi = _phi(s[5], params)
        u_cand = torch.where(phi > 0,
                             params["u_min"].expand(u.shape),
                             params["u_max"].expand(u.shape))
        u_filled = torch.where(torch.isnan(u), u_cand, u)
        rho = s[3] - s[4] - (1.0 - params["epsilon"])

        s1 = clip_lo_hi(s[0] - dt * s[2] * s[0] * s[1], 0.0, 1.0)
        i1 = clip_lo_hi(s[1] + dt * (s[2] * s[0] * s[1]
                                     - params["beta"] * s[1]), 0.0, 1.0)
        drive = (-params["gamma"] * s[2] + params["gamma"] * params["b"]
                 + params["gamma"] * _dot_p(params["a"],
                                            params["u_max"] - u_filled))
        a1 = clip_lo_hi(s[2] + dt * drive, params["alpha_min"],
                        params["alpha_max"])
        l1 = s[3] + dt * rho * s[2] * s[1]
        l2 = s[4] + dt * (rho * s[2] * s[0] + params["beta"] * s[4])
        l3 = s[5] + dt * (rho * s[0] * s[1] + params["gamma"] * s[5])
        return u_filled, torch.stack([s1, i1, a1, l1, l2, l3])

    def state_jacobian(u, s, params, k):
        dt = params["dt"]
        one = torch.ones_like(s[0])
        zero = torch.zeros_like(s[0])
        rho = s[3] - s[4] - (1.0 - params["epsilon"])

        phi = _phi(s[5], params)
        inv_sigma = 1.0 / params["sigma"]
        # the sigma band reads the RAW input: only NaN (optimized) inputs
        # carry the bang-bang sensitivity
        band = torch.isnan(u) & (phi > -inv_sigma) & (phi < inv_sigma)
        umax = params["u_max"].expand(u.shape)
        umin = params["u_min"].expand(u.shape)
        a_b = params["a"].expand(u.shape)
        a36 = -torch.sum(
            torch.where(band,
                        params["gamma"] * dt * (params["sigma"] / 2.0)
                        * a_b * (umax - umin), torch.zeros_like(a_b)),
            dim=0)

        row0 = torch.stack([one - dt * s[2] * s[1], -dt * s[2] * s[0],
                            -dt * s[0] * s[1], zero, zero, zero])
        row1 = torch.stack([dt * s[1] * s[2],
                            one + dt * (s[0] * s[2] - params["beta"]),
                            dt * s[0] * s[1], zero, zero, zero])
        row2 = torch.stack([zero, zero, one - dt * params["gamma"],
                            zero, zero, a36])
        row3 = torch.stack([zero, dt * s[2] * rho, dt * s[1] * rho,
                            one + dt * s[1] * s[2], -dt * s[1] * s[2], zero])
        row4 = torch.stack([dt * s[2] * rho, zero, dt * s[0] * rho,
                            dt * s[0] * s[2],
                            one - dt * (s[0] * s[2] - params["beta"]), zero])
        row5 = torch.stack([dt * s[1] * rho, dt * s[0] * rho, zero,
                            dt * s[0] * s[1], -dt * s[0] * s[1],
                            one + dt * params["gamma"]])
        return torch.stack([row0, row1, row2, row3, row4, row5])

    return EKFSystemBL(
        state_dim=6, input_dim=input_dim,
        nlin_state_update=nlin_state_update,
        state_jacobian=state_jacobian,
        nlin_obs_update=nlin_obs_update,
        obs_jacobian_row=obs_jacobian_row,
        state_hard_margins=state_hard_margins,
        obs_hard_margins=_obs_hard_margins,
    )
