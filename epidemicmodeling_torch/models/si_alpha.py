"""SI and SI-alpha models: the rollouts, the controlled step, the params
constructor and the 3-state EKF system.

Counterpart of epidemicmodeling_tpu/models/si_alpha.py. The SI model with a
prescribed alpha(t) is Tools/SI_Controlled.m:19-22 (the first output
sample is the initial condition). The SI-alpha state is (s, i, alpha);
alpha relaxes towards b + a'(u_max - u) with rate gamma, with optional
Gaussian process noise per state (Tools/SIalpha_Controlled.m:24-28; the
outputs drop the initial condition, :30-32). The EKF system is
Tools/SIAlphaModelEKF.m: state update, Jacobian, the NEWCASES
(x = s i alpha) and TOTALCASES (x = 1 - s) observations and the hard
margins, in the batched callback convention of models/base.py.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.math import (as_device_tensor, clip_hi_lo, clip_lo_hi,
                          float_tensor)
from .base import EKFSystem, stack_matrix


def si_controlled_rollout(alpha, beta, s0, i0, K, dt, device=None):
    """SI model with prescribed alpha(t): returns (s, i), each (..., K),
    the first sample the initial condition (Tools/SI_Controlled.m). alpha:
    a scalar, (K,) or a batch (..., K) of series; s0 and i0 broadcast
    against its batch. Runs on ``device``, else where ``alpha`` lies when it
    is a tensor, else on the CUDA card."""
    dev = resolve_device(device, alpha)
    alpha = float_tensor(alpha, dev)
    if alpha.dim() == 0:
        alpha = alpha.expand(K)
    alpha = alpha[..., :K]
    s, i = (float_tensor(v, dev).to(alpha.dtype) for v in (s0, i0))
    batch = torch.broadcast_shapes(alpha.shape[:-1], s.shape, i.shape)
    s, i = s.expand(batch), i.expand(batch)
    traj_s, traj_i = [], []
    for k in range(K):
        a_t = alpha[..., k]
        traj_s.append(s)
        traj_i.append(i)
        s, i = (clip_lo_hi(s - dt * a_t * s * i, 0.0, 1.0),
                clip_lo_hi(i + dt * (a_t * s * i - beta * i), 0.0, 1.0))
    return torch.stack(traj_s, dim=-1), torch.stack(traj_i, dim=-1)


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


def si_alpha_step(state, u_t, noise_t, params):
    """One Euler step of the controlled SI-alpha model with additive process
    noise inside the derivative (Tools/SIalpha_Controlled.m:25-27).
    state: (..., 3) [s, i, alpha]; u_t: (..., p); noise_t: (..., 3)
    standard normal draws (zeros for the deterministic model)."""
    s1, i1, a1 = si_alpha_step_fields(state[..., 0], state[..., 1],
                                      state[..., 2], u_t, noise_t[..., 0],
                                      noise_t[..., 1], noise_t[..., 2],
                                      params)
    return torch.stack([s1, i1, a1], dim=-1)


def si_alpha_controlled_rollout(u, s0, i0, alpha0, u_max, alpha_min,
                                alpha_max, gamma, a, b, beta, s_noise_std,
                                i_noise_std, alpha_noise_std, K, dt,
                                generator: Optional[torch.Generator] = None,
                                noise=None, device=None):
    """Roll the controlled SI-alpha model for K steps, the initial condition
    dropped from the outputs (Tools/SIalpha_Controlled.m:30-32).

    u: (p, K) NPI schedule (input-major like the reference) or (K, p).
    noise: the (K, 3) standard normal draws of the stochastic model (e.g.
    the JAX package's, for parity); else drawn from ``generator`` (on its
    own device); with neither the model is noise-free, as with key=None.
    Returns (s, i, alpha), each (K,). Runs on ``device``, else where ``u``
    lies when it is a tensor, else on the CUDA card."""
    dev = resolve_device(device, u)
    u = float_tensor(u, dev)
    fd = u.dtype
    if u.dim() == 2 and u.shape[1] == K and u.shape[0] != K:
        u = u.T  # accept reference-style (p, K)
    f = lambda v: float_tensor(v, dev).to(fd)
    params = {
        "dt": dt, "beta": f(beta), "gamma": f(gamma), "a": f(a).reshape(-1),
        "b": f(b), "u_max": f(u_max).reshape(-1),
        "alpha_min": f(alpha_min), "alpha_max": f(alpha_max),
        "s_noise_std": f(s_noise_std), "i_noise_std": f(i_noise_std),
        "alpha_noise_std": f(alpha_noise_std),
    }
    if noise is None and generator is not None:
        noise = torch.randn((K, 3), generator=generator, dtype=fd,
                            device=generator.device)
    noise = (torch.zeros((K, 3), dtype=fd, device=dev) if noise is None
             else f(noise))
    state = torch.stack([f(s0), f(i0), f(alpha0)])
    traj = []
    for k in range(K):
        state = si_alpha_step(state, u[k], noise[k], params)
        traj.append(state)  # outputs exclude the initial condition
    traj = torch.stack(traj)
    return traj[:, 0], traj[:, 1], traj[:, 2]


def SIAlphaParams(*, dt, beta, gamma, a, b, u_min, u_max, s_min, i_min,
                  alpha_min, alpha_max, epsilon=np.nan, w=np.nan,
                  sigma=1e6, dtype=None, device=None):
    """The params dict of the SI-alpha EKF systems (the params struct
    assembled at Tools/TrainPredictPrescribeNPI.m:202-224), as tensors of
    ``dtype`` (float64 by default) on ``device`` (the CUDA card unless
    told otherwise)."""
    dev = resolve_device(device)
    fd = dtype or torch.float64

    def arr(v):
        return as_device_tensor(np.asarray(v, float), dev).to(fd)

    return {
        "dt": arr(dt), "beta": arr(beta), "gamma": arr(gamma),
        "a": arr(a).reshape(-1), "b": arr(b),
        "u_min": arr(u_min).reshape(-1), "u_max": arr(u_max).reshape(-1),
        "s_min": arr(s_min), "i_min": arr(i_min),
        "alpha_min": arr(alpha_min), "alpha_max": arr(alpha_max),
        "epsilon": arr(epsilon), "w": arr(w), "sigma": arr(sigma),
    }


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
