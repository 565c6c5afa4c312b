"""SEIRP 5-compartment model (S, E, I, R, P = passed/deceased),
Euler-discretized.

Counterpart of epidemicmodeling_tpu/models/seirp.py:
- Tools/SEIRP.m:26-32: all seven rates (alpha_e, alpha_i, kappa, rho, beta,
  mu, gamma) are time series, enabling NPI scheduling.
- Tools/SEIRPSaturatedResource.m:27-35: beta and mu interpolate between
  normal (beta_0, mu_0) and saturated (beta_s, mu_s) values through
  h = (tanh((i - i_0)/sigma) + 1)/2, modeling healthcare-system breakdown
  above the infection threshold i_0.

The JAX package vmaps scenario batches through its scan; here a batch is
leading dimensions on the rates and initial states, and the K-step loop is
one Python loop over (..., 5) states. The Euler updates keep the JAX
package's operation order, so float64 agrees with it to rounding.
"""

from __future__ import annotations

import torch

from ..utils.math import float_args


def seirp_step(state, rates, dt):
    """One Euler step. state: (..., 5) [s, e, i, r, p]; rates: (..., 7)
    [alpha_e, alpha_i, kappa, rho, beta, mu, gamma]."""
    s, e, i, r, p = state.unbind(-1)
    ae, ai, ka, ro, be, mu, ga = rates.unbind(-1)
    ds = -ae * s * e - ai * s * i + ga * r
    de = ae * s * e + ai * s * i - ka * e - ro * e
    di = ka * e - be * i - mu * i
    dr = be * i + ro * e - ga * r
    dp = mu * i
    return state + dt * torch.stack([ds, de, di, dr, dp], dim=-1)


def _rates_and_state(rates, x0, K, device):
    """The rate series as one (K, ..., n) tensor (each rate a number or a
    (..., K') series with K' >= K, cut to its first K samples; a trailing
    length of 1 broadcasts) and the initial states as (..., 5), all in one
    dtype on one device, the batch shapes broadcast together."""
    vals = float_args(device, *rates, *x0)
    series = []
    for a in vals[:len(rates)]:
        a = a.expand(K) if a.dim() == 0 else a[..., :K]
        series.append(a.expand(a.shape[:-1] + (K,)))
    R = torch.stack(torch.broadcast_tensors(*series), dim=-1)
    x = torch.stack(torch.broadcast_tensors(*vals[len(rates):]), dim=-1)
    batch = torch.broadcast_shapes(R.shape[:-2], x.shape[:-1])
    R = R.expand(batch + R.shape[-2:]).movedim(-2, 0)
    return R, x.expand(batch + (5,))


def _roll(step, R, x, K):
    traj = []
    for k in range(K):
        traj.append(x)
        x = step(x, R[k])
    return tuple(torch.stack(traj, dim=-2).unbind(-1))


def seirp_rollout(alpha_e, alpha_i, kappa, rho, beta, mu, gamma,
                  s0, e0, i0, r0, p0, T, dt, device=None):
    """Roll SEIRP for K = round(T/dt) samples (first sample = initial
    state).

    Each rate is a number or a (..., >= K) time series; the initial states
    are numbers or (...) batches. Returns (s, e, i, r, p), each (..., K).
    Runs on ``device``, else where the first tensor argument lies, else on
    the CUDA card."""
    K = int(round(T / dt))
    R, x = _rates_and_state((alpha_e, alpha_i, kappa, rho, beta, mu, gamma),
                            (s0, e0, i0, r0, p0), K, device)
    return _roll(lambda x, r_t: seirp_step(x, r_t, dt), R, x, K)


def seirp_saturated_step(state, rates, dt, beta_0, beta_s, mu_0, mu_s,
                         sigma, i_0):
    """One Euler step of SEIRP with resource saturation. rates: (..., 5)
    [alpha_e, alpha_i, kappa, rho, gamma]; beta and mu follow i through
    the tanh ramp."""
    s, e, i, r, p = state.unbind(-1)
    ae, ai, ka, ro, ga = rates.unbind(-1)
    h = (torch.tanh((i - i_0) / sigma) + 1.0) / 2.0
    be = (beta_s - beta_0) * h + beta_0
    mu = (mu_s - mu_0) * h + mu_0
    ds = -ae * s * e - ai * s * i + ga * r
    de = ae * s * e + ai * s * i - ka * e - ro * e
    di = ka * e - be * i - mu * i
    dr = be * i + ro * e - ga * r
    dp = mu * i
    return state + dt * torch.stack([ds, de, di, dr, dp], dim=-1)


def seirp_saturated_rollout(alpha_e, alpha_i, kappa, rho, gamma,
                            s0, e0, i0, r0, p0, T, dt,
                            beta_0, beta_s, mu_0, mu_s, sigma, i_0,
                            device=None):
    """Saturated-resource SEIRP rollout; see seirp_rollout for the
    conventions."""
    K = int(round(T / dt))
    R, x = _rates_and_state((alpha_e, alpha_i, kappa, rho, gamma),
                            (s0, e0, i0, r0, p0), K, device)
    beta_0, beta_s, mu_0, mu_s, sigma, i_0 = float_args(
        x.device, beta_0, beta_s, mu_0, mu_s, sigma, i_0)
    return _roll(lambda x, r_t: seirp_saturated_step(
        x, r_t, dt, beta_0, beta_s, mu_0, mu_s, sigma, i_0), R, x, K)


def seirp_linearized_matrices(alpha_e, alpha_i, kappa, rho, beta, mu, gamma,
                              device=None):
    """Early-phase linearization around (s=1, e=i=r=p=0): the
    continuous-time 5x5 state matrix A of d/dt [s, e, i, r, p] used for the
    analytic cross-checks in testScripts/testSEIRP01.m:106-122
    (eigenanalysis, closed-form early phase). Rates that are (...) batches
    give (..., 5, 5)."""
    ae, ai, ka, ro, be, mu, ga = float_args(
        device, alpha_e, alpha_i, kappa, rho, beta, mu, gamma)
    z = torch.zeros_like(ae)
    rows = [[z, -ae, -ai, ga, z],
            [z, ae - ka - ro, ai, z, z],
            [z, ka, -be - mu, z, z],
            [z, ro, be, -ga, z],
            [z, z, mu, z, z]]
    flat = torch.broadcast_tensors(*(e for row in rows for e in row))
    return torch.stack(flat, dim=-1).unflatten(-1, (5, 5))
