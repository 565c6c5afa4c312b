"""Forward Hamiltonian shooting for the SI-alpha optimal control theory
studies.

Counterpart of epidemicmodeling_tpu/analysis/shooting.py:
- testScripts/testSIModelOptimalControl01.m:62-98: the 3-state model with
  costates integrated FORWARD from guessed initial costates, the bang-bang
  law phi = epsilon*w - gamma*lambda3*a (u = u_min where phi >= 0, else
  u_max), Hamiltonian and (J0, J1) cost tracking.
- testScripts/testSIModelOptimalControl02.m:45-70: the 2-state variant with
  a continuous quadratic-cost control law
  u = round(clip(gamma*w / (-2 A s i rho))) and alpha = A.(u_max^2 - u^2).
- testScripts/testSIModelOptimalControl03.m:64-94: the multiplicative-input
  variant.

Each K-step scan of the JAX package is a Python loop of the same updates in
the same operation order; the state clips are the NaN-ordered
utils.math.clip_lo_hi (MATLAB min/max). Each function runs on ``device``,
else where its first tensor argument lies, else on the CUDA card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils.math import clip_lo_hi, float_args


class ShootingResult(NamedTuple):
    """Forward Hamiltonian-shooting trajectories: states, costates, the
    bang-bang schedule and cost densities (testSIModelOptimalControl01.m:
    62-98)."""
    s: torch.Tensor
    i: torch.Tensor
    alpha: torch.Tensor
    lambdas: torch.Tensor   # (K, 3)
    u: torch.Tensor         # (K, P)
    H: torch.Tensor         # Hamiltonian
    J0: torch.Tensor        # (K,) human cost density
    J1: torch.Tensor        # (K,) NPI cost density


def _dot(x, y):
    return (x * y).sum(-1)


def _inputs(device, w, K, P, vecs, u_schedule):
    """w as (K, P), the (P,) vectors, and the fixed schedule as (K, P) (or
    None), on one device in one dtype."""
    w, *vecs = float_args(device, w, *vecs)
    if w.dim() == 1:
        w = w.expand(K, P)
    vecs = [v.reshape(P) for v in vecs]
    if u_schedule is not None:
        u_schedule = float_args(w.device, u_schedule)[0].to(w.dtype)
        u_schedule = u_schedule.reshape(K, P)
    return w, vecs, u_schedule


def _result(out):
    s, i, al, lam, u, H, J0, J1 = (torch.stack(v) for v in zip(*out))
    return ShootingResult(s, i, al, lam, u, H, J0, J1)


def si_alpha_hamiltonian_shooting(epsilon, w, a, u_min, u_max, gamma, beta,
                                  s0, i0, alpha0, lambda_init, K, dt,
                                  alpha_min=0.0, alpha_max=math.inf,
                                  u_schedule=None, device=None):
    """Forward-integrate states and costates with the bang-bang law (or a
    fixed input schedule ``u_schedule`` (K, P) for the random baseline).
    lambda_init: (3,); w: (P,) or (K, P) weights. Returns ShootingResult
    with (K,) series."""
    P = len(a)
    w, (a, u_min, u_max), u_schedule = _inputs(
        device, w, K, P, (a, u_min, u_max), u_schedule)
    epsilon, gamma, beta, s, i, al, alpha_min, alpha_max = float_args(
        w.device, epsilon, gamma, beta, s0, i0, alpha0, alpha_min, alpha_max)
    l1, l2, l3 = float_args(w.device, lambda_init)[0].unbind()
    one_m_eps = 1.0 - epsilon
    out = []
    for k in range(K):
        w_t = w[k]
        rho = l1 - l2 - one_m_eps
        phi = epsilon * w_t - gamma * l3 * a
        u_t = (torch.where(phi >= 0, u_min, u_max) if u_schedule is None
               else u_schedule[k])
        drive = gamma * _dot(a, u_max - u_t)
        J1 = _dot(w_t, u_t)
        H = (-rho * al * s * i - beta * l2 * i
             + epsilon * J1
             + l3 * (-gamma * al + drive))
        J0 = al * s * i
        out.append((s, i, al, torch.stack([l1, l2, l3]), u_t, H, J0, J1))
        l1, l2, l3 = (l1 + dt * rho * al * i,
                      l2 + dt * (rho * al * s + beta * l2),
                      l3 + dt * (rho * s * i + gamma * l3))
        s, i, al = (clip_lo_hi(s - dt * al * s * i, 0.0, 1.0),
                    clip_lo_hi(i + dt * (al * s * i - beta * i), 0.0, 1.0),
                    clip_lo_hi(al + dt * (-gamma * al + drive),
                               alpha_min, alpha_max))
    return _result(out)


def si_continuous_control(A_coefs, w, u_min, u_max, gamma, beta, s0, i0,
                          rho0, lambda20, K, dt, device=None):
    """2-state continuous (quadratic-cost) control law variant
    (testSIModelOptimalControl02.m:45-70):
      u_t = round(clip(gamma*w / (-2 A s i rho), u_min, u_max))
      alpha_t = sum(A * (u_max^2 - u^2))
    (round half to even; a denominator within 1e-30 of zero is 1e-30).
    Returns a dict with s, i, alpha, u, J0, J1."""
    P = len(A_coefs)
    w, (A_coefs, u_min, u_max), _ = _inputs(
        device, w, K, P, (A_coefs, u_min, u_max), None)
    gamma, beta, s, i, rho, l2 = float_args(
        w.device, gamma, beta, s0, i0, rho0, lambda20)
    tiny = torch.full((), 1e-30, dtype=w.dtype, device=w.device)
    out = []
    for k in range(K):
        w_t = w[k]
        denom = -2.0 * A_coefs * s * i * rho
        u_t = torch.round(torch.minimum(torch.maximum(
            gamma * w_t / torch.where(torch.abs(denom) > 1e-30, denom, tiny),
            u_min), u_max))
        al = torch.sum(A_coefs * (u_max ** 2 - u_t ** 2))
        out.append((s, i, al, u_t, al * s * i, _dot(w_t, u_t)))
        rho, l2 = (rho + dt * rho * al * (i - s) - dt * beta * l2,
                   l2 + dt * rho * al * s + dt * beta * l2)
        s, i = (clip_lo_hi(s - dt * al * s * i, 0.0, 1.0),
                clip_lo_hi(i + dt * al * s * i - dt * beta * i, 0.0, 1.0))
    return {n: torch.stack(v) for n, v in
            zip(("s", "i", "alpha", "u", "J0", "J1"), zip(*out))}


def si_alpha_multiplicative_shooting(epsilon, w, a, c, u_min, u_max, beta,
                                     s0, i0, alpha0, lambda_init, K, dt,
                                     alpha_min=0.0, alpha_max=math.inf,
                                     u_schedule=None, device=None):
    """Modified multiplicative-input model
    (testScripts/testSIModelOptimalControl03.m:64-94): the contact rate
    decays in proportion to the applied NPIs, alpha' = -alpha*(a.u + c),
    with switching function phi = epsilon*w - lambda3*alpha*a and matching
    costate dynamics. Returns ShootingResult."""
    P = len(a)
    w, (a, u_min, u_max), u_schedule = _inputs(
        device, w, K, P, (a, u_min, u_max), u_schedule)
    epsilon, c, beta, s, i, al, alpha_min, alpha_max = float_args(
        w.device, epsilon, c, beta, s0, i0, alpha0, alpha_min, alpha_max)
    l1, l2, l3 = float_args(w.device, lambda_init)[0].unbind()
    one_m_eps = 1.0 - epsilon
    out = []
    for k in range(K):
        w_t = w[k]
        rho = l1 - l2 - one_m_eps
        phi = epsilon * w_t - l3 * al * a
        u_t = (torch.where(phi >= 0, u_min, u_max) if u_schedule is None
               else u_schedule[k])
        au = _dot(a, u_t) + c
        J1 = _dot(w_t, u_t)
        H = (-rho * al * s * i - beta * l2 * i
             + epsilon * J1 - l3 * al * au)
        J0 = al * s * i
        out.append((s, i, al, torch.stack([l1, l2, l3]), u_t, H, J0, J1))
        l1, l2, l3 = (l1 + dt * rho * al * i,
                      l2 + dt * (rho * al * s + beta * l2),
                      l3 + dt * (rho * s * i + l3 * au))
        s, i, al = (clip_lo_hi(s - dt * al * s * i, 0.0, 1.0),
                    clip_lo_hi(i + dt * (al * s * i - beta * i), 0.0, 1.0),
                    clip_lo_hi(al - dt * al * au, alpha_min, alpha_max))
    return _result(out)
