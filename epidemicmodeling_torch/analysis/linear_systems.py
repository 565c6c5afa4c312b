"""Linear-systems analytics: observability and controllability, the SEIRP
linearization, eigenstructure and the closed-form early-phase solution.

Counterpart of epidemicmodeling_tpu/analysis/linear_systems.py:
testScripts/testSEIRP01.m:82-122 (obsv rank checks on the reduced
(e, i, r, p) system, full-state Jacobian, analytic eigenvalues lambda_1..4
and early-phase I(t)/E(t)), testScripts/testModelRanks01/02.m
(observability and controllability ranks of the augmented SEIRP).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.math import as_device_tensor, float_args


def obsv(A, C, device=None):
    """Observability matrix [C; CA; ...; CA^(n-1)] (MATLAB obsv)."""
    A, C = float_args(device, A, C)
    C = torch.atleast_2d(C)
    blocks = [C]
    for _ in range(A.shape[0] - 1):
        blocks.append(blocks[-1] @ A)
    return torch.cat(blocks, dim=0)


def ctrb(A, B, device=None):
    """Controllability matrix [B, AB, ..., A^(n-1)B] (MATLAB ctrb); a B
    whose rows do not match A's is taken transposed."""
    A, B = float_args(device, A, B)
    B = torch.atleast_2d(B)
    if B.shape[0] != A.shape[0]:
        B = B.T
    blocks = [B]
    for _ in range(A.shape[0] - 1):
        blocks.append(A @ blocks[-1])
    return torch.cat(blocks, dim=1)


def seirp_early_phase_matrix(alpha_e, alpha_i, kappa, rho, beta, mu, gamma,
                             device=None):
    """Reduced 4-state (e, i, r, p) system matrix for s ~= 1
    (testSEIRP01.m:84)."""
    ae, ai, ka, ro, be, mu, ga = float_args(
        device, alpha_e, alpha_i, kappa, rho, beta, mu, gamma)
    z = torch.zeros_like(ae)
    return torch.stack([
        torch.stack([ae - ka - ro, ai, z, z]),
        torch.stack([ka, -be - mu, z, z]),
        torch.stack([ro, be, -ga, z]),
        torch.stack([z, mu, z, z]),
    ])


def seirp_jacobian(e, i, r, p, alpha_e, alpha_i, kappa, rho, beta, mu,
                   gamma, device=None):
    """Jacobian of the reduced system at an arbitrary operating point with
    s = 1 - e - i - r - p (testSEIRP01.m:91-103), formed on the host."""
    e, i, r, p, alpha_e, alpha_i, kappa, rho, beta, mu, gamma = (
        float(v) for v in (e, i, r, p, alpha_e, alpha_i, kappa, rho, beta,
                           mu, gamma))
    s = 1.0 - e - i - r - p
    A = np.zeros((4, 4))
    A[0, 0] = alpha_e * (s - e) - alpha_i * i - kappa - rho
    A[0, 1] = alpha_i * (s - i) - alpha_e * e
    A[0, 2] = -alpha_e * e - alpha_i * i
    A[0, 3] = -alpha_e * e - alpha_i * i
    A[1, 0] = kappa
    A[1, 1] = -beta - mu
    A[2, 0] = rho
    A[2, 1] = beta
    A[2, 2] = -gamma
    A[3, 1] = mu
    return as_device_tensor(A, device)


def seirp_early_eigen(alpha_e, alpha_i, kappa, rho, beta, mu, gamma,
                      device=None):
    """Closed-form eigenvalues of the early-phase system
    (testSEIRP01.m:106-112): lambda1 = 0, lambda2 = -gamma,
    lambda3/4 = (delta - beta - mu +/- sqrt((beta+mu+delta)^2 +
    4*kappa*alpha_i)) / 2 with delta = alpha_e - kappa - rho."""
    alpha_e, alpha_i, kappa, rho, beta, mu, gamma = float_args(
        device, alpha_e, alpha_i, kappa, rho, beta, mu, gamma)
    delta = alpha_e - kappa - rho
    disc = torch.sqrt((beta + mu + delta) ** 2 + 4.0 * kappa * alpha_i)
    lam3 = (delta - beta - mu + disc) / 2.0
    lam4 = (delta - beta - mu - disc) / 2.0
    return torch.stack([torch.zeros_like(gamma), -gamma, lam3, lam4])


def seirp_early_closed_form(t, e0, alpha_e, alpha_i, kappa, rho, beta, mu,
                            gamma, device=None):
    """Closed-form early-phase I(t) and E(t) given e(0) = e0, i(0) = 0
    (testSEIRP01.m:120-122)."""
    t, e0, alpha_e, alpha_i, kappa, rho, beta, mu, gamma = float_args(
        device, t, e0, alpha_e, alpha_i, kappa, rho, beta, mu, gamma)
    delta = alpha_e - kappa - rho
    lam = seirp_early_eigen(alpha_e, alpha_i, kappa, rho, beta, mu, gamma)
    l3, l4 = lam[2], lam[3]
    ii = (e0 / alpha_i) * (l3 - delta) * (l4 - delta) / (l3 - l4) * (
        torch.exp(l4 * t) - torch.exp(l3 * t))
    ee = e0 / (l3 - l4) * ((l3 - delta) * torch.exp(l4 * t)
                           + (delta - l4) * torch.exp(l3 * t))
    return ii, ee
