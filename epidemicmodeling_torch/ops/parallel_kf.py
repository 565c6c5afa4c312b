"""Parallel (associative-scan) Kalman filter and RTS smoother.

Counterpart of epidemicmodeling_tpu/ops/parallel_kf.py, after Särkkä &
García-Fernández, "Temporal Parallelization of Bayesian Smoothers" (IEEE
TAC 2021): the filter and the smoother of a linear-Gaussian (or
pre-linearized) model become associative scans over closed-form composable
elements, so the sequential depth is O(log T) instead of O(T): the answer
for very long horizons (multi-year daily series, sub-daily cadences).

A NaN observation row makes its step a pure prediction element, as in the
sequential cores. PyTorch has no associative scan, so ``associative_scan``
follows ``jax.lax.associative_scan``'s own recursion (combine adjacent
pairs, recurse on the halves, fill in the even elements): the combinations
happen in the JAX package's order. Tensor code on any device; no kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.math import as_device_tensor, float_tensor


class PKFResult(NamedTuple):
    """Associative-scan Kalman filter + RTS smoother outputs."""
    means_filt: torch.Tensor    # (T, m) filtered means (posterior)
    covs_filt: torch.Tensor     # (T, m, m)
    means_smooth: torch.Tensor  # (T, m)
    covs_smooth: torch.Tensor   # (T, m, m)


def _mv(A, v):
    """Batched matrix-vector product: (..., m, k) @ (..., k) -> (..., m)."""
    return (A @ v[..., None])[..., 0]


def _t(A):
    return A.transpose(-1, -2)


def _filter_elements(F, Q, H, R, y, m0, P0):
    """Per-step associative elements (A, b, C, eta, J), each with a leading
    time axis.

    F, Q: (T, m, m) transition / process covariance (entry k maps
    x_{k-1} -> x_k; entry 0 is unused), H: (T, n, m), R: (T, n, n),
    y: (T, n) with NaN rows = missing.
    """
    T, m = F.shape[0], F.shape[1]
    kw = dict(dtype=F.dtype, device=F.device)
    I_m = torch.eye(m, **kw)
    first = (torch.arange(T, device=F.device) == 0)
    f2, f1 = first[:, None, None], first[:, None]

    valid = ~torch.isnan(y).any(dim=1)                             # (T,)
    v2, v1 = valid[:, None, None], valid[:, None]
    y0 = torch.where(v1, torch.nan_to_num(y), 0.0)

    Fk = torch.where(f2, I_m, F)
    Qk = torch.where(f2, torch.zeros_like(Q), Q)
    # at k == 0 the "prediction" is the prior itself
    mk = torch.where(f1, m0, torch.zeros((m,), **kw))
    Pk = torch.where(f2, P0, Qk)

    S = H @ Pk @ _t(H) + R
    Sinv = torch.linalg.inv(S)
    K = torch.where(v2, Pk @ _t(H) @ Sinv, 0.0)

    IKH = I_m - K @ H
    A = IKH @ Fk
    b = mk + _mv(K, y0 - _mv(H, mk))
    C = IKH @ Pk
    FtHtSinv = _t(Fk) @ _t(H) @ Sinv
    eta = torch.where(v1, _mv(FtHtSinv, y0), 0.0)
    J = torch.where(v2, FtHtSinv @ H @ Fk, 0.0)
    # at k == 0 A must vanish (b / C already hold the updated prior)
    A = torch.where(f2, 0.0, A)
    J = torch.where(f2, 0.0, J)
    eta = torch.where(f1, 0.0, eta)
    return A, b, C, eta, J


def _combine(e1, e2):
    """Associative combination (Särkkä & García-Fernández eq. 10-11)."""
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    m = A1.shape[-1]
    I_m = torch.eye(m, dtype=A1.dtype, device=A1.device)
    # M = A2 (I + C1 J2)^{-1}
    M = _t(torch.linalg.solve(_t(I_m + C1 @ J2), _t(A2)))
    A = M @ A1
    b = _mv(M, b1 + _mv(C1, eta2)) + b2
    C = M @ C1 @ _t(A2) + C2
    # N = (I + J2 C1)^{-1}
    IJC = I_m + J2 @ C1
    N = torch.linalg.solve(IJC, I_m.expand(IJC.shape))
    At_N = _t(A1) @ N
    eta = _mv(At_N, eta2 - _mv(J2, b1)) + eta1
    J = At_N @ J2 @ A1 + J1
    return (A, b, C, eta, J)


def _smoother_elements(F, Q, means_filt, covs_filt):
    """Per-step smoother elements (E, g, L): x_k | x_{k+1} ~
    N(E x_{k+1} + g, L) from the filtered moments (eq. 19)."""
    T = means_filt.shape[0]
    nxt = torch.clamp(torch.arange(T, device=F.device) + 1, max=T - 1)
    Fk1, Qk1 = F[nxt], Q[nxt]
    Pk = covs_filt
    Pp = Fk1 @ Pk @ _t(Fk1) + Qk1
    E = _t(torch.linalg.solve(_t(Pp), _t(Pk @ _t(Fk1))))
    g = means_filt - _mv(E, _mv(Fk1, means_filt))
    L = Pk - E @ Fk1 @ Pk
    last = (torch.arange(T, device=F.device) == T - 1)
    E = torch.where(last[:, None, None], 0.0, E)
    g = torch.where(last[:, None], means_filt, g)
    L = torch.where(last[:, None, None], Pk, L)
    return E, g, L


def _combine_smooth(acc, elem):
    """Smoother combination on the REVERSED sequence: ``acc`` composes the
    LATER-time elements, ``elem`` is the next EARLIER-time element; the
    paper's (earlier x later) rule (eq. 12) gives E = E_e E_a,
    g = E_e g_a + g_e, L = E_e L_a E_e' + L_e."""
    Ea, ga, La = acc
    Ee, ge, Le = elem
    return (Ee @ Ea, _mv(Ee, ga) + ge, Ee @ La @ _t(Ee) + Le)


def _interleave(even, odd):
    """even[0], odd[0], even[1], odd[1], ... along the first axis (even
    has as many elements as odd, or one more)."""
    out = even.new_empty((even.shape[0] + odd.shape[0],) + even.shape[1:])
    out[0::2] = even
    out[1::2] = odd
    return out


def associative_scan(fn, elems):
    """Inclusive scan of the tuple of tensors ``elems`` along their first
    axis with the associative ``fn``, by jax.lax.associative_scan's
    recursion: fn over adjacent pairs, the scan of those recursively (the
    odd results), then fn of each odd result with the next even element,
    interleaved. Depth O(log T)."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = fn(tuple(e[0:-1:2] for e in elems),
                 tuple(e[1::2] for e in elems))
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(tuple(e[:-1] for e in odd), tuple(e[2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[2::2] for e in elems))
    even = tuple(torch.cat([e[:1], r]) for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def parallel_kalman(F, Q, H, R, y, m0, P0) -> PKFResult:
    """Run the parallel KF + RTS smoother.

    F, Q: (T, m, m); H: (T, n, m); R: (T, n, n); y: (T, n) (NaN = missing);
    m0, P0: prior at step 0 (before the first update). Everything runs
    where F lies when it is a tensor, else on the CUDA card
    (utils.device.resolve_device), in F's dtype (float64 for a non-float
    array). Depth is O(log T) instead of O(T).
    """
    F = float_tensor(F)
    Q, H, R, y, m0, P0 = (as_device_tensor(a, F.device, F.dtype)
                          for a in (Q, H, R, y, m0, P0))
    _, b, C, _, _ = associative_scan(
        _combine, _filter_elements(F, Q, H, R, y, m0, P0))
    means_filt, covs_filt = b, C

    rev = lambda a: torch.flip(a, dims=(0,))
    _, g, L = associative_scan(
        _combine_smooth,
        tuple(rev(x) for x in _smoother_elements(F, Q, means_filt,
                                                 covs_filt)))
    return PKFResult(means_filt, covs_filt, rev(g), rev(L))
