"""Generic batched Extended Kalman Filter + fixed-interval Smoother (EKF/EKS)
in plain PyTorch tensor ops.

Counterpart of epidemicmodeling_tpu/ops/ekf.py (Tools/
GenericExtendedKalmanFilter.m), with every feature of it: fixed or
time-varying noise covariances, NaN observations as pure prediction steps,
the Joseph (or simple) covariance update, forced symmetrization, the gain
discount gamma, the innovation-whiteness monitor rho, adaptive R, terminal
conditions (NaN = unconstrained), the pinv smoother gain with MATLAB's exact
tolerance (or a solve), the smoothed optimal input, and the second-order
Hessian hooks.

The JAX package runs one filter per ``lax.scan`` and batches with ``vmap``.
Here the batch is explicit: every input carries leading batch dimensions
(those of ``s_init``) and the system callbacks take them (models/base.py),
so each step is a few tensor ops over all filters. What JAX marks static
(beta, order, joseph, smoother_gain, outputs, whether R adapts) stays Python
values, so the time loop makes no host sync. The smoother gains
J(k) = P+(k) A(k)^T pinv(P-(k+1)) do not depend on the smoothed states, so
they are formed for all steps at once, in one batched SVD, before the short
backward recursion; each gain is the same arithmetic as in the per-step
loop of the JAX core.

There is no hand-written kernel behind this core (the JAX core reaches no
Pallas kernel either): on a card each step is a few hundred small launches.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.base import EKFSystem
from ..utils.device import resolve_device
from ..utils.math import as_device_tensor, symmetrize


class EKFResult(NamedTuple):
    """EKF/EKS outputs with the filters' batch dimensions first and time
    next: (..., T, ...). ``outputs="light"`` leaves the covariances, gains,
    innovations and rho as None."""

    u_opt: torch.Tensor                   # (..., T, p) NaN inputs filled
    u_opt_smooth: torch.Tensor            # (..., T, p) same, from s_smooth
    s_minus: torch.Tensor                 # (..., T, m) prior states
    s_plus: torch.Tensor                  # (..., T, m) posterior states
    s_smooth: torch.Tensor                # (..., T, m) smoothed states
    P_minus: Optional[torch.Tensor]       # (..., T, m, m)
    P_plus: Optional[torch.Tensor]        # (..., T, m, m)
    P_smooth: Optional[torch.Tensor]      # (..., T, m, m)
    K_gain: Optional[torch.Tensor]        # (..., T, m, n)
    innovations: Optional[torch.Tensor]   # (..., T, n)
    rho: Optional[torch.Tensor]           # (..., T, n, n) whiteness monitor


def _normalize_cov(M, T, batch, name):
    """A noise covariance input as a (*batch, T, d, d) schedule (a view) and
    a 'fixed' flag, with GEKF.m:64-91's conventions for each filter: a
    scalar, a length-T scalar series, a fixed (d, d) matrix or (T, d, d)
    matrices. M carries the batch dimensions, except a 0-dim M, which every
    filter shares."""
    nb = len(batch)
    if M.dim() == 0:
        return M.reshape(1, 1).expand(*batch, T, 1, 1), True
    rank = M.dim() - nb
    if rank < 0 or tuple(M.shape[:nb]) != tuple(batch):
        raise ValueError(f"{name}: shape {tuple(M.shape)} does not lead with "
                         f"the batch shape {tuple(batch)}")
    if rank == 1:
        if M.shape[-1] != T:
            raise ValueError(f"{name}: scalar series length {M.shape[-1]} "
                             f"!= T={T}")
        return M[..., None, None], False
    if rank == 2:
        return M[..., None, :, :].expand(*batch, T, *M.shape[-2:]), True
    if rank == 3:
        if M.shape[-3] != T:
            raise ValueError(f"{name}: time axis {M.shape[-3]} != T={T}")
        return M, False
    raise ValueError(f"{name}: covariance rank {rank} not understood")


def _mrdivide(Bmat, Amat):
    """MATLAB B/A: solve X @ A = B (batched). A singular A gives inf/NaN, as
    jnp.linalg.solve does, instead of raising; ``info`` is not read (that
    would be a host sync)."""
    return torch.linalg.solve_ex(Amat.transpose(-1, -2),
                                 Bmat.transpose(-1, -2)).result.transpose(
                                     -1, -2)


def _matlab_pinv(A):
    """pinv with MATLAB's exact default tolerance (pinv.m), batched: SVD,
    keep sigma_i STRICTLY ABOVE tol = max(size(A)) * eps(norm(A)), eps(x)
    being the floating-point spacing at x and norm(A) = sigma_max. Never
    torch.linalg.pinv's default cutoff, which truncates singular values
    MATLAB keeps at cond ~ 1e15 (epidemicmodeling_tpu/ops/ekf.py:93-104).

    Each matrix is first scaled by a power of two that brings its largest
    entry into [0.5, 1), and the result scaled back: exact (every rounding
    of the SVD, the cutoff and the products scales with it), and it keeps
    a float32 matrix with entries above ~1e19, whose squared column norms
    would overflow inside the card's Jacobi SVD, finite."""
    amax = A.abs().amax(dim=(-2, -1), keepdim=True)
    scale = torch.ldexp(torch.ones_like(amax), -torch.frexp(amax).exponent)
    U, s, Vh = torch.linalg.svd(A * scale, full_matrices=False)
    s0 = s[..., :1]
    tol = max(A.shape[-2:]) * (torch.nextafter(s0, torch.full_like(
        s0, float("inf"))) - s0)
    keep = s > tol
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    return ((Vh.transpose(-1, -2) * s_inv[..., None, :])
            @ U.transpose(-1, -2)) * scale


def _hessian_terms(fn, dim, batch, args):
    """A system's second-order terms, broadcast to the batch shape."""
    t1, t2, t3, t4 = fn(*args)
    return (t1.expand(*batch, dim), t2.expand(*batch, dim, dim),
            t3.expand(*batch, dim), t4.expand(*batch, dim, dim))


def ekf_smoother(
    system: EKFSystem,
    u,                          # (..., T, p) inputs (NaN => optimal control)
    x,                          # (..., T, n) or (..., T) observations
    params,                     # dict of tensors passed to the callbacks
    s_init,                     # (..., m); its leading dims are the batch
    Ps_init,                    # (..., m, m)
    s_final=None,               # (..., m) NaN = unconstrained
    Ps_final=None,              # (..., m, m) NaN = unconstrained
    w_bar=None,                 # (..., l) process noise mean
    v_bar=None,                 # (..., q) observation noise mean
    Q=1.0,                      # per filter: scalar | (T,) | (m,m) | (T,m,m)
    R=1.0,                      # per filter: scalar | (T,) | (n,n) | (T,n,n)
    beta: float = 1.0,          # adaptive-R blending factor (1 = off)
    gamma_discount: float = 1.0,  # Kalman gain stability discount
    inv_monitor_len: int = 21,  # innovation whiteness monitor window
    order: int = 1,             # 1 = standard EKF, else second order
    joseph: bool = True,        # Joseph-stabilized covariance update
    smoother_gain: str = "pinv",  # "pinv" (MATLAB parity) | "solve"
    symmetrize_covs: bool = True,  # force P = (P + P') / 2
    adaptive_R_always: bool = False,  # adapt R even when it varies in time
    outputs: str = "full",      # "light": no covariances, gains or rho
    device=None,
) -> EKFResult:
    """Run the forward EKF and the backward fixed-interval smoother over a
    batch of sequences (the leading dimensions of ``s_init``; none for one
    sequence, as in the JAX package's ekf_smoother).

    Q and R carry the batch dimensions, except a 0-dim value that every
    filter shares. R adapts only when beta != 1 and R is fixed (or
    adaptive_R_always); after a NaN step the generic filter resets it to
    the prior, adaptive_R_always carries it (ops/ekf.py:269-279). Runs on
    ``device``, else on the device of ``x`` (or ``s_init``) when it is a
    tensor, else on the CUDA card."""
    if smoother_gain not in ("pinv", "solve"):
        raise ValueError(f"unknown smoother_gain {smoother_gain!r}")
    if outputs not in ("full", "light"):
        raise ValueError(f"unknown outputs {outputs!r}")
    m, n = system.state_dim, system.obs_dim
    like = next((a for a in (x, s_init, u)
                 if isinstance(a, torch.Tensor)), None)
    dev = resolve_device(device, like)
    x, u = as_device_tensor(x, dev), as_device_tensor(u, dev)
    s_init = as_device_tensor(s_init, dev)
    Ps_init = as_device_tensor(Ps_init, dev)
    dtype = torch.promote_types(torch.promote_types(x.dtype, s_init.dtype),
                                Ps_init.dtype)
    kw = dict(dtype=dtype, device=dev)
    batch = tuple(s_init.shape[:-1])
    nb = len(batch)
    if x.dim() == nb + 1:
        x = x[..., None]
    if u.dim() == nb + 1:
        u = u[..., None]
    x, u = x.to(dtype), u.to(dtype)
    T = x.shape[-2]
    s_init = s_init.to(dtype).reshape(*batch, m)
    Ps_init = Ps_init.to(dtype).reshape(*batch, m, m)
    fill = lambda a, shape: (torch.full(shape, float("nan"), **kw)
                             if a is None else
                             as_device_tensor(a, dev, dtype).expand(shape))
    s_final = fill(s_final, (*batch, m))
    Ps_final = fill(Ps_final, (*batch, m, m))
    w_bar = (torch.zeros(m, **kw) if w_bar is None
             else as_device_tensor(w_bar, dev, dtype))
    v_bar = (torch.zeros(n, **kw) if v_bar is None
             else as_device_tensor(v_bar, dev, dtype))
    leaf = lambda t: t.to(dtype) if t.is_floating_point() else t
    params = {k: leaf(as_device_tensor(v, dev)) for k, v in params.items()}

    Q_seq, _ = _normalize_cov(as_device_tensor(Q, dev, dtype), T, batch, "Q")
    R_seq, fixed_R = _normalize_cov(as_device_tensor(R, dev, dtype), T,
                                    batch, "R")
    adaptive_R = (beta != 1.0) and (fixed_R or adaptive_R_always)
    sym = symmetrize if symmetrize_covs else (lambda M: M)
    full = outputs == "full"
    monitor = full or adaptive_R
    second = order != 1
    if second:
        for name in ("obs_hessian_terms", "state_hessian_terms"):
            if getattr(system, name) is None:
                raise TypeError(f"order={order} needs the system's {name}, "
                                "which it does not define")

    L = int(inv_monitor_len)
    eps = torch.finfo(dtype).eps
    gam = float(gamma_discount)
    I_m = torch.eye(m, **kw)
    col = lambda v: v[..., None]

    # ----- forward filter (GEKF.m:93-186) -----
    s_minus, P_minus = s_init, Ps_init
    R_carry = R_seq[..., 0, :, :]
    if monitor:
        mean_buf = torch.zeros(*batch, L, n, **kw)
        cov_buf = torch.zeros(*batch, L, n, n, **kw)
        covn_buf = torch.zeros(*batch, L, n, n, **kw)
    keep = {k: [] for k in ("s_minus", "P_minus", "s_plus", "P_plus",
                            "u_opt", "K", "innov", "rho")}
    for k in range(T):
        u_k, x_k = u[..., k, :], x[..., k, :]
        Q_k, R_sched_k = Q_seq[..., k, :, :], R_seq[..., k, :, :]
        R_k = R_carry if adaptive_R else R_sched_k

        C, D = system.obs_jacobian(u_k, s_minus, v_bar, params, k)
        x_pred = system.nlin_obs_update(u_k, s_minus, v_bar, params, k)
        if second:
            gs, Gsp, gv, Gvp = _hessian_terms(
                system.obs_hessian_terms, n, batch,
                (u_k, s_minus, P_minus, v_bar, R_k, params, k))
            x_pred = x_pred + gs + gv
        x_pred = system.obs_hard_margins(x_pred, params, k)

        valid = ~torch.isnan(x_k).any(dim=-1)
        innov = torch.where(col(valid), x_k - x_pred, 0.0)

        DRD = D @ R_k @ D.transpose(-1, -2)
        S = C @ P_minus @ C.transpose(-1, -2) + gam * DRD
        if second:
            S = S + Gsp + Gvp
        PCt = P_minus @ C.transpose(-1, -2)
        K_full = PCt / S[..., :1, :1] if n == 1 else _mrdivide(PCt, S)
        K = torch.where(col(col(valid)), K_full, 0.0)

        IKC = I_m - K @ C
        if joseph:
            P_upd = (IKC @ P_minus @ IKC.transpose(-1, -2)
                     + K @ DRD @ K.transpose(-1, -2)) / gam
        else:
            P_upd = IKC @ P_minus / gam
        P_plus = sym(torch.where(col(col(valid)), P_upd, P_minus))
        s_plus = torch.where(col(valid),
                             s_minus + (K @ col(innov))[..., 0], s_minus)
        s_plus = system.state_hard_margins(s_plus, params, k)

        u_opt_k, s_next = system.nlin_state_update(u_k, s_plus, w_bar,
                                                   params, k)
        A, Bm = system.state_jacobians(u_k, s_plus, w_bar, params, k)
        P_next = A @ P_plus @ A.transpose(-1, -2) \
            + Bm @ Q_k @ Bm.transpose(-1, -2)
        if second:
            fs, Fsp, fw, Fwp = _hessian_terms(
                system.state_hessian_terms, m, batch,
                (u_k, s_plus, P_plus, w_bar, Q_k, params, k))
            s_next = s_next + fs + fw
            P_next = P_next + Fsp + Fwp
        P_next = sym(P_next)
        s_next = system.state_hard_margins(s_next, params, k)

        # innovation whiteness monitor (GEKF.m:171-179)
        if monitor:
            cnt = float(min(k + 1, L))
            mean_buf = torch.cat([innov[..., None, :], mean_buf[..., :-1, :]],
                                 dim=-2)
            mu = mean_buf.sum(dim=-2) / cnt
            d = innov - mu
            cc = d[..., :, None] * d[..., None, :]
            cov_buf = torch.cat([cc[..., None, :, :],
                                 cov_buf[..., :-1, :, :]], dim=-3)
        if full:
            ccn = cc / (R_k + eps) if n == 1 else _mrdivide(cc, R_k + eps)
            covn_buf = torch.cat([ccn[..., None, :, :],
                                  covn_buf[..., :-1, :, :]], dim=-3)
            keep["rho"].append(covn_buf.sum(dim=-3) / cnt)
            keep["K"].append(K)
            keep["innov"].append(innov)
        if adaptive_R:
            R_estim = cov_buf.sum(dim=-3) / cnt
            R_adapt = beta * R_k + (1.0 - beta) * R_estim
            # On a NaN step GEKF.m:180-185 skips the R(:,:,k+1) write, so
            # the pre-filled cell keeps the FIXED prior: a NaN hole RESETS
            # the adapted R. The pre-generic estimators hold R in a scalar
            # (Rt_ExpFitEKF.m:97-99), so not updating means CARRYING it.
            R_hold = R_k if adaptive_R_always else R_sched_k
            R_carry = torch.where(col(col(valid)), R_adapt, R_hold)

        for name, v in (("s_minus", s_minus), ("P_minus", P_minus),
                        ("s_plus", s_plus), ("P_plus", P_plus),
                        ("u_opt", u_opt_k)):
            keep[name].append(v)
        s_minus, P_minus = s_next, P_next

    # time-major stacks (T, *batch, ...)
    st = {k: torch.stack(v) for k, v in keep.items() if v}
    keep.clear()
    S_MINUS, S_PLUS = st["s_minus"], st["s_plus"]
    P_MINUS, P_PLUS = st["P_minus"], st["P_plus"]
    u_t = torch.movedim(u, -2, 0)                          # (T, *batch, p)

    # ----- backward fixed-interval smoother (GEKF.m:188-230) -----
    # terminal conditions (NaN = keep the filter estimate; GEKF.m:194-202)
    sT = torch.where(torch.isnan(s_final), S_PLUS[-1], s_final)
    PT = torch.where(torch.isnan(Ps_final), P_PLUS[-1], Ps_final)

    # every gain J(k), k = 0..T-2, at once: pinv + NaN/Inf guard
    # (GEKF.m:208-217); pm_safe keeps a non-finite P- out of the SVD
    ks = torch.arange(T - 1, device=dev).reshape((T - 1,) + (1,) * nb)
    A, _ = system.state_jacobians(u_t[:-1], S_PLUS[:-1], w_bar, params, ks)
    P_minus_next = P_MINUS[1:]
    bad = col(col(~torch.isfinite(P_minus_next).all(dim=-1).all(dim=-1)))
    PAt = P_PLUS[:-1] @ A.transpose(-1, -2)
    pm_safe = torch.where(bad, I_m, P_minus_next)
    if smoother_gain == "pinv":
        J_full = PAt @ _matlab_pinv(pm_safe)
    else:
        J_full = _mrdivide(PAt, pm_safe)
    J = torch.where(bad, 0.0, J_full)
    del A, PAt, pm_safe, J_full, bad, P_minus_next
    if not full:
        # the recursion reads no covariance: free the stacks now
        del st["P_minus"], st["P_plus"], P_MINUS, P_PLUS

    s_sm, P_sm = sT, PT
    S_SM, P_SM = [sT], [PT]
    for k in range(T - 2, -1, -1):
        s_sm = S_PLUS[k] + (J[k] @ col(s_sm - S_MINUS[k + 1]))[..., 0]
        s_sm = system.state_hard_margins(s_sm, params, k)
        S_SM.append(s_sm)
        if full:
            P_sm = sym(P_PLUS[k] - J[k] @ (P_MINUS[k + 1] - P_sm)
                       @ J[k].transpose(-1, -2))
            P_SM.append(P_sm)
    del J
    S_SMOOTH = torch.stack(S_SM[::-1])
    # the smoothed optimal input; its last row stays zero (the reference
    # smoother loop never writes the last sample, GEKF.m:204-230)
    u_sm, _ = system.nlin_state_update(u_t[:-1], S_SMOOTH[:-1], w_bar,
                                       params, ks)
    u_opt_smooth = torch.cat([u_sm, torch.zeros_like(u_t[:1])])

    back = lambda a: None if a is None else torch.movedim(a, 0, nb)
    return EKFResult(
        u_opt=back(st["u_opt"]), u_opt_smooth=back(u_opt_smooth),
        s_minus=back(S_MINUS), s_plus=back(S_PLUS), s_smooth=back(S_SMOOTH),
        P_minus=back(P_MINUS) if full else None,
        P_plus=back(P_PLUS) if full else None,
        P_smooth=back(torch.stack(P_SM[::-1])) if full else None,
        K_gain=back(st.get("K")), innovations=back(st.get("innov")),
        rho=back(st.get("rho")))


def batched_ekf_smoother(system, u, x, params, s_init, Ps_init,
                         s_final=None, Ps_final=None, w_bar=None, v_bar=None,
                         Q=1.0, R=1.0, **kw) -> EKFResult:
    """``ekf_smoother`` over one leading batch axis: u (B, T, p), x (B, T, n),
    s_init (B, m), Ps_init (B, m, m), Q / R and the params leaves with a
    leading B (epidemicmodeling_tpu/ops/ekf.py:365). The core batches
    natively, so this only checks that the batch axis is there."""
    if (s_init.dim() if isinstance(s_init, torch.Tensor)
            else np.ndim(s_init)) != 2:
        raise ValueError("batched_ekf_smoother: s_init must be (B, m)")
    return ekf_smoother(system, u, x, params, s_init, Ps_init, s_final,
                        Ps_final, w_bar, v_bar, Q, R, **kw)


def backward_ekf_smoother(system, u, x, params, s_init, Ps_init,
                          s_final=None, Ps_final=None, w_bar=None,
                          v_bar=None, Q=1.0, R=1.0, **kw) -> EKFResult:
    """Time-reversed EKF/EKS (Tools/SIAlphaModelBackwardEKF.m:18-40): flip
    the inputs and observations in time, swap the initial and final
    conditions, run the filter of a ``system`` whose dynamics are already
    time-reversed (models/backward.py), and flip the results back. Q and R
    pass through UNFLIPPED, as in the reference (BackwardEKF.m:27).
    s_final / Ps_final (the backward run's start) are required."""
    if s_final is None or Ps_final is None:
        raise ValueError("backward_ekf_smoother: s_final and Ps_final start "
                         "the backward run and must be given")
    like = next((a for a in (x, s_final, u)
                 if isinstance(a, torch.Tensor)), None)
    dev = resolve_device(kw.pop("device", None), like)
    s_final = as_device_tensor(s_final, dev)
    nb = s_final.dim() - 1
    x = as_device_tensor(x, dev)
    if x.dim() == nb + 1:
        x = x[..., None]
    flip = lambda a: None if a is None else torch.flip(a, dims=(nb,))
    res = ekf_smoother(system, flip(as_device_tensor(u, dev)), flip(x), params,
                       s_final, Ps_final, s_init, Ps_init, w_bar, v_bar, Q, R,
                       device=dev, **kw)
    return EKFResult(*(flip(f) for f in res))
