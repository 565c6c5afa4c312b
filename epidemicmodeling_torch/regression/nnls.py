"""Batched non-negative least squares and the reference's iterated
NNLS-with-intercept refinement.

Counterpart of epidemicmodeling_tpu/regression/nnls.py:86,158: the
Lawson-Hanson active set (MATLAB ``lsqnonneg``) over a batch of per-region
problems, and the intercept loop of Tools/TrainPredictPrescribeNPI.m:263-278.

Two routes, chosen by the inputs' device:

- CUDA tensors: one launch of the hand-written kernel
  (ops/cuda/nnls_kernel.py, csrc/nnls.cu) runs every problem's whole
  refinement on the card, a block a problem: no host sync and no launch
  per iteration. It takes float32 and float64 (computing in that dtype) and
  up to 32 columns, and raises on anything else; there is no fallback.
- Any other device: the plain version (``nnls_plain``,
  ``nnls_with_intercept_plain``), eager tensor code that the CPU tests hold
  against the JAX package. The JAX code nests ``lax.while_loop``s under
  ``vmap``: every lane iterates until all lanes are done, and a finished
  lane's state is frozen. Here the same loops run eagerly: ``while
  active.any()`` with finished lanes frozen by ``torch.where``, one host
  sync per iteration instead of a fixed trip count. The masked
  normal-equation solves are batched ``torch.linalg.cholesky_ex`` +
  ``cholesky_solve`` over (R, p, p). A singular passive set poisons its
  lane with NaN, never a clamped finite value (nnls.py:47-52). The kernel
  keeps the same caps, thresholds, stopping rules and NaN semantics.

Counters, in the recording in force (utils/profiling.py):

- plain version: each sync goes through utils.profiling.host_sync
  (``host_sync``), and the batched loop trips count as ``nnls.outer``,
  ``nnls.inner`` and ``nnls.intercept`` (a trip counts once however many
  lanes it runs);
- kernel: ``host_sync`` gets 0 (the route makes none), each launch counts
  as ``nnls.launches``, and the kernel's per-problem iteration counts are
  summed when the recording closes, never on the request's path, into
  ``nnls.lane_outer``, ``nnls.lane_inner`` and ``nnls.lane_intercept``
  (totals over the problems: a problem's counts equal a run of the plain
  version on that problem alone).
"""

from __future__ import annotations

import torch

from ..ops.cuda import nnls_kernel
from ..utils.profiling import count, count_on_close, host_sync

LANE_COUNTERS = ("nnls.lane_outer", "nnls.lane_inner", "nnls.lane_intercept")


def _masked_ls(G, c, P):
    """Least squares restricted to the passive set P (R, p) bool: solve
    G[P,P] z[P] = c[P], z[~P] = 0, as one full-size SPD system per lane with
    identity rows outside P. A lane whose system is not positive definite
    gets NaN."""
    p = G.shape[-1]
    eye = torch.eye(p, dtype=G.dtype, device=G.device)
    A = torch.where(P[:, :, None] & P[:, None, :], G, eye)
    b = torch.where(P, c, torch.zeros_like(c))
    L, info = torch.linalg.cholesky_ex(A)
    z = torch.cholesky_solve(b[..., None], L)[..., 0]
    return torch.where((info == 0)[:, None], z,
                       torch.full_like(z, float("nan")))


def _promoted(X, y):
    dtype = torch.promote_types(X.dtype, y.dtype)
    return X.to(dtype), y.to(dtype)


def _on_card(X, y, iterations: int):
    """The kernel's route: (a, b) of nnls_kernel.nnls_intercept, and its
    counters (see the module docstring)."""
    a, b, counts = nnls_kernel.nnls_intercept(*_promoted(X, y), iterations)
    count("host_sync", 0)
    count_on_close(LANE_COUNTERS, counts)
    return a, b


def nnls(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Solve min_x ||X x - y||^2 s.t. x >= 0 for every problem of a batch.

    X: (R, n, p) or (n, p); y: (R, n) or (n,). Returns x (R, p) or (p,).
    The tolerance is MATLAB lsqnonneg's, 10 * eps * ||X||_1 * max(n, p), and
    the outer loop runs at most 3p times. CPU tensors run ``nnls_plain``,
    others the kernel (the module docstring)."""
    if X.dim() == 2:
        return nnls(X[None], y[None])[0]
    if X.device.type == "cpu":
        return nnls_plain(X, y)
    return _on_card(X, y, 0)[0]


def nnls_plain(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``nnls`` as eager tensor ops on any device, X (R, n, p), y (R, n)."""
    X, y = _promoted(X, y)
    dtype = X.dtype
    R, n, p = X.shape
    Xt = X.transpose(-1, -2)
    G = Xt @ X
    c = (Xt @ y[..., None])[..., 0]
    eps = torch.finfo(dtype).eps
    norm1 = torch.amax(torch.sum(torch.abs(X), dim=-2), dim=-1)
    tol_v = 10.0 * eps * norm1 * max(n, p)
    neg_inf = torch.tensor(float("-inf"), dtype=dtype, device=X.device)
    inf = -neg_inf
    zero = torch.zeros((), dtype=dtype, device=X.device)

    def inner_cond(P, z):
        min_zP = torch.amin(torch.where(P, z, inf), dim=-1)
        return (min_zP <= 0.0) & P.any(dim=-1)

    x = torch.zeros((R, p), dtype=dtype, device=X.device)
    P = torch.zeros((R, p), dtype=torch.bool, device=X.device)
    w = c
    active = torch.ones(R, dtype=torch.bool, device=X.device)
    lanes = torch.arange(R, device=X.device)
    for _ in range(3 * p):
        w_free = torch.where(P, neg_inf, w)
        active = active & (~P).any(dim=-1) & (torch.amax(w_free, -1) > tol_v)
        if not host_sync(bool, active.any()):
            break
        count("nnls.outer")
        j = torch.argmax(w_free, dim=-1)
        P_new = P.clone()
        P_new[lanes, j] = True
        P = torch.where(active[:, None], P_new, P)
        z = _masked_ls(G, c, P)
        inner = active & inner_cond(P, z)
        for _ in range(p + 1):
            if not host_sync(bool, inner.any()):
                break
            count("nnls.inner")
            mask = P & (z <= 0.0)
            ratio = torch.where(mask, x / (x - z), inf)
            alpha = torch.amin(ratio, dim=-1, keepdim=True)
            x_n = x + alpha * (z - x)
            P_n = P & (x_n > eps * 10)
            z_n = _masked_ls(G, c, P_n)
            x = torch.where(inner[:, None], x_n, x)
            P = torch.where(inner[:, None], P_n, P)
            z = torch.where(inner[:, None], z_n, z)
            inner = inner & inner_cond(P, z)
        x = torch.where(active[:, None], torch.where(P, z, zero), x)
        w = torch.where(active[:, None], c - (G @ x[..., None])[..., 0], w)
    return x


def nnls_with_intercept(X: torch.Tensor, y: torch.Tensor,
                        iterations: int = 100):
    """The reference's alternating NNLS + intercept refinement
    (Tools/TrainPredictPrescribeNPI.m:263-278), per problem of a batch:

      a = nnls(X, y); b = 0; best = ||y - X a||^2
      repeat up to ``iterations`` times:
        a_cand = nnls(X, y - b)
        b_cand = mean(y - X a)           # uses the OLD a
        err    = ||y - X a - b_cand||^2  # uses the OLD a, new intercept
        if err < best: a, b, best = a_cand, b_cand, err
        else: break

    X: (R, n, p) or (n, p); y: (R, n) or (n,). Returns (a (R, p), b (R,))
    (unbatched: (p,), scalar). CPU tensors run
    ``nnls_with_intercept_plain``, others the kernel (the module
    docstring)."""
    if X.dim() == 2:
        a, b = nnls_with_intercept(X[None], y[None], iterations)
        return a[0], b[0]
    if X.device.type == "cpu":
        return nnls_with_intercept_plain(X, y, iterations)
    return _on_card(X, y, iterations)


def nnls_with_intercept_plain(X: torch.Tensor, y: torch.Tensor,
                              iterations: int = 100):
    """``nnls_with_intercept`` as eager tensor ops on any device, X
    (R, n, p), y (R, n)."""
    X, y = _promoted(X, y)
    dtype = X.dtype

    def resid(Xs, ys, a):
        return ys - (Xs @ a[..., None])[..., 0]

    a = nnls_plain(X, y)
    b = torch.zeros(X.shape[0], dtype=dtype, device=X.device)
    best = torch.sum(resid(X, y, a) ** 2, dim=-1)
    active = torch.ones(X.shape[0], dtype=torch.bool, device=X.device)
    for _ in range(iterations):
        idx = host_sync(torch.nonzero, active)[:, 0]
        if idx.numel() == 0:
            break
        count("nnls.intercept")
        Xs, ys, a_s = X[idx], y[idx], a[idx]
        a_cand = nnls_plain(Xs, ys - b[idx, None])
        r = resid(Xs, ys, a_s)
        b_cand = torch.mean(r, dim=-1)
        err = torch.sum((r - b_cand[:, None]) ** 2, dim=-1)
        improved = err < best[idx]
        a[idx] = torch.where(improved[:, None], a_cand, a_s)
        b[idx] = torch.where(improved, b_cand, b[idx])
        best[idx] = torch.where(improved, err, best[idx])
        active[idx] = improved
    return a, b
