"""The plain reference of the XPRIZE train -> predict -> prescribe product.

Plain PyTorch tensor ops, on any device, in the dtype the caller gives
(float64 for the reference, float32 for the control). It imports nothing of
the program: the EKF/EKS core, the two SI-alpha systems, the non-negative
least squares and the stages are frozen copies of the port's plain
versions, written down again here so that a later change to the program
cannot move its yardstick:
- ``ekf_smoother``: ``epidemicmodeling_torch/ops/ekf_bl.py``
  (``ekf_smoother_bl`` without the innovation monitor, which no compared
  output reads, and with beta = 1, the pipelines' setting);
- ``system3`` / ``system6``: ``epidemicmodeling_torch/models/batch_last.py``
  (Tools/SIAlphaModelEKF.m, Tools/SIAlphaModelEKFOptControlled.m);
- ``nnls`` / ``nnls_with_intercept``: ``epidemicmodeling_torch/regression/
  nnls.py`` (MATLAB lsqnonneg, Tools/TrainPredictPrescribeNPI.m:263-278);
- ``train``, ``historic_states``, ``scenarios``, ``sweep``, ``monte_carlo``,
  ``front`` and ``backtest``: ``epidemicmodeling_torch/pipelines/core.py``
  and ``forecast_quality.py`` (Tools/TrainPredictPrescribeNPI.m,
  Tools/ForecastQualityAssessment.m).

``Arith`` carries the precision. Its ``rnd`` is applied to both operands of
every product inside a matrix or dot product: the identity for the
reference, and for the control the rounding of float32 to TF32 (10 mantissa
bits, to nearest even), which is what a float32 matrix product on the
card's tensor cores does to its operands when TF32 is on.

``cfg`` is the configuration file's ``pipeline`` group: PipelineConfig's
field names, read with PipelineConfig's defaults for the fields it leaves
out (``DEFAULTS``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

DEFAULTS = dict(
    smoothing_win=7, min_cases=1.0, first_num_days_for_case_estimation=7,
    model_gamma_param=7.0, num_days_for_beta_calculation=21.0,
    prob_contagion_after_Tdays=0.01, R0=2.5, dt=1.0, alpha_min=1e-8,
    alpha_max=100.0, sigma=1e6, nonneg_iterations=100, gamma_ekf=0.995,
    alpha_noise_std=1e-2, s_noise_factor=10.0, i_noise_factor=30.0,
    init_cov_factor=10.0, lambda0=0.0, q_lambda=1e-4)


def settings(cfg: dict) -> dict:
    """The pipeline group with defaults filled in, plus the derived rates
    (PipelineConfig.gamma_model, beta_model, alpha0)."""
    c = dict(DEFAULTS)
    c.update({k: v for k, v in cfg.items() if k in DEFAULTS})
    c["gamma_model"] = 1.0 / (c["dt"] * c["model_gamma_param"])
    days = c["num_days_for_beta_calculation"] * c["dt"]
    c["beta_model"] = -math.log(c["prob_contagion_after_Tdays"]) / days
    c["alpha0"] = c["beta_model"] + math.log(c["R0"]) / c["dt"]
    return c


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32: the 13 low mantissa bits cleared, to
    nearest even (NaN and infinity kept)."""
    b = x.contiguous().view(torch.int32)
    keep = ((b >> 13) & 1) + 0xFFF
    r = ((b + keep) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


class Arith(NamedTuple):
    dtype: torch.dtype
    tf32: bool = False

    def rnd(self, x):
        return tf32(x) if self.tf32 else x


REFERENCE = Arith(torch.float64)
CONTROL = Arith(torch.float32, tf32=True)


def lo_hi(x, lo, hi):
    """MATLAB max(lo, min(hi, x)): NaN maps to hi."""
    return torch.fmax(torch.as_tensor(lo, dtype=x.dtype, device=x.device),
                      torch.fmin(torch.as_tensor(hi, dtype=x.dtype,
                                                 device=x.device), x))


def hi_lo(x, lo, hi):
    """MATLAB min(hi, max(lo, x)): NaN maps to lo."""
    return torch.fmin(torch.as_tensor(hi, dtype=x.dtype, device=x.device),
                      torch.fmax(torch.as_tensor(lo, dtype=x.dtype,
                                                 device=x.device), x))


# ---- batch-last EKF/EKS (lane axis B last) --------------------------------

def _mm(ar, A, Bm, m):
    """C[i,k,b] = sum_j A[i,j,b] B[j,k,b]."""
    A, Bm = ar.rnd(A), ar.rnd(Bm)
    acc = A[:, 0, None, :] * Bm[None, 0, :, :]
    for j in range(1, m):
        acc = acc + A[:, j, None, :] * Bm[None, j, :, :]
    return acc


def _mmT(ar, A, Bm, m):
    """A @ B^T per lane."""
    A, Bm = ar.rnd(A), ar.rnd(Bm)
    acc = A[:, 0, None, :] * Bm[:, 0, :][None, :, :]
    for j in range(1, m):
        acc = acc + A[:, j, None, :] * Bm[:, j, :][None, :, :]
    return acc


def _mv(ar, A, x, m):
    A, x = ar.rnd(A), ar.rnd(x)
    acc = A[:, 0, :] * x[0][None, :]
    for j in range(1, m):
        acc = acc + A[:, j, :] * x[j][None, :]
    return acc


def _dot(ar, a, v):
    """Sum over the NPI axis 0 of a * v."""
    return torch.sum(ar.rnd(a) * ar.rnd(v), dim=0)


def _sym(P):
    return 0.5 * (P + P.transpose(0, 1))


def _chol(P, m, floor):
    L = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i + 1):
            s = P[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = (torch.sqrt(torch.clamp_min(s, floor)) if i == j
                       else s / L[j][j])
    zero = torch.zeros_like(P[0, 0])
    return torch.stack([torch.stack([L[i][j] if j <= i else zero
                                     for j in range(m)]) for i in range(m)])


def _chol_solve(L, Bmat, m):
    y = [None] * m
    for i in range(m):
        s = Bmat[i]
        for k in range(i):
            s = s - L[i, k] * y[k]
        y[i] = s / L[i, i]
    x = [None] * m
    for i in range(m - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, m):
            s = s - L[k, i] * x[k]
        x[i] = s / L[i, i]
    return torch.stack(x)


class System(NamedTuple):
    m: int
    update: object      # (u, s, p) -> (u_filled, s_next)
    jacobian: object    # (u, s, p) -> A (m, m, B)
    margins: object     # s -> s


def _obs(s):
    return s[0] * s[1] * s[2]


def _obs_row(s, m):
    zero = torch.zeros_like(s[0])
    return torch.stack([s[1] * s[2], s[0] * s[2], s[0] * s[1]]
                       + [zero] * (m - 3))


def system3(ar) -> System:
    """The 3-state SI-alpha system, NEWCASES observations."""
    def margins(s, p):
        return torch.stack([hi_lo(s[0], p["s_min"], 1.0),
                            hi_lo(s[1], p["i_min"], 1.0),
                            hi_lo(s[2], p["alpha_min"], p["alpha_max"])])

    def update(u, s, p):
        dt = p["dt"]
        s1 = lo_hi(s[0] - dt * s[2] * s[0] * s[1], p["s_min"], 1.0)
        i1 = lo_hi(s[1] + dt * (s[2] * s[0] * s[1] - p["beta"] * s[1]),
                   p["i_min"], 1.0)
        drive = (-p["gamma"] * s[2] + p["gamma"] * p["b"]
                 + p["gamma"] * _dot(ar, p["a"], p["u_max"] - u))
        a1 = lo_hi(s[2] + dt * drive, p["alpha_min"], p["alpha_max"])
        return u, torch.stack([s1, i1, a1])

    def jacobian(u, s, p):
        dt = p["dt"]
        one, zero = torch.ones_like(s[0]), torch.zeros_like(s[0])
        return torch.stack([
            torch.stack([one - dt * s[2] * s[1], -dt * s[2] * s[0],
                         -dt * s[0] * s[1]]),
            torch.stack([dt * s[1] * s[2], one + dt * (s[0] * s[2]
                                                       - p["beta"]),
                         dt * s[0] * s[1]]),
            torch.stack([zero, zero, one - dt * p["gamma"]])])

    return System(3, update, jacobian, margins)


def system6(ar) -> System:
    """SI-alpha plus three costates; NaN inputs are filled by the
    bang-bang law on the switching function eps*w - gamma*lambda3*a."""
    def margins(s, p):
        return torch.stack([hi_lo(s[0], 0.0, 1.0), hi_lo(s[1], 0.0, 1.0),
                            hi_lo(s[2], p["alpha_min"], p["alpha_max"]),
                            s[3], s[4], s[5]])

    def phi(s5, p):
        return p["epsilon"] * p["w"] - p["gamma"] * s5[None, :] * p["a"]

    def update(u, s, p):
        dt = p["dt"]
        cand = torch.where(phi(s[5], p) > 0, p["u_min"].expand(u.shape),
                           p["u_max"].expand(u.shape))
        uf = torch.where(torch.isnan(u), cand, u)
        rho = s[3] - s[4] - (1.0 - p["epsilon"])
        s1 = lo_hi(s[0] - dt * s[2] * s[0] * s[1], 0.0, 1.0)
        i1 = lo_hi(s[1] + dt * (s[2] * s[0] * s[1] - p["beta"] * s[1]),
                   0.0, 1.0)
        drive = (-p["gamma"] * s[2] + p["gamma"] * p["b"]
                 + p["gamma"] * _dot(ar, p["a"], p["u_max"] - uf))
        a1 = lo_hi(s[2] + dt * drive, p["alpha_min"], p["alpha_max"])
        l1 = s[3] + dt * rho * s[2] * s[1]
        l2 = s[4] + dt * (rho * s[2] * s[0] + p["beta"] * s[4])
        l3 = s[5] + dt * (rho * s[0] * s[1] + p["gamma"] * s[5])
        return uf, torch.stack([s1, i1, a1, l1, l2, l3])

    def jacobian(u, s, p):
        dt = p["dt"]
        one, zero = torch.ones_like(s[0]), torch.zeros_like(s[0])
        rho = s[3] - s[4] - (1.0 - p["epsilon"])
        f = phi(s[5], p)
        inv = 1.0 / p["sigma"]
        band = torch.isnan(u) & (f > -inv) & (f < inv)
        umax, umin = p["u_max"].expand(u.shape), p["u_min"].expand(u.shape)
        a = p["a"].expand(u.shape)
        a36 = -torch.sum(torch.where(
            band, p["gamma"] * dt * (p["sigma"] / 2.0) * a * (umax - umin),
            torch.zeros_like(a)), dim=0)
        return torch.stack([
            torch.stack([one - dt * s[2] * s[1], -dt * s[2] * s[0],
                         -dt * s[0] * s[1], zero, zero, zero]),
            torch.stack([dt * s[1] * s[2], one + dt * (s[0] * s[2]
                                                       - p["beta"]),
                         dt * s[0] * s[1], zero, zero, zero]),
            torch.stack([zero, zero, one - dt * p["gamma"], zero, zero,
                         a36]),
            torch.stack([zero, dt * s[2] * rho, dt * s[1] * rho,
                         one + dt * s[1] * s[2], -dt * s[1] * s[2], zero]),
            torch.stack([dt * s[2] * rho, zero, dt * s[0] * rho,
                         dt * s[0] * s[2],
                         one - dt * (s[0] * s[2] - p["beta"]), zero]),
            torch.stack([dt * s[1] * rho, dt * s[0] * rho, zero,
                         dt * s[0] * s[1], -dt * s[0] * s[1],
                         one + dt * p["gamma"]])])

    return System(6, update, jacobian, margins)


class Smoothed(NamedTuple):
    s_plus: torch.Tensor     # (T, m, B)
    s_smooth: torch.Tensor   # (T, m, B)
    u_smooth: torch.Tensor   # (T, p, B), the last row 0


def ekf_smoother(ar, sysm: System, u, x, p, s_init, Ps_init, Q, Rv, gamma,
                 s_final=None, Ps_final=None) -> Smoothed:
    """Order-1 EKF with the Joseph update and the gain discount ``gamma``,
    then the RTS smoother with a Cholesky gain (pivots floored at the
    dtype's tiny), terminal conditions NaN = unconstrained."""
    m = sysm.m
    T, B = x.shape
    eye = torch.eye(m, dtype=x.dtype, device=x.device)[:, :, None]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    s_minus, P_minus = s_init, Ps_init
    SM, PM, SP, PP = [], [], [], []
    for k in range(T):
        C = _obs_row(s_minus, m)
        x_pred = torch.clamp_min(_obs(s_minus), 0.0)
        valid = ~torch.isnan(x[k])
        innov = torch.where(valid, x[k] - x_pred, zero)
        PCt = _mv(ar, P_minus, C, m)
        S = torch.sum(ar.rnd(C) * ar.rnd(PCt), dim=0) + gamma * Rv[k]
        K = torch.where(valid[None, :], PCt / S[None, :], zero)
        IKC = eye - K[:, None, :] * C[None, :, :]
        P_upd = (_mmT(ar, _mm(ar, IKC, P_minus, m), IKC, m)
                 + (K[:, None, :] * K[None, :, :]) * Rv[k][None, None, :]
                 ) / gamma
        P_plus = _sym(torch.where(valid[None, None, :], P_upd, P_minus))
        s_plus = sysm.margins(torch.where(valid[None, :],
                                          s_minus + K * innov[None, :],
                                          s_minus), p)
        _, s_next = sysm.update(u[k], s_plus, p)
        A = sysm.jacobian(u[k], s_plus, p)
        P_next = _sym(_mmT(ar, _mm(ar, A, P_plus, m), A, m) + Q)
        SM.append(s_minus); PM.append(P_minus)
        SP.append(s_plus); PP.append(P_plus)
        s_minus, P_minus = sysm.margins(s_next, p), P_next
    if s_final is None:
        s_sm, P_sm = SP[-1], PP[-1]
    else:
        s_sm = torch.where(torch.isnan(s_final), SP[-1], s_final)
        P_sm = torch.where(torch.isnan(Ps_final), PP[-1], Ps_final)
    tiny = torch.finfo(x.dtype).tiny
    S_SM, U_SM = [None] * T, [None] * T
    S_SM[-1], U_SM[-1] = s_sm, torch.zeros_like(u[0])
    for k in range(T - 2, -1, -1):
        A = sysm.jacobian(u[k], SP[k], p)
        PAt = _mmT(ar, PP[k], A, m)
        L = _chol(PM[k + 1], m, tiny)
        J = _chol_solve(L, PAt.transpose(0, 1), m).transpose(0, 1)
        s_new = sysm.margins(SP[k] + _mv(ar, J, s_sm - SM[k + 1], m), p)
        P_sm = _sym(PP[k] - _mmT(ar, _mm(ar, J, PM[k + 1] - P_sm, m), J, m))
        s_sm = s_new
        S_SM[k] = s_sm
        U_SM[k], _ = sysm.update(u[k], s_sm, p)
    return Smoothed(torch.stack(SP), torch.stack(S_SM), torch.stack(U_SM))


# ---- non-negative least squares ---------------------------------------------

def _masked_ls(G, c, P):
    p = G.shape[-1]
    eye = torch.eye(p, dtype=G.dtype, device=G.device)
    A = torch.where(P[:, :, None] & P[:, None, :], G, eye)
    b = torch.where(P, c, torch.zeros_like(c))
    L, info = torch.linalg.cholesky_ex(A)
    z = torch.cholesky_solve(b[..., None], L)[..., 0]
    return torch.where((info == 0)[:, None], z,
                       torch.full_like(z, float("nan")))


def _matmul(ar, A, B):
    return ar.rnd(A) @ ar.rnd(B)


def nnls(ar, X, y):
    """Lawson-Hanson active set per problem of a batch: X (R, n, p),
    y (R, n) -> x (R, p) >= 0."""
    R, n, p = X.shape
    Xt = X.transpose(-1, -2)
    G = _matmul(ar, Xt, X)
    c = _matmul(ar, Xt, y[..., None])[..., 0]
    eps = torch.finfo(X.dtype).eps
    tol = 10.0 * eps * torch.amax(torch.sum(torch.abs(X), -2), -1) * max(n, p)
    inf = torch.tensor(float("inf"), dtype=X.dtype, device=X.device)
    zero = torch.zeros((), dtype=X.dtype, device=X.device)

    def inner_cond(P, z):
        return ((torch.amin(torch.where(P, z, inf), -1) <= 0.0)
                & P.any(-1))

    x = torch.zeros((R, p), dtype=X.dtype, device=X.device)
    P = torch.zeros((R, p), dtype=torch.bool, device=X.device)
    w = c
    active = torch.ones(R, dtype=torch.bool, device=X.device)
    lanes = torch.arange(R, device=X.device)
    for _ in range(3 * p):
        w_free = torch.where(P, -inf, w)
        active = active & (~P).any(-1) & (torch.amax(w_free, -1) > tol)
        if not bool(active.any()):
            break
        j = torch.argmax(w_free, -1)
        P_new = P.clone()
        P_new[lanes, j] = True
        P = torch.where(active[:, None], P_new, P)
        z = _masked_ls(G, c, P)
        inner = active & inner_cond(P, z)
        for _ in range(p + 1):
            if not bool(inner.any()):
                break
            mask = P & (z <= 0.0)
            alpha = torch.amin(torch.where(mask, x / (x - z), inf), -1,
                               keepdim=True)
            x_n = x + alpha * (z - x)
            P_n = P & (x_n > eps * 10)
            z_n = _masked_ls(G, c, P_n)
            x = torch.where(inner[:, None], x_n, x)
            P = torch.where(inner[:, None], P_n, P)
            z = torch.where(inner[:, None], z_n, z)
            inner = inner & inner_cond(P, z)
        x = torch.where(active[:, None], torch.where(P, z, zero), x)
        w = torch.where(active[:, None],
                        c - _matmul(ar, G, x[..., None])[..., 0], w)
    return x


def nnls_with_intercept(ar, X, y, iterations):
    """The alternating NNLS + intercept refinement of
    TrainPredictPrescribeNPI.m:263-278. Returns (a (R, p), b (R,))."""
    def resid(Xs, ys, a):
        return ys - _matmul(ar, Xs, a[..., None])[..., 0]

    a = nnls(ar, X, y)
    b = torch.zeros(X.shape[0], dtype=X.dtype, device=X.device)
    best = torch.sum(resid(X, y, a) ** 2, -1)
    active = torch.ones(X.shape[0], dtype=torch.bool, device=X.device)
    for _ in range(iterations):
        idx = torch.nonzero(active)[:, 0]
        if idx.numel() == 0:
            break
        Xs, ys, a_s = X[idx], y[idx], a[idx]
        a_cand = nnls(ar, Xs, ys - b[idx, None])
        r = resid(Xs, ys, a_s)
        b_cand = torch.mean(r, -1)
        err = torch.sum((r - b_cand[:, None]) ** 2, -1)
        better = err < best[idx]
        a[idx] = torch.where(better[:, None], a_cand, a_s)
        b[idx] = torch.where(better, b_cand, b[idx])
        best[idx] = torch.where(better, err, best[idx])
        active[idx] = better
    return a, b


# ---- the stages -----------------------------------------------------------

class Inputs(NamedTuple):
    """One input set on the device in the reference's dtype (region-major):
    obs, new_cases_norm, obs_noise_var (R, T), npis (R, T, P), population
    (R,), actual (R, T, P), and the NPI bounds and weights (P,)."""
    obs: torch.Tensor
    new_cases_norm: torch.Tensor
    obs_noise_var: torch.Tensor
    npis: torch.Tensor
    population: torch.Tensor
    actual: torch.Tensor
    u_min: torch.Tensor
    u_max: torch.Tensor
    w: torch.Tensor


def inputs(arrays: dict, mins, maxes, weights, ar: Arith, device) -> Inputs:
    t = lambda a: torch.as_tensor(a, dtype=ar.dtype, device=device)
    return Inputs(t(arrays["obs"]), t(arrays["new_cases_norm"]),
                  t(arrays["obs_noise_var"]), t(arrays["npis"]),
                  t(arrays["population"]), t(arrays["actual"]), t(mins),
                  t(maxes), t(weights))


def head(inp: Inputs, T: int) -> Inputs:
    """The first T days of every series."""
    return inp._replace(obs=inp.obs[:, :T],
                        new_cases_norm=inp.new_cases_norm[:, :T],
                        obs_noise_var=inp.obs_noise_var[:, :T],
                        npis=inp.npis[:, :T], actual=inp.actual[:, :T])


class Init(NamedTuple):
    s_init: torch.Tensor   # (R, 3)
    Ps_init: torch.Tensor  # (R, 3) diagonal
    Q: torch.Tensor        # (R, 3) diagonal
    s_std: torch.Tensor    # (R,)
    i_std: torch.Tensor


def region_init(inp: Inputs, c: dict) -> Init:
    """I0 = the mean of the first positive smoothed daily cases, at least
    min_cases; the noise levels and the initial state from it."""
    N = inp.population
    nc = inp.new_cases_norm * N[:, None]
    ok = torch.isfinite(nc) & (nc > 0)
    rank = torch.cumsum(ok.to(torch.int64), 1)
    take = ok & (rank <= c["first_num_days_for_case_estimation"])
    cnt = take.sum(1)
    mean = (torch.where(take, nc, torch.zeros_like(nc)).sum(1)
            / cnt.clamp_min(1))
    I0 = torch.clamp_min(torch.where(cnt > 0, mean, torch.zeros_like(mean)),
                         c["min_cases"])
    s_std = c["s_noise_factor"] * I0 / N
    i_std = c["i_noise_factor"] * I0 / N
    a_std = torch.full_like(I0, c["alpha_noise_std"])
    stds = torch.stack([s_std, i_std, a_std], -1)
    dt2 = c["dt"] ** 2
    return Init(torch.stack([(N - I0) / N, I0 / N,
                             torch.full_like(I0, c["alpha0"])], -1),
                dt2 * (c["init_cov_factor"] * stds) ** 2, dt2 * stds ** 2,
                s_std, i_std)


def params(inp: Inputs, c: dict, a=None, b=None) -> dict:
    """Region-major (R, ...) model parameters."""
    R, P = inp.obs.shape[0], inp.u_max.shape[0]
    z = torch.zeros(R, dtype=inp.obs.dtype, device=inp.obs.device)
    return {"dt": z + c["dt"], "beta": z + c["beta_model"],
            "gamma": z + c["gamma_model"],
            "a": torch.zeros((R, P), dtype=z.dtype, device=z.device)
            if a is None else a,
            "b": z if b is None else b,
            "u_min": inp.u_min.expand(R, P), "u_max": inp.u_max.expand(R, P),
            "s_min": c["min_cases"] / inp.population,
            "i_min": c["min_cases"] / inp.population,
            "alpha_min": z + c["alpha_min"], "alpha_max": z + c["alpha_max"]}


def _bl(a):
    """Region-major -> lanes last."""
    return torch.movedim(a, 0, -1)


def _diag(d):
    """(R, m) diagonals -> (m, m, R)."""
    return _bl(torch.diag_embed(d))


def ekf3(ar, c, u, obs, p, Rv, init: Init):
    """3-state EKS over the regions: u (R, T, P), obs, Rv (R, T). Returns
    (s_plus, s_smooth), each (R, T, 3)."""
    res = ekf_smoother(ar, system3(ar), _bl(u), obs.T, {k: _bl(v) for k, v
                                                         in p.items()},
                       init.s_init.T, _diag(init.Ps_init), _diag(init.Q),
                       Rv.T, c["gamma_ekf"])
    back = lambda s: torch.movedim(s, -1, 0)
    return back(res.s_plus), back(res.s_smooth)


class Trained(NamedTuple):
    a1: torch.Tensor
    b1: torch.Tensor
    a2: torch.Tensor
    b2: torch.Tensor


def regression_problem(ar, c, inp: Inputs, n_regression: int, a1=None,
                       b1=None):
    """One training round's regression: (x (R, n, P) = u_max - u, y (R, n)
    the smoothed alpha) over the last ``n_regression`` days of an EKS over
    the training window, round 1 (a1 None: zero NPIs, no influence) or
    round 2 (the historic NPIs with the influence a1, b1)."""
    init = region_init(inp, c)
    T = inp.obs.shape[1]
    u = torch.zeros_like(inp.npis) if a1 is None else inp.npis
    _, s = ekf3(ar, c, u, inp.obs, params(inp, c, a1, b1),
                inp.obs_noise_var, init)
    x = (inp.u_max[None, None, :] - inp.npis)[:, T - n_regression:]
    return x, s[:, T - n_regression:, 2]


def train(ar, c, inp: Inputs, n_regression: int) -> Trained:
    """Two EKS rounds over the training window, each followed by the
    NNLS-with-intercept regression of alpha on (u_max - u) over its last
    ``n_regression`` days."""
    x, y1 = regression_problem(ar, c, inp, n_regression)
    a1, b1 = nnls_with_intercept(ar, x, y1, c["nonneg_iterations"])
    x, y2 = regression_problem(ar, c, inp, n_regression, a1, b1)
    a2, b2 = nnls_with_intercept(ar, x, y2, c["nonneg_iterations"])
    return Trained(a1, b1, a2, b2)


def fitted_alpha(inp: Inputs, a, b, n_regression: int, T: int):
    """What a regression says: b + (u_max - u) . a over its window,
    (R, n)."""
    x = (inp.u_max[None, None, :] - inp.npis[:, :T])[:, T - n_regression:]
    return b[:, None] + torch.sum(x * a[:, None, :], -1)


def _step(ar, s, i, al, u_t, p, std=None):
    """One Euler step of the deterministic rollout: fields (...,), u_t and
    p["a"] / p["u_max"] (..., P)."""
    dt = p["dt"]
    s1 = lo_hi(s - dt * (al * s * i), 0.0, 1.0)
    i1 = lo_hi(i + dt * (al * s * i - p["beta"] * i), 0.0, 1.0)
    drive = (-p["gamma"] * al + p["gamma"] * p["b"]
             + p["gamma"] * torch.sum(ar.rnd(p["a"])
                                      * ar.rnd(p["u_max"] - u_t), -1))
    return s1, i1, lo_hi(al + dt * drive, p["alpha_min"], p["alpha_max"])


def historic_states(ar, c, inp: Inputs, a2, b2, T_hist: int):
    """The fixed-schedule scenario's EKS over the whole window; its first
    T_hist smoothed states are every rollout's history, (R, T_hist, 3)."""
    R, T, P = inp.npis.shape
    H = T - T_hist
    ip = inp.npis[:, :T_hist]
    u_fixed = torch.cat([ip[:, :-1], ip[:, -1:].expand(R, H + 1, P)], 1)
    init = region_init(head(inp, T_hist), c)
    _, ssm = ekf3(ar, c, u_fixed, inp.obs, params(inp, c, a2, b2),
                  inp.obs_noise_var, init)
    return ssm[:, :T_hist]


def _rollout(ar, p, s0, u_future):
    """(R, H, P) schedule from the (R, 3) state -> (R, H, 3)."""
    s, i, al = s0[:, 0], s0[:, 1], s0[:, 2]
    out = []
    for t in range(u_future.shape[1]):
        s, i, al = _step(ar, s, i, al, u_future[:, t], p)
        out.append(torch.stack([s, i, al], -1))
    return torch.stack(out, 1)


def scenarios(ar, c, inp: Inputs, a2, b2, s_hist, T_hist: int) -> dict:
    """(J0, J1) of the fixed, zero, max and actual schedules, each (R,)."""
    R, T, P = inp.npis.shape
    H = T - T_hist
    p = params(inp, c, a2, b2)
    w = inp.w[None, None, :]
    ip = inp.npis[:, :T_hist]
    hold = lambda lvl: torch.cat([ip[:, :-1], lvl.expand(R, H + 1, P)], 1)
    out = {}
    for name, u in (("fixed", hold(ip[:, -1:])),
                    ("zero", hold(inp.u_min[None, None, :])),
                    ("max", hold(inp.u_max[None, None, :]))):
        traj = _rollout(ar, p, s_hist[:, -1], u[:, T_hist:])
        st = torch.cat([s_hist, traj], 1)
        out[name] = (torch.mean(st[..., 0] * st[..., 1] * st[..., 2], -1),
                     torch.mean(w * u, (-2, -1)))
    init = region_init(head(inp, T_hist), c)
    _, ssm = ekf3(ar, c, inp.actual, inp.obs, p, inp.obs_noise_var, init)
    out["actual"] = (torch.mean(ssm[..., 0] * ssm[..., 1] * ssm[..., 2], -1),
                     torch.mean(w * inp.actual, (-2, -1)))
    return out


class Sweep(NamedTuple):
    u: torch.Tensor         # (E, R, H, P) prescribed schedules
    J0: torch.Tensor        # (E, R)
    J1: torch.Tensor
    costate_max: float      # the largest finite |smoothed costate|
    costate_nonfinite: float  # the share of smoothed costates not finite


def sweep(ar, c, inp: Inputs, a2, b2, s_hist, eps, T_hist: int) -> Sweep:
    """The 6-state optimal-control EKS for every (epsilon, region) lane,
    lane = e * R + r, the rollout of each prescription from the historic
    state, and its costs. J1 averages w * u over every row of the smoothed
    schedule: the history, the prescription and the zero last row."""
    R, T, P = inp.npis.shape
    E, H = eps.shape[0], T - T_hist
    dev, dt = inp.obs.device, ar.dtype
    init = region_init(head(inp, T_hist), c)
    q2 = c["dt"] ** 2 * c["q_lambda"] ** 2
    tile = lambda a: _bl(a)[..., None, :].expand(_bl(a).shape[:-1] + (E, R)
                                                 ).reshape(_bl(a).shape[:-1]
                                                           + (E * R,))
    p = {k: tile(v) for k, v in params(inp, c, a2, b2).items()}
    p["epsilon"] = eps[:, None].expand(E, R).reshape(E * R)
    p["w"] = tile(inp.w.expand(R, P))
    p["sigma"] = torch.full((E * R,), c["sigma"], dtype=dt, device=dev)
    Qd = torch.cat([init.Q, torch.full((R, 3), q2, dtype=dt, device=dev)], 1)
    Pd = torch.cat([init.Ps_init, torch.full((R, 3), 10.0 * q2, dtype=dt,
                                             device=dev)], 1)
    s0 = torch.cat([init.s_init, torch.full((R, 3), c["lambda0"], dtype=dt,
                                            device=dev)], 1)
    nan = float("nan")
    s_final = torch.tensor([nan] * 3 + [0.0] * 3, dtype=dt, device=dev)
    Pf = torch.zeros((6, 6), dtype=dt, device=dev)
    Pf[:3, :3] = nan
    Pf[3, 3] = Pf[4, 4] = Pf[5, 5] = 1e-8
    u_in = torch.cat([inp.npis[:, :T_hist],
                      torch.full((R, H, P), nan, dtype=dt, device=dev)], 1)
    res = ekf_smoother(
        ar, system6(ar), tile(u_in), tile(inp.obs), p, tile(s0),
        tile(torch.diag_embed(Pd)), tile(torch.diag_embed(Qd)),
        tile(inp.obs_noise_var), c["gamma_ekf"],
        s_final[:, None].expand(6, E * R),
        Pf[:, :, None].expand(6, 6, E * R))
    u_sm = res.u_smooth                                   # (T, P, E*R)
    lam = res.s_smooth[:, 3:].abs()
    fin = torch.isfinite(lam)
    costate_max = float(torch.where(fin, lam, torch.zeros_like(lam)).max())
    costate_nonfinite = float((~fin).double().mean())
    sv = tile(s_hist)[-1]                                 # (3, E*R)
    states = [tile(s_hist)]
    traj = []
    pt = {k: torch.movedim(v, -1, 0) for k, v in p.items()}
    s, i, al = sv[0], sv[1], sv[2]
    for t in range(H):
        s, i, al = _step(ar, s, i, al, u_sm[T_hist + t].T, pt)
        traj.append(torch.stack([s, i, al]))
    states.append(torch.stack(traj))
    full = torch.cat(states, 0)                           # (T, 3, E*R)
    J0 = torch.mean(full[:, 0] * full[:, 1] * full[:, 2], 0).reshape(E, R)
    J1 = torch.mean(p["w"][None] * u_sm, (0, 1)).reshape(E, R)
    u_out = u_sm[T_hist:].reshape(H, P, E, R).permute(2, 3, 0, 1)
    return Sweep(u_out, J0, J1, costate_max, costate_nonfinite)


def score(ar, c, inp: Inputs, a2, b2, s_hist, u_presc, T_hist: int):
    """(J0, J1), each (E, R), of given prescriptions u_presc (E, R, H, P):
    each rolled out from the historic state, its cases and its NPI burden
    averaged over the whole window, the history's NPIs first."""
    E, R, H, P = u_presc.shape
    p = params(inp, c, a2, b2)
    pb = {k: v[None].expand((E,) + v.shape) for k, v in p.items()}
    s, i, al = (s_hist[:, -1, k].expand(E, R) for k in range(3))
    cases = torch.zeros((E, R), dtype=ar.dtype, device=inp.obs.device)
    for t in range(H):
        s, i, al = _step(ar, s, i, al, u_presc[:, :, t], pb)
        cases = cases + s * i * al
    hist = torch.sum(s_hist[..., 0] * s_hist[..., 1] * s_hist[..., 2], -1)
    T = T_hist + H
    J0 = (hist[None] + cases) / T
    hist_w = torch.sum(inp.w * inp.npis[:, :T_hist], (1, 2))
    J1 = (hist_w[None] + torch.sum(inp.w * u_presc, (2, 3))) / (T * P)
    return J0, J1


def monte_carlo(ar, c, inp: Inputs, a2, b2, s_hist, u_random, T_hist: int):
    """(J0, J1), each (N, R), of the (N, H, P) schedules rolled out from the
    historic state and scored over the whole window."""
    R, T, P = inp.npis.shape
    N = u_random.shape[0]
    p = params(inp, c, a2, b2)
    pb = {k: v[None].expand((N,) + v.shape) for k, v in p.items()}
    s, i, al = (s_hist[:, -1, k].expand(N, R) for k in range(3))
    fut = torch.zeros((N, R), dtype=ar.dtype, device=inp.obs.device)
    for t in range(T - T_hist):
        s, i, al = _step(ar, s, i, al, u_random[:, t, None, :], pb)
        fut = fut + s * i * al
    hist = torch.sum(s_hist[..., 0] * s_hist[..., 1] * s_hist[..., 2], -1)
    J0 = (hist[None] + fut) / T
    hist_w = torch.sum(inp.w[None, None, :] * inp.npis[:, :T_hist], (1, 2))
    fut_w = torch.einsum("nhp,p->n", ar.rnd(u_random), ar.rnd(inp.w))
    J1 = (hist_w[None] + fut_w[:, None]) / (T * P)
    return J0, J1


def front(J0, J1):
    """(E, R) membership of each region's Pareto front: no other epsilon
    has both costs strictly smaller."""
    dom = (J0[None] < J0[:, None]) & (J1[None] < J1[:, None])
    return ~torch.any(dom, 1)


class Backtest(NamedTuple):
    err_plus: torch.Tensor     # (R, S, H) % error of the filtered estimate
    err_smooth: torch.Tensor   # (R, S, H) of the smoothed estimate
    mean_smooth: torch.Tensor  # (R, H)
    median_smooth: torch.Tensor


def backtest(ar, c, inp: Inputs, a2, b2, S: int, H: int) -> Backtest:
    """For each start s = 1..S, the EKS with the last s observations masked
    and the actual NPIs, and the percent error of its new cases at
    look-ahead h = 1..H; the mean and median over the starts with a full
    look-ahead window."""
    R, T = inp.obs.shape
    init = region_init(head(inp, T - S), c)
    p = params(inp, c, a2, b2)
    dev = inp.obs.device
    starts = torch.arange(1, S + 1, device=dev)
    masked = torch.arange(T, device=dev)[None, None] >= T - starts[None, :,
                                                                  None]
    x = torch.where(masked, torch.full_like(inp.obs[:, None], float("nan")),
                    inp.obs[:, None])                     # (R, S, T)
    rep = lambda a: torch.repeat_interleave(_bl(a), S, -1)
    res = ekf_smoother(
        ar, system3(ar), rep(inp.npis), x.reshape(R * S, T).T,
        {k: rep(v) for k, v in p.items()}, rep(init.s_init),
        rep(torch.diag_embed(init.Ps_init)), rep(torch.diag_embed(init.Q)),
        rep(inp.obs_noise_var), c["gamma_ekf"])
    back = lambda a: torch.movedim(a, -1, 0).reshape(R, S, T, 3)
    truth = inp.new_cases_norm * inp.population[:, None]
    days = T - starts[:, None] + torch.arange(H, device=dev)
    valid = days < T
    idx = days.clamp(0, T - 1).expand(R, S, H)

    def err(st):
        est = st[..., 0] * st[..., 1] * st[..., 2] * inp.population[:, None,
                                                                    None]
        e = 100.0 * torch.abs(truth[:, None] - est) / truth[:, None]
        return torch.where(valid, torch.gather(e, 2, idx),
                           torch.zeros((), dtype=e.dtype, device=dev))

    ep, es = err(back(res.s_plus)), err(back(res.s_smooth))
    e = es[:, H - 1:] if S >= H else es
    fin = torch.isfinite(e)
    n = fin.sum(1)
    tot = torch.where(fin, e, torch.zeros_like(e)).sum(1)
    mean = torch.where(n > 0, tot / n.clamp_min(1),
                       torch.full_like(tot, float("nan")))
    en = torch.where(fin, e, torch.full_like(e, float("nan")))
    srt = torch.sort(en, 1).values
    k = fin.sum(1, keepdim=True)
    lo = torch.gather(srt, 1, (k - 1).clamp_min(0) // 2)
    hi = torch.gather(srt, 1, (k // 2).clamp_max(e.shape[1] - 1))
    med = torch.where(k > 0, (lo + hi) / 2,
                      torch.full_like(lo, float("nan")))[:, 0]
    return Backtest(ep, es, mean, med)
