"""Shared inputs and error measures of the PyTorch port's kernel tests (and
of chip_smoke.py's kernel phase). Imports no JAX."""

import numpy as np
import torch

from epidemicmodeling_torch.ops.cuda.ekf3_kernel import \
    pack_params3_for_kernel
from epidemicmodeling_torch.ops.cuda.ekf6_kernel import \
    pack_params_for_kernel

U_MAX = np.array([3, 3, 2, 4, 2, 3, 2, 4, 2, 3, 2, 4], float)


def make_inputs(m, B, T, T_hist, seed, obs_type="NEWCASES", dtype=np.float64):
    """NumPy inputs of the m-state system, lanes last (the recipe of
    tests/test_ekf6_kernel.py:build): per-capita observations with a NaN
    tail from T_hist and an interior NaN hole; the 6-state inputs are NaN
    (optimized) from T_hist on."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 3, (T, 12, B)).astype(float)
    if obs_type == "NEWCASES":
        x = np.abs(rng.normal(1e-4, 2e-5, (T, B)))
    else:
        x = np.cumsum(np.abs(rng.normal(1e-4, 2e-5, (T, B))), axis=0)
    x[T_hist:] = np.nan
    x[T_hist // 3:T_hist // 3 + 5] = np.nan
    Rv = np.full((T, B), 4e-10)
    params = {
        "dt": np.full(B, 1.0), "beta": np.full(B, 0.2),
        "gamma": np.full(B, 1 / 7), "b": np.full(B, 0.05),
        "epsilon": rng.random(B), "sigma": np.full(B, 1e6),
        "alpha_min": np.full(B, 1e-8), "alpha_max": np.full(B, 100.0),
        "s_min": np.full(B, 1e-6), "i_min": np.full(B, 1e-6),
        "a": 0.004 * rng.random((12, B)), "u_min": np.zeros((12, B)),
        "u_max": np.broadcast_to(U_MAX[:, None], (12, B)).copy(),
        "w": np.ones((12, B)),
    }
    if m == 6:
        u[T_hist:] = np.nan
        s0 = [0.999, 1e-4, 0.3, 0, 0, 0]
        p0 = [1e-4, 1e-6, 0.1, 1e-7, 1e-7, 1e-7]
        q0 = [1e-8, 1e-8, 1e-4, 1e-8, 1e-8, 1e-8]
        sf = np.tile(np.array([np.nan] * 3 + [0.0] * 3)[:, None], (1, B))
        Pf = np.full((6, 6), np.nan)
        Pf[3, 3] = Pf[4, 4] = Pf[5, 5] = 1e-8
    else:
        s0, p0, q0 = [0.999, 1e-4, 0.3], [1e-4, 1e-6, 0.1], [1e-8, 1e-8, 1e-4]
        sf = np.full((3, B), np.nan)
        Pf = np.full((3, 3), np.nan)
    tile = lambda a: np.tile(np.asarray(a, float)[..., None],
                             (1,) * np.ndim(a) + (B,))
    out = dict(u=u, x=x, Rv=Rv, params=params, s_init=tile(s0),
               Ps_init=tile(np.diag(p0)), Q=tile(np.diag(q0)), s_final=sf,
               Ps_final=tile(Pf))
    cast = lambda v: (np.asarray(v, dtype) if not isinstance(v, dict)
                      else {k: np.asarray(a, dtype) for k, a in v.items()})
    return {k: cast(v) for k, v in out.items()}


def packed_args(m, d, device):
    """The kernel's packed argument tuple on ``device`` from make_inputs."""
    t = {k: ({kk: torch.tensor(vv, device=device) for kk, vv in v.items()}
             if isinstance(v, dict) else torch.tensor(v, device=device))
         for k, v in d.items()}
    B = d["x"].shape[1]
    pack = pack_params3_for_kernel if m == 3 else pack_params_for_kernel
    scal, vecs = pack(t["params"], t["Q"])
    return (t["u"], t["x"], t["Rv"], scal, vecs, t["s_init"],
            t["Ps_init"].reshape(m * m, B), t["s_final"],
            t["Ps_final"].reshape(m * m, B))


def scaled_err(a, b) -> float:
    """max |a - b| / (|b| + 1) over tensors or arrays, in float64."""
    t = lambda v: (v.double() if isinstance(v, torch.Tensor)
                   else torch.from_numpy(np.array(v, np.float64)))
    a, b = t(a), t(b)
    b = b.to(a.device)
    return float((torch.abs(a - b) / (torch.abs(b) + 1.0)).max())


def masked_err(a, b):
    """(scaled error over the cells finite in both, fraction of cells finite
    in one only). In float32 the costates of an unstable lane can overflow;
    the plain version overflows there too."""
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    both = fa & fb
    err = scaled_err(a[both], b[both]) if bool(both.any()) else 0.0
    return err, float((fa != fb).double().mean())


def deploy_inputs(T=120, T_hist=90, seed=0, epsilon=0.3):
    """The native deployment artefact's inputs by the recipe of
    tests/test_deploy.py:build_case, rebuilt with NumPy from the same draws:
    (u, obs, params, s_init, Ps_init, s_final, Ps_final, Q, R_v), params a
    dict of floats and (P,) arrays (the SIAlphaParams fields)."""
    rng = np.random.default_rng(seed)
    P = 12
    obs = np.abs(rng.normal(1e-4, 2e-5, T))
    obs[T_hist:] = np.nan
    u = rng.integers(0, 3, (T, P)).astype(float)
    u[T_hist:] = np.nan
    params = dict(dt=1.0, beta=0.2, gamma=1 / 7, a=0.004 * rng.random(P),
                  b=0.05, u_min=np.zeros(P), u_max=U_MAX.copy(), s_min=1e-6,
                  i_min=1e-6, alpha_min=1e-8, alpha_max=100.0,
                  epsilon=epsilon, w=np.ones(P), sigma=1e6)
    s_init = np.array([0.999, 1e-4, 0.3, 0, 0, 0.0])
    Ps_init = np.diag([1e-4, 1e-6, 0.1, 1e-7, 1e-7, 1e-7])
    s_final = np.array([np.nan, np.nan, np.nan, 0, 0, 0.0])
    Ps_final = np.full((6, 6), np.nan)
    Ps_final[3, 3] = Ps_final[4, 4] = Ps_final[5, 5] = 1e-8
    Q = np.diag([1e-8, 1e-8, 1e-4, 1e-8, 1e-8, 1e-8])
    R_v = np.full(T, 4e-10)
    return u, obs, params, s_init, Ps_init, s_final, Ps_final, Q, R_v


def deploy_history(u, params, s0, T_hist):
    """The historic (s, i, alpha) trajectory, (T_hist, 3): the noise-free
    controlled SI-alpha roll of tests/test_deploy.py:114-122 from s0[:3]
    under the historic inputs u[:T_hist], with params' dt, rates and
    alpha bounds (the initial condition dropped)."""
    p = {k: np.asarray(v, float) for k, v in params.items()}
    dt, beta, gamma, b = (float(p[k]) for k in ("dt", "beta", "gamma", "b"))
    lo, hi = float(p["alpha_min"]), float(p["alpha_max"])
    sc, ic, al = (float(v) for v in np.asarray(s0, float)[:3])
    hist = []
    for t in range(T_hist):
        drive = float(p["a"] @ (p["u_max"] - u[t]))
        sc, ic, al = (
            min(1.0, max(0.0, sc - dt * al * sc * ic)),
            min(1.0, max(0.0, ic + dt * (al * sc * ic - beta * ic))),
            min(hi, max(lo, al + dt * (-gamma * al + gamma * b
                                       + gamma * drive))))
        hist.append((sc, ic, al))
    return np.array(hist)


def deploy_sweep_args(eps, seed=0, T_hist=90, T=120):
    """The native sweep's positional arguments on deploy_inputs (u, x,
    T_hist, params, eps, s_init, Ps_init, s_final, Ps_final, Q, R_v,
    sia_hist): T days, the prescribed window from T_hist, the history by
    deploy_history."""
    u, obs, params, s_init, Ps_init, s_final, Ps_final, Q, R_v = \
        deploy_inputs(T=T, T_hist=T_hist, seed=seed)
    sia = deploy_history(u, params, s_init, T_hist)
    return (u, obs, T_hist, params, eps, s_init, Ps_init, s_final, Ps_final,
            Q, R_v, sia)


def nnls_problems(seed, R=24, n=40, p=12):
    """R float64 NNLS problems (X (R, n, p), y (R, n)) in three families:
    NPI-gap designs (integer levels) against a smoothed-alpha-like target,
    gaussian designs against a signed truth plus noise, and correlated
    designs (gaussian mixed by I + 0.8 M) against a signed truth, whose
    active sets also take the inner loop."""
    rng = np.random.default_rng(seed)
    X, y, q = np.empty((R, n, p)), np.empty((R, n)), R // 3
    X[:q] = rng.integers(0, 5, (q, n, p)).astype(float)
    y[:q] = 0.2 + 0.01 * rng.standard_normal((q, n)) \
        - X[:q] @ (0.004 * rng.random(p))
    X[q:2 * q] = rng.standard_normal((q, n, p))
    Z = rng.standard_normal((R - 2 * q, n, p))
    M = np.eye(p) + 0.8 * rng.standard_normal((R - 2 * q, p, p))
    X[2 * q:] = np.einsum("rnq,rqp->rnp", Z, M)
    truth = rng.standard_normal((R - q, p))
    y[q:] = np.einsum("rnp,rp->rn", X[q:], truth) \
        + 0.1 * rng.standard_normal((R - q, n))
    return torch.from_numpy(X), torch.from_numpy(y)
