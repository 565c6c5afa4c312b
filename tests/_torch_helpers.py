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
