"""The plain PyTorch version of the native Pareto sweep
(deploy/native.newcase_ekf_pareto_sweep_native), float64 on any device.

It composes what the port already has: the pre-generic 6-state EKF/EKS
(pipelines/prescribe.new_case_ekf_optimal_npi) batched over a leading
epsilon dimension, one lane an epsilon; the noise-free re-simulation of
the horizon from the historic endpoint (models/si_alpha's Euler step with
zero noise, the initial condition dropped); and control/npi_cost. The
tests hold the builds of the native artefact against it, and so does
chip_smoke.py on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..control import npi_cost
from ..models.si_alpha import si_alpha_step_fields
from ..pipelines.prescribe import new_case_ekf_optimal_npi
from ..utils.device import resolve_device

_SCALARS = ("dt", "beta", "gamma", "b", "sigma", "alpha_min", "alpha_max")
_VECTORS = ("a", "u_min", "u_max", "w")


def pareto_sweep_plain(u, x, T_hist, params, eps_values, s_init, Ps_init,
                       s_final, Ps_final, Q, R_v, sia_hist, beta_ekf=1.0,
                       gamma_ekf=0.995, inv_monitor_len=21, device=None):
    """The arguments of newcase_ekf_pareto_sweep_native (params["epsilon"]
    is ignored). Runs on ``device``, else on the CUDA card. Returns float64
    tensors on that device: U_OPT_SMOOTH, S_PLUS and S_SMOOTH (E, T, .)
    and, unless sia_hist is None, J0 and J1 (E,).

    J0 averages the new cases s i alpha over all T days, the history's
    (sia_hist) and the horizon's re-simulation; J1 averages w * u over all
    T x P entries (Tools/NPICost.m:5-10)."""
    dev = resolve_device(device)
    f = lambda v: torch.as_tensor(np.asarray(v, float), dtype=torch.float64,
                                  device=dev)
    eps = f(eps_values).reshape(-1)
    E = eps.shape[0]
    u = f(u)
    T, P = u.shape
    lanes = lambda v: v.expand(E, *v.shape).contiguous()
    par = {k: f(params[k]).reshape(()).expand(E).contiguous()
           for k in _SCALARS}
    par.update({k: lanes(f(params[k]).reshape(P)) for k in _VECTORS})
    par["epsilon"] = eps
    res = new_case_ekf_optimal_npi(
        lanes(u), lanes(f(x).reshape(T)), par, lanes(f(s_init).reshape(6)),
        lanes(f(Ps_init).reshape(6, 6)), lanes(f(s_final).reshape(6)),
        lanes(f(Ps_final).reshape(6, 6)),
        Q=lanes(f(Q).reshape(6, 6)),
        R=lanes(f(R_v).reshape(-1).expand(T)), beta=beta_ekf,
        gamma=gamma_ekf, inv_monitor_len=inv_monitor_len, device=dev)
    U = res.u_opt_smooth
    out = {"U_OPT_SMOOTH": U, "S_PLUS": res.s_plus, "S_SMOOTH": res.s_smooth}
    if sia_hist is None:
        return out

    sia = f(sia_hist).reshape(int(T_hist), 3)
    model = {k: par[k][0] for k in _SCALARS + _VECTORS}
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    model.update(s_noise_std=zero, i_noise_std=zero, alpha_noise_std=zero)
    sc, ic, al = (sia[-1, j].expand(E) for j in range(3))
    cases = [(sia[:, 0] * sia[:, 1] * sia[:, 2]).expand(E, -1)]
    for t in range(int(T_hist), T):
        sc, ic, al = si_alpha_step_fields(sc, ic, al, U[:, t], zero, zero,
                                          zero, model)
        cases.append((sc * ic * al)[:, None])
    out["J0"], out["J1"] = npi_cost(torch.cat(cases, dim=-1), U,
                                    par["w"][0])
    return out
