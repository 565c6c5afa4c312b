"""The 6-state optimal-control EKF/EKS kernel (B2): CUDA C++ for Hopper.

Replaces the Pallas kernels behind ``ekf6_pallas``
(epidemicmodeling_tpu/ops/pallas/ekf6_kernel.py:446: ``_fwd_kernel`` :160,
``_bwd_kernel`` :286). Source: ``epidemicmodeling_torch/csrc/ekf6.cu``.

What bounds it on the card: every lane is a sequential chain of T dependent
steps (~2.2k operations forward, ~1.3k backward with IEEE divisions and
square roots), so latency sets the time unless the chain is spread. The
design gives each lane a team of six threads, one per row of the 6x6
matrices: a block holds LANES = 32 lanes in six warps,
warp r being row r of every lane, so row stores stay coalesced across lanes
in the lanes-last layout; the team exchanges rows through shared memory,
the backward factors each P- once per lane in a pipeline (thread r forms
row r of the factor M - r steps ahead), the forward keeps only the lower
triangles of P- and P+ for it, and each step's inputs are prefetched with
cp.async one step ahead. The
Pareto sweep feeds 25 x 235 = 5,875 lanes per chunk: 184 blocks of 192
threads on 132 SMs. No lane padding or time segments (the TPU kernel's
segments and VMEM stash exist only for the TPU's memory); forward and
backward are two launches on PyTorch's current stream.

``ekf6`` launches the kernel for CUDA tensors (contiguous, all float32 or
all float64: the dtype picks the kernels' float or double instance,
``build.instance``; the MATLAB reference computes in double) and raises on
anything it cannot take. For CPU tensors it runs ``ekf6_plain``, the same
computation on the port's batch-last core, in the inputs' dtype. The
recording in force (utils/profiling.py) counts the kernel's launches (one
a forward and backward pair) as ``ekf6.launches`` and their lanes as
``ekf6.lanes``.
"""

from __future__ import annotations

import ctypes

import torch

from ..ekf_bl import ekf_smoother_bl
from ...utils.profiling import count
from ...models.batch_last import si_alpha_costate_ekf_system_bl
from . import build as _build
from .ekf3_kernel import check_options

M = 6
NPI = 12
NSCAL = 14
# the kernel's team layout (csrc/ekf6.cu: LANES, BLOCK)
LANES = 32
BLOCK = M * LANES

_P, _I = ctypes.c_void_p, ctypes.c_int
_F, _D = ctypes.c_float, ctypes.c_double
_SIGNATURES = {
    "ekf6_forward": [_P] * 11 + [_I, _I, _F, _I, _F, _F, _I, _P],
    "ekf6_forward_f64": [_P] * 11 + [_I, _I, _D, _I, _D, _D, _I, _P],
    "ekf6_backward": [_P] * 11 + [_I, _I, _P],
    "ekf6_backward_f64": [_P] * 11 + [_I, _I, _P],
}


def ekf6_plain(u, x, Rv, scal, vecs, s_init, Ps_init, s_final, Ps_final,
               gamma_discount=0.995, obs_type="NEWCASES", beta=1.0,
               inv_monitor_len=21):
    """The kernel's plain PyTorch version: the same packed interface, run on
    ops/ekf_bl.ekf_smoother_bl in the inputs' dtype on any device.
    Returns (S_SMOOTH (T, 6, B), U_OPT_SMOOTH (T, 12, B), S_PLUS (T, 6, B))."""
    check_options(obs_type, beta, inv_monitor_len)
    B = scal.shape[-1]
    params = {"dt": scal[0], "beta": scal[1], "gamma": scal[2],
              "b": scal[3], "epsilon": scal[4], "sigma": scal[5],
              "alpha_min": scal[6], "alpha_max": scal[7],
              "a": vecs[0], "u_min": vecs[1], "u_max": vecs[2], "w": vecs[3]}
    Q = torch.zeros((M, M, B), dtype=scal.dtype, device=scal.device)
    for i in range(M):
        Q[i, i] = scal[8 + i]
    res = ekf_smoother_bl(
        si_alpha_costate_ekf_system_bl(obs_type), u, x, params, s_init,
        Ps_init.reshape(M, M, B), s_final, Ps_final.reshape(M, M, B),
        Q=Q, R=Rv, gamma_discount=gamma_discount,
        inv_monitor_len=inv_monitor_len if beta != 1.0 else 0, beta=beta)
    return res.s_smooth, res.u_opt_smooth, res.s_plus


def ekf6(u, x, Rv, scal, vecs, s_init, Ps_init, s_final, Ps_final,
         gamma_discount=0.995, obs_type="NEWCASES", beta=1.0,
         inv_monitor_len=21):
    """Forward EKF + RTS smoother for the 6-state costate system.

    u: (T, 12, B), NaN = optimize by the bang-bang law; x, Rv: (T, B);
    scal: (14, B) rows [dt, beta, gamma, b, epsilon, sigma, alpha_min,
    alpha_max, q(6)]; vecs: (4, 12, B) planes [a, u_min, u_max, w];
    s_init: (6, B); Ps_init: (36, B) row-major; s_final: (6, B) and
    Ps_final: (36, B), NaN = unconstrained. Any B. beta != 1 adapts the
    fixed prior Rv[0] (GEKF.m:180-185).
    Returns (S_SMOOTH (T, 6, B), U_OPT_SMOOTH (T, 12, B), S_PLUS (T, 6, B)).
    """
    if u.device.type == "cpu":
        return ekf6_plain(u, x, Rv, scal, vecs, s_init, Ps_init, s_final,
                          Ps_final, gamma_discount, obs_type, beta,
                          inv_monitor_len)
    check_options(obs_type, beta, inv_monitor_len)
    T, _, B = u.shape
    args = dict(u=u, x=x, Rv=Rv, scal=scal, vecs=vecs, s_init=s_init,
                Ps_init=Ps_init, s_final=s_final, Ps_final=Ps_final)
    dev = _build.check_args(args, shapes=dict(
        u=(T, NPI, B), x=(T, B), Rv=(T, B), scal=(NSCAL, B),
        vecs=(4, NPI, B), s_init=(M, B), Ps_init=(M * M, B),
        s_final=(M, B), Ps_final=(M * M, B)))
    out = dict(dtype=u.dtype, device=dev)
    S_MINUS = torch.empty((T, M, B), **out)
    S_PLUS = torch.empty((T, M, B), **out)
    # the lower triangles of the symmetric covariances, row by row
    P_MINUS = torch.empty((T, M * (M + 1) // 2, B), **out)
    P_PLUS = torch.empty((T, M * (M + 1) // 2, B), **out)
    S_SMOOTH = torch.empty((T, M, B), **out)
    U_SM = torch.empty((T, NPI, B), **out)
    # the pair counts as one launch
    _build.launch(
        "ekf6", _SIGNATURES, _build.instance("ekf6_forward", u.dtype), dev,
        u.data_ptr(), x.data_ptr(), Rv.data_ptr(), scal.data_ptr(),
        vecs.data_ptr(), s_init.data_ptr(), Ps_init.data_ptr(),
        S_MINUS.data_ptr(), S_PLUS.data_ptr(), P_MINUS.data_ptr(),
        P_PLUS.data_ptr(), T, B, float(gamma_discount),
        int(obs_type == "TOTALCASES"), float(beta), float(1.0 - beta),
        int(inv_monitor_len), n=0)
    _build.launch(
        "ekf6", _SIGNATURES, _build.instance("ekf6_backward", u.dtype), dev,
        u.data_ptr(), S_PLUS.data_ptr(), S_MINUS.data_ptr(),
        P_PLUS.data_ptr(), P_MINUS.data_ptr(), scal.data_ptr(),
        vecs.data_ptr(), s_final.data_ptr(), Ps_final.data_ptr(),
        S_SMOOTH.data_ptr(), U_SM.data_ptr(), T, B)
    count("ekf6.lanes", B)
    return S_SMOOTH, U_SM, S_PLUS


def pack_params_for_kernel(params_bl, Q_bl, dtype=torch.float32):
    """(scal (14, B), vecs (4, 12, B)) from a batch-last 6-state params dict
    and the (6, 6, B) process covariance (its diagonal)."""
    B = params_bl["a"].shape[-1]
    dev = params_bl["a"].device

    def bc(v, shape):
        return torch.as_tensor(v, dtype=dtype, device=dev).expand(shape)

    scal = torch.stack(
        [bc(params_bl[k], (B,)) for k in
         ("dt", "beta", "gamma", "b", "epsilon", "sigma", "alpha_min",
          "alpha_max")]
        + [Q_bl[i, i].to(dtype) for i in range(M)])
    vecs = torch.stack([bc(params_bl[k], (NPI, B))
                        for k in ("a", "u_min", "u_max", "w")])
    return scal, vecs


def pack_ekf6_args(lanes: dict, dtype=torch.float32):
    """The argument tuple of ``ekf6`` / ``ekf6_plain`` (u, x, Rv, scal,
    vecs, s_init, Ps_init, s_final, Ps_final), contiguous in ``dtype``, from
    the batch-last sweep inputs of pipelines.core.sweep_lane_inputs."""
    B = lanes["x"].shape[-1]
    scal, vecs = pack_params_for_kernel(lanes["params"], lanes["Q"], dtype)
    k = lambda a: a.to(dtype).contiguous()
    return (k(lanes["u"]), k(lanes["x"]), k(lanes["Rv"]), scal, vecs,
            k(lanes["s_init"]), k(lanes["Ps_init"].reshape(M * M, B)),
            k(lanes["s_final"]), k(lanes["Ps_final"].reshape(M * M, B)))
