"""The 6-state optimal-control EKF/EKS kernel (B2): CUDA C++ for Hopper.

Replaces the Pallas kernels behind ``ekf6_pallas``
(epidemicmodeling_tpu/ops/pallas/ekf6_kernel.py:446: ``_fwd_kernel`` :160,
``_bwd_kernel`` :286). Source: ``epidemicmodeling_torch/csrc/ekf6.cu``.

What bounds it on the card: every lane is a sequential chain of T dependent
steps (~1.5k flops forward, ~3k backward with IEEE divisions and square
roots), so per-thread latency sets the time. ptxas gives the forward 254
registers and the backward 167, with no spills; at 254 registers two
128-thread blocks fit on an SM. The Pareto sweep feeds 25 x 235 = 5,875
lanes per chunk: 46 blocks of 128 threads on 132 SMs. The design runs one thread
per lane with the time loop inside the thread, (s, P) in registers,
coalesced lanes-last loads, and no lane padding or time segments (the TPU
kernel's segments and VMEM stash exist only for the TPU's memory); forward
and backward are two launches on PyTorch's current stream.

``ekf6`` launches the kernel for CUDA tensors (float32, contiguous) and
raises on anything it cannot take. For CPU tensors it runs ``ekf6_plain``,
the same computation on the port's batch-last core, in the inputs' dtype.
``launches`` counts the kernel launches (one per forward+backward pair).
"""

from __future__ import annotations

import ctypes

import torch

from ..ekf_bl import ekf_smoother_bl
from ...models.batch_last import si_alpha_costate_ekf_system_bl
from . import build as _build
from .ekf3_kernel import check_options, check_kernel_args

M = 6
NPI = 12
NSCAL = 14

launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ekf6_forward": [_P] * 11 + [_I, _I, _F, _I, _F, _F, _I, _P],
    "ekf6_backward": [_P] * 11 + [_I, _I, _P],
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
    dev = check_kernel_args(args, dict(
        u=(T, NPI, B), x=(T, B), Rv=(T, B), scal=(NSCAL, B),
        vecs=(4, NPI, B), s_init=(M, B), Ps_init=(M * M, B),
        s_final=(M, B), Ps_final=(M * M, B)))
    lib = _build.load("ekf6", _SIGNATURES)
    out = dict(dtype=torch.float32, device=dev)
    S_MINUS = torch.empty((T, M, B), **out)
    S_PLUS = torch.empty((T, M, B), **out)
    P_MINUS = torch.empty((T, M * M, B), **out)
    P_PLUS = torch.empty((T, M * M, B), **out)
    S_SMOOTH = torch.empty((T, M, B), **out)
    U_SM = torch.empty((T, NPI, B), **out)
    global launches
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.ekf6_forward(
            u.data_ptr(), x.data_ptr(), Rv.data_ptr(), scal.data_ptr(),
            vecs.data_ptr(), s_init.data_ptr(), Ps_init.data_ptr(),
            S_MINUS.data_ptr(), S_PLUS.data_ptr(), P_MINUS.data_ptr(),
            P_PLUS.data_ptr(), T, B, float(gamma_discount),
            int(obs_type == "TOTALCASES"), float(beta), float(1.0 - beta),
            int(inv_monitor_len), stream)
        _build.check(lib, "ekf6", "ekf6_forward", code)
        code = lib.ekf6_backward(
            u.data_ptr(), S_PLUS.data_ptr(), S_MINUS.data_ptr(),
            P_PLUS.data_ptr(), P_MINUS.data_ptr(), scal.data_ptr(),
            vecs.data_ptr(), s_final.data_ptr(), Ps_final.data_ptr(),
            S_SMOOTH.data_ptr(), U_SM.data_ptr(), T, B, stream)
        _build.check(lib, "ekf6", "ekf6_backward", code)
    launches += 1
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
