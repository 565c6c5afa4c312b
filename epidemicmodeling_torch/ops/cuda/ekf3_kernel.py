"""The 3-state SI-alpha EKF/EKS kernel (B1): CUDA C++ for Hopper.

Replaces the Pallas kernels behind ``ekf3_pallas``
(epidemicmodeling_tpu/ops/pallas/ekf3_kernel.py:306: ``_fwd3_kernel`` :92,
``_bwd3_kernel`` :198). Source: ``epidemicmodeling_torch/csrc/ekf3.cu``.

What bounds it on the card: every lane (filter) is a sequential chain of T
dependent forward steps, so the chain's latency sets the time, not bandwidth
or flops. One launch runs forward and backward: each lane's step inputs are
prefetched a chunk ahead into shared memory (cp.async), the per-lane
constants sit in registers, the forward keeps each step's record in shared
memory (or, when the lanes' histories do not fit, in a device-memory
scratch), all threads of a block then form every smoother gain J(t) in
parallel (J does not depend on the smoothed states), and the backward
recursion left on the chain is a few operations a step. ``ekf3_geometry``
restates the kernel's choice of lanes a block.

``ekf3`` launches the kernel for CUDA tensors (contiguous, all float32 or
all float64: the dtype picks the kernel's float or double instance,
``build.instance``) and raises on anything it cannot take. For CPU tensors
it runs ``ekf3_plain``, the same computation on the port's batch-last core,
in the inputs' dtype. The recording in force (utils/profiling.py) counts
the kernel's launches (one a call) as ``ekf3.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..ekf_bl import ekf_smoother_bl
from ...models.batch_last import si_alpha_ekf_system_bl
from . import build as _build
from .shard import map_lanes

M3 = 3
NPI = 12
NSCAL = 11
MAX_MONITOR = 64

# csrc/ekf3.cu: threads a block, lanes a block at most, the SMs one wave
# covers, a block's shared-memory limit (bytes), the input ring (steps a
# slot, slots, inputs a step), and the floats of a step's record (all, and
# those the backward recursion reads)
THREADS = 128
MAX_LANES = 32
SMS = 132
SMEM_LIMIT = 232448
CHUNK = 8
SLOTS = 2
NIN = NPI + 2
REC = 18
RREC = 15

_P, _I = ctypes.c_void_p, ctypes.c_int
_F, _D = ctypes.c_float, ctypes.c_double
_SIGNATURES = {
    "ekf3_smoother": [_P] * 12 + [_I, _I, _F, _I, _F, _F, _I, _P],
    "ekf3_smoother_f64": [_P] * 12 + [_I, _I, _D, _I, _D, _D, _I, _P],
}

class Ekf3Geometry(NamedTuple):
    lanes: int          # lanes a block (one thread each, warp 0)
    blocks: int
    smem_hist: bool     # the step records stay in shared memory
    smem_bytes: int     # dynamic shared memory a block takes
    hist_floats: int    # the device-memory scratch otherwise (T * REC * B)


def ekf3_geometry(T: int, B: int, itemsize: int = 4) -> Ekf3Geometry:
    """csrc/ekf3.cu's launch shape for (T, B) in the instance whose values
    take ``itemsize`` bytes (4: float, 8: double): as many lanes a block as
    their step records fit in SMEM_LIMIT (at most MAX_LANES), as long as the
    blocks fit in one wave on SMS SMs; else MAX_LANES lanes a block with the
    records in a scratch, read back through a ring of SLOTS x CHUNK rows."""
    ring = SLOTS * CHUNK * NIN
    fit = min(MAX_LANES, SMEM_LIMIT // (itemsize * (ring + T * REC)))
    smem_hist = fit >= 1 and -(-B // fit) <= SMS
    lanes = fit if smem_hist else MAX_LANES
    per_lane = ring + (T * REC if smem_hist else SLOTS * CHUNK * RREC)
    return Ekf3Geometry(lanes, -(-B // lanes), smem_hist,
                        itemsize * lanes * per_lane,
                        0 if smem_hist else T * REC * B)


def check_options(obs_type, beta, inv_monitor_len):
    """Refuse an observation type or an adaptive-R window the kernels (and
    their plain versions) do not take."""
    if obs_type not in ("NEWCASES", "TOTALCASES"):
        raise ValueError(f"unknown observation type {obs_type!r}")
    if beta != 1.0 and not 0 < int(inv_monitor_len) <= MAX_MONITOR:
        raise ValueError("adaptive R (beta != 1) needs 0 < inv_monitor_len "
                         f"<= {MAX_MONITOR} (the R_hat window, "
                         "GEKF.m:180-185)")


def _unpack(scal, vecs, Ps_init, s_final, Ps_final):
    B = scal.shape[-1]
    params = {"dt": scal[0], "beta": scal[1], "gamma": scal[2],
              "b": scal[3], "s_min": scal[4], "i_min": scal[5],
              "alpha_min": scal[6], "alpha_max": scal[7],
              "a": vecs[0], "u_max": vecs[1]}
    Q = torch.zeros((M3, M3, B), dtype=scal.dtype, device=scal.device)
    for i in range(M3):
        Q[i, i] = scal[8 + i]
    return (params, Q, Ps_init.reshape(M3, M3, B), s_final,
            Ps_final.reshape(M3, M3, B))


def ekf3_plain(u, x, Rv, scal, vecs, s_init, Ps_init, s_final, Ps_final,
               gamma_discount=0.995, obs_type="NEWCASES", beta=1.0,
               inv_monitor_len=21):
    """The kernel's plain PyTorch version: the same packed interface, run on
    ops/ekf_bl.ekf_smoother_bl in the inputs' dtype on any device.
    Returns (S_SMOOTH, S_PLUS, S_MINUS), each (T, 3, B)."""
    check_options(obs_type, beta, inv_monitor_len)
    params, Q, Ps0, sf, Pf = _unpack(scal, vecs, Ps_init, s_final, Ps_final)
    res = ekf_smoother_bl(
        si_alpha_ekf_system_bl(obs_type), u, x, params, s_init, Ps0, sf, Pf,
        Q=Q, R=Rv, gamma_discount=gamma_discount,
        inv_monitor_len=inv_monitor_len if beta != 1.0 else 0, beta=beta)
    return res.s_smooth, res.s_plus, res.s_minus


def ekf3(u, x, Rv, scal, vecs, s_init, Ps_init, s_final, Ps_final,
         gamma_discount=0.995, obs_type="NEWCASES", beta=1.0,
         inv_monitor_len=21):
    """Forward EKF + RTS smoother for the 3-state SI-alpha system.

    u: (T, 12, B); x, Rv: (T, B); scal: (11, B) rows [dt, beta, gamma, b,
    s_min, i_min, alpha_min, alpha_max, q(3)]; vecs: (2, 12, B) planes
    [a, u_max]; s_init: (3, B); Ps_init: (9, B) row-major; s_final: (3, B)
    and Ps_final: (9, B), NaN = unconstrained. Any B. beta != 1 adapts the
    fixed prior Rv[0] (GEKF.m:180-185).
    Returns (S_SMOOTH, S_PLUS, S_MINUS), each (T, 3, B).
    """
    if u.device.type == "cpu":
        return ekf3_plain(u, x, Rv, scal, vecs, s_init, Ps_init, s_final,
                          Ps_final, gamma_discount, obs_type, beta,
                          inv_monitor_len)
    check_options(obs_type, beta, inv_monitor_len)
    T, _, B = u.shape
    args = dict(u=u, x=x, Rv=Rv, scal=scal, vecs=vecs, s_init=s_init,
                Ps_init=Ps_init, s_final=s_final, Ps_final=Ps_final)
    dev = _build.check_args(args, shapes=dict(
        u=(T, NPI, B), x=(T, B), Rv=(T, B), scal=(NSCAL, B),
        vecs=(2, NPI, B), s_init=(M3, B), Ps_init=(M3 * M3, B),
        s_final=(M3, B), Ps_final=(M3 * M3, B)))
    out = dict(dtype=u.dtype, device=dev)
    S_MINUS = torch.empty((T, M3, B), **out)
    S_PLUS = torch.empty((T, M3, B), **out)
    S_SMOOTH = torch.empty((T, M3, B), **out)
    g = ekf3_geometry(T, B, u.element_size())
    hist = torch.empty((T, REC, B), **out) if g.hist_floats else None
    _build.launch(
        "ekf3", _SIGNATURES, _build.instance("ekf3_smoother", u.dtype), dev,
        u.data_ptr(), x.data_ptr(), Rv.data_ptr(), scal.data_ptr(),
        vecs.data_ptr(), s_init.data_ptr(), Ps_init.data_ptr(),
        s_final.data_ptr(), S_MINUS.data_ptr(), S_PLUS.data_ptr(),
        S_SMOOTH.data_ptr(), None if hist is None else hist.data_ptr(),
        T, B, float(gamma_discount), int(obs_type == "TOTALCASES"),
        float(beta), float(1.0 - beta), int(inv_monitor_len))
    return S_SMOOTH, S_PLUS, S_MINUS


def rho_from_priors(s_minus, x, Rv, inv_monitor_len: int,
                    obs_type: str = "NEWCASES"):
    """Innovation-whiteness monitor (GEKF.m:171-179) from the stored priors:
    s_minus (T, 3, B); x, Rv (T, B) -> rho (T, B). Rolling window sums by
    cumulative sums, with the in-filter window's semantics (newest-first
    window of length L, count = min(t+1, L))."""
    T = s_minus.shape[0]
    L = int(inv_monitor_len)
    if obs_type == "NEWCASES":
        x_pred = s_minus[:, 0] * s_minus[:, 1] * s_minus[:, 2]
    else:
        x_pred = 1.0 - s_minus[:, 0]
    x_pred = torch.maximum(x_pred, torch.zeros_like(x_pred))
    innov = torch.where(torch.isnan(x), torch.zeros_like(x), x - x_pred)

    def rolling_sum(a):
        c = torch.cumsum(a, dim=0)
        if T <= L:
            return c
        return c - torch.cat([torch.zeros_like(c[:L]), c[:-L]])

    cnt = torch.clamp_max(torch.arange(1, T + 1, device=x.device), L)
    cnt = cnt.to(innov.dtype)[:, None]
    mu = rolling_sum(innov) / cnt
    cc = (innov - mu) ** 2
    ccn = cc / (Rv + torch.finfo(innov.dtype).eps)
    return rolling_sum(ccn) / cnt


def pack_params3_for_kernel(params_bl, Q_bl, dtype=torch.float32):
    """(scal (11, B), vecs (2, 12, B)) from a batch-last 3-state params dict
    and the (3, 3, B) process covariance (its diagonal)."""
    B = params_bl["a"].shape[-1]
    dev = params_bl["a"].device

    def bc(v, shape):
        return torch.as_tensor(v, dtype=dtype, device=dev).expand(shape)

    scal = torch.stack(
        [bc(params_bl[k], (B,)) for k in
         ("dt", "beta", "gamma", "b", "s_min", "i_min", "alpha_min",
          "alpha_max")]
        + [Q_bl[i, i].to(dtype) for i in range(M3)])
    vecs = torch.stack([bc(params_bl["a"], (NPI, B)),
                        bc(params_bl["u_max"], (NPI, B))])
    return scal, vecs


def pack_ekf3_args(u_bl, x_bl, Rv_bl, params_bl, Q_bl, s_init_bl,
                   Ps_init_bl, s_final_bl=None, Ps_final_bl=None,
                   dtype=torch.float32):
    """The argument tuple of ``ekf3`` / ``ekf3_plain`` (u, x, Rv, scal, vecs,
    s_init, Ps_init, s_final, Ps_final), contiguous in ``dtype``, from
    batch-last pipeline arrays. s_final/Ps_final None => unconstrained."""
    T, B = x_bl.shape
    kw = dict(dtype=dtype, device=x_bl.device)
    sf = (torch.full((M3, B), float("nan"), **kw) if s_final_bl is None
          else s_final_bl)
    Pf = (torch.full((M3 * M3, B), float("nan"), **kw)
          if Ps_final_bl is None else Ps_final_bl.reshape(M3 * M3, B))
    scal, vecs = pack_params3_for_kernel(params_bl, Q_bl, dtype)
    k = lambda a: a.to(dtype).contiguous()
    return (k(u_bl), k(x_bl), k(Rv_bl), scal, vecs, k(s_init_bl),
            k(Ps_init_bl.reshape(M3 * M3, B)), k(sf), k(Pf))


def ekf3_lanes(u_bl, x_bl, Rv_bl, params_bl, Q_bl, s_init_bl, Ps_init_bl,
               s_final_bl=None, Ps_final_bl=None, gamma_discount=0.995,
               obs_type="NEWCASES", mesh=None):
    """Param-packing glue around ``ekf3`` for the pipeline (the counterpart
    of ekf3_pallas_lanes, epidemicmodeling_tpu/ops/pallas/ekf3_kernel.py:475;
    no lane padding without a mesh: the kernel masks its ragged edge). The
    filter runs in the caller's dtype (x_bl's): on a CUDA device the
    kernel's instance of it (float32 or float64; any other raises), on the
    CPU the plain version.

    mesh: a parallel.Mesh of more than one slot splits the lanes over its
    slots, region-major ("dp", "ep"), one launch a slot (ops/cuda/shard.py),
    padded to a multiple of the slot count; the outputs come back on the
    lead slot.

    All arrays batch-last. Returns (S_SMOOTH, S_PLUS, S_MINUS), each
    (T, 3, B)."""
    args = pack_ekf3_args(u_bl, x_bl, Rv_bl, params_bl, Q_bl, s_init_bl,
                          Ps_init_bl, s_final_bl, Ps_final_bl, x_bl.dtype)
    run = functools.partial(ekf3, gamma_discount=gamma_discount,
                            obs_type=obs_type)
    return tuple(map_lanes(run, mesh, args, ("dp", "ep"), n_out=3))
