"""The native deployment artefact: the pre-generic 6-state optimal-NPI
EKF/EKS (Tools/NewCaseEKFEstimatorWithOptimalNPI.m) and its Pareto epsilon
sweep for one region, behind a plain C interface.

Counterpart of epidemicmodeling_tpu/deploy/native.py: the same functions,
arguments and returned dicts of NumPy arrays, plus ``device``. One C
interface, two builds of it:

- the card build, ``csrc/newcase_ekf.cu`` (nvcc for sm_90a through
  ops/cuda/build.py, without fused multiply-adds), the default: a
  hand-written float64 kernel, a team of threads an epsilon lane, that
  runs the filter, the smoother, the horizon's re-simulation and the
  costs. Its
  device-pointer entry takes tensors torch allocated, on torch's current
  stream; its host-pointer entries are the framework-free serving path;
- the CPU build, ``deploy/src/newcase_ekf.cpp`` (g++ with the JAX package's
  flags), chosen with ``device="cpu"``: the accelerator-free artefact, the
  JAX package's library bit for bit, threaded over epsilon.

Both builds share ``csrc/newcase_ekf.cuh``, and both are built at first use
into build/torch_kernels/ at the root of the checkout, keyed by a hash of
their sources and flags. ``device=None`` means the card
(utils/device.resolve_device), which raises when there is none.
``newcase_ekf_sweep`` is the kernel's wrapper on tensors: it launches the
kernel for CUDA tensors and runs the plain version (deploy/plain.py) for
CPU tensors. The recording in force (utils/profiling.py) counts the card
build's launches as ``newcase_ekf.launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import threading
from pathlib import Path

import numpy as np
import torch

from ..ops.cuda import build as _build
from ..utils.device import resolve_device
from ..utils.profiling import count
from .plain import pareto_sweep_plain

M = 6
# the kernel's limits, geometry and scratch layout (csrc/newcase_ekf.cuh
# MAX_NPI, csrc/newcase_ekf.cu MAX_MONITOR, LANES, SCRATCH_PER_LANE_STEP)
NPI_MAX = 64
MONITOR_MAX = 64
LANES = 16
SCRATCH_PER_LANE_STEP = 2 * M + 2 * M * M

SRC = Path(__file__).resolve().parent / "src" / "newcase_ekf.cpp"
HEADER = _build.CSRC / "newcase_ekf.cuh"
# the JAX package's flags (epidemicmodeling_tpu/deploy/native.py:21)
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SINGLE = ([_P, _P, _I, _I] + [_D] * 8 + [_P] * 4 + [_P] * 4 + [_P] * 2
           + [_D, _D, _I] + [_P] * 3)
_SWEEP_HEAD = ([_P, _P, _I, _I, _I] + [_D] * 7 + [_P, _I] + [_P] * 4
               + [_P] * 4 + [_P] * 2 + [_D, _D, _I])
_CPU_SIGNATURES = {
    "newcase_ekf_optimal_npi": _SINGLE,
    "newcase_ekf_pareto_sweep": _SWEEP_HEAD + [_P, _I] + [_P] * 3,
}
_CARD_SIGNATURES = {
    "newcase_ekf_optimal_npi_cuda": _SINGLE,
    "newcase_ekf_pareto_sweep_cuda": _SWEEP_HEAD + [_P] + [_P] * 3,
    "newcase_ekf_sweep_device": _SWEEP_HEAD + [_P, _P] + [_P] * 5 + [_P],
    "newcase_ekf_block_sms": [_P, _I],
    "newcase_ekf_host_phases": [_P],
}
HOST_PHASES = ("alloc", "copy_in", "kernel", "copy_out", "free")
_lock = threading.Lock()
_cpu_handle = None


def library_path() -> Path:
    """Where the CPU build lies: build/torch_kernels/, keyed by its sources
    and flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for src in (SRC, HEADER):
        h.update(src.read_bytes())
    return _build.BUILD_DIR / f"libnewcase_ekf_cpu_{h.hexdigest()[:16]}.so"


def build_library(force: bool = False) -> str:
    """Compile the CPU build unless its hashed library exists (always with
    ``force``). Returns its path."""
    so = library_path()
    if force or not so.exists():
        _build.compile_into(so, ["g++", *GXX_FLAGS, str(SRC)])
    return str(so)


def _cpu_lib() -> ctypes.CDLL:
    global _cpu_handle
    with _lock:
        if _cpu_handle is None:
            lib = ctypes.CDLL(build_library())
            for fn, argtypes in _CPU_SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _cpu_handle = lib
        return _cpu_handle


def _card_lib() -> ctypes.CDLL:
    return _build.load("newcase_ekf", _CARD_SIGNATURES)


def blocks(n_eps: int) -> int:
    """The kernel's blocks for n_eps lanes (LANES a block)."""
    return -(-int(n_eps) // LANES)


def block_sms(n_eps: int) -> np.ndarray:
    """The SM each block of the card's last launch at n_eps lanes ran on
    (the kernel records it)."""
    out = np.zeros(blocks(n_eps), dtype=np.int32)
    lib = _card_lib()
    _build.check(lib, "newcase_ekf", "newcase_ekf_block_sms",
                 lib.newcase_ekf_block_sms(out.ctypes.data, len(out)))
    return out


def host_entry_phases() -> dict:
    """The parts of the last host-pointer call's wall, ms, by HOST_PHASES:
    the device allocation, the copies in, the kernel (launch to
    synchronisation), the copies out, the free."""
    out = np.zeros(len(HOST_PHASES))
    _card_lib().newcase_ekf_host_phases(out.ctypes.data)
    return dict(zip(HOST_PHASES, out.tolist()))


def native_inputs(u, x, params, s_init, Ps_init, s_final, Ps_final, Q,
                  R_v) -> dict:
    """The C interface's inputs as contiguous float64 NumPy arrays and
    floats, with the JAX wrapper's checks: x of u's length, P <= 64, the
    four NPI vectors of length P. params: the SIAlphaParams dict."""
    arr = lambda v, *shape: np.ascontiguousarray(
        np.asarray(v, float).reshape(*shape))
    u = arr(u, *np.shape(u))
    x = arr(x, -1)
    T, P = u.shape
    if x.shape[0] != T:
        raise ValueError(f"x length {x.shape[0]} != u time dim {T}")
    if P > NPI_MAX:
        raise ValueError(
            f"NPI dim {P} exceeds the native build limit ({NPI_MAX})")
    d = dict(u=u, x=x, T=T, P=P)
    for k in ("a", "u_min", "u_max", "w"):
        d[k] = arr(params[k], -1)
        if d[k].shape[0] != P:
            raise ValueError(
                f"params[{k!r}] length {d[k].shape[0]} != NPI dim {P}")
    for k in ("dt", "beta", "gamma", "b", "epsilon", "sigma", "alpha_min",
              "alpha_max"):
        d[k] = float(np.asarray(params[k]))
    d.update(s_init=arr(s_init, M), Ps_init=arr(Ps_init, M, M),
             s_final=arr(s_final, M), Ps_final=arr(Ps_final, M, M),
             Q=arr(Q, M, M),
             R_v=np.ascontiguousarray(np.broadcast_to(
                 np.asarray(R_v, float).reshape(-1), (T,)).copy()))
    return d


def _check_monitor(inv_monitor_len, device: torch.device) -> int:
    L = int(inv_monitor_len)
    if L < 1:
        raise ValueError(f"inv_monitor_len {L} < 1")
    if device.type == "cuda" and L > MONITOR_MAX:
        raise ValueError(f"inv_monitor_len {L} exceeds the card build's "
                         f"limit ({MONITOR_MAX})")
    return L


def _ptr(v):
    return v.data_ptr() if isinstance(v, torch.Tensor) else v.ctypes.data


def _head(d, T_hist, eps, n_eps, beta_ekf, gamma_ekf, L) -> list:
    """The sweep entries' arguments up to inv_monitor_len."""
    p = lambda k: _ptr(d[k])
    return [p("u"), p("x"), d["T"], d["P"], int(T_hist), d["dt"], d["beta"],
            d["gamma"], d["b"], d["sigma"], d["alpha_min"], d["alpha_max"],
            _ptr(eps), n_eps, p("a"), p("u_min"), p("u_max"), p("w"),
            p("s_init"), p("Ps_init"), p("s_final"), p("Ps_final"), p("Q"),
            p("R_v"), float(beta_ekf), float(gamma_ekf), L]


def _single(d, beta_ekf, gamma_ekf, L) -> list:
    """The single-epsilon entries' arguments up to inv_monitor_len."""
    p = lambda k: _ptr(d[k])
    return [p("u"), p("x"), d["T"], d["P"], d["dt"], d["beta"], d["gamma"],
            d["b"], d["epsilon"], d["sigma"], d["alpha_min"], d["alpha_max"],
            p("a"), p("u_min"), p("u_max"), p("w"), p("s_init"),
            p("Ps_init"), p("s_final"), p("Ps_final"), p("Q"), p("R_v"),
            float(beta_ekf), float(gamma_ekf), L]


def to_device(d: dict, device) -> dict:
    """native_inputs with every array a float64 tensor on ``device``."""
    return {k: torch.from_numpy(v).to(device) if isinstance(v, np.ndarray)
            else v for k, v in d.items()}


def newcase_ekf_sweep(dc: dict, eps: torch.Tensor, T_hist: int = 0,
                      sia_hist=None, beta_ekf=1.0, gamma_ekf=0.995,
                      inv_monitor_len=21, states: bool = False) -> dict:
    """The kernel's wrapper. dc: to_device(native_inputs(...), device); eps:
    (E,) float64 on the same device; sia_hist: (T_hist, 3) there too, or
    None to skip the re-simulation and the costs; states: also return
    S_PLUS and S_SMOOTH (E, T, 6). On a CUDA device it launches the kernel
    through its device-pointer entry on torch's current stream, without
    waiting for it; on the CPU it runs the plain version
    (deploy/plain.pareto_sweep_plain). Returns tensors on eps's device:
    U_OPT_SMOOTH (E, T, P) and, with sia_hist, J0 and J1 (E,)."""
    dev = eps.device
    L = _check_monitor(inv_monitor_len, dev)
    if dev.type == "cpu":
        res = pareto_sweep_plain(
            dc["u"], dc["x"], T_hist, dc, eps, dc["s_init"], dc["Ps_init"],
            dc["s_final"], dc["Ps_final"], dc["Q"], dc["R_v"], sia_hist,
            beta_ekf, gamma_ekf, L, device=dev)
        return {k: v for k, v in res.items()
                if states or not k.startswith("S_")}
    _build.check_args(
        {k: v for k, v in [("eps", eps), ("sia_hist", sia_hist),
                           *dc.items()] if isinstance(v, torch.Tensor)},
        (torch.float64,), device=dev)
    T, P, E = dc["T"], dc["P"], eps.numel()
    new = lambda *shape: torch.empty(shape, dtype=torch.float64, device=dev)
    out = {"U_OPT_SMOOTH": new(E, T, P)}
    if sia_hist is not None:
        out.update(J0=new(E), J1=new(E))
    if states:
        out.update(S_PLUS=new(E, T, M), S_SMOOTH=new(E, T, M))
    scratch = new(T * SCRATCH_PER_LANE_STEP * E)
    opt = lambda k: _ptr(out[k]) if k in out else None
    _build.launch(
        "newcase_ekf", _CARD_SIGNATURES, "newcase_ekf_sweep_device", dev,
        *_head(dc, T_hist, eps, E, beta_ekf, gamma_ekf, L),
        None if sia_hist is None else _ptr(sia_hist), _ptr(scratch),
        opt("U_OPT_SMOOTH"), opt("J0"), opt("J1"), opt("S_PLUS"),
        opt("S_SMOOTH"))
    return out


def sweep_host_entry(d: dict, eps, T_hist, sia_hist, beta_ekf=1.0,
                     gamma_ekf=0.995, inv_monitor_len=21) -> dict:
    """The card build's host-pointer sweep (the framework-free serving
    path: it allocates, copies in, launches, copies out and frees with the
    CUDA runtime alone) on native_inputs ``d``. Returns NumPy arrays."""
    L = _check_monitor(inv_monitor_len, torch.device("cuda"))
    eps = np.ascontiguousarray(np.asarray(eps, float).reshape(-1))
    sia_hist = np.ascontiguousarray(
        np.asarray(sia_hist, float).reshape(int(T_hist), 3))
    E = eps.shape[0]
    out = dict(U_OPT_SMOOTH=np.zeros((E, d["T"], d["P"])), J0=np.zeros(E),
               J1=np.zeros(E))
    lib = _card_lib()
    code = lib.newcase_ekf_pareto_sweep_cuda(
        *_head(d, T_hist, eps, E, beta_ekf, gamma_ekf, L), _ptr(sia_hist),
        *(_ptr(v) for v in out.values()))
    _build.check(lib, "newcase_ekf", "newcase_ekf_pareto_sweep_cuda", code)
    count(_build.LAUNCHES["newcase_ekf"])
    return out


def newcase_ekf_optimal_npi_native(u, x, params, s_init, Ps_init,
                                   s_final, Ps_final, Q, R_v,
                                   beta_ekf=1.0, gamma_ekf=0.995,
                                   inv_monitor_len=21, device=None):
    """Run the native EKF/EKS for one epsilon (params["epsilon"]).
    u: (T, P) with NaN = optimal control; x: (T,) with NaN = prediction
    only; params: the SIAlphaParams dict (host side). Runs the card build
    (the sweep kernel at E = 1) unless ``device="cpu"`` asks for the CPU
    build. Returns dict with S_PLUS (T,6), S_SMOOTH (T,6), U_OPT_SMOOTH
    (T,P), NumPy arrays."""
    d = native_inputs(u, x, params, s_init, Ps_init, s_final, Ps_final, Q,
                      R_v)
    dev = resolve_device(device)
    L = _check_monitor(inv_monitor_len, dev)
    if dev.type == "cuda":
        eps = torch.tensor([d["epsilon"]], dtype=torch.float64, device=dev)
        res = newcase_ekf_sweep(to_device(d, dev), eps, beta_ekf=beta_ekf,
                                gamma_ekf=gamma_ekf, inv_monitor_len=L,
                                states=True)
        return {k: res[k][0].cpu().numpy()
                for k in ("S_PLUS", "S_SMOOTH", "U_OPT_SMOOTH")}
    T, P = d["T"], d["P"]
    out = dict(S_PLUS=np.zeros((T, M)), S_SMOOTH=np.zeros((T, M)),
               U_OPT_SMOOTH=np.zeros((T, P)))
    rc = _cpu_lib().newcase_ekf_optimal_npi(
        *_single(d, beta_ekf, gamma_ekf, L),
        *(_ptr(v) for v in out.values()))
    if rc != 0:
        raise RuntimeError(f"native EKF failed with code {rc}")
    return out


def newcase_ekf_pareto_sweep_native(u, x, T_hist, params, eps_values,
                                    s_init, Ps_init, s_final, Ps_final,
                                    Q, R_v, sia_hist, beta_ekf=1.0,
                                    gamma_ekf=0.995, inv_monitor_len=21,
                                    n_threads=0, device=None):
    """Full Pareto epsilon sweep for one region (the serving-side
    testPrescribeXPRIZE01 flow: per epsilon the opt-controlled EKF/EKS,
    the horizon's re-simulation, NPICost). params: SIAlphaParams dict whose
    "epsilon" is ignored; sia_hist: (T_hist, 3) historic (s, i, alpha)
    trajectory. On the card (the default) one kernel launch runs every
    epsilon; with ``device="cpu"`` the CPU build runs them on n_threads
    threads (0: all hardware threads). Returns dict with U_OPT_SMOOTH
    (E, T, P), J0 (E,), J1 (E,), NumPy arrays."""
    d = native_inputs(u, x, params, s_init, Ps_init, s_final, Ps_final, Q,
                      R_v)
    dev = resolve_device(device)
    L = _check_monitor(inv_monitor_len, dev)
    eps = np.ascontiguousarray(np.asarray(eps_values, float).reshape(-1))
    sia_hist = np.ascontiguousarray(
        np.asarray(sia_hist, float).reshape(int(T_hist), 3))
    if dev.type == "cuda":
        t = lambda v: torch.from_numpy(v).to(dev)
        res = newcase_ekf_sweep(to_device(d, dev), t(eps), T_hist,
                                t(sia_hist), beta_ekf, gamma_ekf, L)
        return {k: v.cpu().numpy() for k, v in res.items()}
    E = eps.shape[0]
    out = dict(U_OPT_SMOOTH=np.zeros((E, d["T"], d["P"])), J0=np.zeros(E),
               J1=np.zeros(E))
    rc = _cpu_lib().newcase_ekf_pareto_sweep(
        *_head(d, T_hist, eps, E, beta_ekf, gamma_ekf, L), _ptr(sia_hist),
        int(n_threads), *(_ptr(v) for v in out.values()))
    if rc != 0:
        raise RuntimeError(f"native Pareto sweep failed with code {rc}")
    return out
