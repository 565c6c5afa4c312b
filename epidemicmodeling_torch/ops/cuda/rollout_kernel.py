"""The controlled SI-alpha rollout from the end-of-history state: CUDA C++
for Hopper. Source: ``epidemicmodeling_torch/csrc/rollout.cu``.

It replaces no Pallas kernel: the JAX package runs these rollouts as
``lax.scan`` loops inside its compiled stages (the Pareto sweep's, the
forecast scenarios' and the Monte Carlo's, epidemicmodeling_tpu/pipelines/
core.py). The port ran them as eager Python loops, ~35 small launches a
step, and each clip bound of 0 or 1 became a device tensor through a
pageable copy and a host sync: ~43,000 launches and ~5,000 syncs a float64
XPRIZE request, with the host unable to run ahead of the card.

One call rolls G schedules over R regions for H steps, lane = g * R + r
(epsilon-major in the sweep, schedule-major in the Monte Carlo,
scenario-major in the forecast), one launch on the card. What bounds it
there: each lane's chain of H dependent steps, not bytes.

Routing, by what the inputs show: CPU tensors run ``rollout_plain`` (the
eager loop of models/si_alpha.si_alpha_step_fields, which the CPU tests
hold against the JAX package); any other device runs the kernel, which
takes CUDA tensors in float32 or float64 and raises on anything else. There
is no fallback, and the pipeline's backend does not enter. The recording
in force (utils/profiling.py) counts the kernel's launches as
``rollout.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...models.si_alpha import si_alpha_step_fields
from . import build as _build

# csrc/rollout.cu: threads a block (one lane each) and the NPIs it takes
THREADS = 128
NPI = 12
# the per-region (R,) parameters, in the order of the C entry's region array
REGION_PARAMS = ("dt", "beta", "gamma", "b", "alpha_min", "alpha_max",
                 "s_noise_std", "i_noise_std", "alpha_noise_std")

_P, _L = ctypes.c_void_p, ctypes.c_longlong
_ENTRY = [_L, _L, _L, _L] + [_P] * 16
_SIGNATURES = {"rollout_f32": _ENTRY, "rollout_f64": _ENTRY}


def _check_shapes(s0, params, u, noise, out):
    """The shapes a rollout takes; returns (G, R, H, P)."""
    if u.dim() != 4:
        raise ValueError(f"u must be (G, R, H, P), got {tuple(u.shape)}")
    G, R, H, P = u.shape
    want = {"s0": (s0, (R, 3)), "a": (params["a"], (R, P)),
            "u_max": (params["u_max"], (R, P))}
    want.update({k: (params[k], (R,)) for k in REGION_PARAMS})
    if noise is not None:
        want["noise"] = (noise, (G, R, H, 3))
    for k, o in enumerate(out or ()):
        want[f"out[{k}]"] = (o, (G, R, H))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if out is not None and len(out) != 3:
        raise ValueError(f"out must hold three fields (s, i, alpha), got "
                         f"{len(out)}")
    return G, R, H, P


def rollout(s0: torch.Tensor, params: dict, u: torch.Tensor,
            noise: Optional[torch.Tensor] = None, out=None) -> torch.Tensor:
    """Roll G schedules out from each region's end-of-history state.

    s0 (R, 3); params: the (R,) tensors REGION_PARAMS and a, u_max (R, P);
    u (G, R, H, P); noise (G, R, H, 3) standard-normal draws
    (cfg.stochastic_forecast), or None for the deterministic rollout; out:
    None, or three (G, R, H) tensors (s, i, alpha) that the trajectory is
    written into. Every input may be a strided view (stride 0 included).
    Returns each lane's horizon sum of s i alpha, (G, R)."""
    if u.device.type == "cpu":
        return rollout_plain(s0, params, u, noise, out)
    return rollout_cuda(s0, params, u, noise, out)


def rollout_plain(s0, params, u, noise=None, out=None) -> torch.Tensor:
    """``rollout`` as eager tensor ops on any device: H steps of
    si_alpha_step_fields over (G, R) batches."""
    G, R, H, P = _check_shapes(s0, params, u, noise, out)
    s, i, al = (s0[:, k].expand(G, R) for k in range(3))
    zero = torch.zeros((G, R), dtype=u.dtype, device=u.device)
    n = (zero,) * 3
    cases = zero
    for t in range(H):
        if noise is not None:
            n = (noise[:, :, t, 0], noise[:, :, t, 1], noise[:, :, t, 2])
        s, i, al = si_alpha_step_fields(s, i, al, u[:, :, t], *n, params)
        cases = cases + s * i * al
        if out is not None:
            for o, v in zip(out, (s, i, al)):
                o[:, :, t] = v
    return cases


def rollout_cuda(s0, params, u, noise=None, out=None) -> torch.Tensor:
    """``rollout`` in one launch of the kernel: every tensor CUDA, on one
    device, in one dtype, float32 or float64, P = NPI; raises
    otherwise. Returns without waiting for the card."""
    G, R, H, P = _check_shapes(s0, params, u, noise, out)
    if P != NPI:
        raise ValueError(f"the rollout kernel takes P = {NPI} NPIs, got "
                         f"P = {P}")
    named = dict(s0=s0, a=params["a"], u_max=params["u_max"], u=u,
                 **{k: params[k] for k in REGION_PARAMS})
    if noise is not None:
        named["noise"] = noise
    for k, o in enumerate(out or ()):
        named[f"out[{k}]"] = o
    dev = _build.check_args(named, contiguous=False)
    cases = torch.empty((G, R), dtype=u.dtype, device=dev)
    _build.launch("rollout", _SIGNATURES, _build.instance("rollout", u.dtype),
                  dev, *entry_args(s0, params, u, noise, out, cases))
    return cases


def entry_args(s0, params, u, noise, out, cases) -> tuple:
    """The C entry's arguments but the stream, for tensors of any device
    (the tests call the source's entries on the CPU through it)."""
    G, R, H, P = u.shape
    lls = lambda v: (_L * len(v))(*v)
    ptrs = lambda ts: (_P * len(ts))(*(None if t is None else t.data_ptr()
                                       for t in ts))
    region = [params[k] for k in REGION_PARAMS]
    traj = list(out) if out is not None else [None] * 3
    traj_st = [x for o in traj
               for x in (o.stride() if o is not None else (0, 0, 0))]
    return (G, R, H, P, s0.data_ptr(), lls(s0.stride()), ptrs(region),
            lls([t.stride(0) for t in region]), params["a"].data_ptr(),
            lls(params["a"].stride()), params["u_max"].data_ptr(),
            lls(params["u_max"].stride()), u.data_ptr(), lls(u.stride()),
            None if noise is None else noise.data_ptr(),
            lls(noise.stride() if noise is not None else (0, 0, 0, 0)),
            ptrs(traj), lls(traj_st), cases.data_ptr())
