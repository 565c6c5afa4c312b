"""NaN-ordered clips, covariance symmetrization and the moving-average
filters shared by the model equations, the EKF cores and the estimators.

MATLAB's min/max ignore NaN operands, so the reference's clips sanitize a NaN
state to a bound instead of propagating it (CLAUDE.md "Parity conventions").
torch.fmin/fmax have exactly that semantics; torch.clamp propagates NaN and
must not replace these. The filters are MATLAB ``filter(ones(1,w), w, x)``
(causal, zero initial conditions, Tools/TrainPredictPrescribeNPI.m:173) and
``filtfilt`` of the same boxcar (:174). Counterpart of
epidemicmodeling_tpu/utils/math.py.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def _like(v, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=x.dtype, device=x.device)


def clip_lo_hi(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """MATLAB ``max(lo, min(hi, x))``: a NaN x maps to hi."""
    return torch.fmax(_like(lo, x), torch.fmin(_like(hi, x), x))


def clip_hi_lo(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """MATLAB ``min(hi, max(lo, x))``: a NaN x maps to lo."""
    return torch.fmin(_like(hi, x), torch.fmax(_like(lo, x), x))


def symmetrize(P: torch.Tensor) -> torch.Tensor:
    """Force symmetry of (..., m, m) covariance stacks: (P + P^T) / 2."""
    return 0.5 * (P + P.transpose(-1, -2))


def clip01(x: torch.Tensor) -> torch.Tensor:
    """Clip to the [0, 1] interval (compartment fractions); NaN stays NaN,
    as with jnp.clip."""
    return torch.clamp(x, 0.0, 1.0)


def as_device_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on ``device``, else where it lies when it is a
    tensor, else on the CUDA card (utils.device.resolve_device); in
    ``dtype``, else its own (NumPy float64 stays float64)."""
    dev = resolve_device(device, x)
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype or x.dtype)
    # np.array copies: arrays handed over from JAX are read-only
    return torch.as_tensor(np.array(x), dtype=dtype, device=dev)


def float_tensor(x, device=None) -> torch.Tensor:
    """as_device_tensor, in float64 unless ``x`` is floating already."""
    t = as_device_tensor(x, device)
    return t if t.is_floating_point() else t.to(torch.float64)


def float_args(device, *values) -> list:
    """``values`` as tensors on one device (``device``, else where the
    first tensor among them lies, else the CUDA card) in one floating
    dtype: float64 unless every tensor given is float32, as JAX's
    ``result_type(float)`` under x64 for Python numbers."""
    like = next((v for v in values if isinstance(v, torch.Tensor)), None)
    dev = resolve_device(device, like)
    ts = [float_tensor(v, dev) for v in values]
    fd = ts[0].dtype
    for t in ts[1:]:
        fd = torch.promote_types(fd, t.dtype)
    return [t.to(fd) for t in ts]


def host_array(v) -> np.ndarray:
    """A tensor (on any device) or array-like as a host NumPy array."""
    return np.asarray(v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                      else v)


def convolve_valid(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``np.convolve(x, kernel, "valid")`` along the last axis of a batch:
    y[..., t] = sum_j x[..., t + j] kernel[w - 1 - j], the correlation with
    the flipped taps. Sliding windows (unfold) times the taps, summed, so
    both devices add each window's w products in one order."""
    w = kernel.shape[-1]
    return (x.unfold(-1, w, 1) * kernel.flip(-1)).sum(dim=-1)


def causal_moving_average(x, win: int, axis: int = -1, device=None):
    """Causal length-``win`` moving average with MATLAB
    ``filter(ones(1,w), w, x)`` semantics (zero initial conditions): y[t]
    is the mean of the last w samples, zeros before t = 0."""
    x = torch.movedim(as_device_tensor(x, device), axis, -1)
    kernel = torch.ones(win, dtype=x.dtype, device=x.device) / win
    xp = torch.nn.functional.pad(x, (win - 1, 0))
    return torch.movedim(convolve_valid(xp, kernel), -1, axis)


def filtfilt_ma(x, win: int, axis: int = -1, device=None):
    """Zero-phase boxcar filtering approximating MATLAB
    ``filtfilt(ones(1,w), w, x)``: the causal filter forward, then
    backward, over the series extended by filtfilt's odd reflection of
    length 3 (w - 1) (capped at T - 1) at both ends."""
    x = torch.movedim(as_device_tensor(x, device), axis, -1)
    T = x.shape[-1]
    nfact = 3 * (win - 1)
    if nfact >= T:
        nfact = T - 1
    # odd extension: 2 x[0] - x[nfact:0:-1] and 2 x[-1] - x[-2:-2-nfact:-1]
    pre = 2 * x[..., :1] - x[..., 1:nfact + 1].flip(-1)
    post = 2 * x[..., -1:] - x[..., T - 1 - nfact:T - 1].flip(-1)
    xe = torch.cat([pre, x, post], dim=-1)
    fwd = causal_moving_average(xe, win)
    bwd = causal_moving_average(fwd.flip(-1), win).flip(-1)
    return torch.movedim(bwd[..., nfact:nfact + T], -1, axis)
