"""Batched NNLS with the reference's intercept refinement: CUDA C++ for
Hopper. Source: ``epidemicmodeling_torch/csrc/nnls.cu``.

It replaces no TPU kernel: the JAX package nests ``lax.while_loop``s under
``vmap`` (epidemicmodeling_tpu/regression/nnls.py:86, :158). It was added
because the port's eager version (regression/nnls.py, the plain version)
drives the Lawson-Hanson active set from the host one batched step at a
time, with a host sync at every loop test: ~225 syncs and ~7,200 launches a
backtest request at the XPRIZE size.

What bounds it on the card: each problem's chain of dependent active-set
steps (a masked Cholesky and two triangular solves each), not bytes or
flops. One launch runs every problem, a block each: the block forms G, X'y
and the tolerance with all its threads, reading X and y from device memory,
and one warp runs the active set, a lane a column; the intercept steps' X'(y - b) and residual sums are block
reductions. Nothing returns to the host until the launch ends.

``nnls_intercept`` launches it for CUDA tensors (float32 or float64, any
strides) and raises on anything it cannot take; regression/nnls.py routes
CUDA tensors here and CPU tensors to the plain version. ``masked_solve``
runs the kernel's masked Cholesky solve alone and is for the tests only: no
path of the port calls it. The recording in force (utils/profiling.py)
counts the launches of both as ``nnls.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build as _build

# csrc/nnls.cu: threads a block and the most columns (one lane each)
THREADS = 256
MAX_P = 32

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_NNLS = [_P, _L, _L, _L, _P, _L, _L, _I, _I, _I, _I, _P, _P, _P, _P]
_SOLVE = [_P, _P, _P, _P, _I, _I, _P]
_SIGNATURES = {"nnls_intercept_f32": _NNLS, "nnls_intercept_f64": _NNLS,
               "nnls_masked_solve_f32": _SOLVE,
               "nnls_masked_solve_f64": _SOLVE}


def _check(named: dict, p: int) -> torch.device:
    """1 <= p <= MAX_P, then build.check_args (any strides). Returns the
    device."""
    if not 1 <= p <= MAX_P:
        raise ValueError(f"the NNLS kernel takes 1 to {MAX_P} columns "
                         f"(a lane each), got p = {p}")
    return _build.check_args(named, contiguous=False)


def nnls_intercept(X: torch.Tensor, y: torch.Tensor, iterations: int):
    """regression/nnls.py's nnls_with_intercept for every problem of a
    batch, one launch. X (R, n, p), y (R, n): CUDA, one dtype (float32 or
    float64), any strides; R, n >= 1. ``iterations`` = 0 is nnls alone
    (b = 0). Returns (a (R, p), b (R,), counts (R, 3) int32: each problem's
    outer, inner and intercept iterations), on X's device, without waiting
    for the card."""
    if X.dim() != 3 or y.dim() != 2 or y.shape != X.shape[:2]:
        raise ValueError(f"X must be (R, n, p) and y (R, n), got "
                         f"{tuple(X.shape)} and {tuple(y.shape)}")
    R, n, p = X.shape
    dev = _check(dict(X=X, y=y), p)
    if R < 1 or n < 1:
        raise ValueError(f"the NNLS kernel needs R, n >= 1, got {R}, {n}")
    if int(iterations) < 0:
        raise ValueError(f"iterations must be >= 0, got {iterations}")
    a = torch.empty((R, p), dtype=X.dtype, device=dev)
    b = torch.empty(R, dtype=X.dtype, device=dev)
    counts = torch.empty((R, 3), dtype=torch.int32, device=dev)
    _build.launch(
        "nnls", _SIGNATURES, _build.instance("nnls_intercept", X.dtype), dev,
        X.data_ptr(), *X.stride(), y.data_ptr(), *y.stride(), R, n, p,
        int(iterations), a.data_ptr(), b.data_ptr(), counts.data_ptr())
    return a, b, counts


def masked_solve(G: torch.Tensor, c: torch.Tensor, P: torch.Tensor):
    """The kernel's masked solve, one warp a problem: G (R, p, p), c (R, p),
    P (R, p) bool, CUDA -> z (R, p), as regression/nnls.py's _masked_ls
    (NaN in every column of a problem whose system is not positive
    definite). For the tests only: the NNLS cannot be driven into a
    singular passive set on demand (a column in the span of the passive
    set's columns has w = 0 up to rounding, below the tolerance it must
    exceed to enter), so the NaN case is held here, alone."""
    R, p = c.shape
    dev = _check(dict(G=G, c=c), p)
    G, c = G.contiguous(), c.contiguous()
    P = P.to(device=dev, dtype=torch.uint8).contiguous()
    z = torch.empty((R, p), dtype=c.dtype, device=dev)
    _build.launch(
        "nnls", _SIGNATURES, _build.instance("nnls_masked_solve", c.dtype),
        dev, G.data_ptr(), c.data_ptr(), P.data_ptr(), z.data_ptr(), R, p)
    return z
