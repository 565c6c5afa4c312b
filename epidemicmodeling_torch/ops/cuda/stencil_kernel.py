"""The diffusion-stencil kernel (B4): CUDA C++ for Hopper.

Replaces the Pallas kernels behind ``diffusion_step_pallas``
(epidemicmodeling_tpu/ops/pallas/stencil.py:114): ``_diffusion_pallas`` :44
(body ``_stencil_kernel`` :29) and ``_diffusion_pallas_tiled`` :82 (body
``_stencil_tiled_kernel`` :56). Source:
``epidemicmodeling_torch/csrc/stencil.cu``.

What bounds it on the card: bytes, one read and one write of the field per
step (2 * 4 * Lx * Ly in float32). The kernel runs many steps per launch
(temporal blocking): each block loads its tile and a halo of K cells into
shared memory once, runs K steps there and writes only the frames asked for,
so a rollout of n steps makes ceil(n / K) launches (K = STEPS_PER_LAUNCH of
the dtype) and reads the field 1/K as often. Dense sources and sparse
(cell, amount) injections are added inside the kernel before each step. The
whole-grid / row-panel split of the Pallas version existed because of the
TPU's VMEM; one kernel covers every size, and ``force_tiled`` changes
nothing.

``stencil_rollout`` launches the kernel for a CUDA field (float32 or
float64, contiguous) and raises on anything it cannot take; for a CPU field
it runs ``stencil_rollout_plain``, the same steps as a Python loop over
``stencil_plain``. ``stencil`` is the one-step case. The recording in
force (utils/profiling.py) counts the kernel's launches as
``stencil.launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build as _build

# csrc/stencil.cu: threads of a block (= box columns), box rows and steps a
# launch by dtype
THREADS = 256
BOX_ROWS = {torch.float32: 54, torch.float64: 26}
STEPS_PER_LAUNCH = {torch.float32: 8, torch.float64: 4}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ROLLOUT_ARGS = [_P] * 6 + [_I] * 5 + [_P, _I, _P, _P]
_SIGNATURES = {"stencil_rollout_f32": _ROLLOUT_ARGS,
               "stencil_rollout_f64": _ROLLOUT_ARGS}


def _check_field(C) -> None:
    if not isinstance(C, torch.Tensor) or C.dim() != 2:
        raise ValueError("the field must be a 2-D tensor (Lx, Ly)")
    if C.dtype not in _build.DTYPES:
        raise ValueError(f"the field must be float32 or float64 "
                         f"(got {C.dtype})")


def step_weights(weights, n_steps: int) -> list:
    """``weights`` as n_steps (ax, ay, axy) float triples: one triple for
    every step, or a sequence of n_steps triples."""
    w = list(weights)
    if len(w) == 3 and not isinstance(w[0], (tuple, list)):
        return [tuple(float(x) for x in w)] * n_steps
    if len(w) != n_steps or any(len(t) != 3 for t in w):
        raise ValueError(f"weights must be one (ax, ay, axy) triple or "
                         f"{n_steps} of them")
    return [tuple(float(x) for x in t) for t in w]


def stencil_plain(C, ax, ay, axy=0.0, out=None):
    """The kernel's plain PyTorch version of one step: one explicit 9-point
    diffusion step of the field C (Lx, Ly) in its dtype, on any device; the
    boundary is copied unchanged, and axy = 0 is the 4-neighbour scheme.
    Writes into ``out`` when given. Returns the new field."""
    _check_field(C)
    ax, ay, axy = float(ax), float(ay), float(axy)
    c0 = 1.0 - 2.0 * ax - 2.0 * ay - 4.0 * axy
    out = torch.empty_like(C) if out is None else out
    out.copy_(C)
    if C.shape[0] < 3 or C.shape[1] < 3:
        return out
    acc = (c0 * C[1:-1, 1:-1]
           + ax * (C[:-2, 1:-1] + C[2:, 1:-1])
           + ay * (C[1:-1, :-2] + C[1:-1, 2:]))
    if axy != 0.0:
        acc = acc + axy * (C[:-2, :-2] + C[2:, 2:] + C[:-2, 2:]
                           + C[2:, :-2])
    out[1:-1, 1:-1] = acc
    return out


def stencil_rollout_plain(C, n_steps, weights, sources=None, cells=None,
                          amounts=None, frames=None, out=None):
    """The multi-step kernel's plain version, a Python loop over
    ``stencil_plain``, with the same arguments as ``stencil_rollout``: before
    step t the field gets sources[t] and then the injections cells[t] /
    amounts[t] (a scatter-add in walker order on the CPU), then one step.
    Returns the last field."""
    _check_field(C)
    ws = step_weights(weights, n_steps)
    cur = C
    for t in range(n_steps):
        x = cur if sources is None else cur + sources[t]
        if cells is not None and t < cells.shape[0]:
            hit = cells[t] >= 0
            x = x.clone(memory_format=torch.contiguous_format)
            x.view(-1).index_add_(0, cells[t][hit].long(), amounts[t][hit])
        dst = (frames[t] if frames is not None
               else out if t == n_steps - 1 else None)
        cur = stencil_plain(x, *ws[t], out=dst)
    return cur


def _overlaps(a, b) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a0 < b0 + b.numel() * b.element_size()
            and b0 < a0 + a.numel() * a.element_size())


def stencil_rollout(C, n_steps, weights, sources=None, cells=None,
                    amounts=None, frames=None, out=None):
    """``n_steps`` explicit diffusion steps of C (Lx, Ly) in its dtype.

    weights: (ax, ay, axy) for every step, or n_steps such triples (axy = 0
    is the 4-neighbour scheme). sources: optional (n_steps, Lx, Ly), added
    to the field before each step (diffusion_rollout's C + src). cells /
    amounts: optional (k, W) int32 flat cells (i * Ly + j; < 0 injects
    nothing) and amounts in C's dtype, k <= n_steps; before step t < k the
    amounts are added at their cells, duplicates summing in walker order
    (walkers.py's C.at[pos].add), after the dense source. frames: optional
    (n_steps, Lx, Ly) tensor that receives every step's field; else ``out``
    (Lx, Ly), allocated when None, receives the last. Neither may overlap C.
    Returns the last field (frames[-1] when frames are kept)."""
    _check_field(C)
    if C.device.type == "cpu":
        return stencil_rollout_plain(C, n_steps, weights, sources, cells,
                                     amounts, frames, out)
    dev, dt = _build.check_args(dict(field=C)), C.dtype
    # a tensor that goes with the field: its device, contiguous, the shape
    like = lambda name, t, *shape, dtype=dt: _build.check_args(
        {name: t}, (dtype,), {name: shape}, device=dev)
    n = int(n_steps)
    if n < 1:
        raise ValueError("n_steps must be >= 1")
    ws = step_weights(weights, n)
    Lx, Ly = C.shape
    if Lx * Ly >= 2 ** 31:
        raise ValueError("the field must have fewer than 2**31 cells")
    if sources is not None:
        like("sources", sources, n, Lx, Ly)
    W = n_inj = 0
    if cells is not None and cells.numel() == 0:   # no walker: nothing to add
        cells = amounts = None
    if cells is not None:
        if (not isinstance(cells, torch.Tensor) or cells.dim() != 2
                or not 1 <= cells.shape[0] <= n):
            raise ValueError("cells must be a (k, W) tensor with "
                             "1 <= k <= n_steps")
        n_inj, W = cells.shape
        like("cells", cells, n_inj, W, dtype=torch.int32)
        like("amounts", amounts, n_inj, W)
    elif amounts is not None:
        raise ValueError("amounts need cells")
    scratch = None
    if frames is not None:
        like("frames", frames, n, Lx, Ly)
        if out is not None:
            raise ValueError("give frames or out, not both")
        dst = frames
    else:
        if out is None:
            out = torch.empty_like(C, memory_format=torch.contiguous_format)
        like("out", out, Lx, Ly)
        dst = out
        if math.ceil(n / STEPS_PER_LAUNCH[dt]) > 1:
            scratch = torch.empty_like(out)
    if _overlaps(dst, C):
        raise ValueError("out must not overlap the input field")
    w = (ctypes.c_double * (3 * n))(*(x for t in ws for x in t))
    launched = ctypes.c_int(0)
    ptr = lambda t: None if t is None else t.data_ptr()
    _build.launch(
        "stencil", _SIGNATURES, _build.instance("stencil_rollout", dt), dev,
        C.data_ptr(), dst.data_ptr(), ptr(scratch), ptr(sources),
        ptr(cells), ptr(amounts), W, n_inj, Lx, Ly, n, w,
        int(frames is not None), ctypes.byref(launched), n=launched)
    return frames[-1] if frames is not None else out


def stencil(C, ax, ay, axy=0.0, force_tiled=False, out=None):
    """One explicit diffusion step of C (Lx, Ly): interior cells get the
    9-point update with weights ax (first axis), ay (second axis) and axy
    (diagonals; 0 = 4-neighbour scheme), boundary cells are copied. The
    counterpart of diffusion_step_pallas; ``force_tiled`` changes nothing.
    ``out``: an (Lx, Ly) tensor to write into, distinct from C. Returns the
    new field, in C's dtype. The one-step case of ``stencil_rollout``."""
    _check_field(C)
    if C.device.type == "cpu":
        return stencil_plain(C, ax, ay, axy, out)
    return stencil_rollout(C, 1, (ax, ay, axy), out=out)
