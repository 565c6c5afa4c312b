"""The diffusion-stencil kernel (B4): CUDA C++ for Hopper.

Replaces the Pallas kernels behind ``diffusion_step_pallas``
(epidemicmodeling_tpu/ops/pallas/stencil.py:114): ``_diffusion_pallas`` :44
(body ``_stencil_kernel`` :29) and ``_diffusion_pallas_tiled`` :82 (body
``_stencil_tiled_kernel`` :56). Source:
``epidemicmodeling_torch/csrc/stencil.cu``.

What bounds it on the card: bytes, one read and one write of the field per
step (2 * 4 * Lx * Ly in float32). One thread per cell, threads along the
contiguous Ly axis, neighbours through L1/L2. The whole-grid / row-panel
split of the Pallas version exists because of the TPU's VMEM; here one
kernel covers every size, and ``force_tiled`` is accepted and changes
nothing.

``stencil`` launches the kernel for a CUDA tensor (float32 or float64,
contiguous) and raises on anything it cannot take. For a CPU tensor it runs
``stencil_plain``, the same update as one PyTorch slicing expression, in the
field's dtype. ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import build as _build

launches = 0

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    "stencil_f32": [_P, _P, _I, _I, _D, _D, _D, _D, _P],
    "stencil_f64": [_P, _P, _I, _I, _D, _D, _D, _D, _P],
}
_ENTRY = {torch.float32: "stencil_f32", torch.float64: "stencil_f64"}


def _check_field(C) -> None:
    if not isinstance(C, torch.Tensor) or C.dim() != 2:
        raise ValueError("the field must be a 2-D tensor (Lx, Ly)")
    if C.dtype not in _ENTRY:
        raise ValueError(f"the field must be float32 or float64 "
                         f"(got {C.dtype})")


def stencil_plain(C, ax, ay, axy=0.0, out=None):
    """The kernel's plain PyTorch version: one explicit 9-point diffusion
    step of the field C (Lx, Ly) in its dtype, on any device; the boundary
    is copied unchanged, and axy = 0 is the 4-neighbour scheme. Writes into
    ``out`` when given. Returns the new field."""
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


def stencil(C, ax, ay, axy=0.0, force_tiled=False, out=None):
    """One explicit diffusion step of C (Lx, Ly): interior cells get the
    9-point update with weights ax (first axis), ay (second axis) and axy
    (diagonals; 0 = 4-neighbour scheme), boundary cells are copied. The
    counterpart of diffusion_step_pallas; ``force_tiled`` changes nothing.
    ``out``: an (Lx, Ly) tensor to write into, distinct from C. Returns the
    new field, in C's dtype."""
    _check_field(C)
    if C.device.type == "cpu":
        return stencil_plain(C, ax, ay, axy, out)
    if C.device.type != "cuda":
        raise ValueError(f"the field is on {C.device}: expected a CUDA or "
                         "CPU tensor")
    if not C.is_contiguous():
        raise ValueError("the field must be contiguous")
    if out is None:
        out = torch.empty_like(C, memory_format=torch.contiguous_format)
    elif (out.device != C.device or out.dtype != C.dtype
          or out.shape != C.shape or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {C.dtype} CUDA tensor "
                         f"of shape {tuple(C.shape)} on {C.device}")
    elif out.data_ptr() == C.data_ptr():
        raise ValueError("out must not be the input field")
    ax, ay, axy = float(ax), float(ay), float(axy)
    c0 = 1.0 - 2.0 * ax - 2.0 * ay - 4.0 * axy
    entry = _ENTRY[C.dtype]
    lib = _build.load("stencil", _SIGNATURES)
    global launches
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream(C.device).cuda_stream
        code = getattr(lib, entry)(C.data_ptr(), out.data_ptr(), C.shape[0],
                                   C.shape[1], c0, ax, ay, axy, stream)
    _build.check(lib, "stencil", entry, code)
    launches += 1
    return out
