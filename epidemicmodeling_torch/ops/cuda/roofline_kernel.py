"""The card's roofline anchors (B5): CUDA C++ for Hopper.

Replace the Pallas microkernels behind ``bench_kernel`` (bench.py:119:
``fma_kernel`` :108, ``copy_kernel`` :116), which anchor the TPU's roofline.
Source: ``epidemicmodeling_torch/csrc/roofline.cu``. No path of the system
runs them; ``chip_smoke.py`` launches them to measure the float32 rate and
the device-memory rate that the other kernels' bounds assume.

``fma_chain`` (x <- x * 1.0000001 + 1e-9, DEPTH times an element, fused)
is bound by the float32 rate, ``copy_plus_one`` (x + 1) by device memory.
Both launch the kernel for a contiguous float32 CUDA tensor whose size is a
multiple of 4 and that starts on a 16-byte boundary, and raise on anything
else; on a CPU tensor they run their plain versions. ``launches`` counts the
kernel launches.

The copy is a persistent ring of TMA bulk copies (csrc/roofline.cu):
``copy_geometry`` restates its launch, and ``library_copy_geometry`` asks
the built library for the launch on the current card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build as _build

DEPTH = 512
# the kernel's float32 constants, as Python floats
FMA_A, FMA_B = (float(torch.tensor(v, dtype=torch.float32))
                for v in (1.0000001, 1e-9))

launches = 0

_P, _L = ctypes.c_void_p, ctypes.c_longlong
_SIGNATURES = {"roofline_fma": [_P, _P, _L, _P],
               "roofline_copy": [_P, _P, _L, _P]}

# csrc/roofline.cu's copy: threads a block, bytes a chunk (a stage of the
# ring), stages, blocks an SM, and the shared memory a block may take
COPY_THREADS = 256
CHUNK_BYTES = 32768
STAGES = 6
BLOCKS_PER_SM = 1
SMEM_LIMIT = 232448


class CopyGeometry(NamedTuple):
    blocks: int
    stages: int
    chunk_bytes: int
    smem_bytes: int


def copy_geometry(n: int, sms: int) -> CopyGeometry:
    """The copy's launch for n floats on a card of ``sms`` SMs:
    BLOCKS_PER_SM blocks an SM, no more than there are chunks, each with a
    ring of STAGES chunks in dynamic shared memory."""
    if n <= 0 or n % 4:
        raise ValueError("n must be a positive multiple of 4")
    chunks = -(-4 * n // CHUNK_BYTES)
    return CopyGeometry(min(chunks, BLOCKS_PER_SM * sms), STAGES,
                        CHUNK_BYTES, STAGES * CHUNK_BYTES)


def library_copy_geometry(n: int) -> CopyGeometry:
    """The built library's launch of the copy for n floats on the current
    card (roofline_copy_geometry)."""
    lib = _build.load("roofline", _SIGNATURES)
    fn = lib.roofline_copy_geometry
    fn.argtypes = [_L, _P]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    _build.check(lib, "roofline", "roofline_copy_geometry",
                 fn(n, ctypes.addressof(out)))
    return CopyGeometry(*out)


def fma_chain_plain(x):
    """DEPTH steps x <- x * a + b in float64, a and b the kernel's float32
    constants (each kernel step rounds once to float32, so the two differ by
    about DEPTH * 2**-24 relative at most)."""
    y = x.double()
    for _ in range(DEPTH):
        y = y * FMA_A + FMA_B
    return y.to(x.dtype)


def copy_plus_one_plain(x):
    return x + 1.0


def _launch(entry, x, plain):
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        raise ValueError("x must be a float32 tensor")
    if x.device.type == "cpu":
        return plain(x)
    if (x.device.type != "cuda" or not x.is_contiguous() or x.numel() == 0
            or x.numel() % 4 or x.data_ptr() % 16):
        raise ValueError("x must be a contiguous CUDA tensor of 4k > 0 "
                         "elements on a 16-byte boundary")
    out = torch.empty_like(x)
    lib = _build.load("roofline", _SIGNATURES)
    global launches
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = getattr(lib, entry)(x.data_ptr(), out.data_ptr(), x.numel(),
                                   stream)
    _build.check(lib, "roofline", entry, code)
    launches += 1
    return out


def fma_chain(x):
    """DEPTH fused steps x <- x * 1.0000001 + 1e-9 of every element."""
    return _launch("roofline_fma", x, fma_chain_plain)


def copy_plus_one(x):
    """x + 1, one read and one write of x."""
    return _launch("roofline_copy", x, copy_plus_one_plain)
