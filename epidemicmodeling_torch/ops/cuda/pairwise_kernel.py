"""The pairwise social-force kernel (B3): CUDA C++ for Hopper.

Replaces the Pallas kernel behind ``social_forces_pallas``
(epidemicmodeling_tpu/ops/pallas/pairwise.py:101): ``_pairwise_pallas`` :79
(body ``_pairwise_kernel`` :33). Source:
``epidemicmodeling_torch/csrc/pairwise.cu``.

What bounds it on the card: operations, N * (N + O) pairs of 14 float32
operations, an IEEE square root and division among them; the bytes are
O(N + O). The grid splits the rows into tiles of THREADS * ROWS_PER_THREAD
and the sources into chunks; each block stages its chunk into shared memory
at once and sums each of its rows over it (ROWS_PER_THREAD rows a thread),
writing per-chunk partial sums to a scratch tensor, which a second kernel
sums per row in chunk order. ``pairwise_geometry`` picks the chunks. The
ragged edges are masked by index, so nothing is padded.

``social_forces`` launches the kernel for CUDA tensors and raises on what it
cannot take; for a CPU tensor it runs ``social_forces_plain``, the same law
as one (N, N + O) broadcast. Both compute in float32 whatever the input
dtype, as social_forces_pallas does, and cast the forces back to the
positions' dtype. ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from . import build as _build

launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"pairwise_forces": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F,
                                     _F, _F, _P]}
_DTYPES = (torch.float32, torch.float64)
F32 = torch.float32

# The kernel's launch constants (csrc/pairwise.cu: THREADS, ROWS,
# MIN_BLOCKS, MAX_CHUNK) and the card the grid is sized for (an H100's 132
# SMs)
THREADS = 256
ROWS_PER_THREAD = 2
MIN_BLOCKS_PER_SM = 2        # __launch_bounds__: registers for 2 blocks
MAX_CHUNK = 4096             # sources a block stages: 32 KiB
MIN_CHUNK = 128
SMS = 132
TARGET_BLOCKS = 8 * SMS      # enough blocks to fill every SM 8 deep


class PairwiseGeometry(NamedTuple):
    """The pairwise kernel's launch: a (row_tiles, chunks) grid of
    ``threads``-thread blocks, each owning ``threads * rows_per_thread``
    agent rows and ``chunk`` consecutive sources (the last chunk ragged)
    staged in ``smem_bytes`` of shared memory; partial sums go to a
    ``scratch`` (chunks, N, 2) float32 tensor."""
    threads: int
    rows_per_thread: int
    row_tiles: int
    chunks: int
    chunk: int
    smem_bytes: int
    scratch: tuple


def pairwise_geometry(N: int, O: int) -> PairwiseGeometry:
    """The launch geometry for N agents and O obstacle points. Enough
    source chunks that the grid has about TARGET_BLOCKS blocks, but none
    smaller than MIN_CHUNK sources and none larger than MAX_CHUNK; the
    chunk size is then evened out so that no chunk is empty."""
    if N < 1 or O < 0:
        raise ValueError(f"need N >= 1 and O >= 0 (got N={N}, O={O})")
    M = N + O
    row_tiles = math.ceil(N / (THREADS * ROWS_PER_THREAD))
    chunks = max(min(math.ceil(TARGET_BLOCKS / row_tiles),
                     math.ceil(M / MIN_CHUNK)),
                 math.ceil(M / MAX_CHUNK))
    chunk = math.ceil(M / chunks)
    chunks = math.ceil(M / chunk)
    return PairwiseGeometry(THREADS, ROWS_PER_THREAD, row_tiles, chunks,
                            chunk, 8 * chunk, (chunks, N, 2))


def _check_points(**named) -> None:
    for name, t in named.items():
        if (not isinstance(t, torch.Tensor) or t.dim() != 2
                or t.shape[1] != 2):
            raise ValueError(f"{name} must be an (n, 2) tensor")
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name} must be float32 or float64 "
                             f"(got {t.dtype})")


def pair_terms(pos, obstacle_xy, cfg, rows, dtype=F32):
    """The force law's terms on the agents ``rows`` (indices into pos)
    from all N agents and O obstacles: (tx, ty), each a (len(rows), N + O)
    broadcast in ``dtype`` on pos's device, the force on row i being
    (sum_k tx_ik, sum_k ty_ik). Computed in the order of the JAX package's
    dense path, w * sign * (dx, dy) / d^3."""
    p = pos.to(dtype)
    src = torch.cat([p, obstacle_xy.to(pos.device, dtype)])      # (M, 2)
    N, M = p.shape[0], src.shape[0]
    r = p[rows]
    dx = r[:, 0:1] - src[None, :, 0]                              # (R, M)
    dy = r[:, 1:2] - src[None, :, 1]
    d2 = dx * dx + dy * dy
    # the correctly rounded root, as IEEE sqrtf gives it on the card. On the
    # CPU, PyTorch's root is MKL's vector math run from several threads, and
    # its first call in a process can run one thread's share at low accuracy
    # (PERF.md, Findings); NumPy's root is the IEEE one.
    d = (torch.from_numpy(np.sqrt(d2.numpy())) if d2.device.type == "cpu"
         else torch.sqrt(d2))
    col = torch.arange(M, device=pos.device)
    subject = col < N
    sign = torch.where(subject[None, :],
                       torch.sign(cfg.inter_subject_opt_dist - d), -1.0)
    sign = torch.where(d > cfg.no_further_effect_dist, 0.0, sign)
    w = torch.where(subject, float(cfg.subject_subject_weight),
                    float(cfg.subject_obstacle_weight)).to(dtype)
    # zero the self-interaction: source column k is agent row k
    ws = torch.where(rows.to(pos.device)[:, None] == col[None, :], 0.0,
                     w[None, :]) * sign
    d3 = d ** 3
    # drop coincident points (d2 = 0), whose terms are 0 / 0
    positive = d2 > 0.0
    return (torch.where(positive, ws * dx / d3, 0.0),
            torch.where(positive, ws * dy / d3, 0.0))


def forces_of_rows(pos, obstacle_xy, cfg, rows, dtype=F32):
    """The plain force law on the agents ``rows`` (see pair_terms), in
    ``dtype``. Returns (len(rows), 2) in ``dtype``."""
    tx, ty = pair_terms(pos, obstacle_xy, cfg, rows, dtype)
    return torch.stack([torch.sum(tx, dim=1), torch.sum(ty, dim=1)], dim=-1)


def social_forces_plain(pos, obstacle_xy, cfg):
    """The kernel's plain PyTorch version: forces (N, 2) on every agent
    (pos (N, 2)) from all agents and obstacles (obstacle_xy (O, 2)),
    computed in float32 on pos's device and returned in pos's dtype."""
    _check_points(pos=pos, obstacle_xy=obstacle_xy)
    rows = torch.arange(pos.shape[0], device=pos.device)
    return forces_of_rows(pos, obstacle_xy, cfg, rows).to(pos.dtype)


def social_forces(pos, obstacle_xy, cfg):
    """Pairwise social forces on N agents: pos (N, 2), obstacle_xy (O, 2),
    cfg a PopulationSimConfig (its weights, optimal distance and cutoff).
    Agents attract or repel toward the optimal distance, obstacles repel,
    with 1/d^2 falloff; zero beyond the cutoff, for self-pairs and for
    coincident points. float32 compute; returns (N, 2) in pos's dtype. The
    counterpart of social_forces_pallas."""
    _check_points(pos=pos, obstacle_xy=obstacle_xy)
    if pos.device.type == "cpu":
        return social_forces_plain(pos, obstacle_xy, cfg)
    if pos.device.type != "cuda" or obstacle_xy.device != pos.device:
        raise ValueError(f"pos and obstacle_xy must be CUDA tensors on one "
                         f"device (got {pos.device} and "
                         f"{obstacle_xy.device})")
    if not (pos.is_contiguous() and obstacle_xy.is_contiguous()):
        raise ValueError("pos and obstacle_xy must be contiguous")
    p, o = pos.to(F32), obstacle_xy.to(F32)
    N, O = p.shape[0], o.shape[0]
    out = torch.empty((N, 2), dtype=F32, device=pos.device)
    if N == 0:
        return out.to(pos.dtype)
    if p.data_ptr() % 8 or (O and o.data_ptr() % 8):
        raise ValueError("pos and obstacle_xy must start on an 8-byte "
                         "boundary (the kernel reads (x, y) pairs)")
    g = pairwise_geometry(N, O)
    partial = torch.empty(g.scratch, dtype=F32, device=pos.device)
    lib = _build.load("pairwise", _SIGNATURES)
    global launches
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        code = lib.pairwise_forces(
            p.data_ptr(), o.data_ptr(), partial.data_ptr(), out.data_ptr(),
            N, O, g.chunk, g.chunks, float(cfg.subject_subject_weight),
            float(cfg.subject_obstacle_weight),
            float(cfg.inter_subject_opt_dist),
            float(cfg.no_further_effect_dist), stream)
    _build.check(lib, "pairwise", "pairwise_forces", code)
    launches += 1
    return out.to(pos.dtype)
