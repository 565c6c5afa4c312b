"""2-D diffusion PDE cellular automaton (4- and 8-neighbour discretizations).

Counterpart of epidemicmodeling_tpu/spatial/diffusion.py. Reference
behaviour: testScripts/testCellularAutomataForPDESolution.m:43-49, explicit
interior-point stencil updates with Dirichlet (frozen) boundaries and the
CFL-style stability check at :35-37.

A rollout is one call of the multi-step stencil wrapper
(ops/cuda/stencil_kernel.py), so the device decides what runs it: the
hand-written CUDA kernel for a field on the card (ceil(n / K) launches, the
sources added inside the kernel), its plain PyTorch version for a field on
the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda.stencil_kernel import stencil, stencil_rollout
from ..utils.device import resolve_device

CFL_MESSAGE = ("Stability condition for parameters not fulfilled. "
               "Make simulation time period smaller")


def stencil_weights(D, dt, dx, dy):
    """(ax, ay, axy) of the explicit schemes."""
    return D * dt / dx ** 2, D * dt / dy ** 2, D * dt / (dx ** 2 + dy ** 2)


def cfl_check(D, dt, dx, dy):
    """Stability condition of the explicit schemes (reference :35-37).
    Returns (ok4, ok8)."""
    ax, ay, axy = stencil_weights(D, dt, dx, dy)
    return (1 - 2 * ax - 2 * ay) >= 0, (1 - 2 * ax - 2 * ay - 4 * axy) >= 0


def diffusion_step_4(C, D, dt, dx, dy):
    """One 4-neighbour explicit step of C (Lx, Ly); boundary rows/cols are
    left unchanged (the reference only updates interior indices 2:L-1)."""
    ax, ay, _ = stencil_weights(D, dt, dx, dy)
    return stencil(C, ax, ay, 0.0)


def diffusion_step_8(C, D, dt, dx, dy):
    """One 8-neighbour explicit step (diagonal coupling via axy)."""
    return stencil(C, *stencil_weights(D, dt, dx, dy))


def as_field(a, dtype=None, device=None) -> torch.Tensor:
    """``a`` as a contiguous tensor on ``device``, in ``dtype`` (default: its
    own; NumPy input keeps its NumPy dtype)."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))
    return a.to(device=device, dtype=dtype or a.dtype).contiguous()


def diffusion_rollout(C0, D, dt, dx, dy, n_steps, neighborhood: int = 4,
                      sources=None, use_pallas: bool = False, device=None,
                      dtype=None):
    """Roll the CA for n_steps; returns (n_steps+1, Lx, Ly) including C0.

    sources: optional (n_steps, Lx, Ly) array added BEFORE each diffusion
    update (exhalation injection,
    testCellularAutomataForPDESolutionWalking.m:69-74); when given, its
    length sets the number of steps, as in the JAX package.
    use_pallas: accepted for the JAX signature; the device decides (kernel
    on the card, plain version on the CPU).
    device: default the device of C0 when it is a tensor, else the CUDA card
    (a RuntimeError without one). dtype: default C0's.
    """
    dev = resolve_device(device, C0)
    C0 = as_field(C0, dtype, dev)
    ok4, ok8 = cfl_check(D, dt, dx, dy)
    ax, ay, axy = stencil_weights(D, dt, dx, dy)
    if neighborhood == 4:
        if not bool(ok4):
            raise ValueError(CFL_MESSAGE)
        axy = 0.0
    elif neighborhood == 8:
        if not bool(ok8):
            raise ValueError(CFL_MESSAGE)
    else:
        raise ValueError("neighborhood must be 4 or 8")

    if sources is not None:
        sources = as_field(sources, C0.dtype, dev)
        n_steps = sources.shape[0]
    traj = torch.empty((n_steps + 1,) + tuple(C0.shape), dtype=C0.dtype,
                       device=dev)
    traj[0] = C0
    if n_steps > 0:
        stencil_rollout(traj[0], n_steps, (ax, ay, axy), sources=sources,
                        frames=traj[1:])
    return traj
