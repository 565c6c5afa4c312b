"""Diffusion CA with random-walk particle sources.

Counterpart of epidemicmodeling_tpu/spatial/walkers.py. Reference
behaviour: testScripts/testCellularAutomataForPDESolutionWalking.m, random
walkers exhale particles (source injection :69-74) into the diffusing
concentration field each step.
"""

from __future__ import annotations

import torch

from ..ops.cuda.stencil_kernel import stencil
from ..utils.device import resolve_device
from .diffusion import as_field, stencil_weights


def walking_sources_sim(Lx: int, Ly: int, n_walkers: int, n_steps: int,
                        D: float, dt: float, dx: float, dy: float,
                        exhale: float, generator=None, neighborhood: int = 4,
                        return_fields: bool = False, *, start=None,
                        steps=None, device=None, dtype=None):
    """Random walkers injecting ``exhale`` into their current cell each step
    while the field diffuses (4-neighbour scheme when ``neighborhood`` is 4,
    else 8). Returns (C (Lx, Ly) final field, positions (n_steps, n_walkers,
    2)); with ``return_fields=True`` returns (C, positions, fields
    (n_steps, Lx, Ly)), the per-step frames the reference renders to video
    (testCellularAutomataForPDESolutionWalking.m:65-101).

    Randomness: the start cells (n_walkers, 2), uniform over the interior,
    and the per-step moves (n_steps, n_walkers, 2) in {-1, 0, 1} are drawn
    from ``generator`` (a torch.Generator on the device; None: torch's
    default) unless ``start`` / ``steps`` give them. jax.random draws cannot
    be reproduced, so the tests hand both packages the same numbers.
    device: default the device of ``start`` or ``steps`` when a tensor, else
    the CUDA card. dtype: the field's, default torch's default dtype.
    """
    dev = resolve_device(device, start if start is not None else steps)
    dtype = dtype or torch.get_default_dtype()
    draw = dict(generator=generator, device=dev)
    if start is None:
        start = torch.stack([
            torch.randint(1, Lx - 1, (n_walkers,), **draw),
            torch.randint(1, Ly - 1, (n_walkers,), **draw)], dim=1)
    if steps is None:
        steps = torch.randint(-1, 2, (n_steps, n_walkers, 2), **draw)
    pos = as_field(start, torch.long, dev)
    steps = as_field(steps, torch.long, dev)
    ax, ay, axy = stencil_weights(D, dt, dx, dy)
    if neighborhood == 4:
        axy = 0.0
    lo = torch.tensor([1, 1], device=dev)
    hi = torch.tensor([Lx - 2, Ly - 2], device=dev)
    amount = torch.full((n_walkers,), float(exhale), dtype=dtype, device=dev)

    C = torch.zeros((Lx, Ly), dtype=dtype, device=dev)
    traj = torch.empty((n_steps, n_walkers, 2), dtype=torch.long, device=dev)
    fields = (torch.empty((n_steps, Lx, Ly), dtype=dtype, device=dev)
              if return_fields else None)
    for t in range(n_steps):
        # inject at the current cells (a scatter-add: duplicates sum), then
        # diffuse; the injection is out of place, since C may be a stored
        # frame
        C = torch.index_add(C.reshape(-1), 0, pos[:, 0] * Ly + pos[:, 1],
                            amount).view(Lx, Ly)
        C = stencil(C, ax, ay, axy,
                    out=fields[t] if return_fields else None)
        # a +-1 step per axis, clipped to the interior
        pos = torch.clamp(pos + steps[t], lo, hi)
        traj[t] = pos
    if return_fields:
        return C, traj, fields
    return C, traj
