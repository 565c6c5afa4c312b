"""Diffusion CA with random-walk particle sources.

Counterpart of epidemicmodeling_tpu/spatial/walkers.py. Reference
behaviour: testScripts/testCellularAutomataForPDESolutionWalking.m, random
walkers exhale particles (source injection :69-74) into the diffusing
concentration field each step.

The walks do not depend on the field, so they are computed first, for all
steps at once (``clamped_walk``, a scan in log2(n_steps) tensor passes), and
the injections and the diffusion then run as one call of the multi-step
stencil wrapper: on the card the kernel adds each step's injections in
walker order and makes ceil(n_steps / K) launches.
"""

from __future__ import annotations

import torch

from ..ops.cuda.stencil_kernel import stencil_rollout
from ..utils.device import resolve_device
from .diffusion import as_field, stencil_weights


def clamped_walk(start, steps, lo, hi):
    """Positions after each step of walks x_{t+1} = clamp(x_t + d_t, lo,
    hi): start (W, 2), steps (n, W, 2), lo/hi (2,) integer tensors; returns
    (n, W, 2). Each step is the map x -> clamp(x + a, l, h), and such maps
    compose into one of the same form (clamp(clamp(x + a1, l1, h1) + a2, l2,
    h2) = clamp(x + a1 + a2, clamp(l1 + a2, l2, h2), clamp(h1 + a2, l2,
    h2)), so the prefix maps come from a doubling scan in log2(n) passes of
    exact integer arithmetic, with no pass per step."""
    a = steps.clone()
    lo_, hi_ = lo.expand_as(a).clone(), hi.expand_as(a).clone()
    k = 1
    while k < a.shape[0]:
        a2, l2, h2 = a[k:], lo_[k:], hi_[k:]
        new = (a[:-k] + a2, torch.clamp(lo_[:-k] + a2, l2, h2),
               torch.clamp(hi_[:-k] + a2, l2, h2))
        a[k:], lo_[k:], hi_[k:] = new
        k *= 2
    return torch.clamp(start + a, lo_, hi_)


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
    start = as_field(start, torch.long, dev)
    steps = as_field(steps, torch.long, dev)
    ax, ay, axy = stencil_weights(D, dt, dx, dy)
    if neighborhood == 4:
        axy = 0.0
    # a +-1 step per axis, clipped to the interior; step t injects at the
    # cells before its move
    traj = clamped_walk(start, steps, torch.tensor([1, 1], device=dev),
                        torch.tensor([Lx - 2, Ly - 2], device=dev))
    pos = torch.cat([start[None], traj[:-1]])
    cells = (pos[..., 0] * Ly + pos[..., 1]).to(torch.int32)
    amounts = torch.full((n_steps, n_walkers), float(exhale), dtype=dtype,
                         device=dev)
    C0 = torch.zeros((Lx, Ly), dtype=dtype, device=dev)
    fields = (torch.empty((n_steps, Lx, Ly), dtype=dtype, device=dev)
              if return_fields else None)
    C = stencil_rollout(C0, n_steps, (ax, ay, axy), cells=cells,
                        amounts=amounts, frames=fields)
    if return_fields:
        return C, traj, fields
    return C, traj
