"""Agent-based 2-D population motion with social forces + exhaled-particle
diffusion coupling.

Counterpart of epidemicmodeling_tpu/spatial/agents.py. Reference behaviour:
testScripts/testPopulation2DMotionDynamics.m:
- N agents with position/velocity/acceleration/jerk integrators, each
  clipped to physical maxima (:100-135)
- moves that land on or cross an obstacle are undone (:104-123)
- pairwise social forces (:140-172): agents attract/repel toward a 6 m
  optimal distance (weight +10), obstacles always repel (weight -5), 1/r^2
  falloff, 15 m cutoff, self and coincident terms dropped
- marked (infected) agents exhale into the concentration field each step,
  which then diffuses with BOTH the 4- and 8-neighbour updates applied back
  to back (:176-189, quirk kept)

The per-agent loops are (N, ...) tensor ops in a Python loop over steps. On
the card the social forces run the pairwise kernel (ops/cuda/
pairwise_kernel.py), and each sim step's exhalation and its two diffusion
steps are one two-step launch of the stencil kernel, with per-step weights.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops.cuda.pairwise_kernel import forces_of_rows, social_forces
from ..ops.cuda.stencil_kernel import stencil_rollout
from ..utils.device import resolve_device
from .diffusion import as_field, stencil_weights


@dataclasses.dataclass(frozen=True)
class PopulationSimConfig:
    """Agent-motion simulation constants; defaults mirror
    testPopulation2DMotionDynamics.m:16-60."""
    n_subjects: int = 150
    dt: float = 0.1
    dl: float = 0.3
    x_min: float = 0.0
    y_min: float = 0.0
    x_max: float = 70.0
    y_max: float = 50.0
    v_max: float = 2.5
    a_max: float = 1.44
    j_max: float = 0.6
    eta_p_std: float = 0.1
    eta_v_std: float = 0.1 / 1.4142135623730951
    eta_a_std: float = 0.01 / 1.4142135623730951
    eta_j_std: float = 0.0
    subject_subject_weight: float = 10.0
    subject_obstacle_weight: float = -5.0
    inter_subject_opt_dist: float = 6.0
    no_further_effect_dist: float = 15.0
    n_marked: int = 2              # infected agents exhaling particles
    exhale_amount: float = 1.0
    diffusion_D: float = 1e-2
    # On the card both values run the pairwise kernel (csrc/pairwise.cu),
    # float32 forces with O(N) device memory per step. On the CPU "xla" is
    # the kernel's plain law, a dense (N, N+O) broadcast, in the positions'
    # dtype and "pallas" the same law in float32, as in the JAX package.
    force_backend: str = "xla"

    def __post_init__(self):
        if self.force_backend not in ("xla", "pallas"):
            raise ValueError(
                f"force_backend={self.force_backend!r} — expected 'xla' or "
                "'pallas' (a typo would silently fall back to the XLA "
                "broadcast, which OOMs beyond N ~ 2e4)")


class PopulationSimResult(NamedTuple):
    """Simulated kinematic histories plus the exhaled-particle field."""
    p: torch.Tensor      # (T, N, 2) positions
    v: torch.Tensor      # (T, N, 2) velocities
    a: torch.Tensor      # (T, N, 2) accelerations
    j: torch.Tensor      # (T, N, 2) jerks
    C: torch.Tensor      # (Lx, Ly) final particle concentration field


def default_environment(cfg: PopulationSimConfig):
    """Walled rectangle with an interior L-shaped wall (reference :42-48).
    Returns NumPy (environment_plan (Lx, Ly) 0/1, obstacle_xy (O, 2)
    meters); 234 x 167 with 914 obstacle points at the defaults."""
    Lx = int(np.ceil((cfg.x_max - cfg.x_min) / cfg.dl))
    Ly = int(np.ceil((cfg.y_max - cfg.y_min) / cfg.dl))
    plan = np.zeros((Lx, Ly))
    plan[0, :] = 1
    plan[-1, :] = 1
    plan[:, 0] = 1
    plan[:, -1] = 1
    plan[round(10.0 / cfg.dl): round(25.0 / cfg.dl), round(10.0 / cfg.dl)] = 1
    plan[round(10.0 / cfg.dl), round(10.0 / cfg.dl): round(30.0 / cfg.dl)] = 1
    ox, oy = np.nonzero(plan)
    obstacle_xy = np.stack([ox * cfg.dl + cfg.x_min,
                            oy * cfg.dl + cfg.y_min], axis=1)
    return plan, obstacle_xy


def _social_forces(pos, obstacle_xy, cfg: PopulationSimConfig):
    """Pairwise forces on each agent from all agents + obstacles, as one
    dense (N, N+O) broadcast in pos's dtype (the pairwise kernel's plain
    law). pos: (N, 2); obstacle_xy: (O, 2). Returns (N, 2)."""
    rows = torch.arange(pos.shape[0], device=pos.device)
    return forces_of_rows(pos, obstacle_xy, cfg, rows, pos.dtype)


def _cells(p, cfg, Lx, Ly):
    """The plan cells (ix, iy) of positions p (N, 2): rounded half to even
    (torch.round, as jnp.round), clipped to the grid."""
    ix = torch.clamp(torch.round((p[:, 0] - cfg.x_min) / cfg.dl), 0, Lx - 1)
    iy = torch.clamp(torch.round((p[:, 1] - cfg.y_min) / cfg.dl), 0, Ly - 1)
    return ix.long(), iy.long()


def _crossed_obstacle(p_old, p_new, obstacle_xy, plan, cfg):
    """Per-agent boolean: did the move land on or cross an obstacle?
    (reference :104-123). p_old/p_new: (N, 2). A vertical move divides by
    zero (IEEE inf/NaN, whose comparisons are false), as in the reference."""
    Lx, Ly = plan.shape
    # landing-cell check
    ix, iy = _cells(p_new, cfg, Lx, Ly)
    landed = plan[ix, iy] > 0

    # path-crossing check: y-distance of each obstacle from the line through
    # (A, B), gated to the segment's bounding box (:111,115)
    xA, yA = p_old[:, 0:1], p_old[:, 1:2]
    xB, yB = p_new[:, 0:1], p_new[:, 1:2]
    ox = obstacle_xy[None, :, 0]
    oy = obstacle_xy[None, :, 1]
    y_line = ((yA - yB) * ox + yB * xA - yA * xB) / (xA - xB)
    y_dist = oy - y_line
    in_box = ((oy <= torch.maximum(yA, yB)) & (oy >= torch.minimum(yA, yB))
              & (ox <= torch.maximum(xA, xB)) & (ox >= torch.minimum(xA, xB)))
    crossing = torch.any((torch.abs(y_dist) <= cfg.dl) & in_box, dim=1)
    return landed | crossing


def population_motion_sim(cfg: PopulationSimConfig, n_steps: int,
                          generator=None, environment=None, p_init=None,
                          v_init=None, a_init=None, j_init=None, *,
                          noise=None, device=None, dtype=None):
    """Run the coupled agent-motion + particle-diffusion simulation.

    environment: (plan (Lx, Ly), obstacle_xy (O, 2)), default
    ``default_environment(cfg)``. Randomness: the start state (p/v/a/j_init,
    each (N, 2)) and the per-step standard-normal draws are drawn from
    ``generator`` (a torch.Generator on the device; None: torch's default)
    unless given; ``noise`` = four (n_steps, N, 2) arrays, the draws of the
    position, velocity, acceleration and jerk noise in that order.
    device: default the device of the first start-state tensor given, else
    the CUDA card (a RuntimeError without one). dtype: default p_init's when
    it is a tensor, else torch's default dtype.

    Returns PopulationSimResult with (T = n_steps, ...) trajectories.
    """
    if environment is None:
        plan, obstacle_xy = default_environment(cfg)
    else:
        plan, obstacle_xy = environment
    given = [a for a in (p_init, v_init, a_init, j_init)
             if isinstance(a, torch.Tensor)]
    dev = resolve_device(device, given[0] if given else None)
    if dtype is None:
        dtype = (p_init.dtype if isinstance(p_init, torch.Tensor)
                 else torch.get_default_dtype())
    N = cfg.n_subjects
    plan = as_field(plan, None, dev)
    Lx, Ly = plan.shape
    obstacle_xy = as_field(obstacle_xy, dtype, dev).reshape(-1, 2)
    draw = dict(generator=generator, dtype=dtype, device=dev)

    if p_init is None:
        u = torch.rand((2, N), **draw)
        p_init = torch.stack([
            (cfg.x_max - cfg.x_min) * u[0] + cfg.x_min,
            (cfg.y_max - cfg.y_min) * u[1] + cfg.y_min], dim=1)
    if v_init is None:
        v_init = torch.clamp_max(0.5 * torch.randn((N, 2), **draw),
                                 cfg.v_max / np.sqrt(2.0))
    if a_init is None:
        a_init = torch.clamp_max(0.1 * torch.randn((N, 2), **draw),
                                 cfg.a_max / np.sqrt(2.0))
    if j_init is None:
        j_init = torch.zeros((N, 2), dtype=dtype, device=dev)
    p, v, a, jj = (as_field(x, dtype, dev)
                   for x in (p_init, v_init, a_init, j_init))
    if noise is not None:
        noise = [as_field(x, dtype, dev) for x in noise]

    # only the marked agents exhale; adding 0.0 for the others, as the
    # reference does, changes no value
    m = min(cfg.n_marked, N)
    amount = torch.full((1, m), cfg.exhale_amount, dtype=dtype, device=dev)
    ax, ay, axy = stencil_weights(cfg.diffusion_D, cfg.dt, cfg.dl, cfg.dl)
    # the 4-neighbour step, then the 8-neighbour one
    weights = ((ax, ay, 0.0), (ax, ay, axy))
    C = torch.zeros((Lx, Ly), dtype=dtype, device=dev)
    ix, iy = _cells(p, cfg, Lx, Ly)
    C.view(-1).index_add_(0, ix[:m] * Ly + iy[:m], amount[0])

    clip2 = lambda x, lim: torch.clamp(x, -lim, lim)
    traj = torch.empty((4, n_steps, N, 2), dtype=dtype, device=dev)
    for t in range(n_steps):
        if noise is None:
            n_p, n_v, n_a, n_j = torch.randn((4, N, 2), **draw)
        else:
            n_p, n_v, n_a, n_j = (x[t] for x in noise)

        p_new = p + cfg.dt * v + cfg.eta_p_std * n_p
        p_new = torch.stack([
            torch.clamp(p_new[:, 0], cfg.x_min, cfg.x_max),
            torch.clamp(p_new[:, 1], cfg.y_min, cfg.y_max)], dim=1)
        undo = _crossed_obstacle(p, p_new, obstacle_xy, plan, cfg)
        p_next = torch.where(undo[:, None], p, p_new)

        v_next = clip2(v + cfg.dt * a + cfg.eta_v_std * n_v, cfg.v_max)
        a_next = clip2(a + cfg.dt * jj + cfg.eta_a_std * n_a, cfg.a_max)
        j_next = clip2(jj + cfg.eta_j_std * n_j, cfg.j_max)

        # social forces evaluated at the PRE-update positions (:141,156)
        if p.is_cuda or cfg.force_backend == "pallas":
            forces = social_forces(p, obstacle_xy, cfg)
        else:
            forces = _social_forces(p, obstacle_xy, cfg)
        a_next = clip2(a_next + forces.to(dtype), cfg.a_max)

        # exhale at pre-update marked positions (duplicate cells sum, as
        # .at[].add does), then diffuse with both neighbourhood updates back
        # to back (:176-189): one two-step call, injecting before the first
        ix, iy = _cells(p, cfg, Lx, Ly)
        cells = (ix[:m] * Ly + iy[:m]).to(torch.int32)[None]
        C = stencil_rollout(C, 2, weights, cells=cells, amounts=amount)

        p, v, a, jj = p_next, v_next, a_next, j_next
        for k, x in enumerate((p, v, a, jj)):
            traj[k, t] = x
    return PopulationSimResult(p=traj[0], v=traj[1], a=traj[2], j=traj[3],
                               C=C)
