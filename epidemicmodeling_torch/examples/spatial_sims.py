"""Spatial simulation driver (testScripts/testCellularAutomataForPDESolution*.m
+ testPopulation2DMotionDynamics.m): diffusion method comparison, walking
sources, and the social-force population sim. On the card the diffusion
steps run the stencil kernel and the agents' social forces the pairwise
kernel.

--video OUT.mp4 (or .gif) additionally renders the walker-CA field and the
population-motion agents as animations — the reference writes AVI videos of
both (testCellularAutomataForPDESolutionWalking.m:65-101,
testPopulation2DMotionDynamics.m rendering loop). Two files are written,
suffixed _walkers and _agents; without ffmpeg the writer falls back to gif.

Usage: python -m epidemicmodeling_torch.examples.spatial_sims [--video OUT] [--device cpu]
"""

import argparse
import os

import numpy as np
import torch

from ..spatial import (PopulationSimConfig, diffusion_rollout,
                       population_motion_sim)
from ..spatial.walkers import walking_sources_sim
from ..utils.device import resolve_device
from ..utils.math import host_array
from ._common import cpu_generator

GRID = 51
N_WALKERS, WALK_STEPS = 2, 250
SIM_STEPS = 500


def walker_draws(generator: torch.Generator, Lx=GRID, Ly=GRID,
                 n_walkers=N_WALKERS, n_steps=WALK_STEPS):
    """The walkers' start cells (uniform over the interior) and per-step
    moves in {-1, 0, 1}, drawn on the CPU as walking_sources_sim draws
    them."""
    start = torch.stack([
        torch.randint(1, Lx - 1, (n_walkers,), generator=generator),
        torch.randint(1, Ly - 1, (n_walkers,), generator=generator)], dim=1)
    steps = torch.randint(-1, 2, (n_steps, n_walkers, 2),
                          generator=generator)
    return start, steps


def sim_draws(cfg: PopulationSimConfig, n_steps: int,
              generator: torch.Generator, dtype):
    """The agent sim's start state (population_motion_sim's distributions)
    and its four (n_steps, N, 2) per-step standard-normal draws, drawn on
    the CPU. Returns (dict of p/v/a/j_init, noise)."""
    N = cfg.n_subjects
    draw = dict(generator=generator, dtype=dtype)
    u = torch.rand((2, N), **draw)
    init = dict(
        p_init=torch.stack([(cfg.x_max - cfg.x_min) * u[0] + cfg.x_min,
                            (cfg.y_max - cfg.y_min) * u[1] + cfg.y_min], 1),
        v_init=torch.clamp_max(0.5 * torch.randn((N, 2), **draw),
                               cfg.v_max / np.sqrt(2.0)),
        a_init=torch.clamp_max(0.1 * torch.randn((N, 2), **draw),
                               cfg.a_max / np.sqrt(2.0)),
        j_init=torch.zeros((N, 2), dtype=dtype))
    z = torch.randn((4, n_steps, N, 2), **draw)
    return init, tuple(z)


def main(video=None, *, device=None, dtype=None, walks=None, sim_inputs=None):
    """Run the three simulations. walks: (start, steps) of the walkers,
    default walker_draws of a CPU generator seeded with 0; sim_inputs:
    (init dict, noise) of the agent sim, default sim_draws of one seeded
    with 1. dtype: the walkers' field and the agents' (default torch's),
    the diffusion field keeps its NumPy float64 unless given. Returns the
    printed numbers and the final fields and trajectories."""
    device = resolve_device(device)
    # two-point-source diffusion, both discretizations (reference grid 51x51)
    C0 = np.zeros((GRID, GRID))
    C0[25, 25] = 1.0
    C0[16, 12] = 1.0
    c4 = diffusion_rollout(C0, 1e-1, 0.01, 0.1, 0.1, 249, neighborhood=4,
                           device=device, dtype=dtype)[-1]
    c8 = diffusion_rollout(C0, 1e-1, 0.01, 0.1, 0.1, 249, neighborhood=8,
                           device=device, dtype=dtype)[-1]
    corr = np.corrcoef(host_array(c4).ravel(), host_array(c8).ravel())[0, 1]
    peaks = (float(c4.max()), float(c8.max()))
    print(f"diffusion: 4- vs 8-neighbor field correlation after 249 steps: "
          f"{corr:.4f}; peaks {peaks[0]:.4e} / {peaks[1]:.4e}")

    start, steps = walks if walks is not None else \
        walker_draws(cpu_generator(0))
    C, traj, fields = walking_sources_sim(
        GRID, GRID, n_walkers=N_WALKERS, n_steps=WALK_STEPS, D=1e-2,
        dt=0.01, dx=0.1, dy=0.1, exhale=1.0, return_fields=True,
        start=start, steps=steps, device=device, dtype=dtype)
    walk_mass = float(C.sum())
    print(f"walking sources: total exhaled mass in field {walk_mass:.1f}"
          f" after 250 steps")

    # the reference's N=150 agents; on the card the forces run the pairwise
    # kernel (ops/cuda/pairwise_kernel.py), which scales to N ~ 1e5
    cfg = PopulationSimConfig(n_subjects=150)
    sim_dtype = dtype or torch.get_default_dtype()
    init, noise = sim_inputs if sim_inputs is not None else \
        sim_draws(cfg, SIM_STEPS, cpu_generator(1), sim_dtype)
    res = population_motion_sim(cfg, n_steps=SIM_STEPS, **init, noise=noise,
                                device=device, dtype=sim_dtype)
    speed = np.linalg.norm(host_array(res.v[-1]), axis=1)
    field_total = float(res.C.sum())
    print(f"population sim: 150 agents x {SIM_STEPS} steps; mean speed "
          f"{speed.mean():.2f} m/s; particle field total "
          f"{field_total:.0f}")

    videos = None
    if video:
        from ..spatial.agents import default_environment
        from ..viz import animate_agents, animate_field
        stem, ext = os.path.splitext(video)
        p1 = animate_field(host_array(fields), f"{stem}_walkers{ext}",
                           points=host_array(traj), every=2,
                           title="walking exhalation sources")
        _, obstacle_xy = default_environment(cfg)
        p2 = animate_agents(host_array(res.p), f"{stem}_agents{ext}",
                            obstacle_xy=host_array(obstacle_xy), every=4,
                            bounds=(cfg.x_min, cfg.x_max,
                                    cfg.y_min, cfg.y_max),
                            title="population motion (social forces)")
        videos = (p1, p2)
        print(f"videos written: {p1}, {p2}")
    return dict(corr=corr, peaks=peaks, walk_mass=walk_mass,
                mean_speed=float(speed.mean()), field_total=field_total,
                c4=c4, c8=c8, walk_field=C, walk_traj=traj, sim=res,
                videos=videos)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--video", default=None,
                    help="render animations to this path "
                         "(.mp4 with ffmpeg, .gif otherwise); two files "
                         "are written, suffixed _walkers and _agents")
    ap.add_argument("--device", default=None,
                    help="where to run (default: the CUDA card)")
    a = ap.parse_args()
    main(video=a.video, device=a.device)
