from .diffusion import (
    diffusion_step_4, diffusion_step_8, diffusion_rollout, cfl_check)
from .agents import PopulationSimConfig, population_motion_sim

__all__ = ["diffusion_step_4", "diffusion_step_8", "diffusion_rollout",
           "cfl_check", "PopulationSimConfig", "population_motion_sim"]
