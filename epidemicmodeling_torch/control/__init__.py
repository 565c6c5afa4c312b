from .npi_cost import npi_cost
from .pareto import (pareto_front_mask_batched, epsilon_grid,
                     random_npi_schedules)

__all__ = ["npi_cost", "pareto_front_mask_batched", "epsilon_grid",
           "random_npi_schedules"]
