from .linear_systems import (obsv, ctrb, seirp_early_phase_matrix,
                             seirp_jacobian, seirp_early_eigen,
                             seirp_early_closed_form)
from .seirp_scenarios import SEIRP_SCENARIOS, run_seirp_scenario
from .shooting import (si_alpha_hamiltonian_shooting,
                       si_alpha_multiplicative_shooting,
                       si_continuous_control)
from .country_stats import (mortality_rate, active_cases,
                            r0_generation_ratio, causal_moving_average,
                            lagged_case_rate)

__all__ = [
    "obsv", "ctrb", "seirp_early_phase_matrix", "seirp_jacobian",
    "seirp_early_eigen", "seirp_early_closed_form",
    "SEIRP_SCENARIOS", "run_seirp_scenario",
    "si_alpha_hamiltonian_shooting", "si_alpha_multiplicative_shooting",
    "si_continuous_control",
    "mortality_rate", "active_cases", "r0_generation_ratio",
    "causal_moving_average", "lagged_case_rate",
]
