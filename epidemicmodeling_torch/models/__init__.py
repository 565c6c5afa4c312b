from .base import EKFSystem
from .sir import sir_step, sir_rollout
from .seirp import (seirp_step, seirp_rollout, seirp_saturated_step,
                    seirp_saturated_rollout, seirp_linearized_matrices)
from .si_alpha import (si_controlled_rollout, si_alpha_step,
                       si_alpha_step_fields, si_alpha_controlled_rollout,
                       SIAlphaParams, si_alpha_ekf_system)
from .costate import si_alpha_costate_ekf_system, bang_bang_fill
from .backward import (si_alpha_backward_ekf_system,
                       si_alpha_costate_backward_ekf_system)
from .batch_last import (si_alpha_ekf_system_bl,
                         si_alpha_costate_ekf_system_bl)

__all__ = ["EKFSystem", "sir_step", "sir_rollout", "seirp_step",
           "seirp_rollout", "seirp_saturated_step",
           "seirp_saturated_rollout", "seirp_linearized_matrices",
           "si_controlled_rollout", "si_alpha_step",
           "si_alpha_step_fields", "si_alpha_controlled_rollout",
           "SIAlphaParams", "si_alpha_ekf_system",
           "si_alpha_costate_ekf_system", "bang_bang_fill",
           "si_alpha_backward_ekf_system",
           "si_alpha_costate_backward_ekf_system", "si_alpha_ekf_system_bl",
           "si_alpha_costate_ekf_system_bl"]
