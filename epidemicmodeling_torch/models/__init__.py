from .si_alpha import si_alpha_step_fields
from .batch_last import (si_alpha_ekf_system_bl,
                         si_alpha_costate_ekf_system_bl)

__all__ = ["si_alpha_step_fields", "si_alpha_ekf_system_bl",
           "si_alpha_costate_ekf_system_bl"]
