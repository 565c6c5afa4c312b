from .estimators import (rt_ekf_system, rt_expfit_gen_ratios,
                         rt_expfit_log_lin_reg, rt_expfit_nonlin_ls,
                         rt_expfit_ekf)

__all__ = ["rt_ekf_system", "rt_expfit_gen_ratios", "rt_expfit_log_lin_reg",
           "rt_expfit_nonlin_ls", "rt_expfit_ekf"]
