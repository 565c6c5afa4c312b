from .estimators import rt_ekf_system, rt_expfit_ekf

__all__ = ["rt_ekf_system", "rt_expfit_ekf"]
