from .ekf import (EKFResult, ekf_smoother, batched_ekf_smoother,
                  backward_ekf_smoother)
from .ekf_bl import EKFSystemBL, EKFResultBL, ekf_smoother_bl
from .ar import ar_fit, ar_fit_burg, ar_forecast
from .smoothing import smooth_series, tikhonov_smooth
from .parallel_kf import parallel_kalman, PKFResult

__all__ = ["EKFResult", "ekf_smoother", "batched_ekf_smoother",
           "backward_ekf_smoother", "EKFSystemBL", "EKFResultBL",
           "ekf_smoother_bl", "ar_fit", "ar_fit_burg", "ar_forecast",
           "smooth_series", "tikhonov_smooth", "parallel_kalman",
           "PKFResult"]
