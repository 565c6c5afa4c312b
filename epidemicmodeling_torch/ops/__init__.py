from .ekf import (EKFResult, ekf_smoother, batched_ekf_smoother,
                  backward_ekf_smoother)
from .ekf_bl import EKFSystemBL, EKFResultBL, ekf_smoother_bl

__all__ = ["EKFResult", "ekf_smoother", "batched_ekf_smoother",
           "backward_ekf_smoother", "EKFSystemBL", "EKFResultBL",
           "ekf_smoother_bl"]
