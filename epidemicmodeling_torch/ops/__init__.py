from .ekf_bl import EKFSystemBL, EKFResultBL, ekf_smoother_bl

__all__ = ["EKFSystemBL", "EKFResultBL", "ekf_smoother_bl"]
