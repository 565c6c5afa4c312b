from .device import resolve_device
from .math import (clip_lo_hi, clip_hi_lo, symmetrize, clip01,
                   causal_moving_average, filtfilt_ma)
from .dates import date_range_days, num_days_between

__all__ = ["clip_lo_hi", "clip_hi_lo", "symmetrize", "clip01",
           "causal_moving_average", "filtfilt_ma", "date_range_days",
           "num_days_between", "resolve_device"]
