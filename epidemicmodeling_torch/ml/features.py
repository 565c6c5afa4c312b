"""Feature engineering for the ML pipeline.

Counterpart of epidemicmodeling_tpu/ml/features.py:
testScripts/test04FullFeatureExtMLpipeline.m, the holiday/long-weekend
indicator (:96-100), lagged NPI feature stacking (:355), standardization
and the chronological train/test split (:293-383). The calendar feature and
the region window are host NumPy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.math import as_device_tensor


def lagged_features(X, lags, device=None):
    """Stack lagged copies of the feature matrix: X (T, F) with lag list
    [0, 1, 7, ...] -> (T, F * len(lags)); missing history zero-padded
    (test04:355). Runs on ``device``, else where ``X`` lies when it is a
    tensor, else on the CUDA card."""
    X = as_device_tensor(X, device)
    cols = []
    for lag in lags:
        if lag == 0:
            cols.append(X)
        else:
            cols.append(torch.cat([X.new_zeros((lag, X.shape[1])), X[:-lag]]))
    return torch.cat(cols, dim=1)


def long_weekend_feature(dates, device=None):
    """1.0 on weekends and adjacent bridge days (the reference's holiday
    long-weekend feature, test04:96-100). dates: sequence of ISO strings or
    numpy datetime64. Returns a float64 tensor on ``device`` (else the CUDA
    card)."""
    d = np.asarray(dates, dtype="datetime64[D]")
    # 1970-01-01 (day 0) was a Thursday => +3 makes 0 = Monday
    dow = ((d.astype("datetime64[D]").view("int64") + 3) % 7)
    weekend = (dow == 5) | (dow == 6)
    bridge = np.zeros_like(weekend)
    # Friday before a Saturday, Monday after a Sunday
    bridge[:-1] |= weekend[1:] & (dow[:-1] == 4)
    bridge[1:] |= weekend[:-1] & (dow[1:] == 0)
    return as_device_tensor((weekend | bridge).astype(float), device)


def standardize(X, axis=0, eps=1e-12, device=None):
    """(X - mean) / std along axis, the population std (ddof 0, as
    ``jnp.std``); a std at or below ``eps`` is taken as 1. Returns
    (Xs, mean, std)."""
    X = as_device_tensor(X, device)
    mu = X.mean(dim=axis, keepdim=True)
    sd = X.std(dim=axis, keepdim=True, correction=0)
    sd = torch.where(sd > eps, sd, torch.ones_like(sd))
    return (X - mu) / sd, mu, sd


def train_test_split_time(X, y, train_fraction: float = 0.8):
    """Chronological split (no shuffling: time series)."""
    T = X.shape[0]
    cut = int(T * train_fraction)
    return (X[:cut], y[:cut]), (X[cut:], y[cut:])


def region_window_mask(dates, confirmed, criterion: str = "MIN_CASE_BASED",
                       min_cases: float = 100.0, start_date: int = 0,
                       end_date: int = 99999999):
    """Per-region processing-window selection
    (test04FullFeatureExtMLpipeline.m:16,83-90), host NumPy:

    - ``MIN_CASE_BASED``: days with ConfirmedCases > min_cases, up to
      end_date (the epidemic-onset criterion)
    - ``DATE_BASED``: start_date <= date <= end_date
    - ``DATA_OR_MIN_CASE_BASED``: both conditions jointly

    dates: (T,) ints YYYYMMDD; confirmed: (T,) cumulative cases (NaN =
    not reporting, never selected by the case criterion). Returns a (T,)
    boolean NumPy mask.
    """
    dates = np.asarray(dates)
    confirmed = np.asarray(confirmed, float)
    in_end = dates <= end_date
    case_ok = np.where(np.isnan(confirmed), False, confirmed > min_cases)
    if criterion == "MIN_CASE_BASED":
        return case_ok & in_end
    if criterion == "DATE_BASED":
        return (dates >= start_date) & in_end
    if criterion == "DATA_OR_MIN_CASE_BASED":
        return case_ok & (dates >= start_date) & in_end
    raise ValueError(f"unknown start_date_criterion {criterion!r}")
