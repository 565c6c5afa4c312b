"""Direct new-cases multivariate closed-loop LSTM
(testScripts/test05DirectNewCasesLearning.m).

Trains an LSTM on [new cases, NPI levels, lagged NPIs] features to predict
next-day new cases DIRECTLY (no EKF in the loop), then rolls it out
closed-loop over a held-out tail: the case channel is fed back
autoregressively (predictAndUpdateState semantics, test05:216-233) while
the NPI channels follow the actual schedule. Prints the closed-loop MAE
against ground truth and a last-value persistence baseline.

Usage: python -m epidemicmodeling_torch.examples.direct_newcases_lstm [--device cpu]
"""

import sys

import numpy as np
import torch

from ..data import synthetic_oxford_frame
from ..ml import (LSTMForecaster, lagged_features, rollout_forecast_exog,
                  standardize, train_forecaster)
from ..utils.device import resolve_device
from ..utils.math import host_array
from ._common import cpu_generator, split_device


def main(n_days=220, hidden=16, epochs=120, seed=0, *, device=None,
         params=None):
    """Train and roll out. params: the initial weights (a state_dict, e.g.
    lstm_params_from_flax of the flax model's), default flax-distributed
    draws from a CPU generator seeded with ``seed``. Returns the
    closed-loop MAE, the persistence MAE, the losses and the rollout."""
    device = resolve_device(device)
    frame, _, _ = synthetic_oxford_frame(n_regions=1, n_days=n_days,
                                         seed=seed)
    npi_cols = [c for c in frame if c[0] in "CH" and "_" in c]
    order = np.argsort(frame["Date"], kind="stable")
    confirmed = np.asarray(frame["ConfirmedCases"], float)[order]
    new_cases = np.maximum(np.diff(confirmed, prepend=0.0), 0.0)
    # 7-day causal smoothing like the reference's preprocessing
    kern = np.ones(7) / 7.0
    smoothed = np.convolve(new_cases, kern)[:len(new_cases)]
    cases_std = standardize(smoothed[:, None], device=device)[0][:, 0]

    U = torch.as_tensor(np.column_stack(
        [np.asarray(frame[c], float)[order] for c in npi_cols]),
        device=device)
    U_lag = lagged_features(U, lags=(3, 5, 7))              # :117-123
    feats = torch.cat([cases_std[:, None], U, U_lag], dim=1)  # target FIRST
    feats = standardize(feats)[0]
    feats[:, 0] = cases_std              # target channel keeps its own scale
    # (so the fed-back prediction and the training target y agree in units)

    T = len(cases_std)
    T_train = int(0.8 * T)
    X = feats[:-1]                                   # predict next-day cases
    y = cases_std[1:][:, None]

    model = LSTMForecaster(hidden_sizes=(hidden,), out_features=1)
    params, losses = train_forecaster(
        model, X[:T_train - 1], y[:T_train - 1], cpu_generator(seed),
        num_epochs=epochs, params=params, device=device)
    print(f"train mse: first={losses[0]:.4f} last={losses[-1]:.4f}")

    # closed-loop over the tail: feed back predicted cases, real NPI plan
    preds = host_array(rollout_forecast_exog(
        model, params, feats[:T_train], feats[T_train:], target_col=0,
        device=device))
    cs = host_array(cases_std)
    truth_tail = cs[T_train:]
    mae = float(np.mean(np.abs(preds - truth_tail)))
    persist = float(np.mean(np.abs(cs[T_train - 1] - truth_tail)))
    # like the reference experiment, this reports the comparison without
    # claiming the LSTM wins — on nonstationary epidemic tails a long
    # closed-loop rollout is hard (test05 plots the overlays for the same
    # reason)
    print(f"closed-loop horizon={len(truth_tail)}  LSTM MAE={mae:.4f}  "
          f"persistence MAE={persist:.4f}")
    return dict(mae=mae, persist=persist, losses=losses, preds=preds)


if __name__ == "__main__":
    dev, _ = split_device(sys.argv)
    main(device=dev)
