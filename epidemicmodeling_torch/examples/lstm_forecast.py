"""Per-region LSTM case forecasting driver
(testScripts/test00ReadOxfordDataPlusProcessLSTM.m): standardize the smoothed
new-case series, train a 100-unit LSTM next-step model, roll a closed-loop
forecast. The LSTM runs on cuDNN in IEEE float32 (ml/lstm.py).

Usage: python -m epidemicmodeling_torch.examples.lstm_forecast [--device cpu]
"""

import sys

import numpy as np

from ..data import synthetic_oxford_frame
from ..ml import LSTMForecaster, rollout_forecast, standardize, \
    train_forecaster
from ..utils.device import resolve_device
from ..utils.math import host_array
from ._common import cpu_generator, split_device


def main(*, device=None, params=None, num_epochs: int = 250,
         lr_drop_period: int = 125):
    """Train and forecast. params: the initial weights (a state_dict, e.g.
    lstm_params_from_flax of the flax model's), default flax-distributed
    draws from a CPU generator seeded with 0. Returns the losses, the
    30-day forecast and its MAPE."""
    device = resolve_device(device)
    _, _, truth = synthetic_oxford_frame(n_regions=1, n_days=220, seed=2)
    tr = next(iter(truth.values()))
    cases = tr["s"] * tr["i"] * tr["alpha"] * tr["pop"]

    n_test = 30
    train = cases[:-n_test]
    xs, mu, sd = standardize(train.reshape(-1, 1), device=device)
    x_in, y_out = xs[:-1], xs[1:]

    model = LSTMForecaster(hidden_sizes=(100,))
    params, losses = train_forecaster(
        model, x_in, y_out, cpu_generator(0), num_epochs=num_epochs,
        lr=0.005, lr_drop_period=lr_drop_period, params=params,
        device=device)
    pred_std = rollout_forecast(model, params, xs, n_test, device=device)
    pred = host_array(pred_std) * float(sd[0, 0]) + float(mu[0, 0])
    truth_tail = cases[-n_test:]
    mape = np.mean(np.abs(pred - truth_tail)
                   / np.maximum(truth_tail, 1e-9)) * 100
    print(f"final train loss {losses[-1]:.4f}; "
          f"{n_test}-day closed-loop forecast MAPE {mape:.1f}%")
    return dict(losses=losses, final_loss=losses[-1], forecast=pred,
                forecast_std=host_array(pred_std), mape=float(mape))


if __name__ == "__main__":
    dev, _ = split_device(sys.argv)
    main(device=dev)
