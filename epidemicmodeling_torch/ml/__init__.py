from .layers import ExpLayer, ScaledTanhLayer
from .lstm import (LSTMForecaster, train_forecaster, rollout_forecast,
                   rollout_forecast_exog, lstm_params_from_flax)
from .linear import ridge_regression, arx_fit_predict
from .svr import svr_fit, svr_predict
from .features import (lagged_features, long_weekend_feature,
                       region_window_mask,
                       standardize, train_test_split_time)

__all__ = [
    "ExpLayer", "ScaledTanhLayer",
    "LSTMForecaster", "train_forecaster", "rollout_forecast",
    "rollout_forecast_exog", "lstm_params_from_flax",
    "ridge_regression", "arx_fit_predict",
    "svr_fit", "svr_predict",
    "lagged_features", "long_weekend_feature", "standardize",
    "train_test_split_time", "region_window_mask",
]
