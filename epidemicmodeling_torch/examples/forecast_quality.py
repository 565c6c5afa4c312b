"""Forecast-quality backtest driver — reproduces the IEEE JSTSP evaluation
(testScripts/testIEEEJSTSP2021ArticleResults.m: MaxLookAheadDays=60, per-day
EKF reruns) on synthetic data, printing the error-vs-horizon curves that
are the paper's headline figures. On the card every (region, holdout
start) filter runs in one ekf3 launch.

Usage: python -m epidemicmodeling_torch.examples.forecast_quality [--device cpu]
"""

import sys

import numpy as np

from ..data import NPI_MAXES_DEFAULT, synthetic_oxford_frame
from ..pipelines import PipelineConfig
from ..pipelines.forecast_quality import forecast_quality_assessment
from ..utils.device import resolve_device
from ..utils.math import host_array
from ._common import split_device, truth_batches


def main(*, device=None, dtype=None):
    """Run the backtest; returns the per-region median % error curves
    (R, 60) with the region names and the day-1/7/30/60 values printed."""
    device = resolve_device(device)
    n_days = 300
    _, _, truth = synthetic_oxford_frame(n_regions=4, n_days=n_days, seed=0)
    names, batch, _ = truth_batches(truth)

    res = forecast_quality_assessment(
        batch, np.zeros(12), NPI_MAXES_DEFAULT,
        num_regression_days=n_days - 90, num_forecast_days=90,
        max_look_ahead_days=60,
        cfg=PipelineConfig(smoother_gain="solve", backend="lanes"),
        dtype=dtype, device=device)

    med = host_array(res.median_error_smooth)   # (R, 60)
    print("median % error vs look-ahead horizon (per region):")
    for r, name in enumerate(names):
        print(f"  {name:14s} day1={med[r, 0]:6.2f}%  day7={med[r, 6]:6.2f}%"
              f"  day30={med[r, 29]:6.2f}%  day60={med[r, 59]:6.2f}%")
    return dict(names=names, median_error_smooth=med,
                printed=med[:, [0, 6, 29, 59]], result=res)


if __name__ == "__main__":
    dev, _ = split_device(sys.argv)
    main(device=dev)
