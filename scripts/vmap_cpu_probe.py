#!/usr/bin/env python3
"""CPU readings behind two of chip_smoke.py's choices for the "vmap" backend
(the generic EKF/EKS core), on chip_smoke's synthetic XPRIZE regions:

1. ``bounds``: float32, 16 regions x 440 training days, the train stage and
   the backtest (60 starts x 60 days ahead) on "vmap" against "pallas"
   (whose EKS runs the kernels' plain versions on the CPU): the scaled
   error |a - b| / (|b| + 1) of the trained coefficients and of the
   backtest's error curves. chip_smoke's VMAP_TRAIN_BOUND and
   VMAP_BACKTEST_BOUND are set well above these readings.
2. ``sensitivity``: float64, 16 regions x 400 + 20 days, each regression
   type: how far the historic states of the forecast stage move when the
   trained coefficients change by 1e-11 (relative), in units of
   1e-12 + 1e-9 |x| (so above 1 means "outside rtol 1e-9"). It is why
   chip_smoke holds the card against the CPU stage by stage from the same
   inputs, not along the whole chain.

    python scripts/vmap_cpu_probe.py [bounds|sensitivity]

Runs on the CPU (a few minutes); prints its readings.
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from epidemicmodeling_torch.pipelines import (  # noqa: E402
    PipelineConfig, forecast_quality_assessment)
from epidemicmodeling_torch.pipelines.core import (  # noqa: E402
    forecast_scenarios, train_regions)

CPU = torch.device("cpu")


def scaled(a, b):
    ok = torch.isfinite(a) & torch.isfinite(b)
    return float((torch.abs(a - b) / (torch.abs(b) + 1))[ok].max())


def bounds():
    bt, _, _, _ = cs.xprize_inputs(16, 440, 92, seed=0)
    f32 = torch.float32
    tr = {be: train_regions(bt, cs.MINS, cs.NPI_MAXES_DEFAULT, 440,
                            PipelineConfig(backend=be), dtype=f32,
                            device=CPU).trained
          for be in ("vmap", "pallas")}
    print("train, vmap against pallas (float32): " + " ".join(
        f"{k}={scaled(getattr(tr['vmap'], k), getattr(tr['pallas'], k)):.3e}"
        for k in ("a1", "b1", "a2", "b2")))
    res = {be: forecast_quality_assessment(
        bt, cs.MINS, cs.NPI_MAXES_DEFAULT, 380, 60, 60,
        PipelineConfig(backend=be), dtype=f32, device=CPU)
        for be in ("vmap", "pallas")}
    print("backtest, vmap against pallas (float32): " + " ".join(
        f"{f}={scaled(getattr(res['vmap'], f), getattr(res['pallas'], f)):.3e}"
        for f in ("mean_error_smooth", "median_error_smooth")))


def sensitivity():
    bt, bf, _, _ = cs.xprize_inputs(16, 400, 20, seed=1)
    f64 = torch.float64
    for reg in cs.REGRESSIONS:
        cfg = PipelineConfig(regression_type=reg, lasso_cv_folds=5)
        t0 = time.perf_counter()
        out = train_regions(bt, cs.MINS, cs.NPI_MAXES_DEFAULT, 400, cfg,
                            dtype=f64, device=CPU)
        s_hist = []
        for rel in (0.0, 1e-11):
            tr = out.trained._replace(a2=out.trained.a2 * (1 + rel),
                                      b2=out.trained.b2 * (1 + rel))
            _, s = forecast_scenarios(bf, tr, out.init, cs.WEIGHTS, cs.MINS,
                                      cs.NPI_MAXES_DEFAULT, 400, cfg,
                                      dtype=f64, device=CPU)
            s_hist.append(s)
        moved = (torch.abs(s_hist[1] - s_hist[0])
                 / (1e-12 + 1e-9 * torch.abs(s_hist[0]))).amax(dim=(1, 2))
        print(f"{reg}: historic states moved by a 1e-11 coefficient change, "
              f"per region, in units of 1e-12 + 1e-9|x|: max "
              f"{float(moved.max()):.3e} (region {int(moved.argmax())}), "
              f"median {float(moved.median()):.3e} "
              f"[{time.perf_counter() - t0:.1f}s]")


if __name__ == "__main__":
    what = sys.argv[1:] or ["bounds", "sensitivity"]
    for w in what:
        {"bounds": bounds, "sensitivity": sensitivity}[w]()
