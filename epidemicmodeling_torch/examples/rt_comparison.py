"""Rt estimator cross-comparison driver (testScripts/test01FitExponential.m):
run the four growth-rate estimators on the same new-case series and print
their agreement. float64 tensor ops, no kernel of its own.

Usage: python -m epidemicmodeling_torch.examples.rt_comparison [--device cpu]
"""

import sys

import numpy as np

from ..data import synthetic_oxford_frame
from ..rt import (rt_expfit_ekf, rt_expfit_gen_ratios, rt_expfit_log_lin_reg,
                  rt_expfit_nonlin_ls)
from ..utils.device import resolve_device
from ..utils.math import host_array
from ._common import split_device

DAYS = tuple(range(30, 200, 30))


def main(*, device=None):
    """Run the four estimators; returns each one's growth rate lambda (T,)
    (generation ratios smoothed, log-linear, nonlinear LS, the 2nd-order
    EKF's smoothed lambda) and the printed rows."""
    device = resolve_device(device)
    _, _, truth = synthetic_oxford_frame(n_regions=1, n_days=200, seed=1)
    tr = next(iter(truth.values()))
    cases = tr["s"] * tr["i"] * tr["alpha"] * tr["pop"]
    cases = np.maximum(cases, 1e-3)

    on = dict(device=device)
    _, _, _, lam_gr_s = rt_expfit_gen_ratios(cases, 7, 3, 1.0, **on)
    _, _, lam_lr, _ = rt_expfit_log_lin_reg(cases, 14, 1.0, **on)
    _, _, lam_ls, _ = rt_expfit_nonlin_ls(cases, 14, 1.0, **on)
    res = rt_expfit_ekf(
        cases, s_init=np.array([float(cases[0]), 0.0]), time_scale=1.0,
        alpha=1.0, sigma=1.0, w_bar=np.zeros(2), v_bar=np.zeros(1),
        Ps_init=np.diag([1.0, 0.1]), Q_w=np.diag([1e-1, 1e-4]),
        R_v=np.array([[1e-1]]), order=2, **on)
    lams = dict(gen_ratios=host_array(lam_gr_s), log_lin=host_array(lam_lr),
                nonlin_ls=host_array(lam_ls),
                ekf=host_array(res.s_smooth[:, 1]))

    print("day | gen-ratios | log-lin | nonlin-LS | EKF(2nd)")
    for t in DAYS:
        print(f"{t:4d} | {lams['gen_ratios'][t]:10.4f} | "
              f"{lams['log_lin'][t]:7.4f} | {lams['nonlin_ls'][t]:9.4f} | "
              f"{lams['ekf'][t]:8.4f}")
    return dict(lams, rows=np.array([[lams[k][t] for k in lams]
                                     for t in DAYS]))


if __name__ == "__main__":
    dev, _ = split_device(sys.argv)
    main(device=dev)
