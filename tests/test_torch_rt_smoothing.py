"""The port's Rt estimators, smoothing filters, moving averages and
filter-health report against the JAX package, float64 on the CPU.

Tolerances: rtol 1e-9 / atol 1e-12 for the generation-ratio and
log-linear estimators, Tikhonov and the moving averages (sliding sums and
one dense solve); the NumPy copies (sliding mean and median, the health
report) exactly. The nonlinear least-squares estimator's 60-step
Levenberg-Marquardt run stops where its float64 cost no longer decreases,
which fixes A and lambda only to ~1e-9 relative: on these series the
port's and the JAX package's fits differ by up to 4.8e-10 in A while their
window costs differ by 5.3e-13 relative, and 600 steps give the port's
60-step result bit for bit (CPU run). It is therefore held by
co-optimality (every window's cost at the port's fit within 1e-11
relative of the cost at the JAX fit) and its outputs at rtol 5e-9, lambda
at 5e-9 of its largest magnitude (a growth rate that crosses zero has no
relative precision there).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from epidemicmodeling_tpu.data import synthetic_oxford_frame
from epidemicmodeling_tpu.ops import diagnostics as jax_diag
from epidemicmodeling_tpu.ops import smoothing as jax_smooth
from epidemicmodeling_tpu.rt import estimators as jax_rt
from epidemicmodeling_tpu.utils import math as jax_math

from epidemicmodeling_torch.ops import smooth_series, tikhonov_smooth
from epidemicmodeling_torch.ops.diagnostics import (filter_health,
                                                    summarize_health)
from epidemicmodeling_torch.ops.smoothing import sliding_mean, sliding_median
from epidemicmodeling_torch.rt import (rt_expfit_gen_ratios,
                                       rt_expfit_log_lin_reg,
                                       rt_expfit_nonlin_ls)
from epidemicmodeling_torch.utils import (causal_moving_average, clip01,
                                          filtfilt_ma)

TOL = dict(rtol=1e-9, atol=1e-12)
LM_RTOL = 5e-9
LM_COST_RTOL = 1e-11
FILTERS = ("BYPASS", "TIKHONOV", "MOVINGAVERAGE-CAUSAL",
           "MOVINGAVERAGE-NONCAUSAL", "MOVINGMEDIAN")


def rt_series(zero_at=None):
    """examples/rt_comparison.py's series (one synthetic region, 200
    days, floored at 1e-3), optionally with one zero sample."""
    _, _, truth = synthetic_oxford_frame(n_regions=1, n_days=200, seed=1)
    tr = next(iter(truth.values()))
    cases = np.maximum(tr["s"] * tr["i"] * tr["alpha"] * tr["pop"], 1e-3)
    if zero_at is not None:
        cases[zero_at] = 0.0
    return cases


def _close(got, ref, tol=TOL, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol,
                               err_msg=what)


@pytest.mark.parametrize("zero", [False, True], ids=["clean", "zero"])
def test_gen_ratios_match_jax(zero):
    x = rt_series(60 if zero else None)
    ref = jax_rt.rt_expfit_gen_ratios(x, 7, 3, 1.0)
    got = rt_expfit_gen_ratios(torch.tensor(x), 7, 3, 1.0)
    for g, r in zip(got, ref):
        _close(g, r)   # inf / NaN where the zero enters: the same cells


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("zero", [False, True], ids=["clean", "zero"])
def test_log_lin_reg_matches_jax(causal, zero):
    x = rt_series(60 if zero else None)
    ref = jax_rt.rt_expfit_log_lin_reg(jnp.asarray(x), 14, 1.0, causal)
    got = rt_expfit_log_lin_reg(torch.tensor(x), 14, 1.0, causal)
    for g, r in zip(got, ref):
        _close(g, r)


def _lm_cost(x, A, lam, wlen, time_unit, causal):
    """Every window's cost sum (y - A exp(lambda t))^2 at the estimator's
    outputs (float64, NumPy), and the windows' output indices."""
    half = wlen // 2
    w, lo = (wlen, wlen - 1) if causal else (2 * half + 1, half)
    n = (np.arange(-wlen + 1, 1) if causal else np.arange(-half, half + 1))
    idx = np.arange(len(x) - w + 1) + lo
    win = np.lib.stride_tricks.sliding_window_view(x, w)
    r = lam[idx] * time_unit
    return ((win - A[idx, None] * np.exp(r[:, None] * n / time_unit)) ** 2
            ).sum(axis=1), idx


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", ["clean", "zero", "week", "singular"])
def test_nonlin_ls_matches_jax(causal, case):
    """Windows with a zero keep (A = raw count, lambda = 0); "singular":
    time_unit = inf makes every window's normal matrix singular (t = 0), so
    every step is rejected (JAX's LU returns NaN there; the port rejects on
    solve_ex's info) and each fit stays at its start."""
    x = rt_series(60 if case == "zero" else None)
    tu = {"week": 7.0, "singular": np.inf}.get(case, 1.0)
    ref = [np.asarray(v) for v in
           jax_rt.rt_expfit_nonlin_ls(jnp.asarray(x), 14, tu, causal)]
    got = [v.numpy() for v in
           rt_expfit_nonlin_ls(torch.tensor(x), 14, tu, causal)]
    if case == "singular":
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        return
    c_ref, idx = _lm_cost(x, ref[1], ref[2], 14, tu, causal)
    c_got, _ = _lm_cost(x, got[1], got[2], 14, tu, causal)
    np.testing.assert_allclose(c_got, c_ref, rtol=LM_COST_RTOL, atol=0)
    for k in (0, 1, 3):     # Rt, A, ExpFit
        np.testing.assert_allclose(got[k], ref[k], rtol=LM_RTOL, atol=0)
    np.testing.assert_allclose(got[2], ref[2], rtol=0,
                               atol=LM_RTOL * np.abs(ref[2]).max())
    if case == "zero":
        # the windows holding the zero: output days 60..73 (causal) or
        # 53..67 (centered)
        hit = np.arange(60, 74) if causal else np.arange(53, 68)
        np.testing.assert_array_equal(got[2][hit], 0.0)
        np.testing.assert_array_equal(got[1][hit], x[hit])


@pytest.mark.parametrize("filter_type", FILTERS)
def test_smooth_series_matches_jax(filter_type):
    x = rt_series() * np.exp(0.1 * np.random.default_rng(2)
                             .standard_normal(200))
    ref = jax_smooth.smooth_series(x, filter_type)
    got = smooth_series(torch.tensor(x), filter_type)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    if filter_type in ("BYPASS", "MOVINGAVERAGE-NONCAUSAL", "MOVINGMEDIAN"):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    else:
        _close(got, ref)


def test_smoothing_pieces_match_jax():
    """Tikhonov at orders 1-3, the sliding mean and median at even and odd
    windows (host NumPy, so exactly), and the unknown-type error."""
    x = rt_series()[:120] / 1e3
    for order in (1, 2, 3):
        _close(tikhonov_smooth(torch.tensor(x), order, 10.0),
               jax_smooth.tikhonov_smooth(x, order, 10.0))
    for w in (1, 4, 7):
        np.testing.assert_array_equal(sliding_mean(torch.tensor(x), w),
                                      jax_smooth.sliding_mean(x, w))
        np.testing.assert_array_equal(sliding_median(x, w),
                                      jax_smooth.sliding_median(x, w))
    with pytest.raises(ValueError, match="Unknown filter type"):
        smooth_series(torch.tensor(x), "GAUSSIAN")
    with pytest.raises(ValueError, match="Unknown filter type"):
        jax_smooth.smooth_series(x, "GAUSSIAN")


@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("win", [1, 3, 7, 20])
def test_moving_averages_match_jax(axis, win):
    """Both filters along either axis of a (3, 50) batch; at win = 20,
    3 (w - 1) = 57 >= T = 50, so filtfilt's padding is capped at T - 1."""
    x = np.random.default_rng(win).standard_normal((3, 50))
    x = x if axis == -1 else x.T.copy()
    for jf, pf in ((jax_math.causal_moving_average, causal_moving_average),
                   (jax_math.filtfilt_ma, filtfilt_ma)):
        _close(pf(torch.tensor(x), win, axis), jf(jnp.asarray(x), win, axis))
    np.testing.assert_array_equal(
        clip01(torch.tensor(x)).numpy(), np.asarray(jax_math.clip01(x)))


def test_filter_health_matches_jax():
    """A batch with a healthy region, a non-finite one, an exploding one
    and an inconsistent rho; tensors or arrays in, the same report and
    summary out."""
    rng = np.random.default_rng(4)
    S = rng.random((4, 30, 3))
    S[1, 5, 2] = np.nan
    S[2, 7, 0] = 1e7
    rho = 1.0 + 0.1 * rng.standard_normal((4, 30))
    rho[3] = 50.0
    rho[0, 20] = np.nan
    names = ["A", "B", "C", "D"]
    for r in (None, rho):
        ref = jax_diag.filter_health(S, r)
        got = filter_health(torch.tensor(S),
                            None if r is None else torch.tensor(r))
        for f in ref._fields:
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(ref, f), err_msg=f)
        assert summarize_health(got, names) == jax_diag.summarize_health(
            ref, names)
        assert summarize_health(got) == jax_diag.summarize_health(ref)
