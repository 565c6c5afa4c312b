"""The port's forecast-quality backtest against the JAX package's.

The same NumPy batch (the JAX package's own preprocessing of synthetic
regions, one of them with a zero-case tail so that some per-day errors are
inf) goes through the JAX forecast_quality_assessment (backend "lanes",
float64 on the CPU) and the port's (float64 on the CPU, both batch-last
backends: every (region, start) lane in one call of the ekf3 kernel's plain
version), and through both packages' "vmap" backend (the generic core).
Tolerance: rtol 1e-9 / atol 1e-12 (the golden's), with identical
non-finite patterns.
"""

import numpy as np
import pytest
import torch

from epidemicmodeling_tpu.data import synthetic_oxford_frame
from epidemicmodeling_tpu.data.preprocess import (
    NPI_MAXES_DEFAULT, build_region_batch, preprocess_region)
from epidemicmodeling_tpu.pipelines import PipelineConfig as JaxConfig
from epidemicmodeling_tpu.pipelines.forecast_quality import \
    forecast_quality_assessment as jax_backtest

from epidemicmodeling_torch.ops.cuda import build, ekf3_kernel
from epidemicmodeling_torch.parallel import make_mesh
from epidemicmodeling_torch.pipelines import (PipelineConfig,
                                              forecast_quality_assessment)
from epidemicmodeling_torch.pipelines.forecast_quality import _nanmedian
from epidemicmodeling_torch.utils.profiling import recording

TOL = dict(rtol=1e-9, atol=1e-12)
FIELDS = ("est_error_plus", "est_error_smooth", "mean_error_smooth",
          "median_error_smooth")
# (num_forecast_days, max_look_ahead_days): more starts than horizons, and
# fewer (every start then enters the aggregates)
SHAPES = {"S>=H": (30, 20), "S<H": (12, 20)}


@pytest.fixture(scope="module")
def batch():
    _, _, truth = synthetic_oxford_frame(n_regions=3, n_days=170, seed=3)
    sers, names = [], []
    for r, (name, tr) in enumerate(truth.items()):
        confirmed = np.cumsum(tr["s"] * tr["i"] * tr["alpha"] * tr["pop"])
        if r == 1:
            confirmed[-12:] = confirmed[-13]     # no new case in 12 days
        sers.append(preprocess_region(confirmed, None, tr["u"], tr["pop"]))
        names.append(name)
    return build_region_batch(sers, names)


def _kw(shape):
    S, H = SHAPES[shape]
    return dict(npi_mins=np.zeros(12), npi_maxes=NPI_MAXES_DEFAULT,
                num_regression_days=120, num_forecast_days=S,
                max_look_ahead_days=H)


@pytest.fixture(scope="module")
def jax_results(batch):
    cfg = JaxConfig(backend="lanes", smoother_gain="solve")
    return {s: jax_backtest(batch, cfg=cfg, **_kw(s)) for s in SHAPES}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("backend", ["lanes", "pallas"])
def test_backtest_matches_jax(batch, jax_results, backend, shape):
    with recording() as rec:
        got = forecast_quality_assessment(
            batch, cfg=PipelineConfig(backend=backend), dtype=torch.float64,
            device="cpu", **_kw(shape))
    assert build.launches(rec, "ekf3") == 0   # plain versions on the CPU
    ref = jax_results[shape]
    S, H = SHAPES[shape]
    assert tuple(got.est_error_smooth.shape) == (3, S, H)
    for f in FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b),
                                      err_msg=f)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f)
        ok = np.isfinite(b)
        np.testing.assert_allclose(a[ok], b[ok], **TOL, err_msg=f)
    np.testing.assert_allclose(got.trained.a2.numpy(),
                               np.asarray(ref.trained.a2), **TOL)
    # the zero-case tail gives inf per-day errors, masked in the aggregates
    assert np.isinf(got.est_error_smooth.numpy()[1]).any()
    assert np.isfinite(got.mean_error_smooth.numpy()[[0, 2]]).all()


@pytest.fixture(scope="module")
def jax_vmap_results(batch):
    return {s: jax_backtest(batch, cfg=JaxConfig(), **_kw(s)) for s in SHAPES}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_backtest_vmap_matches_jax(batch, jax_vmap_results, shape,
                                   monkeypatch):
    """backend "vmap" (the default config: the generic core, the pinv
    smoother gain) against the JAX package's "vmap" backtest: every
    (region, start) filter in one batch of the core, no ekf3 call."""
    def ran(*a, **k):
        raise AssertionError("the vmap backtest reached ekf3")

    monkeypatch.setattr(ekf3_kernel, "ekf3", ran)
    got = forecast_quality_assessment(batch, cfg=PipelineConfig(),
                                      dtype=torch.float64, device="cpu",
                                      **_kw(shape))
    ref = jax_vmap_results[shape]
    for f in FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f)
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b), err_msg=f)
        ok = np.isfinite(b)
        np.testing.assert_allclose(a[ok], b[ok], **TOL, err_msg=f)
    np.testing.assert_allclose(got.trained.a2.numpy(),
                               np.asarray(ref.trained.a2), **TOL)


def test_backtest_lanes_are_region_major(batch, monkeypatch):
    """One ekf3 call over R * S lanes, lane r * S + s holding region r with
    its last s + 1 observations masked NaN (starts s = 0..S-1)."""
    seen = []
    real = ekf3_kernel.ekf3

    def spy(*args, **kw):
        seen.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(ekf3_kernel, "ekf3", spy)
    S = 5
    forecast_quality_assessment(batch, np.zeros(12), NPI_MAXES_DEFAULT, 100,
                                S, 4, PipelineConfig(backend="pallas"),
                                dtype=torch.float64, device="cpu")
    assert len(seen) == 3                       # two training rounds, one run
    u, x = seen[-1][0], seen[-1][1]
    T = x.shape[0]
    assert tuple(x.shape) == (T, 3 * S)
    obs = torch.as_tensor(np.asarray(batch.observations))
    for r in range(3):
        for s in range(S):
            lane = x[:, r * S + s]
            assert torch.isnan(lane[T - s - 1:]).all()
            assert torch.equal(lane[:T - s - 1], obs[r, :T - s - 1])
            assert torch.equal(u[:, :, r * S + s],
                               torch.as_tensor(np.asarray(batch.npis))[r])


def test_nanmedian_is_numpys():
    rng = np.random.default_rng(2)
    e = rng.random((4, 9, 5))
    e[rng.random(e.shape) < 0.3] = np.nan
    e[1, :, 2] = np.nan
    with np.errstate(all="ignore"), pytest.warns(RuntimeWarning,
                                                 match="All-NaN"):
        ref = np.nanmedian(e, axis=1)
    np.testing.assert_allclose(_nanmedian(torch.from_numpy(e)).numpy(), ref,
                               rtol=1e-15)


def test_backtest_refuses_unported_options(batch):
    kw = dict(_kw("S>=H"), dtype=torch.float64, device="cpu")
    with pytest.raises(TypeError, match="obs_hessian_terms"):
        forecast_quality_assessment(batch, cfg=PipelineConfig(order=2), **kw)
    # the mesh is ported: its dp axis must divide the 3 regions
    with pytest.raises(ValueError, match="not divisible by mesh dp=2"):
        forecast_quality_assessment(
            batch, cfg=PipelineConfig(backend="pallas"),
            mesh=make_mesh(2, device="cpu"),
            **dict(kw, device=None))
    with pytest.raises(ValueError, match="training days"):
        forecast_quality_assessment(
            batch, cfg=PipelineConfig(backend="pallas"),
            **dict(kw, num_forecast_days=169))
