"""The PyTorch port's XPRIZE slice as a whole, held against the JAX package.

The same NumPy batches (built by the JAX package's own preprocessing) go
through the JAX run_pipeline (backend "lanes", float64 on the CPU) and the
port's run_pipeline (float64 on the CPU, both batch-last backends; for CPU
tensors both reach the kernels' plain versions). The Monte-Carlo schedules are the
JAX run's own, passed in, since torch cannot reproduce jax.random draws.

Tolerances: the continuous outputs at rtol 1e-9 / atol 1e-12 (the golden's
tolerance, tests/test_realistic_data.py:103-106); the discrete prescriptions
and the Pareto fronts exactly (ROADMAP grading rule "Float64 twin on clean
data").
"""

import numpy as np
import pytest
import torch
import jax

from epidemicmodeling_tpu.control import epsilon_grid as jax_epsilon_grid
from epidemicmodeling_tpu.data import synthetic_oxford_frame
from epidemicmodeling_tpu.data.preprocess import (
    NPI_MAXES_DEFAULT, build_region_batch, preprocess_region)
from epidemicmodeling_tpu.pipelines import PipelineConfig as JaxConfig
from epidemicmodeling_tpu.pipelines.train_predict_prescribe import \
    run_pipeline as jax_run_pipeline

from epidemicmodeling_torch.pipelines import (
    PipelineConfig, run_pipeline, trained_params_from_numpy)

T_HIST, HORIZON = 80, 19
TOL = dict(rtol=1e-9, atol=1e-12)
COMMON = dict(smoother_gain="solve", pareto_chunk=2, num_monte_carlo=16)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def slice_inputs():
    _, _, truth = synthetic_oxford_frame(n_regions=3, n_days=T_HIST + HORIZON,
                                         seed=7)
    sers, names = [], []
    for name, tr in truth.items():
        nc = tr["s"] * tr["i"] * tr["alpha"] * tr["pop"]
        sers.append(preprocess_region(np.cumsum(nc)[:T_HIST], None,
                                      tr["u"][:T_HIST], tr["pop"]))
        names.append(name)
    actual = np.stack([tr["u"] for tr in truth.values()])
    return dict(bt=build_region_batch(sers, names),
                bf=build_region_batch(sers, names, horizon=HORIZON),
                actual=actual, eps=np.asarray(jax_epsilon_grid(4)))


@pytest.fixture(scope="module")
def jax_result(slice_inputs):
    d = slice_inputs
    return jax_run_pipeline(
        d["bt"], d["bf"], d["actual"], T_HIST, np.ones(12), d["eps"],
        np.zeros(12), NPI_MAXES_DEFAULT, T_HIST,
        JaxConfig(backend="lanes", **COMMON), key=jax.random.PRNGKey(0))


def _run_port(d, backend, jres, **kw):
    return run_pipeline(
        d["bt"], d["bf"], d["actual"], T_HIST, np.ones(12), d["eps"],
        np.zeros(12), NPI_MAXES_DEFAULT, T_HIST,
        PipelineConfig(backend=backend, **COMMON), dtype=torch.float64,
        u_random=np.asarray(jres.monte_carlo["u_random"]), **kw)


def _assert_downstream_equal(port, jres):
    for name, sc in jres.scenarios.items():
        for field in ("s", "i", "alpha", "J0", "J1"):
            np.testing.assert_allclose(
                getattr(port.scenarios[name], field).numpy(),
                np.asarray(getattr(sc, field)), **TOL,
                err_msg=f"scenario {name} {field}")
    np.testing.assert_allclose(port.s_hist.numpy(), np.asarray(jres.s_hist),
                               **TOL)
    for k in ("J0", "J1", "s", "i", "alpha"):
        np.testing.assert_allclose(port.pareto[k].numpy(),
                                   np.asarray(jres.pareto[k]), **TOL,
                                   err_msg=f"pareto {k}")
    np.testing.assert_array_equal(port.pareto["u_prescribed"].numpy(),
                                  np.asarray(jres.pareto["u_prescribed"]))
    np.testing.assert_array_equal(port.pareto_front.numpy(),
                                  np.asarray(jres.pareto_front))
    for k in ("J0", "J1"):
        np.testing.assert_allclose(port.monte_carlo[k].numpy(),
                                   np.asarray(jres.monte_carlo[k]), **TOL,
                                   err_msg=f"monte carlo {k}")


@pytest.mark.parametrize("backend", ["lanes", "pallas"])
def test_pipeline_matches_jax(slice_inputs, jax_result, backend):
    port = _run_port(slice_inputs, backend, jax_result)
    for k in ("a1", "b1", "a2", "b2"):
        np.testing.assert_allclose(getattr(port.trained, k).numpy(),
                                   np.asarray(getattr(jax_result.trained, k)),
                                   **TOL, err_msg=k)
    _assert_downstream_equal(port, jax_result)
    assert set(port.stage_seconds) == {"train", "scenarios", "pareto",
                                       "monte_carlo", "front"}


@pytest.mark.parametrize("variant", [
    dict(observation_type="TOTALCASES"),
    dict(pareto_store_trajectories=False, pareto_chunk=3),
], ids=["totalcases", "costs_only_sweep"])
def test_pipeline_variants_match_jax(variant):
    """TOTALCASES observations (x = 1 - s) and the costs-and-prescriptions
    -only sweep, on a smaller slice, against the JAX package."""
    obs_type = variant.get("observation_type", "NEWCASES")
    _, _, truth = synthetic_oxford_frame(n_regions=2, n_days=70, seed=11)
    sers, names = [], []
    for name, tr in truth.items():
        nc = tr["s"] * tr["i"] * tr["alpha"] * tr["pop"]
        sers.append(preprocess_region(np.cumsum(nc)[:56], None,
                                      tr["u"][:56], tr["pop"]))
        names.append(name)
    bt = build_region_batch(sers, names, obs_type=obs_type)
    bf = build_region_batch(sers, names, obs_type=obs_type, horizon=14)
    eps = np.asarray(jax_epsilon_grid(5))
    kw = dict(COMMON, **variant)
    ref = jax_run_pipeline(bt, bf, None, 56, np.ones(12), eps, np.zeros(12),
                           NPI_MAXES_DEFAULT, 56,
                           JaxConfig(backend="lanes", **kw),
                           key=jax.random.PRNGKey(1))
    got = run_pipeline(bt, bf, None, 56, np.ones(12), eps, np.zeros(12),
                       NPI_MAXES_DEFAULT, 56,
                       PipelineConfig(backend="pallas", **kw),
                       dtype=torch.float64,
                       u_random=np.asarray(ref.monte_carlo["u_random"]))
    np.testing.assert_allclose(got.trained.a2.numpy(),
                               np.asarray(ref.trained.a2), **TOL)
    for k in ("J0", "J1"):
        np.testing.assert_allclose(got.pareto[k].numpy(),
                                   np.asarray(ref.pareto[k]), **TOL)
        np.testing.assert_allclose(got.monte_carlo[k].numpy(),
                                   np.asarray(ref.monte_carlo[k]), **TOL)
    np.testing.assert_array_equal(got.pareto["u_prescribed"].numpy(),
                                  np.asarray(ref.pareto["u_prescribed"]))
    stored = variant.get("pareto_store_trajectories", True)
    assert (got.pareto["s"] is None) == (not stored)
    assert (ref.pareto["s"] is None) == (not stored)


def test_trained_path_matches_jax(slice_inputs, jax_result):
    """Prescribe from the JAX package's trained parameters, handed over
    through trained_params_from_numpy, in a shuffled row order."""
    tr = jax_result.trained
    perm = [2, 0, 1]
    shuffled = dict(names=[tr.names[i] for i in perm],
                    population=np.asarray(tr.population)[perm],
                    **{k: np.asarray(getattr(tr, k))[perm]
                       for k in ("a1", "b1", "a2", "b2")})
    port = _run_port(slice_inputs, "pallas", jax_result,
                     trained=trained_params_from_numpy(shuffled))
    np.testing.assert_array_equal(port.trained.a2.numpy(),
                                  np.asarray(tr.a2))
    _assert_downstream_equal(port, jax_result)


def test_monte_carlo_draws_follow_the_law(slice_inputs, jax_result):
    """Without u_random the schedules come from the generator: integer
    levels inside [u_min, u_max], the first half constant over time."""
    d = slice_inputs
    res = run_pipeline(
        d["bt"], d["bf"], None, T_HIST, np.ones(12), d["eps"][:2],
        np.zeros(12), NPI_MAXES_DEFAULT, T_HIST,
        PipelineConfig(backend="pallas", **COMMON), dtype=torch.float64,
        generator=torch.Generator().manual_seed(0),
        trained=trained_params_from_numpy(jax_result.trained))
    u = res.monte_carlo["u_random"].numpy()
    assert u.shape == (16, HORIZON, 12)
    assert (u == np.round(u)).all() and (u >= 0).all()
    assert (u <= NPI_MAXES_DEFAULT).all()
    assert (u[:8] == u[:8, :1]).all()
    assert (u[8:] != u[8:, :1]).any()
    assert "actual" not in res.scenarios
    assert np.isfinite(res.monte_carlo["J0"].numpy()).all()


@pytest.mark.parametrize("change", [dict(backend="vmap"),
                                    dict(stochastic_forecast=True)])
def test_unported_options_raise(slice_inputs, change):
    d = slice_inputs
    cfg = PipelineConfig(**dict(dict(backend="pallas", **COMMON), **change))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_pipeline(d["bt"], d["bf"], None, T_HIST, np.ones(12),
                     d["eps"], np.zeros(12), NPI_MAXES_DEFAULT, T_HIST, cfg,
                     dtype=torch.float64)


def test_port_reproduces_realistic_golden(tmp_path):
    """The port, fed the batches tests/test_realistic_data.py builds from
    the jointly-pathological fixture, reproduces its committed golden."""
    import os
    from epidemicmodeling_tpu.data import realistic_oxford_frame
    from epidemicmodeling_tpu.data.oxford import (
        load_geo_list, load_oxford_data, load_populations)
    from epidemicmodeling_tpu.data.preprocess import OXFORD_NPI_COLUMNS
    from epidemicmodeling_tpu.pipelines.train_predict_prescribe import \
        build_batches_from_frames
    from epidemicmodeling_tpu.utils.dates import num_days_between

    df, pops, _ = realistic_oxford_frame(n_regions=4, n_days=200, seed=7)
    df.to_csv(tmp_path / "oxford.csv", index=False)
    pops.to_csv(tmp_path / "populations.csv", index=False)
    pops[["CountryName", "RegionName"]].to_csv(tmp_path / "geos.csv",
                                               index=False)
    start, end, end_pred = "2020-03-01", "2020-08-17", "2020-09-16"
    frame = load_oxford_data(str(tmp_path / "oxford.csv"),
                             list(OXFORD_NPI_COLUMNS), start, end_pred)
    geo = [g for g in load_geo_list(str(tmp_path / "geos.csv"))
           if g in set(frame["GeoID"])]
    cfg = PipelineConfig(backend="lanes", smoother_gain="solve",
                         pareto_chunk=3, num_monte_carlo=16)
    bt, bf, actual, T_hist, _ = build_batches_from_frames(
        frame, load_populations(str(tmp_path / "populations.csv")), geo,
        start, end, end_pred, None, JaxConfig(**COMMON))
    res = run_pipeline(bt, bf, actual, T_hist, np.ones(12),
                       np.asarray(jax_epsilon_grid(6)), np.zeros(12),
                       NPI_MAXES_DEFAULT, num_days_between(start, end), cfg,
                       generator=torch.Generator().manual_seed(0),
                       dtype=torch.float64)
    golden = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                                  "realistic_pipeline.npz"))
    got = {"a2": res.trained.a2, "b2": res.trained.b2,
           "J0": res.pareto["J0"], "J1": res.pareto["J1"]}
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), golden[k], **TOL, err_msg=k)


def test_region_init_matches_and_carries_over(slice_inputs):
    """region_init is the same host computation in both packages, and
    region_init_from_numpy hands the JAX package's result over unchanged."""
    from epidemicmodeling_tpu.pipelines.core import \
        region_init as jax_region_init
    from epidemicmodeling_torch.pipelines import region_init_from_numpy
    from epidemicmodeling_torch.pipelines.core import region_init

    ref = jax_region_init(slice_inputs["bt"], JaxConfig())
    got = region_init(slice_inputs["bt"], PipelineConfig(), torch.float64)
    carried = region_init_from_numpy(ref)
    for k in ref._fields:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)
        np.testing.assert_array_equal(getattr(carried, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)


@pytest.mark.parametrize("n", [4, 250, 7])
def test_control_helpers_match_jax(n):
    """epsilon_grid (float64 eps even for a float32 grid), the batched
    Pareto-front mask and the NPI cost against the JAX package."""
    from epidemicmodeling_tpu.control import (
        npi_cost as jax_npi_cost,
        pareto_front_mask_batched as jax_front)
    from epidemicmodeling_torch.control import (
        epsilon_grid, npi_cost, pareto_front_mask_batched)
    import jax.numpy as jnp

    # JAX builds a float32 grid in float32 (a 12 * ulp exponent error is
    # ~2e-6 relative after 10**x); the port builds it in float64 and rounds
    # once
    for jdt, tdt, rtol in ((jnp.float64, torch.float64, 1e-13),
                           (jnp.float32, torch.float32, 5e-6)):
        np.testing.assert_allclose(epsilon_grid(n, tdt).numpy(),
                                   np.asarray(jax_epsilon_grid(n, jdt)),
                                   rtol=rtol, atol=0)
    rng = np.random.default_rng(n)
    J0, J1 = rng.random((n, 5)), rng.random((n, 5))
    J1[1] = J1[0]                       # ties are not dominated
    np.testing.assert_array_equal(
        pareto_front_mask_batched(torch.from_numpy(J0),
                                  torch.from_numpy(J1)).numpy(),
        np.asarray(jax_front(jnp.asarray(J0), jnp.asarray(J1))))
    cases, u, w = rng.random((5, n)), rng.random((5, n, 12)), rng.random(12)
    for got, ref in zip(npi_cost(torch.from_numpy(cases), torch.from_numpy(u),
                                 torch.from_numpy(w)),
                        jax_npi_cost(cases, u, w)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13)
