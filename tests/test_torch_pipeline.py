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

import dataclasses

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
        u_random=np.asarray(jres.monte_carlo["u_random"]), device="cpu",
        **kw)


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
                       dtype=torch.float64, device="cpu",
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
        generator=torch.Generator().manual_seed(0), device="cpu",
        trained=trained_params_from_numpy(jax_result.trained))
    u = res.monte_carlo["u_random"].numpy()
    assert u.shape == (16, HORIZON, 12)
    assert (u == np.round(u)).all() and (u >= 0).all()
    assert (u <= NPI_MAXES_DEFAULT).all()
    assert (u[:8] == u[:8, :1]).all()
    assert (u[8:] != u[8:, :1]).any()
    assert "actual" not in res.scenarios
    assert np.isfinite(res.monte_carlo["J0"].numpy()).all()


@pytest.mark.parametrize("change", [dict(backend="vmap"), dict(order=2)])
def test_unported_options_raise(slice_inputs, change, monkeypatch):
    """The two options the port once refused. backend="vmap" now runs: the
    default PipelineConfig (the generic core, the MATLAB-exact pinv gain)
    against the JAX package's default run, prescriptions and fronts
    exactly, the continuous outputs at TOL, launching no hand-written
    kernel. order=2 is refused by both packages with a TypeError (the
    SI-alpha systems define no Hessian terms)."""
    from epidemicmodeling_torch.ops.cuda import ekf3_kernel, ekf6_kernel
    d = slice_inputs
    args = (d["bt"], d["bf"], d["actual"], T_HIST, np.ones(12), d["eps"],
            np.zeros(12), NPI_MAXES_DEFAULT, T_HIST)
    if "order" in change:
        with pytest.raises(TypeError, match="obs_hessian_terms"):
            run_pipeline(*args, PipelineConfig(**COMMON, **change),
                         dtype=torch.float64, device="cpu")
        with pytest.raises(TypeError):
            jax_run_pipeline(*args, JaxConfig(backend="vmap", **COMMON,
                                              **change),
                             key=jax.random.PRNGKey(0))
        return
    kw = dict(pareto_chunk=COMMON["pareto_chunk"],
              num_monte_carlo=COMMON["num_monte_carlo"])
    assert PipelineConfig(**kw).backend == "vmap"
    ref = jax_run_pipeline(*args, JaxConfig(**kw), key=jax.random.PRNGKey(0))

    def ran(*a, **k):
        raise AssertionError("the vmap backend reached a batch-last EKS")

    monkeypatch.setattr(ekf3_kernel, "ekf3", ran)
    monkeypatch.setattr(ekf6_kernel, "ekf6", ran)
    port = run_pipeline(*args, PipelineConfig(**kw), dtype=torch.float64,
                        device="cpu",
                        u_random=np.asarray(ref.monte_carlo["u_random"]))
    for k in ("a1", "b1", "a2", "b2"):
        np.testing.assert_allclose(getattr(port.trained, k).numpy(),
                                   np.asarray(getattr(ref.trained, k)),
                                   **TOL, err_msg=k)
    _assert_downstream_equal(port, ref)


@pytest.mark.parametrize("regression", ["LASSO", "NONNEGATIVELS-ELEMENT-WISE"])
def test_train_stage_regressions_match_jax(regression):
    """The train stage with the reference driver's LASSO (lasso(...,'CV'),
    5 folds here) and with the element-wise robust fits, both packages on
    the generic core: every coefficient at TOL. The slice (2 regions,
    seed 18) has no NPI constant over its 80-day regression window, where
    the element-wise fit of the JAX package returns a rounding residue
    (tests/test_torch_regression.py::test_robust_constant_column_has_no_
    slope)."""
    from epidemicmodeling_tpu.pipelines.core import \
        train_regions as jax_train_regions
    from epidemicmodeling_torch.pipelines import train_regions
    _, _, truth = synthetic_oxford_frame(n_regions=2, n_days=99, seed=18)
    sers = [preprocess_region(
        np.cumsum(tr["s"] * tr["i"] * tr["alpha"] * tr["pop"])[:T_HIST],
        None, tr["u"][:T_HIST], tr["pop"]) for tr in truth.values()]
    bt = build_region_batch(sers, list(truth))
    assert (np.ptp(np.asarray(bt.npis), axis=1) > 0).all()
    kw = dict(regression_type=regression, lasso_cv_folds=5)
    ref = jax_train_regions(bt, np.zeros(12), NPI_MAXES_DEFAULT, T_HIST,
                            JaxConfig(**kw))
    got = train_regions(bt, np.zeros(12), NPI_MAXES_DEFAULT, T_HIST,
                        PipelineConfig(**kw), dtype=torch.float64,
                        device="cpu")
    for k in ("a1", "b1", "a2", "b2"):
        np.testing.assert_allclose(getattr(got.trained, k).numpy(),
                                   np.asarray(getattr(ref.trained, k)),
                                   **TOL, err_msg=k)
    np.testing.assert_allclose(got.s_smooth_round2.numpy(),
                               np.asarray(ref.s_smooth_round2), **TOL)


def test_pipeline_defaults_to_the_card(slice_inputs, monkeypatch):
    """Without device= and with NumPy batches run_pipeline runs on the CUDA
    card, so with no card it raises before any work instead of running on
    the CPU; the stage functions share the default."""
    from epidemicmodeling_torch.ops.cuda import ekf3_kernel
    from epidemicmodeling_torch.pipelines import train_regions

    def ran(*args, **kwargs):
        raise AssertionError("the pipeline ran on the CPU")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(ekf3_kernel, "ekf3_plain", ran)
    d = slice_inputs
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_pipeline(d["bt"], d["bf"], None, T_HIST, np.ones(12), d["eps"],
                     np.zeros(12), NPI_MAXES_DEFAULT, T_HIST,
                     PipelineConfig(backend="pallas", **COMMON))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_regions(d["bt"], np.zeros(12), NPI_MAXES_DEFAULT, T_HIST,
                      PipelineConfig(backend="pallas", **COMMON))


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
                       dtype=torch.float64, device="cpu")
    golden = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                                  "realistic_pipeline.npz"))
    got = {"a2": res.trained.a2, "b2": res.trained.b2,
           "J0": res.pareto["J0"], "J1": res.pareto["J1"]}
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), golden[k], **TOL, err_msg=k)


def test_train_predict_prescribe_reproduces_realistic_golden(tmp_path):
    """The port's own CSV entry point on the files
    tests/test_realistic_data.py writes reproduces its committed golden."""
    import os
    from epidemicmodeling_tpu.data import realistic_oxford_frame
    from epidemicmodeling_torch.pipelines import train_predict_prescribe

    df, pops, _ = realistic_oxford_frame(n_regions=4, n_days=200, seed=7)
    df.to_csv(tmp_path / "oxford.csv", index=False)
    pops.to_csv(tmp_path / "populations.csv", index=False)
    pops[["CountryName", "RegionName"]].to_csv(tmp_path / "geos.csv",
                                               index=False)
    res = train_predict_prescribe(
        npi_weights=np.ones(12),
        epsilon_values=np.asarray(jax_epsilon_grid(6)),
        start_train_date="2020-03-01", end_train_date="2020-08-17",
        start_regression_date="2020-03-01", end_predict_date="2020-09-16",
        data_file=str(tmp_path / "oxford.csv"),
        geo_file=str(tmp_path / "geos.csv"),
        populations_file=str(tmp_path / "populations.csv"),
        npi_maxes=NPI_MAXES_DEFAULT,
        cfg=PipelineConfig(backend="pallas", smoother_gain="solve",
                           pareto_chunk=3, num_monte_carlo=16),
        generator=torch.Generator().manual_seed(0), dtype=torch.float64,
        trained_params_file=str(tmp_path / "trained.mat"), device="cpu")
    golden = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                                  "realistic_pipeline.npz"))
    got = {"a2": res.trained.a2, "b2": res.trained.b2,
           "J0": res.pareto["J0"], "J1": res.pareto["J1"]}
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), golden[k], **TOL, err_msg=k)
    assert res.stage_seconds["read_csv"] > 0
    from epidemicmodeling_torch.pipelines import load_trained_params_mat
    np.testing.assert_array_equal(
        load_trained_params_mat(tmp_path / "trained.mat").a2.numpy(),
        res.trained.a2.numpy())


@pytest.mark.parametrize("entry", ["train_predict_prescribe",
                                   "forecast_quality_assessment"])
def test_new_entry_points_default_to_the_card(slice_inputs, tmp_path,
                                              monkeypatch, entry):
    """Without device= the CSV entry point and the backtest run on the CUDA
    card, so with no card they raise before any work."""
    from epidemicmodeling_torch.ops.cuda import ekf3_kernel
    from epidemicmodeling_torch import pipelines

    def ran(*args, **kwargs):
        raise AssertionError("ran on the CPU")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(ekf3_kernel, "ekf3_plain", ran)
    cfg = PipelineConfig(backend="pallas", **COMMON)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "train_predict_prescribe":
            missing = str(tmp_path / "never_read.csv")
            pipelines.train_predict_prescribe(
                np.ones(12), slice_inputs["eps"], "2020-03-01",
                "2020-05-01", "2020-03-01", "2020-06-01", missing, missing,
                missing, npi_maxes=NPI_MAXES_DEFAULT, cfg=cfg)
        else:
            pipelines.forecast_quality_assessment(
                slice_inputs["bt"], np.zeros(12), NPI_MAXES_DEFAULT, 40, 10,
                5, cfg)


@pytest.fixture(scope="module")
def stochastic(slice_inputs, jax_result):
    """The JAX stages with cfg.stochastic_forecast and a key, on the
    deterministic run's trained parameters, and the draws they make:
    (R, H, 3) from the key itself for the scenarios (one draw shared by the
    rollouts), one an epsilon from split(key, E) for the sweep, one a
    schedule from split(split(key)[1], N) for the Monte Carlo."""
    import jax.numpy as jnp
    from epidemicmodeling_tpu.pipelines import core as jcore
    d = slice_inputs
    cfg = JaxConfig(backend="lanes", stochastic_forecast=True,
                    **dict(COMMON, pareto_chunk=4))
    key = jax.random.PRNGKey(3)
    R, H = 3, HORIZON
    draw = lambda k: np.array(jax.random.normal(k, (R, H, 3), jnp.float64))
    init = jcore.region_init(d["bt"], cfg)
    tr = jax_result.trained
    args = (np.ones(12), np.zeros(12), NPI_MAXES_DEFAULT)
    scen, s_hist = jcore.forecast_scenarios(
        d["bf"], tr, init, *args, T_HIST, cfg, key=key)
    plan = np.random.default_rng(4).integers(0, 3, (R, H, 12)).astype(float)
    planned = jcore.scenario_from_schedule(
        d["bf"], tr, init, s_hist, plan, *args, T_HIST, cfg, key=key)
    par = jcore.pareto_prescribe(d["bf"], tr, init, s_hist, d["eps"],
                                 args[0], *args[1:], T_HIST, cfg, key=key)
    mc = jcore.monte_carlo_baseline(d["bf"], tr, init, s_hist, *args,
                                    T_HIST, cfg, key=key)
    k_noise = jax.random.split(key)[1]
    return dict(
        cfg=cfg, init=init, scen=scen, s_hist=s_hist, plan=plan,
        planned=planned, par=par, mc=mc, scen_noise=draw(key),
        sweep_noise=np.stack([draw(k) for k in jax.random.split(key, 4)]),
        mc_noise=np.stack([draw(k) for k in
                           jax.random.split(k_noise, cfg.num_monte_carlo)]),
        rollout=jcore._rollout_from(
            cfg, init, dict(jcore._base_params(
                cfg, np.zeros(12), NPI_MAXES_DEFAULT, R, jnp.float64),
                a=tr.a2, b=tr.b2), s_hist[:, -1, :], jnp.asarray(plan), key))


def _port_stage_inputs(slice_inputs, jax_result, stochastic):
    from epidemicmodeling_torch.pipelines import region_init_from_numpy
    return (PipelineConfig(**dataclasses.asdict(stochastic["cfg"])),
            trained_params_from_numpy(jax_result.trained),
            region_init_from_numpy(stochastic["init"]))


def test_stochastic_rollout_and_scenarios_match_jax(slice_inputs, jax_result,
                                                    stochastic):
    """The rollout from the end of the history (against the JAX package's
    _rollout_from), the three scenarios and scenario_from_schedule with
    the JAX draws passed in as noise."""
    from epidemicmodeling_torch.pipelines import (forecast_scenarios,
                                                  scenario_from_schedule)
    from epidemicmodeling_torch.pipelines.core import (_rollout_fields,
                                                       stage_params)
    cfg, trained, init = _port_stage_inputs(slice_inputs, jax_result,
                                            stochastic)
    d, st = slice_inputs, stochastic
    kw = dict(dtype=torch.float64, device="cpu")
    args = (np.ones(12), np.zeros(12), NPI_MAXES_DEFAULT)
    s_hist = torch.from_numpy(np.array(st["s_hist"]))
    params = stage_params(cfg, d["bf"], trained, *args[1:], torch.float64,
                          torch.device("cpu"))
    fields = _rollout_fields(cfg, init, params, s_hist,
                             torch.from_numpy(st["plan"])[None],
                             torch.from_numpy(st["scen_noise"]))
    np.testing.assert_array_equal(fields[:, 0, :, :T_HIST].numpy(),
                                  s_hist.permute(2, 0, 1).numpy())
    traj = fields[:, 0, :, T_HIST:].permute(1, 2, 0)       # (R, H, 3)
    np.testing.assert_allclose(traj.numpy(), np.asarray(st["rollout"]), **TOL)
    scen, _ = forecast_scenarios(d["bf"], trained, init, *args, T_HIST, cfg,
                                 noise=st["scen_noise"], **kw)
    got = dict(scen, planned=scenario_from_schedule(
        d["bf"], trained, init, s_hist, st["plan"], *args, T_HIST, cfg,
        noise=st["scen_noise"], **kw))
    for name, ref in dict(st["scen"], planned=st["planned"]).items():
        for f in ("s", "i", "alpha", "u", "J0", "J1"):
            np.testing.assert_allclose(
                getattr(got[name], f).numpy(), np.asarray(getattr(ref, f)),
                **TOL, err_msg=f"{name} {f}")
    # the noise moves the forecast
    det, _ = forecast_scenarios(d["bf"], trained, init, *args, T_HIST,
                                PipelineConfig(backend="pallas", **COMMON),
                                **kw)
    assert not torch.allclose(det["fixed"].i, scen["fixed"].i)


def test_stochastic_sweep_and_monte_carlo_match_jax(slice_inputs, jax_result,
                                                    stochastic):
    """One Pareto chunk (4 epsilons, one draw each) and the Monte Carlo
    with the JAX draws passed in as noise."""
    from epidemicmodeling_torch.pipelines import (monte_carlo_baseline,
                                                  pareto_prescribe)
    cfg, trained, init = _port_stage_inputs(slice_inputs, jax_result,
                                            stochastic)
    d, st = slice_inputs, stochastic
    kw = dict(dtype=torch.float64, device="cpu")
    args = (np.ones(12), np.zeros(12), NPI_MAXES_DEFAULT)
    par = pareto_prescribe(d["bf"], trained, init, np.asarray(st["s_hist"]),
                           d["eps"], *args, T_HIST, cfg,
                           noise=st["sweep_noise"], **kw)
    for k in ("J0", "J1", "s", "i", "alpha"):
        np.testing.assert_allclose(par[k].numpy(), np.asarray(st["par"][k]),
                                   **TOL, err_msg=f"pareto {k}")
    np.testing.assert_array_equal(par["u_prescribed"].numpy(),
                                  np.asarray(st["par"]["u_prescribed"]))
    mc = monte_carlo_baseline(
        d["bf"], trained, init, np.asarray(st["s_hist"]), *args, T_HIST,
        cfg, u_random=np.asarray(st["mc"]["u_random"]),
        noise=st["mc_noise"], **kw)
    for k in ("J0", "J1"):
        np.testing.assert_allclose(mc[k].numpy(), np.asarray(st["mc"][k]),
                                   **TOL, err_msg=f"monte carlo {k}")


def test_stochastic_pipeline_draws_from_the_generator(slice_inputs):
    """Without explicit noise run_pipeline draws it from the generator: one
    seed gives one result, another seed another."""
    d = slice_inputs
    cfg = PipelineConfig(backend="pallas", stochastic_forecast=True, **COMMON)
    run = lambda seed: run_pipeline(
        d["bt"], d["bf"], None, T_HIST, np.ones(12), d["eps"], np.zeros(12),
        NPI_MAXES_DEFAULT, T_HIST, cfg, dtype=torch.float64, device="cpu",
        generator=torch.Generator().manual_seed(seed))
    a, b, c = run(1), run(1), run(2)
    for k in ("J0", "J1"):
        assert torch.equal(a.pareto[k], b.pareto[k])
        assert torch.isfinite(a.monte_carlo[k]).all()
    assert torch.equal(a.scenarios["fixed"].i, b.scenarios["fixed"].i)
    assert not torch.equal(a.scenarios["fixed"].i, c.scenarios["fixed"].i)
    with pytest.raises(ValueError, match="noise has shape"):
        from epidemicmodeling_torch.pipelines.core import forecast_noise
        forecast_noise(cfg, (3, 4, 3), torch.float64, torch.device("cpu"),
                       noise=np.zeros((3, 5, 3)))


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
