"""The port's example drivers (epidemicmodeling_torch/examples/) against
the JAX drivers in examples/, on the CPU in float64.

Each JAX driver runs as tests/test_examples_smoke.py imports it; the
library calls it makes are wrapped to record their results (and, where
the driver's sizes are fixed, to cut them: the same cut is passed to the
port's main). Where the JAX driver takes a key, its draws are passed to
the port (the Monte-Carlo schedules, the spatial draws rebuilt from the
key schedule, the LSTM's initial weights, the SVR's random features).
Both drivers write into their own temporary working directory.

Tolerances:
- discrete outputs exactly: prescriptions, front masks and sizes, the
  prescriptions CSV byte for byte, counts, the optimal index, the
  observability rank, the best model; the printed lines equal where
  both print the same text;
- costs, states, error curves, SEIRP and Rt series at rtol 1e-9 (float64;
  rtol_nonlin_ls 5e-9 of the largest magnitude, the nonlinear LS rule of
  tests/test_torch_rt_smoothing.py);
- the spatial fields at rtol 1e-12 (the stencil is exact arithmetic in
  one order), the agent sim at rtol 1e-9 / atol 1e-12 (tests/
  test_torch_spatial.py's "xla" rule);
- the LSTM losses and rollouts (float32 models) at rtol 1e-4 from JAX's
  initial weights (tests/test_torch_ml.py's rule), over shortened
  trainings; the SVR after 50 Adam steps at rtol 1e-9.
"""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

from epidemicmodeling_torch.control import epsilon_grid as pgrid  # noqa: E402
from epidemicmodeling_torch.examples import NAMES  # noqa: E402
from epidemicmodeling_torch.ml import lstm_params_from_flax  # noqa: E402

F64 = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-9
PKG = os.path.join(os.path.dirname(__file__), "..", "epidemicmodeling_torch",
                   "examples")


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def close(got, ref, rtol=RTOL, atol=0.0, msg=""):
    np.testing.assert_allclose(_np(got), _np(ref), rtol=rtol, atol=atol,
                               err_msg=msg)


class Recorder:
    """Wraps ``name`` in each of ``modules`` (the JAX package modules a
    driver imports it from) so that every call is recorded; ``edit``
    rewrites the keyword arguments first."""

    def __init__(self, monkeypatch, modules, name, edit=None):
        self.calls = []
        orig = getattr(modules[0], name)

        def wrapped(*args, **kw):
            if edit is not None:
                kw = edit(args, kw)
            out = orig(*args, **kw)
            self.calls.append((args, kw, out))
            return out

        for m in modules:
            monkeypatch.setattr(m, name, wrapped)

    @property
    def out(self):
        return self.calls[-1][2]


def jax_driver(name):
    return importlib.import_module(name)


def port_driver(name):
    return importlib.import_module(f"epidemicmodeling_torch.examples.{name}")


def run_in(path, monkeypatch, fn, *args, **kw):
    path.mkdir()
    monkeypatch.chdir(path)
    return fn(*args, **kw)


# --- the pipeline drivers ----------------------------------------------------

def _hold_pipeline(res, jres, front_sizes=None):
    """A port TrainPredictPrescribeResult against the JAX one."""
    par, jpar = res.pareto, jres.pareto
    np.testing.assert_array_equal(_np(par["u_prescribed"]),
                                  np.asarray(jpar["u_prescribed"]))
    np.testing.assert_array_equal(_np(res.pareto_front),
                                  np.asarray(jres.pareto_front))
    for k in ("J0", "J1"):
        close(par[k], jpar[k], msg=k)
        close(res.monte_carlo[k], jres.monte_carlo[k], msg=f"mc {k}")
    close(res.s_hist, jres.s_hist, atol=1e-15)
    for f in ("a1", "b1", "a2", "b2"):
        close(getattr(res.trained, f), getattr(jres.trained, f), atol=1e-15,
              msg=f)
    for label in ("fixed", "zero", "max"):
        close(res.scenarios[label].J0, jres.scenarios[label].J0, msg=label)
    if front_sizes is not None:
        np.testing.assert_array_equal(
            front_sizes, np.asarray(jres.pareto_front).sum(axis=0))


def _same_npz(a, b):
    with np.load(a) as za, np.load(b) as zb:
        assert set(za.files) == set(zb.files)
        for k in za.files:
            if za[k].dtype.kind in "fc":
                close(za[k], zb[k], atol=1e-15, msg=k)
            else:
                np.testing.assert_array_equal(za[k], zb[k])


N_EPS = 24


def test_xprize_prescribe_matches_jax(tmp_path, monkeypatch, capsys):
    """The --synthetic run (6 regions x 240 days) at 24 epsilons (the JAX
    driver's epsilon_grid(250) cut by wrapping): prescriptions.csv byte
    for byte, trained_params.npz, the fronts, costs and states."""
    import epidemicmodeling_tpu.control as jcontrol
    import epidemicmodeling_tpu.pipelines as jpipe
    from epidemicmodeling_tpu.control import epsilon_grid as jgrid
    monkeypatch.setattr(jcontrol, "epsilon_grid", lambda n: jgrid(N_EPS))
    rec = Recorder(monkeypatch, [jpipe], "train_predict_prescribe")
    run_in(tmp_path / "jax", monkeypatch, jax_driver("xprize_prescribe").main,
           ["x", "--synthetic"])
    jout = capsys.readouterr().out
    jres = rec.out
    pmod = port_driver("xprize_prescribe")
    monkeypatch.setattr(pmod, "epsilon_grid", lambda n: pgrid(N_EPS))
    got = run_in(tmp_path / "port", monkeypatch, pmod.main,
                 ["x", "--synthetic"],
                 u_random=np.asarray(jres.monte_carlo["u_random"]), **F64)
    assert capsys.readouterr().out == jout
    assert got["n_regions"] == 6 and got["prescriptions"] == \
        "prescriptions.csv"
    _hold_pipeline(got["result"], jres, got["front_sizes"])
    assert (tmp_path / "port" / "prescriptions.csv").read_bytes() == \
        (tmp_path / "jax" / "prescriptions.csv").read_bytes()
    _same_npz(tmp_path / "port" / "trained_params.npz",
              tmp_path / "jax" / "trained_params.npz")


def _same_backend(monkeypatch, backend, port_module):
    """Run both drivers of a pair on ``backend``: the port's drivers take
    the "lanes" backend (the kernels on the card) where the JAX driver
    takes the default "vmap" (the generic core, the pinv smoother gain),
    so on "lanes" the JAX driver's PipelineConfig is built with it, on
    "vmap" the port driver's."""
    import epidemicmodeling_tpu.pipelines as jpipe
    module = jpipe if backend == "lanes" else port_module
    orig = module.PipelineConfig
    monkeypatch.setattr(module, "PipelineConfig",
                        lambda **kw: orig(**dict(kw, backend=backend)))


@pytest.mark.parametrize("backend", ["lanes", "vmap"])
def test_prescribe_from_checkpoint_matches_jax(tmp_path, monkeypatch,
                                               capsys, backend):
    """Train, checkpoint, reload and sweep at 48 epsilons in chunks of 16
    (the drivers' epsilon_grid(2000) cut by wrapping), both drivers on
    ``backend``; then the port's driver on the JAX driver's checkpoint
    file."""
    import epidemicmodeling_tpu.control as jcontrol
    from epidemicmodeling_tpu.control import epsilon_grid as jgrid
    from epidemicmodeling_tpu.pipelines import prescribe as jprescribe
    monkeypatch.setattr(jcontrol, "epsilon_grid", lambda n: jgrid(48))
    pmod = port_driver("prescribe_from_checkpoint")
    monkeypatch.setattr(pmod, "epsilon_grid", lambda n: pgrid(48))
    _same_backend(monkeypatch, backend, pmod)
    rec = Recorder(monkeypatch, [jprescribe], "prescribe_from_checkpoint")
    run_in(tmp_path / "jax", monkeypatch,
           jax_driver("prescribe_from_checkpoint").main, ["x"])
    jout = capsys.readouterr().out
    jpar, jmc = rec.out
    u_random = np.asarray(jmc["u_random"])
    port = pmod.main
    got = run_in(tmp_path / "port", monkeypatch, port, ["x"],
                 u_random=u_random, **F64)
    assert capsys.readouterr().out == jout
    _same_npz(tmp_path / "port" / "trained_params.npz",
              tmp_path / "jax" / "trained_params.npz")

    def hold(got):
        assert got["n_epsilon"] == 48 and got["n_policies"] == 500
        np.testing.assert_array_equal(_np(got["pareto"]["u_prescribed"]),
                                      np.asarray(jpar["u_prescribed"]))
        for k in ("J0", "J1"):
            close(got["pareto"][k], jpar[k], msg=k)
            close(got["monte_carlo"][k], jmc[k], msg=f"mc {k}")
        import epidemicmodeling_tpu.control as jc
        front = np.asarray(jc.pareto_front_mask_batched(jpar["J0"],
                                                        jpar["J1"]))
        np.testing.assert_array_equal(got["front"], front)
        np.testing.assert_array_equal(got["front_sizes"], front.sum(axis=0))

    hold(got)
    # the checkpoint branch, on the JAX driver's file
    ckpt = str(tmp_path / "jax" / "trained_params.npz")
    hold(run_in(tmp_path / "port_ckpt", monkeypatch, port, ["x", ckpt],
                u_random=u_random, **F64))
    assert capsys.readouterr().out.startswith(
        f"loaded checkpoint {ckpt}: 3 regions\n")


def test_forecast_quality_matches_jax(monkeypatch, capsys):
    """The backtest at the JAX driver's size (4 regions x 300 days, 90
    holdout starts, 60 days ahead): the error curves and the printed
    table."""
    from epidemicmodeling_tpu.pipelines import forecast_quality as jfq
    rec = Recorder(monkeypatch, [jfq], "forecast_quality_assessment")
    jax_driver("forecast_quality").main()
    jout = capsys.readouterr().out
    got = port_driver("forecast_quality").main(**F64)
    assert capsys.readouterr().out == jout
    ref = rec.out
    for f in ("median_error_smooth", "mean_error_smooth", "est_error_plus",
              "est_error_smooth"):
        close(getattr(got["result"], f), getattr(ref, f), msg=f)
    close(got["median_error_smooth"], ref.median_error_smooth)


def test_realistic_data_pipeline_matches_jax(tmp_path, monkeypatch, capsys):
    """The artefact-laden CSVs at the smoke test's size (3 regions x 150
    days, 4 epsilons): the artefact counts, the recovered shares, the
    fronts, prescriptions and costs."""
    res_j = run_in(tmp_path / "jax", monkeypatch,
                   jax_driver("realistic_data_pipeline").main,
                   n_regions=3, n_days=150, n_eps=4)
    jout = capsys.readouterr().out
    got = run_in(tmp_path / "port", monkeypatch,
                 port_driver("realistic_data_pipeline").main, n_regions=3,
                 n_days=150, n_eps=4,
                 u_random=np.asarray(res_j.monte_carlo["u_random"]), **F64)
    assert capsys.readouterr().out == jout
    assert got["neg_days"] > 0 and got["nan_npis"] > 0
    _hold_pipeline(got["result"], res_j, got["front_sizes"])
    assert got["result"].trained.names == tuple(res_j.trained.names)


@pytest.mark.parametrize("backend", ["lanes", "vmap"])
def test_make_figures_matches_jax(tmp_path, monkeypatch, capsys, backend):
    """The figures' pipeline run (32 epsilons, 200 Monte-Carlo schedules),
    both drivers on ``backend``: the optimal index exactly, every array a
    figure shows, and the same five PNG files."""
    port = port_driver("make_figures")
    _same_backend(monkeypatch, backend, port)
    import epidemicmodeling_tpu.pipelines.core as jcore
    # the package rebinds the module's name to its function
    jtpp = sys.modules[
        "epidemicmodeling_tpu.pipelines.train_predict_prescribe"]
    rec_run = Recorder(monkeypatch, [jtpp], "run_pipeline")
    rec_train = Recorder(monkeypatch, [jcore], "train_regions")
    jax_driver("make_figures").main(outdir=str(tmp_path / "jax"))
    jout = capsys.readouterr().out
    jres, jtr = rec_run.out, rec_train.out
    got = port.main(outdir=str(tmp_path / "port"),
                    u_random=np.asarray(jres.monte_carlo["u_random"]),
                    **F64)
    assert capsys.readouterr().out == jout.replace(
        str(tmp_path / "jax"), str(tmp_path / "port"))
    r = 0
    J0 = np.asarray(jres.pareto["J0"][:, r])
    J1 = np.asarray(jres.pareto["J1"][:, r])
    from epidemicmodeling_tpu.viz import select_optimal_index
    assert got["i_opt"] == select_optimal_index(J0, J1)
    close(got["J0"], J0)
    close(got["J1"], J1)
    close(got["states"], jres.s_hist[r], atol=1e-15)
    close(got["mc_J0"], jres.monte_carlo["J0"][:, r])
    np.testing.assert_array_equal(got["front"],
                                  np.asarray(jres.pareto_front[:, r]))
    np.testing.assert_array_equal(
        got["u_prescribed"],
        np.asarray(jres.pareto["u_prescribed"])[got["i_opt"], r])
    for f in ("s_smooth_round1", "s_smooth_round2", "rho_round1",
              "rho_round2"):
        close(got[f], np.asarray(getattr(jtr, f))[r], atol=1e-15, msg=f)
    names = {p.name for p in (tmp_path / "port").glob("*.png")}
    assert names == set(port.FIGURES) == {
        p.name for p in (tmp_path / "jax").glob("*.png")}


# --- the spatial driver ------------------------------------------------------

def _jax_walks(key, L, W, NT):
    """The JAX walkers' start cells and steps for ``key``
    (spatial/walkers.py's schedule)."""
    k_init, k_run = jax.random.split(key)
    start = np.stack([
        np.asarray(jax.random.randint(k_init, (W,), 1, L - 1)),
        np.asarray(jax.random.randint(jax.random.fold_in(k_init, 1), (W,),
                                      1, L - 1))], axis=1)
    steps = np.stack([np.asarray(jax.random.randint(k, (W, 2), -1, 2))
                      for k in jax.random.split(k_run, NT)])
    return start, steps


def _jax_sim_draws(cfg, T, key):
    """The JAX agent sim's start state and per-step normal draws for
    ``key`` (spatial/agents.py's schedule)."""
    N = cfg.n_subjects
    k0, k1, k2, k3, k_run = jax.random.split(key, 5)
    init = dict(
        p_init=np.stack([
            (cfg.x_max - cfg.x_min) * np.asarray(jax.random.uniform(k0, (N,)))
            + cfg.x_min,
            (cfg.y_max - cfg.y_min) * np.asarray(jax.random.uniform(k1, (N,)))
            + cfg.y_min], axis=1),
        v_init=np.minimum(cfg.v_max / np.sqrt(2.0), 0.5 * np.asarray(
            jax.random.normal(k2, (N, 2)))),
        a_init=np.minimum(cfg.a_max / np.sqrt(2.0), 0.1 * np.asarray(
            jax.random.normal(k3, (N, 2)))),
        j_init=np.zeros((N, 2)))
    draws = [[], [], [], []]
    for k_t in jax.random.split(k_run, T):
        for lst, k in zip(draws, jax.random.split(k_t, 4)):
            lst.append(np.asarray(jax.random.normal(k, (N, 2), jnp.float64)))
    return init, tuple(np.stack(d) for d in draws)


# The agent sim is chaotic: the port and the JAX package, both float64,
# part by 4e-13 m after 60 steps, 1e-11 after 100, 1e-7 after 200 and by
# metres after 300 (an e-fold every ~7 steps; CPU run), as two operation
# orders of one package would. So the JAX driver's 500 steps are cut to 60
# by wrapping.
SIM_STEPS = 60


def test_spatial_sims_matches_jax(monkeypatch, capsys):
    """The three simulations from the JAX driver's draws, the agent sim cut
    to 60 steps: both diffusion fields and the walkers' field, the walk,
    the agents' trajectories and the particle field, and the printed
    numbers."""
    import epidemicmodeling_tpu.spatial as jspatial
    import epidemicmodeling_tpu.spatial.walkers as jwalkers
    from epidemicmodeling_torch.spatial import PopulationSimConfig
    rec_diff = Recorder(monkeypatch, [jspatial], "diffusion_rollout")
    rec_walk = Recorder(monkeypatch, [jwalkers], "walking_sources_sim")
    rec_sim = Recorder(monkeypatch, [jspatial], "population_motion_sim",
                       lambda args, kw: dict(kw, n_steps=SIM_STEPS))
    jax_driver("spatial_sims").main(video=None)
    jout = capsys.readouterr().out.split("\n")
    walks = _jax_walks(jax.random.PRNGKey(0), 51, 2, 250)
    sim_inputs = _jax_sim_draws(PopulationSimConfig(n_subjects=150),
                                SIM_STEPS, jax.random.PRNGKey(1))
    pmod = port_driver("spatial_sims")
    psim = pmod.population_motion_sim
    monkeypatch.setattr(pmod, "population_motion_sim", lambda *a, **kw:
                        psim(*a, **dict(kw, n_steps=SIM_STEPS)))
    got = pmod.main(walks=walks, sim_inputs=sim_inputs, **F64)
    out = capsys.readouterr().out.split("\n")
    assert out == jout
    close(got["c4"], rec_diff.calls[0][2][-1], rtol=1e-12)
    close(got["c8"], rec_diff.calls[1][2][-1], rtol=1e-12)
    j4, j8 = (np.asarray(c[2][-1]).ravel() for c in rec_diff.calls)
    close(got["corr"], np.corrcoef(j4, j8)[0, 1], rtol=1e-12)
    C_j, traj_j, _ = rec_walk.out
    np.testing.assert_array_equal(_np(got["walk_traj"]), np.asarray(traj_j))
    close(got["walk_field"], C_j, rtol=1e-12)
    ref = rec_sim.out
    for f in ("p", "v", "a", "j", "C"):
        close(getattr(got["sim"], f), getattr(ref, f), atol=1e-12, msg=f)
    close(got["mean_speed"], np.linalg.norm(np.asarray(ref.v[-1]),
                                            axis=1).mean())
    close(got["field_total"], float(ref.C.sum()))


# --- the studies -------------------------------------------------------------

def test_seirp_scenarios_matches_jax(monkeypatch, capsys):
    """The five scenarios at dt = 0.5, the observability rank and the
    saturated comparison."""
    import epidemicmodeling_tpu.analysis as janalysis
    import epidemicmodeling_tpu.models as jmodels
    rec = Recorder(monkeypatch, [janalysis], "run_seirp_scenario")
    rec_sat = Recorder(monkeypatch, [jmodels], "seirp_saturated_rollout")
    jax_driver("seirp_scenarios").main()
    jout = capsys.readouterr().out
    got = port_driver("seirp_scenarios").main(device="cpu")
    assert capsys.readouterr().out == jout
    assert got["rank"] == 4
    for (args, _, res), (name, vals) in zip(rec.calls,
                                            got["scenarios"].items()):
        assert args[0] == name
        close(vals[:2], [float(np.max(res["i"])), float(res["p"][-1])])
    close([got["saturated"], got["unlimited"]],
          [float(c[2][4][-1]) for c in rec_sat.calls])


def test_rt_comparison_matches_jax(monkeypatch, capsys):
    """The four growth-rate estimates on one synthetic series."""
    import epidemicmodeling_tpu.rt as jrt
    recs = {k: Recorder(monkeypatch, [jrt], f"rt_expfit_{k}")
            for k in ("gen_ratios", "log_lin_reg", "nonlin_ls", "ekf")}
    jax_driver("rt_comparison").main()
    jout = capsys.readouterr().out
    got = port_driver("rt_comparison").main(device="cpu")
    assert capsys.readouterr().out == jout
    close(got["gen_ratios"], recs["gen_ratios"].out[3])
    close(got["log_lin"], recs["log_lin_reg"].out[2])
    ls = np.asarray(recs["nonlin_ls"].out[2])
    close(got["nonlin_ls"], ls, rtol=0, atol=5e-9 * np.abs(ls).max())
    close(got["ekf"], recs["ekf"].out.s_smooth[:, 1])


# --- the ML drivers ----------------------------------------------------------

def _short_training(epochs, drop=None):
    """A train_forecaster edit that runs ``epochs`` epochs (the drop of the
    learning rate at ``drop``)."""
    def edit(args, kw):
        kw = dict(kw, num_epochs=epochs)
        if drop is not None:
            kw["lr_drop_period"] = drop
        return kw
    return edit


def _initial_weights(call):
    """The initial weights the recorded JAX train_forecaster call drew."""
    (model, x, _, key), _, _ = call
    return lstm_params_from_flax(model.init(key, x))


def test_lstm_forecast_matches_jax(monkeypatch, capsys):
    """The 100-unit forecaster for 20 epochs with the learning-rate drop at
    10 (the JAX driver's 250 / 125 cut by wrapping), from its initial
    weights: losses and the 30-day forecast at rtol 1e-4."""
    import epidemicmodeling_tpu.ml as jml
    rec = Recorder(monkeypatch, [jml], "train_forecaster",
                   _short_training(20, 10))
    jax_driver("lstm_forecast").main()
    capsys.readouterr()
    params = _initial_weights(rec.calls[0])
    got = port_driver("lstm_forecast").main(
        device="cpu", params=params, num_epochs=20, lr_drop_period=10)
    losses_j = rec.out[1]
    assert len(got["losses"]) == 20 and got["losses"][-1] < got["losses"][0]
    close(got["losses"], losses_j, rtol=1e-4)
    out = capsys.readouterr().out
    assert out.startswith("final train loss ") and "MAPE" in out
    # the JAX driver's standardized forecast, recomputed from its trained
    # weights and its series (x_in followed by the last target)
    from epidemicmodeling_tpu.ml import rollout_forecast as jroll
    (model, x_in, y_out, _), _, (pj, _) = rec.calls[0]
    xs = jnp.concatenate([x_in, y_out[-1:]])
    close(got["forecast_std"], jroll(model, pj, xs, 30), rtol=1e-4,
          atol=1e-6)


def test_direct_newcases_lstm_matches_jax(monkeypatch):
    """The tiny configuration of tests/test_examples_smoke.py (80 days, 8
    units, 15 epochs) from the JAX driver's initial weights: the losses,
    the closed-loop rollout and both MAEs."""
    import epidemicmodeling_tpu.ml as jml
    rec = Recorder(monkeypatch, [jml], "train_forecaster")
    mae_j, persist_j, losses_j = jax_driver("direct_newcases_lstm").main(
        n_days=80, hidden=8, epochs=15, seed=0)
    got = port_driver("direct_newcases_lstm").main(
        80, 8, 15, 0, device="cpu", params=_initial_weights(rec.calls[0]))
    close(got["losses"], losses_j, rtol=1e-4)
    close(got["persist"], persist_j)
    close(got["mae"], mae_j, rtol=1e-4)
    assert got["losses"][-1] < got["losses"][0]


def test_ml_comparison_matches_jax(monkeypatch, capsys):
    """The per-region MAE table with the SVRs cut to 50 Adam steps and the
    LSTM to 20 epochs (by wrapping), from JAX's random features and
    initial weights. pandas' to_datetime is given the YYYYMMDD format so
    that the JAX driver's long-weekend column reads the calendar dates, as
    the port's does (module docstring of the port's driver)."""
    import pandas as pd
    import epidemicmodeling_tpu.ml.lstm as jlstm
    import epidemicmodeling_tpu.ml.svr as jsvr
    to_dt = pd.to_datetime
    monkeypatch.setattr(pd, "to_datetime", lambda s, *a, **k: to_dt(
        s.astype(str), format="%Y%m%d"))
    rec_svr = Recorder(monkeypatch, [jsvr], "svr_fit",
                       lambda args, kw: dict(kw, n_steps=50))
    rec_lstm = Recorder(monkeypatch, [jlstm], "train_forecaster",
                        _short_training(20))
    jax_driver("ml_comparison").main()
    jout = capsys.readouterr().out
    rbf = [c[2] for c in rec_svr.calls if c[1]["kernel"] == "rbf"]
    assert all(np.array_equal(m.omega, rbf[0].omega) for m in rbf)
    got = port_driver("ml_comparison").main(
        device="cpu", svr_draws=(np.asarray(rbf[0].omega),
                                 np.asarray(rbf[0].phase)),
        lstm_params=_initial_weights(rec_lstm.calls[0]), svr_steps=50,
        lstm_epochs=20)
    out = capsys.readouterr().out
    table = jout.split("\n")[1:6]
    assert out.split("\n")[1:6] == table
    lines = [ln.split() for ln in table[2:]]
    for r, ln in zip(got["table"], lines):
        close(r[:4], [float(v) for v in ln[1:5]], rtol=0, atol=5e-5)
    assert out.split("\n")[-2] == jout.split("\n")[-2]


# --- the rules every driver keeps --------------------------------------------

def _main_args(name):
    return (["x", "--synthetic"],) if name == "xprize_prescribe" else \
        (["x"],) if name == "prescribe_from_checkpoint" else ()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="needs a machine without a CUDA card")
@pytest.mark.parametrize("name", NAMES)
def test_driver_raises_without_a_card(name, tmp_path, monkeypatch):
    """Without --device cpu (device=) a driver resolves the card first and
    raises, before it reads, writes or computes anything."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_driver(name).main(*_main_args(name))
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("name", ["rt_comparison", "spatial_sims"])
def test_module_entry_takes_the_device_option(name, tmp_path):
    """``python -m`` with ``--device cpu`` prints what main prints (the
    split_device and the argparse entries); without it, on a machine with
    no card, it fails with "no CUDA device"."""
    import subprocess
    root = os.path.join(os.path.dirname(__file__), "..")
    # one thread: beside busy test workers, a child spinning a thread on
    # every core runs the spatial driver's ~10 s for minutes
    run = lambda *a: subprocess.run(
        [sys.executable, "-m", f"epidemicmodeling_torch.examples.{name}",
         *a], cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.abspath(root),
                 OMP_NUM_THREADS="1"))
    out = run("--device", "cpu")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines and lines[0].startswith(
        "day | gen-ratios" if name == "rt_comparison" else "diffusion: ")
    if not torch.cuda.is_available():
        bare = run()
        assert bare.returncode != 0 and "no CUDA device" in bare.stderr


def test_device_option_is_parsed():
    from epidemicmodeling_torch.examples._common import split_device
    assert split_device(["p", "--device", "cpu", "a.csv"]) == \
        ("cpu", ["p", "a.csv"])
    assert split_device(["p", "--device=cuda:0"]) == ("cuda:0", ["p"])
    assert split_device(["p", "--synthetic"]) == (None, ["p", "--synthetic"])


def test_drivers_import_no_jax():
    """No module of the port's examples imports jax, flax, optax, pandas or
    the JAX package (a line-by-line scan of every import)."""
    import ast
    files = sorted(f for f in os.listdir(PKG) if f.endswith(".py"))
    assert {f[:-3] for f in files} >= set(NAMES)
    for f in files:
        tree = ast.parse(open(os.path.join(PKG, f)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in (
                    "jax", "jaxlib", "flax", "optax", "pandas",
                    "epidemicmodeling_tpu"), f"{f} imports {m}"
