"""The port's standalone trainer and prescriptor slice against the JAX
package: the AR fits and forecast, the SI rollouts, the AR-alpha
prescription, the pre-generic 6-state EKS, prescription from a checkpoint
and the training-only entry point with its mortality estimates.

Everything runs float64 on the CPU (the JAX package under x64, the root
conftest). Random draws cannot be reproduced by torch, so the JAX
package's draws are rebuilt from its key schedule and passed in.
Tolerances: the AR fits and forecast rtol 1e-10 (a solve of the p x p
normal equations; the fits agree to ~5e-12 on these series, CPU run), the
rollouts rtol 1e-12 (elementwise, in the JAX package's operation order),
everything downstream of an EKF/EKS or a regression rtol 1e-9 / atol 1e-12
(the pipeline's golden tolerance, tests/test_realistic_data.py:103-106);
discrete outputs (prescriptions, fronts) exactly.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from epidemicmodeling_tpu.control import epsilon_grid as jax_epsilon_grid
from epidemicmodeling_tpu.control import pareto_front_mask as jax_front
from epidemicmodeling_tpu.data import synthetic_oxford_frame
from epidemicmodeling_tpu.data.preprocess import (
    NPI_MAXES_DEFAULT, build_region_batch, preprocess_region)
from epidemicmodeling_tpu.models import SIAlphaParams as JaxSIAlphaParams
from epidemicmodeling_tpu.models import si_alpha as jax_si
from epidemicmodeling_tpu.ops import ar as jax_ar
from epidemicmodeling_tpu.pipelines import PipelineConfig as JaxConfig
from epidemicmodeling_tpu.pipelines import checkpoint as jax_ckpt
from epidemicmodeling_tpu.pipelines import core as jax_core
from epidemicmodeling_tpu.pipelines import prescribe as jax_prescribe
from epidemicmodeling_tpu.pipelines import train as jax_train

from epidemicmodeling_torch.control import pareto_front_mask
from epidemicmodeling_torch.models import (SIAlphaParams,
                                           si_alpha_controlled_rollout,
                                           si_controlled_rollout)
from epidemicmodeling_torch.ops import ar_fit, ar_fit_burg, ar_forecast
from epidemicmodeling_torch.pipelines import (
    PipelineConfig, load_trained_params, prescribe_from_checkpoint,
    region_init_from_numpy, train_npi_prescriptor, trained_params_from_numpy)
from epidemicmodeling_torch.pipelines.prescribe import (
    ar_alpha_prescription, new_case_ekf_optimal_npi)

AR_TOL = dict(rtol=1e-10, atol=0)
ROLL_TOL = dict(rtol=1e-12, atol=0)
TOL = dict(rtol=1e-9, atol=1e-12)
U_MAX = np.array([3, 3, 2, 4, 2, 3, 2, 4, 2, 3, 2, 4], float)


def _ar_series(seed, p=8, T=240):
    """A stable AR(p) series (random reflection coefficients |k| < 0.9
    through the Levinson step-up, as tests/test_ar_prescribe.py draws
    them) plus a slow sinusoid."""
    rng = np.random.default_rng(seed)
    a = np.zeros(p)
    for m in range(p):
        k = rng.uniform(-0.9, 0.9)
        a[:m] = a[:m] + k * a[:m][::-1]
        a[m] = k
    e = 0.1 * rng.standard_normal(T + 100)
    y = np.zeros(T + 100)
    for t in range(p, T + 100):
        y[t] = -np.dot(a, y[t - p:t][::-1]) + e[t]
    return y[100:] + 0.5 * np.sin(0.05 * np.arange(T))


def _close(got, ref, tol, what=""):
    np.testing.assert_allclose(np.asarray(got.cpu() if hasattr(got, "cpu")
                                          else got),
                               np.asarray(ref), **tol, err_msg=what)


@pytest.mark.parametrize("method", ["fb", "ls", "burg"])
@pytest.mark.parametrize("order", [2, 8, 24])
def test_ar_fits_match_jax(method, order):
    y = _ar_series(order)
    if method == "burg":
        ref, got = jax_ar.ar_fit_burg(jnp.asarray(y), order), ar_fit_burg(
            torch.tensor(y), order)
    else:
        ref = jax_ar.ar_fit(jnp.asarray(y), order, method)
        got = ar_fit(torch.tensor(y), order, method)
    _close(got[0], ref[0], AR_TOL, "a")
    _close(got[1], ref[1], AR_TOL, "noise_var")


@pytest.mark.parametrize("keyed", [False, True], ids=["mean", "noisy"])
def test_ar_forecast_matches_jax(keyed):
    """The zero-noise forecast (key=None), and the noisy one with the JAX
    package's normal draws passed in."""
    y = _ar_series(3)
    a, nv = jax_ar.ar_fit(jnp.asarray(y), 8)
    key = jax.random.PRNGKey(4) if keyed else None
    ref = jax_ar.ar_forecast(jnp.asarray(y), a, nv, 40, key=key)
    z = (np.asarray(jax.random.normal(key, (40,), jnp.float64)) if keyed
         else None)
    got = ar_forecast(torch.tensor(y), np.asarray(a), float(nv), 40,
                      noise=z)
    _close(got, ref, AR_TOL)


def _rollout_kw(rng, P=12, K=70):
    return dict(s0=0.99, i0=1e-3, alpha0=0.4, u_max=U_MAX, alpha_min=1e-8,
                alpha_max=100.0, gamma=1 / 7, a=0.004 * rng.random(P),
                b=0.2, beta=0.2, s_noise_std=1e-4, i_noise_std=1e-5,
                alpha_noise_std=1e-3, K=K, dt=1.0)


@pytest.mark.parametrize("case", ["si", "si_alpha_pk", "si_alpha_kp",
                                  "si_alpha_noisy"])
def test_si_rollouts_match_jax(case):
    """si_controlled_rollout (the first sample the initial condition) and
    si_alpha_controlled_rollout (the initial condition dropped) with the
    schedule as (p, K) and (K, p), noise-free and with the JAX package's
    (K, 3) normal draws passed in."""
    rng = np.random.default_rng(11)
    if case == "si":
        alpha = 0.3 + 0.05 * rng.standard_normal(60)
        ref = jax_si.si_controlled_rollout(jnp.asarray(alpha), 0.2, 0.99,
                                           1e-3, 60, 1.0)
        got = si_controlled_rollout(torch.tensor(alpha), 0.2, 0.99, 1e-3,
                                    60, 1.0)
        assert float(got[0][0]) == 0.99 and float(got[1][0]) == 1e-3
    else:
        kw = _rollout_kw(rng)
        u = rng.integers(0, 3, (kw["K"], 12)).astype(float)
        u = u.T if case == "si_alpha_pk" else u
        key = jax.random.PRNGKey(5) if case == "si_alpha_noisy" else None
        ref = jax_si.si_alpha_controlled_rollout(jnp.asarray(u), key=key,
                                                 **kw)
        noise = (np.asarray(jax.random.normal(key, (kw["K"], 3),
                                              jnp.float64))
                 if key is not None else None)
        got = si_alpha_controlled_rollout(u, noise=noise, device="cpu", **kw)
        assert len(got) == 3
    for g, r in zip(got, ref):
        _close(g, r, ROLL_TOL)


def _ar_prescription_args(seed=2):
    rng = np.random.default_rng(seed)
    T = 200
    alpha = 0.2 + 0.05 * np.sin(0.05 * np.arange(T)) \
        + 0.005 * rng.standard_normal(T)
    return dict(alpha_train=alpha, a_coef=0.004 * rng.random(12),
                b_coef=0.05, beta_model=0.2, gamma_model=1 / 7,
                npi_mins=np.zeros(12), npi_maxes=U_MAX.astype(int),
                npi_weights=np.ones(12), s0=0.99, i0=1e-3, n_ahead=30,
                n_monte_carlo=8)


def test_ar_alpha_prescription_matches_jax():
    """The key schedule of the JAX function rebuilt: split(key) -> k_ar (the
    forecast's (H,) normals) and k_mc (the (N, H, P) integer levels)."""
    kw = _ar_prescription_args()
    key = jax.random.PRNGKey(0)
    ref = jax_prescribe.ar_alpha_prescription(
        jnp.asarray(kw["alpha_train"]), **{k: v for k, v in kw.items()
                                           if k != "alpha_train"}, key=key)
    k_ar, k_mc = jax.random.split(key)
    ar_noise = np.asarray(jax.random.normal(k_ar, (30,), jnp.float64))
    u_draw = np.asarray(jax.random.randint(
        k_mc, (8, 30, 12), jnp.asarray(kw["npi_mins"], jnp.int32),
        jnp.asarray(kw["npi_maxes"], jnp.int32) + 1))
    got = ar_alpha_prescription(**kw, u_draw=u_draw, ar_noise=ar_noise,
                                device="cpu")
    for f in ref._fields:
        _close(getattr(got, f), getattr(ref, f), TOL, f)


def test_ar_alpha_prescription_draws_from_the_generator():
    """Without draws passed in they come from the generator: the same seed
    gives the same result, levels are integers within the NPI bounds."""
    kw = _ar_prescription_args()
    runs = [ar_alpha_prescription(**kw, device="cpu",
                                  generator=torch.Generator().manual_seed(7))
            for _ in range(2)]
    for f in runs[0]._fields:
        assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), f
    other = ar_alpha_prescription(**kw, device="cpu",
                                  generator=torch.Generator().manual_seed(8))
    assert not torch.equal(other.J1_random, runs[0].J1_random)
    assert runs[0].s_scenarios.shape == (8, 90 + 30)
    assert bool(torch.isfinite(runs[0].J0_random).all())


def _optimal_npi_inputs():
    """tests/test_ar_prescribe.py:142's inputs."""
    P, T, T_hist = 12, 80, 60
    rng = np.random.default_rng(1)
    obs = np.abs(rng.normal(1e-4, 2e-5, T))
    obs[T_hist:] = np.nan
    u = rng.integers(0, 3, (T, P)).astype(float)
    u[T_hist:] = np.nan
    params = dict(dt=1.0, beta=0.2, gamma=1 / 7, a=0.004 * rng.random(P),
                  b=0.05, u_min=np.zeros(P), u_max=U_MAX, s_min=1e-6,
                  i_min=1e-6, alpha_min=1e-8, alpha_max=100.0, epsilon=0.3,
                  w=np.ones(P), sigma=1e6)
    Ps_final = np.full((6, 6), np.nan)
    Ps_final[3, 3] = Ps_final[4, 4] = Ps_final[5, 5] = 1e-8
    return dict(u=u, x=obs, params=params,
                s_init=np.array([0.999, 1e-4, 0.3, 0, 0, 0.0]),
                Ps_init=np.diag([1e-4, 1e-6, 0.1, 1e-7, 1e-7, 1e-7]),
                s_final=np.array([np.nan, np.nan, np.nan, 0, 0, 0.0]),
                Ps_final=Ps_final,
                Q=np.diag([1e-8, 1e-8, 1e-4, 1e-8, 1e-8, 1e-8]),
                R=np.full(T, 4e-10)), T_hist


def test_new_case_ekf_optimal_npi_matches_jax():
    d, T_hist = _optimal_npi_inputs()
    ref = jax_prescribe.new_case_ekf_optimal_npi(
        jnp.asarray(d["u"]), jnp.asarray(d["x"]),
        JaxSIAlphaParams(**d["params"]), *(jnp.asarray(d[k]) for k in (
            "s_init", "Ps_init", "s_final", "Ps_final")),
        Q=jnp.asarray(d["Q"]), R=jnp.asarray(d["R"]))
    got = new_case_ekf_optimal_npi(
        torch.tensor(d["u"]), torch.tensor(d["x"]),
        SIAlphaParams(**d["params"], device="cpu"),
        *(torch.tensor(d[k]) for k in ("s_init", "Ps_init", "s_final",
                                       "Ps_final")),
        Q=torch.tensor(d["Q"]), R=torch.tensor(d["R"]))
    u = got.u_opt_smooth[T_hist:-1].numpy()
    assert np.all((u == 0) | (u == U_MAX[None, :]))
    np.testing.assert_array_equal(got.u_opt_smooth.numpy(),
                                  np.asarray(ref.u_opt_smooth))
    for f in ref._fields:
        r = getattr(ref, f)
        if r is None or f == "u_opt_smooth":
            continue
        _close(getattr(got, f), r, TOL, f)


def test_pareto_front_mask_matches_jax():
    rng = np.random.default_rng(3)
    J0, J1 = rng.random(40), rng.random(40)
    J0[5], J1[5] = J0[6], J1[6]     # a tie: neither dominates the other
    got = pareto_front_mask(torch.tensor(J0), torch.tensor(J1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_front(J0, J1)))


T_HIST, HORIZON = 180, 40


@pytest.fixture(scope="module")
def example_inputs():
    """examples/prescribe_from_checkpoint.py's data: 3 regions x 180 + 40
    days (synthetic, seed 6)."""
    _, _, truth = synthetic_oxford_frame(n_regions=3, n_days=T_HIST, seed=6)
    sers, names = [], []
    for name, tr in truth.items():
        nc = tr["s"] * tr["i"] * tr["alpha"] * tr["pop"]
        sers.append(preprocess_region(np.cumsum(nc), None, tr["u"],
                                      tr["pop"]))
        names.append(name)
    return dict(bt=build_region_batch(sers, names),
                bf=build_region_batch(sers, names, horizon=HORIZON),
                eps=np.asarray(jax_epsilon_grid(16)))


@pytest.mark.parametrize("backend", ["pallas", "vmap"])
def test_prescribe_from_checkpoint_matches_jax(example_inputs, backend):
    """The example's flow on the JAX side (train, forecast the scenarios,
    prescribe from the trained parameters); the port prescribes from the
    JAX package's trained parameters, RegionInit and historic states, with
    its Monte-Carlo schedules passed in. "pallas" is held against the JAX
    package's "lanes" backend (the same batch-last arithmetic; on CPU
    tensors the port's kernel wrappers run their plain versions)."""
    d = example_inputs
    gain = "solve" if backend == "pallas" else "pinv"
    jcfg = JaxConfig(backend="lanes" if backend == "pallas" else "vmap",
                     pareto_chunk=8, num_monte_carlo=16, smoother_gain=gain)
    out = jax_core.train_regions(d["bt"], np.zeros(12), NPI_MAXES_DEFAULT,
                                 T_HIST, jcfg)
    _, s_hist = jax_core.forecast_scenarios(
        d["bf"], out.trained, out.init, np.ones(12), np.zeros(12),
        NPI_MAXES_DEFAULT, T_HIST, jcfg)
    par_ref, mc_ref = jax_prescribe.prescribe_from_checkpoint(
        out.trained, d["bf"], s_hist, out.init, d["eps"], np.ones(12),
        np.zeros(12), NPI_MAXES_DEFAULT, T_HIST, jcfg,
        key=jax.random.PRNGKey(0))
    par, mc = prescribe_from_checkpoint(
        trained_params_from_numpy(out.trained), d["bf"], np.asarray(s_hist),
        region_init_from_numpy(out.init), d["eps"], np.ones(12),
        np.zeros(12), NPI_MAXES_DEFAULT, T_HIST,
        PipelineConfig(backend=backend, pareto_chunk=8, num_monte_carlo=16,
                       smoother_gain=gain),
        dtype=torch.float64, device="cpu",
        u_random=np.asarray(mc_ref["u_random"]))
    np.testing.assert_array_equal(par["u_prescribed"].numpy(),
                                  np.asarray(par_ref["u_prescribed"]))
    np.testing.assert_array_equal(
        pareto_front_mask(par["J0"][:, 0], par["J1"][:, 0]).numpy(),
        np.asarray(jax_front(par_ref["J0"][:, 0], par_ref["J1"][:, 0])))
    for k in ("J0", "J1", "s", "i", "alpha"):
        _close(par[k], par_ref[k], TOL, f"pareto {k}")
    for k in ("J0", "J1"):
        _close(mc[k], mc_ref[k], TOL, f"monte carlo {k}")


@pytest.fixture(scope="module")
def mortality_batch():
    """tests/test_pipeline.py:162's data: synthetic_oxford_frame(3, 200,
    seed 0), 150 training days with the cumulative deaths."""
    _, _, truth = synthetic_oxford_frame(n_regions=3, n_days=200, seed=0)
    sers, names = [], []
    for name, tr in truth.items():
        nc = tr["s"] * tr["i"] * tr["alpha"] * tr["pop"]
        deaths = np.cumsum(0.01 * nc)
        sers.append(preprocess_region(np.cumsum(nc)[:150], deaths[:150],
                                      tr["u"][:150], tr["pop"]))
        names.append(name)
    return build_region_batch(sers, names)


def test_train_npi_prescriptor_matches_jax(mortality_batch, tmp_path):
    """Training, the mortality / beta estimates and the checkpoint, against
    the JAX package (its default configuration); the .npz each package
    writes loads in the other to the same parameters."""
    ref_out, ref_mort = jax_train.train_npi_prescriptor(
        mortality_batch, np.zeros(12), NPI_MAXES_DEFAULT, 150,
        trained_params_file=str(tmp_path / "jax_params"))
    out, mort = train_npi_prescriptor(
        mortality_batch, np.zeros(12), NPI_MAXES_DEFAULT, 150,
        trained_params_file=str(tmp_path / "port_params"),
        dtype=torch.float64, device="cpu")
    for k in ("a1", "b1", "a2", "b2"):
        _close(getattr(out.trained, k), getattr(ref_out.trained, k), TOL, k)
    for k in ("s_smooth_round1", "s_smooth_round2", "rho_round1",
              "rho_round2"):
        _close(getattr(out, k), getattr(ref_out, k), TOL, k)
    assert mort is not None
    for f in ref_mort._fields:
        got = getattr(mort, f)
        assert isinstance(got, np.ndarray), f
        _close(got, getattr(ref_mort, f), TOL, f)
    # the .npz cross-read, both ways
    from_port = jax_ckpt.load_trained_params(str(tmp_path / "port_params"))
    from_jax = load_trained_params(str(tmp_path / "jax_params"))
    for k in ("a1", "b1", "a2", "b2", "population"):
        np.testing.assert_array_equal(np.asarray(getattr(from_port, k)),
                                      np.asarray(getattr(out.trained, k)))
        np.testing.assert_array_equal(np.asarray(getattr(from_jax, k)),
                                      np.asarray(getattr(ref_out.trained, k)))
    assert tuple(from_port.names) == tuple(out.trained.names)
    assert tuple(from_jax.names) == tuple(ref_out.trained.names)


def _entry_calls(example_inputs):
    """Each new entry point called as a user would, with NumPy inputs and
    no device=."""
    from epidemicmodeling_torch.ops import smooth_series, tikhonov_smooth
    from epidemicmodeling_torch.rt import (rt_expfit_gen_ratios,
                                           rt_expfit_log_lin_reg,
                                           rt_expfit_nonlin_ls)
    from epidemicmodeling_torch.utils import causal_moving_average
    d, T_hist = _optimal_npi_inputs()
    y = _ar_series(1)
    kw = _rollout_kw(np.random.default_rng(0))
    return {
        "ar_fit": lambda: ar_fit(y, 4),
        "ar_forecast": lambda: ar_forecast(y, np.zeros(4), 1.0, 5),
        "si_controlled_rollout": lambda: si_controlled_rollout(
            np.full(10, 0.3), 0.2, 0.99, 1e-3, 10, 1.0),
        "si_alpha_controlled_rollout": lambda: si_alpha_controlled_rollout(
            np.zeros((kw["K"], 12)), **kw),
        "SIAlphaParams": lambda: SIAlphaParams(**d["params"]),
        "new_case_ekf_optimal_npi": lambda: new_case_ekf_optimal_npi(
            d["u"], d["x"], d["params"], d["s_init"], d["Ps_init"]),
        "ar_alpha_prescription": lambda: ar_alpha_prescription(
            **_ar_prescription_args()),
        "prescribe_from_checkpoint": lambda: prescribe_from_checkpoint(
            None, example_inputs["bf"], None, None, example_inputs["eps"],
            np.ones(12), np.zeros(12), NPI_MAXES_DEFAULT, T_HIST),
        "train_npi_prescriptor": lambda: train_npi_prescriptor(
            example_inputs["bt"], np.zeros(12), NPI_MAXES_DEFAULT, T_HIST),
        "rt_expfit_gen_ratios": lambda: rt_expfit_gen_ratios(
            y + 5, 7, 3, 1.0),
        "rt_expfit_log_lin_reg": lambda: rt_expfit_log_lin_reg(
            y + 5, 14, 1.0),
        "rt_expfit_nonlin_ls": lambda: rt_expfit_nonlin_ls(y + 5, 14, 1.0),
        "smooth_series": lambda: smooth_series(y, "MOVINGAVERAGE-NONCAUSAL"),
        "tikhonov_smooth": lambda: tikhonov_smooth(y),
        "causal_moving_average": lambda: causal_moving_average(y, 7),
    }


ENTRY_POINTS = ["ar_fit", "ar_forecast", "si_controlled_rollout",
                "si_alpha_controlled_rollout", "SIAlphaParams",
                "new_case_ekf_optimal_npi", "ar_alpha_prescription",
                "prescribe_from_checkpoint", "train_npi_prescriptor",
                "rt_expfit_gen_ratios", "rt_expfit_log_lin_reg",
                "rt_expfit_nonlin_ls", "smooth_series", "tikhonov_smooth",
                "causal_moving_average"]


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_new_entry_points_default_to_the_card(example_inputs, monkeypatch,
                                              entry):
    """Without device= and with NumPy inputs each runs on the CUDA card, so
    with no card it raises before any work instead of running on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_calls(example_inputs)[entry]()
