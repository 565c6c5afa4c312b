"""The port's SIR / SEIRP models and theory studies (linear systems, the
SEIRP scenarios, country statistics, Hamiltonian shooting) against the JAX
package, float64 on the CPU.

Tolerances: the rollouts, the linear-systems analytics and the country
statistics at rtol 1e-12 (the same Euler updates in the same operation
order; they differ from JAX only where a reduction or a transcendental
rounds differently). Shooting: the controls equal, states, costates, J0 and
J1 at rtol 1e-10 (the costates grow over the run and carry the one-ulp
differences of the (P,) dot products); the Hamiltonian by the structural
certificate of tests/test_analysis_fuzz.py (chip_smoke.
shooting_certificates), recomputed from the port's own carried series, with
the check that no single flip of a bang-bang control lowers H, because H is a near-cancelling sum of terms that carry
those costates and cannot be graded across implementations.
"""

import numpy as np
import pytest
import torch

import epidemicmodeling_tpu.analysis as jax_analysis
from chip_smoke import shooting_certificates
import epidemicmodeling_tpu.models as jax_models
import epidemicmodeling_torch.analysis as port_analysis
import epidemicmodeling_torch.models as port_models

TOL = dict(rtol=1e-12, atol=1e-300)
SHOOT_TOL = dict(rtol=1e-10, atol=1e-300)
U_MAX = np.array([3, 3, 2, 4, 2, 3, 2, 4, 2, 3, 2, 4], float)
RATES_A = dict(alpha_e=0.65, alpha_i=0.005, kappa=0.05, rho=0.08,
               beta=0.1, mu=0.02, gamma=0.0)
CPU = dict(device="cpu")


def _close(got, ref, tol=TOL, what=""):
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu", what
    assert got.dtype == torch.float64 or not got.is_floating_point(), what
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol,
                               err_msg=what)


def test_exports_match_the_jax_package():
    assert sorted(port_analysis.__all__) == sorted(jax_analysis.__all__)
    for name in ("sir_step", "sir_rollout", "seirp_step", "seirp_rollout",
                 "seirp_saturated_step", "seirp_saturated_rollout"):
        assert name in port_models.__all__, name
    assert port_analysis.SEIRP_SCENARIOS == jax_analysis.SEIRP_SCENARIOS
    from epidemicmodeling_tpu.analysis.seirp_scenarios import N_POP
    from epidemicmodeling_torch.analysis.seirp_scenarios import (
        N_POP as PORT_N_POP)
    assert PORT_N_POP == N_POP


@pytest.mark.parametrize("seed", [0, 1])
def test_sir_rollout_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a, b, g = rng.uniform(0.1, 0.6), rng.uniform(0.05, 0.2), \
        rng.uniform(0.0, 0.02)
    args = (0.99, 0.01, 0.0, a, b, g, 120.0, 0.1)
    ref = jax_models.sir_rollout(*args)
    got = port_models.sir_rollout(*args, **CPU)
    assert len(got) == 3 and got[0].shape == (1200,)
    for k, (g_, r_) in enumerate(zip(got, ref)):
        _close(g_, r_, what=f"compartment {k}")
    # a batch of parameter sets as leading dimensions equals the single runs
    batch = port_models.sir_rollout(0.99, 0.01, 0.0,
                                    torch.tensor([a, 0.3], dtype=torch.float64), b,
                                    g, 120.0, 0.1,
                                    **CPU)
    for g_, b_ in zip(got, batch):
        assert torch.equal(b_[0], g_)


def _random_rates(rng, K):
    """Seven time-varying SEIRP rate series (K,)."""
    base = np.array([0.65, 0.005, 0.05, 0.08, 0.1, 0.02, 0.001])
    wig = 1.0 + 0.3 * np.sin(np.arange(K)[:, None] * rng.uniform(
        0.001, 0.05, 7) + rng.uniform(0, 6, 7))
    return (base * rng.uniform(0.5, 1.5, 7) * wig).T


@pytest.mark.parametrize("seed", [0, 1])
def test_seirp_rollouts_match_jax(seed):
    rng = np.random.default_rng(100 + seed)
    T, dt = 300.0, 0.5
    K = int(round(T / dt))
    rates = _random_rates(rng, K)
    x0 = (1.0 - 1e-4, 1e-4, 0.0, 0.0, 0.0)
    ref = jax_models.seirp_rollout(*rates, *x0, T, dt)
    got = port_models.seirp_rollout(*rates, *x0, T, dt, **CPU)
    for k, (g_, r_) in enumerate(zip(got, ref)):
        _close(g_, r_, what=f"seirp compartment {k}")

    # scalar rates broadcast; a (3,) batch of alpha_e series equals the
    # three single runs bit for bit
    batch_ae = np.stack([rates[0], 0.9 * rates[0], 1.1 * rates[0]])
    batch = port_models.seirp_rollout(torch.as_tensor(batch_ae),
                                      *rates[1:], *x0, T, dt)
    for b in range(3):
        single = port_models.seirp_rollout(batch_ae[b], *rates[1:], *x0, T,
                                           dt, **CPU)
        for g_, b_ in zip(single, batch):
            assert torch.equal(b_[b], g_)

    # the saturated-resource model (testSEIRP03's tanh ramp crossed inside
    # the run)
    r5 = [rates[j] for j in (0, 1, 2, 3, 6)]
    sat = (0.1, 0.05, 0.02, 0.2, 0.01, 0.05)
    ref = jax_models.seirp_saturated_rollout(*r5, *x0, T, dt, *sat)
    got = port_models.seirp_saturated_rollout(*r5, *x0, T, dt, *sat, **CPU)
    for k, (g_, r_) in enumerate(zip(got, ref)):
        _close(g_, r_, what=f"saturated compartment {k}")
    assert float(got[2].max()) > 0.01  # the ramp's threshold i_0 is crossed


def test_seirp_steps_and_linearization_match_jax():
    from epidemicmodeling_tpu.models.seirp import seirp_linearized_matrices
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 0.3, 5)
    r7 = rng.uniform(0.001, 0.7, 7)
    _close(port_models.seirp_step(torch.as_tensor(x), torch.as_tensor(r7),
                                  0.3),
           jax_models.seirp_step(x, r7, 0.3))
    sat = (0.1, 0.05, 0.02, 0.2, 0.01, 0.05)
    _close(port_models.seirp_saturated_step(
        torch.as_tensor(x), torch.as_tensor(r7[:5]), 0.3, *sat),
        jax_models.seirp_saturated_step(x, r7[:5], 0.3, *sat))
    _close(port_models.sir_step(torch.as_tensor(x[:3]), dict(
        alpha=0.4, beta=0.1, gamma=0.01, dt=0.3)),
        jax_models.sir_step(x[:3], dict(alpha=0.4, beta=0.1, gamma=0.01,
                                        dt=0.3)))
    _close(port_models.seirp_linearized_matrices(*r7, **CPU),
           seirp_linearized_matrices(*r7))


@pytest.mark.parametrize("name", sorted(jax_analysis.SEIRP_SCENARIOS))
def test_seirp_scenarios_match_jax(name):
    ref = jax_analysis.run_seirp_scenario(name, dt=0.5)
    got = port_analysis.run_seirp_scenario(name, dt=0.5, **CPU)
    for k in ("t", "s", "e", "i", "r", "p"):
        _close(got[k], ref[k], what=k)
    assert got["N"] == ref["N"] and got["dt"] == ref["dt"]
    for k, v in ref["rates"].items():
        np.testing.assert_array_equal(got["rates"][k], v, err_msg=k)


def test_linear_systems_match_jax():
    rng = np.random.default_rng(11)
    A = np.asarray(jax_analysis.seirp_early_phase_matrix(**RATES_A))
    A_port = port_analysis.seirp_early_phase_matrix(**RATES_A, **CPU)
    _close(A_port, A)
    for C in (np.concatenate([np.zeros((3, 1)), np.eye(3)], axis=1),
              np.array([[0.0, 0, 0, 1]]), np.array([0.0, 1, 0, 0])):
        ob = port_analysis.obsv(A, C, **CPU)
        ob_ref = np.asarray(jax_analysis.obsv(A, C))
        _close(ob, ob_ref)
        assert np.linalg.matrix_rank(ob.numpy()) == \
            np.linalg.matrix_rank(ob_ref)
    M = rng.standard_normal((4, 4))
    for B in (rng.standard_normal((4, 2)), rng.standard_normal((2, 4)),
              np.array([0.0, 1.0, 0.0, 0.0])):
        ct = port_analysis.ctrb(M, B, **CPU)
        ct_ref = np.asarray(jax_analysis.ctrb(M, B))
        assert ct.shape == ct_ref.shape
        _close(ct, ct_ref)
        assert np.linalg.matrix_rank(ct.numpy()) == \
            np.linalg.matrix_rank(ct_ref)
    op = rng.uniform(0, 0.05, 4)
    _close(port_analysis.seirp_jacobian(*op, **RATES_A, **CPU),
           jax_analysis.seirp_jacobian(*op, **RATES_A))
    for rates in (RATES_A, dict(RATES_A, gamma=0.01, kappa=0.3)):
        lam = port_analysis.seirp_early_eigen(**rates, **CPU)
        _close(lam, jax_analysis.seirp_early_eigen(**rates))
        # and against the numeric eigenvalues of the port's own matrix
        num = torch.linalg.eigvals(port_analysis.seirp_early_phase_matrix(
            **rates, **CPU)).real
        np.testing.assert_allclose(np.sort(lam.numpy()),
                                   np.sort(num.numpy()), atol=1e-12)
    t = np.linspace(0.0, 25.0, 251)
    for g_, r_ in zip(
            port_analysis.seirp_early_closed_form(t, 1 / 84e6, **RATES_A,
                                                  **CPU),
            jax_analysis.seirp_early_closed_form(t, 1 / 84e6, **RATES_A)):
        _close(g_, r_)


def test_country_stats_match_jax():
    rng = np.random.default_rng(7)
    T, C = 40, 3
    total = np.cumsum(np.abs(rng.normal(50, 30, (C, T))), axis=1)
    total[1, 10] -= 120.0   # a negative revision: negative new cases
    total[2, :3] = 0.0      # 0/0 in the mortality ratio
    dead = 0.02 * total
    dead[0, 5] = 3.0
    reco = 0.3 * total
    infected = np.abs(rng.normal(200, 80, (C, T))) + 1.0
    _close(port_analysis.mortality_rate(dead, total, **CPU),
           jax_analysis.mortality_rate(dead, total), dict(rtol=0, atol=0))
    _close(port_analysis.active_cases(total, dead, reco, **CPU),
           jax_analysis.active_cases(total, dead, reco),
           dict(rtol=0, atol=0))
    for p in (1, 3, 5):
        _close(port_analysis.r0_generation_ratio(infected[0], p, **CPU),
               jax_analysis.r0_generation_ratio(infected[0], p))
    x = rng.normal(size=(2, 15))
    for clip in (True, False):
        _close(port_analysis.causal_moving_average(x, 4, clip, **CPU),
               jax_analysis.causal_moving_average(x, 4, clip))
    for lag in (0, 3):
        for smoothed in (False, True):
            got = port_analysis.lagged_case_rate(total, infected, lag=lag,
                                                 smoothed=smoothed, **CPU)
            assert got.shape == (C, T - 1 - lag)
            _close(got, jax_analysis.lagged_case_rate(
                total, infected, lag=lag, smoothed=smoothed),
                what=f"lag {lag} smoothed {smoothed}")


def _certify(res, eps, w, a, beta, optimal=True, **kw):
    """chip_smoke.shooting_certificates on the port's own series: H within
    1e-11 of its recomputed terms' scale, and no single flip of a
    bang-bang control lowering H."""
    h, flips = shooting_certificates(res, eps, w, a, np.zeros(12), U_MAX,
                                     beta, optimal=optimal, **kw)
    assert h <= 1.0 and flips, (h, flips)


def _shooting_problem(seed):
    rng = np.random.default_rng(seed)
    P, K, dt = 12, 500, 0.1
    w = rng.uniform(0.5, 1.5, P) if seed else np.ones(P)
    return dict(epsilon=0.2, w=w, a=0.01 * np.ones(P) if not seed
                else rng.uniform(0.005, 0.02, P), u_min=np.zeros(P),
                u_max=U_MAX, gamma=1 / 7, beta=1 / 7, s0=0.99, i0=0.01,
                alpha0=0.1, lambda_init=np.array([-1.0, 1.0, 1.0]),
                K=K, dt=dt), rng


def _hold_shooting(got, ref, what):
    np.testing.assert_array_equal(got.u.numpy(), np.asarray(ref.u),
                                  err_msg=what)
    for f in ("s", "i", "alpha", "lambdas", "J0", "J1"):
        _close(getattr(got, f), getattr(ref, f), SHOOT_TOL, f"{what} {f}")


@pytest.mark.parametrize("seed", [0, 1])
def test_hamiltonian_shooting_matches_jax(seed):
    """tests/test_analysis.py's setting (P = 12, K = 500, dt = 0.1): the
    bang-bang run and two fixed random schedules."""
    kw, rng = _shooting_problem(seed)
    ref = jax_analysis.si_alpha_hamiltonian_shooting(**kw)
    got = port_analysis.si_alpha_hamiltonian_shooting(**kw, **CPU)
    assert isinstance(got, port_analysis.shooting.ShootingResult)
    _hold_shooting(got, ref, "optimal")
    u = got.u.numpy()
    assert np.all((u == 0.0) | (u == U_MAX[None, :]))  # bang-bang
    _certify(got, kw["epsilon"], kw["w"], kw["a"], kw["beta"],
             gamma=kw["gamma"])
    for _ in range(2):
        sched = rng.integers(0, 4, (kw["K"], 12)).astype(float)
        ref = jax_analysis.si_alpha_hamiltonian_shooting(**kw,
                                                         u_schedule=sched)
        got = port_analysis.si_alpha_hamiltonian_shooting(
            **kw, u_schedule=sched, **CPU)
        _hold_shooting(got, ref, "fixed schedule")
        _certify(got, kw["epsilon"], kw["w"], kw["a"], kw["beta"],
                 optimal=False, gamma=kw["gamma"])
    # time-varying weights and a finite alpha_max
    w_tv = rng.uniform(0.2, 2.0, (kw["K"], 12))
    kw2 = dict(kw, w=w_tv, alpha_max=0.12)
    ref = jax_analysis.si_alpha_hamiltonian_shooting(**kw2)
    got = port_analysis.si_alpha_hamiltonian_shooting(**kw2, **CPU)
    _hold_shooting(got, ref, "time-varying w")
    _certify(got, kw["epsilon"], w_tv, kw["a"], kw["beta"], gamma=kw["gamma"])


def test_multiplicative_shooting_matches_jax():
    P = 12
    kw = dict(epsilon=0.2, w=np.ones(P), a=0.0001 * np.ones(P), c=0.0004,
              u_min=np.zeros(P), u_max=U_MAX, beta=1 / 7, s0=0.99, i0=0.01,
              alpha0=0.1, lambda_init=np.zeros(3), K=400, dt=0.1,
              alpha_max=10.0)
    for lam0 in (np.zeros(3), np.array([-0.5, 0.2, 3.0])):
        kw["lambda_init"] = lam0
        ref = jax_analysis.si_alpha_multiplicative_shooting(**kw)
        got = port_analysis.si_alpha_multiplicative_shooting(**kw, **CPU)
        _hold_shooting(got, ref, f"lambda0 {lam0}")
        u = got.u.numpy()
        assert np.all((u == 0.0) | (u == U_MAX[None, :]))
        _certify(got, kw["epsilon"], kw["w"], kw["a"], kw["beta"],
                 c=kw["c"])
    sched = np.random.default_rng(3).integers(0, 3, (400, P)).astype(float)
    ref = jax_analysis.si_alpha_multiplicative_shooting(**kw,
                                                        u_schedule=sched)
    got = port_analysis.si_alpha_multiplicative_shooting(
        **kw, u_schedule=sched, **CPU)
    _hold_shooting(got, ref, "fixed schedule")


@pytest.mark.parametrize("gamma", [0.0, 3e-5])
def test_continuous_control_matches_jax(gamma):
    P = 12
    kw = dict(A_coefs=0.002 * np.ones(P), w=np.ones(P), u_min=np.zeros(P),
              u_max=U_MAX, gamma=gamma, beta=1 / 7, s0=0.99, i0=0.01,
              rho0=-1.0, lambda20=0.0, K=300, dt=0.1)
    ref = jax_analysis.si_continuous_control(**kw)
    got = port_analysis.si_continuous_control(**kw, **CPU)
    assert sorted(got) == sorted(ref)
    np.testing.assert_array_equal(got["u"].numpy(), np.asarray(ref["u"]))
    for k in ("s", "i", "alpha", "J0", "J1"):
        _close(got[k], ref[k], SHOOT_TOL, k)
    if gamma == 0.0:
        assert (got["u"] == 0).all()
    else:  # the law leaves the box's corners: interior rounded levels
        u = got["u"].numpy()
        assert ((u > 0) & (u < U_MAX)).any()


@pytest.mark.parametrize("call", [
    lambda: port_models.sir_rollout(0.99, 0.01, 0.0, 0.3, 0.1, 0.0, 5, 1.0),
    lambda: port_analysis.run_seirp_scenario("A", dt=1.0),
    lambda: port_analysis.seirp_early_eigen(**RATES_A),
    lambda: port_analysis.mortality_rate(np.ones(3), np.ones(3)),
    lambda: port_analysis.si_continuous_control(
        np.ones(2), np.ones(2), np.zeros(2), np.ones(2), 0.1, 0.1, 0.9, 0.1,
        -1.0, 0.0, 3, 0.1),
])
def test_entry_points_run_on_the_card_by_default(call):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
