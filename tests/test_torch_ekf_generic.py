"""The port's generic EKF/EKS core (epidemicmodeling_torch/ops/ekf.py), its
systems and the Rt estimator, held against the JAX package and the NumPy
oracles on the same seeded float64 inputs, on the CPU.

Tolerances: rtol 1e-9 / atol 1e-12 against the JAX core (the golden
tolerance of tests/test_ekf.py), on every output the run returns, except:
- the costate system: its costates cross zero and are chaotic at the ulp
  level, so summation orders move them ~1e-9 absolute over 100 steps
  (tests/test_ekf.py:207-210): the bound that test holds the JAX core to,
  rtol 1e-4 / atol 1e-8 (the port reads 8.7e-6 relative, 3.5e-9 absolute
  on a costate near zero against JAX, CPU run), and the prescribed inputs
  exactly;
- the oracles, at the tolerances the JAX package's own tests hold them to
  (tests/test_ekf.py, tests/test_rt.py, tests/test_ekf_fuzz.py).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from epidemicmodeling_tpu.models import (
    SIAlphaParams, si_alpha_backward_ekf_system as jax_backward3,
    si_alpha_costate_backward_ekf_system as jax_backward6,
    si_alpha_costate_ekf_system as jax_costate,
    si_alpha_ekf_system as jax_sia)
from epidemicmodeling_tpu.ops import ekf_smoother as jax_ekf
from epidemicmodeling_tpu.ops import backward_ekf_smoother as jax_backward
from epidemicmodeling_tpu.ops.ekf import _matlab_pinv as jax_pinv
from epidemicmodeling_tpu.rt.estimators import rt_expfit_ekf as jax_rt

from epidemicmodeling_torch.models import (
    si_alpha_backward_ekf_system, si_alpha_costate_backward_ekf_system,
    si_alpha_costate_ekf_system, si_alpha_ekf_system)
from epidemicmodeling_torch.ops import (backward_ekf_smoother,
                                        batched_ekf_smoother, ekf_smoother)
from epidemicmodeling_torch.ops.ekf import _matlab_pinv
from epidemicmodeling_torch.rt import rt_expfit_ekf

from tests import oracle_ekf
from tests.oracle_rt import rt_expfit_ekf_oracle
from tests.test_ekf import U_MAX, make_setup
from tests.test_matlab_pinv import _rand_spd

TOL = dict(rtol=1e-9, atol=1e-12)
COSTATE_TOL = dict(rtol=1e-4, atol=1e-8)
SYSTEMS = {"NEWCASES": (si_alpha_ekf_system, jax_sia),
           "costate": (si_alpha_costate_ekf_system, jax_costate)}


def _t(a):
    return torch.tensor(np.asarray(a, float))


def _params(pr):
    return {k: _t(v) for k, v in pr.items()}


def _run(obs_type, args, kw, system="NEWCASES"):
    """The port and the JAX core on the same NumPy inputs ``args`` (u, x,
    params, s_init, Ps_init, s_final, Ps_final) and options ``kw``."""
    u, x, pr, si, Pi, sf, Pf = args
    port_sys, jax_sys = SYSTEMS[system]
    port = ekf_smoother(port_sys(obs_type), _t(u), _t(x), _params(pr),
                        _t(si), _t(Pi), None if sf is None else _t(sf),
                        None if Pf is None else _t(Pf),
                        **{k: _t(v) if isinstance(v, np.ndarray) else v
                           for k, v in kw.items()})
    ref = jax_ekf(jax_sys(obs_type), jnp.asarray(u), jnp.asarray(x),
                  SIAlphaParams(**pr), jnp.asarray(si), jnp.asarray(Pi),
                  None if sf is None else jnp.asarray(sf),
                  None if Pf is None else jnp.asarray(Pf),
                  **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                     for k, v in kw.items()})
    return port, ref


def _assert_same(port, ref, tol=TOL, fields=None):
    for f in fields or ref._fields:
        r = getattr(ref, f)
        p = getattr(port, f)
        assert (p is None) == (r is None), f
        if r is not None:
            np.testing.assert_allclose(p.numpy(), np.asarray(r), **tol,
                                       err_msg=f)


def _setup3(T, seed, nan_tail=0, hole=False):
    u, obs, _, pr, s_init, Ps_init, Q, R_v = make_setup(
        T=T, seed=seed, obs_nan_tail=nan_tail)
    if hole:
        obs = obs.copy()
        obs[T // 3:T // 3 + 6] = np.nan
    return (u, obs, pr, s_init, Ps_init, None, None), Q, R_v


@pytest.mark.parametrize("case", ["basic", "nan_tail", "terminal"])
def test_matches_jax_and_oracle(case):
    """The 3-state system against the JAX core and the oracle: a plain run,
    a NaN forecast tail, and terminal conditions (NaN = unconstrained)."""
    args, Q, R_v = _setup3(120, {"basic": 0, "nan_tail": 1,
                                 "terminal": 3}[case],
                           nan_tail=30 if case == "nan_tail" else 0)
    if case == "terminal":
        Pf = np.full((3, 3), np.nan)
        Pf[2, 2] = 1e-8
        args = args[:5] + (np.array([np.nan, np.nan, 0.2]), Pf)
    kw = dict(Q=Q, R=R_v, gamma_discount=0.995)
    port, ref = _run("NEWCASES", args, kw)
    _assert_same(port, ref)
    u, obs, pr, si, Pi, sf, Pf = args
    orc = oracle_ekf.generic_ekf(
        u.T, obs.reshape(1, -1), oracle_ekf.si_alpha_handles("NEWCASES"),
        {k: np.asarray(v, float) for k, v in pr.items()}, si, Pi,
        np.full(3, np.nan) if sf is None else sf,
        np.full((3, 3), np.nan) if Pf is None else Pf, np.zeros(3),
        np.zeros(1), Q, R_v, 1.0, 0.995, 21, 1)
    for name, i in (("s_minus", 2), ("s_plus", 3), ("s_smooth", 4)):
        np.testing.assert_allclose(getattr(port, name).numpy(), orc[i].T,
                                   **TOL, err_msg=name)
    np.testing.assert_allclose(port.rho.numpy().reshape(-1),
                               orc[10].reshape(-1), **TOL)
    if case == "terminal":
        assert float(port.s_smooth[-1, 2]) == 0.2


@pytest.mark.parametrize("always", [False, True], ids=["reset", "carry"])
def test_adaptive_R_reset_and_carry(always):
    """Fixed R with beta = 0.9 and a NaN hole: the generic filter resets the
    adapted R to the prior after the hole, adaptive_R_always carries it;
    the two runs must differ after the hole and each match JAX."""
    args, Q, R_v = _setup3(100, 2, hole=True)
    kw = dict(Q=Q, R=np.array([[float(R_v[0])]]), beta=0.9,
              gamma_discount=0.995, adaptive_R_always=always)
    port, ref = _run("NEWCASES", args, kw)
    _assert_same(port, ref)
    other, _ = _run("NEWCASES", args, dict(kw, adaptive_R_always=not always))
    assert not torch.allclose(port.s_plus[60:], other.s_plus[60:],
                              rtol=1e-6, atol=0)


def test_time_varying_R_adapts_only_when_asked():
    """A per-day R adapts only with adaptive_R_always (GEKF.m:180)."""
    args, Q, R_v = _setup3(80, 5, hole=True)
    for always in (False, True):
        kw = dict(Q=Q, R=R_v, beta=0.9, adaptive_R_always=always)
        port, ref = _run("NEWCASES", args, kw)
        _assert_same(port, ref)
    plain, _ = _run("NEWCASES", args, dict(Q=Q, R=R_v))
    inert, _ = _run("NEWCASES", args, dict(Q=Q, R=R_v, beta=0.9))
    assert torch.equal(plain.s_smooth, inert.s_smooth)


def test_totalcases_matches_jax():
    args, Q, _ = _setup3(100, 11)
    u, _, pr, si, Pi, sf, Pf = args
    rng = np.random.default_rng(11)
    obs = np.cumsum(np.abs(rng.normal(1e-4, 2e-5, 100)))
    obs[70:] = np.nan
    kw = dict(Q=Q, R=np.full(100, 1e-10), gamma_discount=0.995)
    port, ref = _run("TOTALCASES", (u, obs, pr, si, Pi, sf, Pf), kw)
    _assert_same(port, ref)


def _costate_args(T=100, T_hist=70, seed=4, eps=0.35):
    (u, obs, pr, si3, Pi3, _, _), Q3, R_v = _setup3(T, seed)
    obs, u = obs.copy(), u.copy()
    obs[T_hist:] = np.nan
    u[T_hist:] = np.nan
    pr = dict(pr, epsilon=eps, w=np.ones(12), sigma=1e6)
    si = np.concatenate([si3, np.zeros(3)])
    Pi = np.zeros((6, 6))
    Pi[:3, :3] = Pi3
    np.fill_diagonal(Pi[3:, 3:], 10.0 * 1e-8)
    Q = np.zeros((6, 6))
    Q[:3, :3] = Q3
    np.fill_diagonal(Q[3:, 3:], 1e-8)
    sf = np.array([np.nan] * 3 + [0.0] * 3)
    Pf = np.zeros((6, 6))
    Pf[:3, :3] = np.nan
    np.fill_diagonal(Pf[3:, 3:], 1e-8)
    return (u, obs, pr, si, Pi, sf, Pf), Q, R_v


@pytest.mark.parametrize("outputs", ["full", "light"])
@pytest.mark.parametrize("gain", ["pinv", "solve"])
def test_costate_bang_bang(outputs, gain):
    """The 6-state optimal-control system with NaN future inputs, both
    smoother gains and both output sets, against JAX (and, full + pinv,
    the oracle at tests/test_ekf.py's own bound): the NaN inputs are filled
    by the bang-bang law, so the prescribed inputs are u_min or u_max and
    equal JAX's exactly."""
    args, Q, R_v = _costate_args()
    kw = dict(Q=Q, R=R_v, gamma_discount=0.995, smoother_gain=gain,
              outputs=outputs)
    port, ref = _run("NEWCASES", args, kw, system="costate")
    _assert_same(port, ref, COSTATE_TOL)
    np.testing.assert_array_equal(port.u_opt_smooth.numpy(),
                                  np.asarray(ref.u_opt_smooth))
    u_sm = port.u_opt_smooth.numpy()[70:-1]
    assert ((u_sm == 0.0) | (u_sm == U_MAX)).all()
    if outputs == "light":
        assert port.P_minus is None and port.rho is None
    if outputs == "full" and gain == "pinv":
        u, obs, pr, si, Pi, sf, Pf = args
        orc = oracle_ekf.generic_ekf(
            u.T, obs.reshape(1, -1),
            oracle_ekf.si_alpha_costate_handles("NEWCASES"),
            {k: np.asarray(v, float) for k, v in pr.items()}, si, Pi, sf, Pf,
            np.zeros(6), np.zeros(1), Q, R_v, 1.0, 0.995, 21, 1)
        np.testing.assert_allclose(port.s_smooth.numpy(), orc[4].T,
                                   rtol=1e-4, atol=1e-8)


@pytest.mark.parametrize("cond", [1e6, 1e14, 1e15, 1e16])
def test_matlab_pinv_matches_jax_and_oracle(cond):
    """MATLAB's exact cutoff on tests/test_matlab_pinv.py's inputs (at
    cond ~ 1/eps64 it decides which singular values survive), batched over
    five matrices: the same kept rank as the JAX package's _matlab_pinv and
    the oracle's (trace(pinv(A) A) counts it), and the same pinv to
    kappa * 1e-12 of its scale, kappa = sigma_max / (smallest kept sigma).
    A pinv is determined only to ~kappa * eps: the JAX package and the
    oracle agree to 1e-9 at any kappa because jaxlib and NumPy run the
    same LAPACK gesdd code, and torch's CPU SVD is MKL's (a 1e14-conditioned
    input reads 5.1e-6 here; 1e-9 at cond 1e6, CPU run)."""
    rng = np.random.default_rng(1)
    A = np.stack([_rand_spd(rng, 6, cond) for _ in range(5)])
    got = _matlab_pinv(_t(A)).numpy()
    for k in range(5):
        rank = round(np.trace(got[k] @ A[k]))
        s = np.linalg.svd(A[k])[1]
        kappa = s[0] / s[rank - 1]
        for ref in (np.asarray(jax_pinv(jnp.asarray(A[k]))),
                    oracle_ekf.matlab_pinv(A[k])):
            assert rank == round(np.trace(ref @ A[k])), (cond, k)
            scale = max(np.abs(ref).max(), 1.0)
            err = np.abs(got[k] - ref).max() / scale
            assert err < max(kappa * 1e-12, 1e-9), (cond, k, err)


def test_matlab_pinv_strict_cutoff():
    """A singular value exactly at tol is dropped, just above it kept, and
    a power-of-two rescaling of the input changes nothing."""
    tol = 4 * np.spacing(1.0)
    for delta, kept in ((0.0, False), (2.0 * tol, True)):
        A = np.diag([1.0, 0.5, 0.25, tol + delta])
        for scale in (1.0, 2.0 ** 40, 2.0 ** -40):
            got = _matlab_pinv(_t(A * scale)).numpy() * scale
            np.testing.assert_allclose(got, oracle_ekf.matlab_pinv(A),
                                       rtol=1e-12, atol=0)
            assert (got[3, 3] > 0) == kept


@pytest.mark.parametrize("gain", ["pinv", "solve"])
def test_nonfinite_prior_covariance_zeroes_the_gain(gain):
    """A NaN observation model pushes P- to non-finite values on one lane:
    the smoother must not raise (torch's SVD does on non-finite input; the
    core swaps in the identity first) and must give J = 0 there, so the
    smoothed state is the filtered one, as in JAX."""
    args, Q, R_v = _setup3(40, 6)
    u, obs, pr, si, Pi, _, _ = args
    Q = Q.copy()
    Q[0, 0] = np.inf        # P- = A P+ A' + Q is infinite from step 1 on
    kw = dict(Q=Q, R=R_v, smoother_gain=gain)
    port, ref = _run("NEWCASES", args, kw)
    assert not torch.isfinite(port.P_minus[1:]).all()
    _assert_same(port, ref, fields=("s_plus", "s_smooth", "u_opt_smooth"))
    np.testing.assert_array_equal(port.s_smooth[:-1].numpy(),
                                  port.s_plus[:-1].numpy())


def _backward_args(m):
    """The inputs of tests/test_ar_prescribe.py's backward oracle tests
    (test_backward_ekf_matches_oracle, test_backward_costate_ekf_matches_
    oracle)."""
    T = 80 if m == 3 else 70
    rng = np.random.default_rng(11 if m == 3 else 12)
    u = rng.integers(0, 3, (T, 12)).astype(float)
    obs = np.abs(rng.normal(1e-4, 3e-5, T))
    pr = dict(dt=1.0, beta=0.2, gamma=1 / 7, a=0.004 * rng.random(12),
              b=0.05, u_min=np.zeros(12), u_max=U_MAX, s_min=1e-6,
              i_min=1e-6, alpha_min=1e-8, alpha_max=100.0)
    if m == 3:
        return (u, obs, pr, np.array([0.99, 1e-3, 0.3]),
                np.diag([1e-4, 1e-6, 0.1]), np.array([0.9, 5e-3, 0.25]),
                np.diag([1e-4, 1e-6, 0.1]), np.diag([1e-10, 1e-10, 1e-5]),
                np.full(T, 1e-12))
    u[50:] = np.nan
    obs[50:] = np.nan
    pr.update(epsilon=0.3, w=np.ones(12), sigma=1e6)
    P6 = np.diag([1e-4, 1e-6, 0.1, 1e-7, 1e-7, 1e-7])
    return (u, obs, pr, np.array([0.99, 1e-3, 0.3, 0, 0, 0.0]), P6,
            np.array([0.95, 2e-3, 0.25, 0, 0, 0.0]), P6,
            np.diag([1e-8, 1e-8, 1e-4, 1e-8, 1e-8, 1e-8]),
            np.full(T, 4e-10))


@pytest.mark.parametrize("m", [3, 6])
def test_backward_smoother_matches_jax_and_oracle(m):
    """The time-reversed systems through backward_ekf_smoother (the flip
    protocol) against the JAX package's and the oracle's
    backward_generic_ekf, on the fields and at the bounds
    tests/test_ar_prescribe.py holds the JAX package to: 3-state s_plus
    and s_smooth at rtol 1e-9; 6-state s_plus at rtol 1e-7 / atol 1e-9 and
    the filled and smoothed inputs exactly."""
    u, obs, pr, si, Pi, sf, Pf, Q, R = _backward_args(m)
    port_sys, jax_sys, handles = (
        (si_alpha_backward_ekf_system, jax_backward3,
         oracle_ekf.si_alpha_backward_handles) if m == 3 else
        (si_alpha_costate_backward_ekf_system, jax_backward6,
         oracle_ekf.si_alpha_costate_backward_handles))
    port = backward_ekf_smoother(
        port_sys(), _t(u), _t(obs), _params(pr), s_init=_t(si),
        Ps_init=_t(Pi), s_final=_t(sf), Ps_final=_t(Pf), Q=_t(Q), R=_t(R),
        gamma_discount=0.995)
    ref = jax_backward(
        jax_sys(), jnp.asarray(u), jnp.asarray(obs), SIAlphaParams(**pr),
        s_init=jnp.asarray(si), Ps_init=jnp.asarray(Pi),
        s_final=jnp.asarray(sf), Ps_final=jnp.asarray(Pf),
        Q=jnp.asarray(Q), R=jnp.asarray(R), gamma_discount=0.995)
    orc = oracle_ekf.backward_generic_ekf(
        u.T, obs.reshape(1, -1), handles(),
        {k: np.asarray(v, float) for k, v in pr.items()}, si, Pi, sf, Pf,
        np.zeros(m), np.zeros(1), Q, R.reshape(1, 1, -1), 1.0, 0.995, 21, 1)
    if m == 3:
        checks = (("s_plus", 3, TOL), ("s_smooth", 4, TOL))
    else:
        exact = dict(rtol=0, atol=0)
        checks = (("s_plus", 3, dict(rtol=1e-7, atol=1e-9)),
                  ("u_opt", 0, exact), ("u_opt_smooth", 1, exact))
    for name, i, tol in checks:
        got = getattr(port, name).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(ref, name)), **tol,
                                   err_msg=name)
        np.testing.assert_allclose(got, orc[i].T, **tol, err_msg=name)


@pytest.mark.parametrize("system", ["NEWCASES", "costate"])
def test_batch_equals_per_lane_loop(system):
    """Four filters as one batch (batched_ekf_smoother) against the same
    four run one at a time: the batch only adds a leading axis, so each
    lane must come out as its own run does (rtol 1e-12: batched and single
    matrix products may round differently in the last bit, which the
    costates' chaos grows to the costate bound), the inputs exactly."""
    lanes = []
    for b in range(4):
        if system == "NEWCASES":
            args, Q, R_v = _setup3(60, 10 + b, hole=b % 2 == 1)
            sf = np.full(3, np.nan)
            Pf = np.full((3, 3), np.nan)
            args = args[:5] + (sf, Pf)
        else:
            args, Q, R_v = _costate_args(T=60, T_hist=45, seed=10 + b,
                                         eps=0.2 * (b + 1))
        lanes.append((args, Q, R_v))
    stack = lambda i: _t(np.stack([lane[0][i] for lane in lanes]))
    params = {k: _t(np.stack([lane[0][2][k] for lane in lanes]).astype(float))
              for k in lanes[0][0][2]}
    port_sys = SYSTEMS[system][0]("NEWCASES")
    kw = dict(gamma_discount=0.995, inv_monitor_len=7)
    batch = batched_ekf_smoother(
        port_sys, stack(0), stack(1), params, stack(3), stack(4), stack(5),
        stack(6), Q=_t(np.stack([lane[1] for lane in lanes])),
        R=_t(np.stack([lane[2] for lane in lanes])), **kw)
    assert batch.s_smooth.shape[:2] == (4, 60)
    tol = (dict(rtol=1e-12, atol=1e-15) if system == "NEWCASES"
           else COSTATE_TOL)
    for b, (args, Q, R_v) in enumerate(lanes):
        u, obs, pr, si, Pi, sf, Pf = args
        one = ekf_smoother(port_sys, _t(u), _t(obs), _params(pr), _t(si),
                           _t(Pi), _t(sf), _t(Pf), Q=_t(Q), R=_t(R_v), **kw)
        for f in one._fields:
            np.testing.assert_allclose(getattr(batch, f)[b].numpy(),
                                       getattr(one, f).numpy(), **tol,
                                       err_msg=f)
        np.testing.assert_array_equal(batch.u_opt_smooth[b].numpy(),
                                      one.u_opt_smooth.numpy())


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("seed", [0, 2])
def test_rt_expfit_ekf_matches_jax_and_oracle(order, seed):
    """The Rt estimator (the repo's only order-2 EKF) against the JAX
    package and tests/oracle_rt.py, on tests/test_ekf_fuzz.py's inputs:
    interior NaN holes, noise means, adaptive R (carried through NaN steps)
    and the gain discount."""
    rng = np.random.default_rng(6000 + seed)
    T = 90
    lam = float(rng.uniform(0.01, 0.06))
    x = 5.0 * np.exp(lam * np.arange(T)) * np.exp(
        0.03 * rng.standard_normal(T))
    for _ in range(rng.integers(1, 3)):
        start = int(rng.integers(10, T - 15))
        x[start:start + int(rng.integers(2, 7))] = np.nan
    ts, al, sg = 1.0, float(rng.uniform(0.8, 1.0)), float(
        rng.choice([1.0, 5.0]))
    w_bar = np.array([0.0, float(rng.normal(0.0, 0.01))])
    v_bar = np.array([float(rng.normal(0.0, 0.05))])
    s_init, Ps_init = np.array([5.0, 0.0]), np.diag([1.0, 0.1])
    Q = np.diag([1e-2, 1e-4]) * 10.0 ** rng.uniform(-0.5, 0.5)
    R = np.array([[1e-2]])
    beta, gamma = float(rng.choice([1.0, 0.9])), float(
        rng.choice([1.0, 0.995]))
    kw = dict(time_scale=ts, alpha=al, sigma=sg, beta=beta, gamma=gamma,
              order=order)
    port = rt_expfit_ekf(x, s_init=s_init, w_bar=w_bar, v_bar=v_bar,
                         Ps_init=Ps_init, Q_w=Q, R_v=R, device="cpu", **kw)
    ref = jax_rt(jnp.asarray(x), s_init=jnp.asarray(s_init),
                 w_bar=jnp.asarray(w_bar), v_bar=jnp.asarray(v_bar),
                 Ps_init=jnp.asarray(Ps_init), Q_w=jnp.asarray(Q),
                 R_v=jnp.asarray(R), **kw)
    _assert_same(port, ref)
    (S_MINUS, S_PLUS, _, P_PLUS, _, S_SMOOTH, _, _, rho) = \
        rt_expfit_ekf_oracle(x, s_init, (ts, al, sg), w_bar, v_bar, Ps_init,
                             Q, R, beta, gamma, 21, order)
    np.testing.assert_allclose(port.s_plus.numpy(), S_PLUS.T, **TOL)
    np.testing.assert_allclose(port.P_plus.numpy(), np.moveaxis(P_PLUS, 2, 0),
                               **TOL)
    np.testing.assert_allclose(port.s_smooth.numpy(), S_SMOOTH.T,
                               rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(port.rho.numpy().reshape(-1), rho, **TOL)


def test_order_two_needs_hessian_terms():
    """order=2 on a system without Hessian terms: a TypeError naming them
    before any step, where the JAX core calls the missing callback."""
    args, Q, R_v = _setup3(20, 0)
    with pytest.raises(TypeError, match="obs_hessian_terms"):
        _run("NEWCASES", args, dict(Q=Q, R=R_v, order=2))


def test_entry_defaults_to_the_card(monkeypatch):
    """NumPy inputs and no device=: the core runs on the CUDA card, so with
    no card it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt_expfit_ekf(np.ones(10), np.array([1.0, 0.0]), 1.0, 1.0, 1.0,
                      np.zeros(2), np.zeros(1), np.eye(2), np.eye(2) * 1e-2,
                      np.array([[1e-2]]))
