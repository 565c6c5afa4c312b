"""The port's batch-last EKF/EKS core and the kernels' plain versions, held
against the JAX package on the same NumPy inputs.

* ops/ekf_bl.ekf_smoother_bl at float64 vs the JAX ekf_smoother_bl (x64 on
  the CPU): both systems, both observation types, beta = 1 and the fixed-R
  adaptation beta = 0.9, NaN observations in the tail and in an interior
  hole. Same arithmetic in the same order, so the scaled error
  |a - b| / (|b| + 1) is held at 1e-9 and u_opt_smooth exactly.
* ekf3_plain / ekf6_plain at float32 vs the Pallas kernels ekf3_pallas /
  ekf6_pallas in interpret mode (as tests/test_ekf6_kernel.py runs them), at
  the tolerances of tests/test_ekf6_kernel.py:83-86,188-190: both run f32,
  and op-order roundoff compounds on the exploding costates. The discrete
  prescriptions on rows [T_hist, T-1) must be exactly equal.
* rho_from_priors and both parameter packers.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from epidemicmodeling_tpu.models.batch_last import (
    si_alpha_costate_ekf_system_bl as jax_sys6,
    si_alpha_ekf_system_bl as jax_sys3)
from epidemicmodeling_tpu.ops.ekf_bl import ekf_smoother_bl as jax_eks
from epidemicmodeling_tpu.ops.pallas.ekf3_kernel import (
    ekf3_pallas, pack_params3_for_kernel as jax_pack3,
    rho_from_priors as jax_rho)
from epidemicmodeling_tpu.ops.pallas.ekf6_kernel import (
    ekf6_pallas, pack_params_for_kernel as jax_pack6)

from epidemicmodeling_torch.models.batch_last import (
    si_alpha_costate_ekf_system_bl, si_alpha_ekf_system_bl)
from epidemicmodeling_torch.ops.cuda.ekf3_kernel import (
    ekf3, ekf3_plain, pack_params3_for_kernel, rho_from_priors)
from epidemicmodeling_torch.ops.cuda.ekf6_kernel import (
    ekf6, ekf6_plain, pack_params_for_kernel)
from epidemicmodeling_torch.ops.ekf_bl import ekf_smoother_bl

from tests._torch_helpers import make_inputs, scaled_err


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _torch(d):
    return {k: ({kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
                if isinstance(v, dict) else torch.from_numpy(np.array(v)))
            for k, v in d.items()}


def _jax(d):
    return {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else jnp.asarray(v))
            for k, v in d.items()}


@pytest.mark.parametrize("beta", [1.0, 0.9])
@pytest.mark.parametrize("obs_type", ["NEWCASES", "TOTALCASES"])
@pytest.mark.parametrize("m", [3, 6])
def test_ekf_smoother_bl_matches_jax_f64(m, obs_type, beta):
    d = make_inputs(m, B=16, T=60, T_hist=44, seed=m + 10 * (beta != 1),
                    obs_type=obs_type)
    L = 21
    systems = {3: (jax_sys3, si_alpha_ekf_system_bl),
               6: (jax_sys6, si_alpha_costate_ekf_system_bl)}[m]
    outs = []
    for sys_fn, conv, run in ((systems[0], _jax, jax_eks),
                              (systems[1], _torch, ekf_smoother_bl)):
        a = conv(d)
        outs.append(run(sys_fn(obs_type), a["u"], a["x"], a["params"],
                        a["s_init"], a["Ps_init"], a["s_final"],
                        a["Ps_final"], Q=a["Q"], R=a["Rv"],
                        gamma_discount=0.995, inv_monitor_len=L, beta=beta))
    ref, got = outs
    for k in ("s_minus", "s_plus", "s_smooth", "rho"):
        assert scaled_err(getattr(got, k).numpy(), getattr(ref, k)) < 1e-9, k
    np.testing.assert_array_equal(got.u_opt_smooth.numpy(),
                                  np.asarray(ref.u_opt_smooth))
    np.testing.assert_array_equal(got.u_opt.numpy(), np.asarray(ref.u_opt))


@pytest.mark.parametrize("beta", [1.0, 0.9])
def test_ekf3_plain_matches_pallas_interpret(beta):
    d = make_inputs(3, B=128, T=90, T_hist=70, seed=3, dtype=np.float32)
    B = 128
    jd = _jax(d)
    scal_j, vecs_j = jax_pack3(jd["params"], jd["Q"])
    kw = dict(gamma_discount=0.995, beta=beta, inv_monitor_len=21)
    ref = ekf3_pallas(jd["u"], jd["x"], jd["Rv"], scal_j, vecs_j,
                      jd["s_init"], jd["Ps_init"].reshape(9, B),
                      jd["s_final"], jd["Ps_final"].reshape(9, B),
                      interpret=True, **kw)
    td = _torch(d)
    scal, vecs = pack_params3_for_kernel(td["params"], td["Q"])
    got = ekf3_plain(td["u"], td["x"], td["Rv"], scal, vecs, td["s_init"],
                     td["Ps_init"].reshape(9, B), td["s_final"],
                     td["Ps_final"].reshape(9, B), **kw)
    # the device-dispatching wrapper takes the plain version for CPU tensors
    via_wrapper = ekf3(td["u"], td["x"], td["Rv"], scal, vecs, td["s_init"],
                       td["Ps_init"].reshape(9, B), td["s_final"],
                       td["Ps_final"].reshape(9, B), **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, via_wrapper))
    ssm, sp, sm = (g.numpy() for g in got)
    assert ssm.dtype == np.float32
    assert scaled_err(sp, ref[1]) < 1e-4
    assert scaled_err(sm, ref[2]) < 1e-4
    assert scaled_err(ssm, ref[0]) < 1e-3


@pytest.mark.parametrize("beta", [1.0, 0.9])
def test_ekf6_plain_matches_pallas_interpret(beta):
    B, T, T_hist = 128, 96, 64
    d = make_inputs(6, B=B, T=T, T_hist=T_hist, seed=4, dtype=np.float32)
    jd = _jax(d)
    scal_j, vecs_j = jax_pack6(jd["params"], jd["Q"])
    kw = dict(gamma_discount=0.995, beta=beta, inv_monitor_len=21)
    ref = ekf6_pallas(jd["u"], jd["x"], jd["Rv"], scal_j, vecs_j,
                      jd["s_init"], jd["Ps_init"].reshape(36, B),
                      jd["s_final"], jd["Ps_final"].reshape(36, B),
                      interpret=True, **kw)
    td = _torch(d)
    scal, vecs = pack_params_for_kernel(td["params"], td["Q"])
    args = (td["u"], td["x"], td["Rv"], scal, vecs, td["s_init"],
            td["Ps_init"].reshape(36, B), td["s_final"],
            td["Ps_final"].reshape(36, B))
    got = ekf6_plain(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, ekf6(*args, **kw)))
    ssm, usm, sp = (g.numpy() for g in got)
    assert scaled_err(sp, ref[2]) < 1e-3
    assert scaled_err(ssm, ref[0]) < 1e-2
    np.testing.assert_array_equal(usm[T_hist:-1], np.asarray(ref[1])[T_hist:-1])
    assert (usm[-1] == 0).all()


def test_rho_and_packers_match_jax():
    d = make_inputs(6, B=16, T=50, T_hist=40, seed=5)
    jd, td = _jax(d), _torch(d)
    for jax_pack, pack in ((jax_pack3, pack_params3_for_kernel),
                           (jax_pack6, pack_params_for_kernel)):
        for ref, got in zip(jax_pack(jd["params"], jd["Q"], jnp.float64),
                            pack(td["params"], td["Q"], torch.float64)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    s_minus = np.abs(np.random.default_rng(0).normal(0.3, 0.1, (50, 3, 16)))
    for L in (21, 60):
        for obs_type in ("NEWCASES", "TOTALCASES"):
            ref = jax_rho(jnp.asarray(s_minus), jd["x"], jd["Rv"], L,
                          obs_type=obs_type)
            got = rho_from_priors(torch.from_numpy(s_minus), td["x"],
                                  td["Rv"], L, obs_type=obs_type)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-12, atol=0)


def test_cpu_wrappers_refuse_bad_options():
    d = _torch(make_inputs(3, B=4, T=10, T_hist=8, seed=1))
    scal, vecs = pack_params3_for_kernel(d["params"], d["Q"])
    args = (d["u"], d["x"], d["Rv"], scal, vecs, d["s_init"],
            d["Ps_init"].reshape(9, 4), d["s_final"],
            d["Ps_final"].reshape(9, 4))
    with pytest.raises(ValueError, match="inv_monitor_len"):
        ekf3(*args, beta=0.9, inv_monitor_len=0)
    with pytest.raises(ValueError, match="observation type"):
        ekf3(*args, obs_type="DEATHS")


def _tri(P):
    """The lower triangle of a symmetric (3, 3, B) matrix, row by row, and
    back: csrc/ekf3.cu's record keeps P+ and P- this way."""
    return torch.stack([P[i, k] for i in range(3) for k in range(i + 1)])


def _untri(v):
    idx = {(i, k): i * (i + 1) // 2 + k for i in range(3) for k in range(i + 1)}
    return torch.stack([torch.stack([v[idx[max(i, k), min(i, k)]]
                                     for k in range(3)]) for i in range(3)])


@pytest.mark.parametrize("T", [1, 2, 9, 40])
@pytest.mark.parametrize("obs_type", ["NEWCASES", "TOTALCASES"])
def test_ekf3_gain_pass_then_recursion_is_the_smoother(monkeypatch, obs_type,
                                                       T):
    """csrc/ekf3.cu's backward in plain PyTorch, float64: every smoother
    gain J(t) formed first, from step t's record alone (S+, P+ of step t,
    S- and P- of step t+1, the covariances as lower triangles), then the
    recursion ss = margins(S+ + J (ss_next - S-)) from the terminal row.
    The gains do not depend on the smoothed states, so this reproduces
    ekf_smoother_bl's smoothed states bit for bit."""
    from epidemicmodeling_torch.ops import ekf_bl
    d = _torch(make_inputs(3, B=7, T=T, T_hist=max(1, T - 6), seed=T,
                           obs_type=obs_type))
    syms = []
    real_sym = ekf_bl._sym

    def keep(P):
        out = real_sym(P)
        syms.append(out)
        return out
    monkeypatch.setattr(ekf_bl, "_sym", keep)
    sys3 = si_alpha_ekf_system_bl(obs_type)
    res = ekf_smoother_bl(sys3, d["u"], d["x"], d["params"], d["s_init"],
                          d["Ps_init"], d["s_final"], d["Ps_final"],
                          Q=d["Q"], R=d["Rv"], gamma_discount=0.995)
    # the forward's symmetrizations alternate P+ of step t and P- of t + 1
    P_plus, P_minus_next = syms[0:2 * T:2], syms[1:2 * T:2]
    records = [dict(sp=res.s_plus[t], smn=res.s_minus[t + 1],
                    Pp=_tri(P_plus[t]), Pm=_tri(P_minus_next[t]))
               for t in range(T - 1)]
    for t, r in enumerate(records):        # the gain pass
        A = sys3.state_jacobian(d["u"][t], r["sp"], d["params"], t)
        PAt = ekf_bl._mmT(_untri(r["Pp"]), A, 3)
        Lc = ekf_bl._chol_bl(_untri(r["Pm"]), 3,
                             jitter=torch.finfo(torch.float64).tiny)
        r["J"] = ekf_bl._chol_solve_mat_bl(Lc, PAt.transpose(0, 1),
                                           3).transpose(0, 1)
    ss = torch.where(torch.isnan(d["s_final"]), res.s_plus[-1], d["s_final"])
    out = [ss]
    for t in range(T - 2, -1, -1):         # the recursion
        r = records[t]
        ss = sys3.state_hard_margins(
            r["sp"] + ekf_bl._mv(r["J"], ss - r["smn"], 3), d["params"], t)
        out.insert(0, ss)
    assert torch.equal(torch.stack(out), res.s_smooth)
