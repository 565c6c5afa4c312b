"""The port's associative-scan Kalman filter and RTS smoother
(ops/parallel_kf.py) against the JAX package's parallel_kalman, float64,
on tests/test_parallel_kf.py's systems: the gap cases and the four fuzz
seeds. The port's scan follows jax.lax.associative_scan's recursion, so
the combinations happen in the same order: every output is held at
rtol 1e-12 with atol 1e-12 times its largest magnitude (measured: ~5e-15
of it, CPU run). The port is also held against its own sequential generic
EKF/EKS (ops/ekf.py) on the same linear system, at test_parallel_kf.py's
parallel-vs-sequential tolerances, and its scan against
jax.lax.associative_scan bit for bit."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from epidemicmodeling_tpu.ops.parallel_kf import \
    parallel_kalman as jax_parallel_kalman

from epidemicmodeling_torch.models.base import EKFSystem
from epidemicmodeling_torch.ops import ekf_smoother, parallel_kalman
from epidemicmodeling_torch.ops.parallel_kf import associative_scan

from tests.test_parallel_kf import _fuzz_system, build_system

FIELDS = ("means_filt", "covs_filt", "means_smooth", "covs_smooth")


def _hold_against_jax(system):
    ref = jax_parallel_kalman(*(jnp.asarray(a) for a in system))
    got = parallel_kalman(*(torch.as_tensor(a) for a in system))
    for name, g, r in zip(FIELDS, got, ref):
        r = np.asarray(r)
        assert g.dtype == torch.float64 and g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-12,
                                   atol=1e-12 * np.max(np.abs(r)),
                                   err_msg=name)


@pytest.mark.parametrize("gap", [None, (80, 120)])
def test_parallel_kalman_matches_jax(gap):
    _hold_against_jax(build_system(gap=gap))


@pytest.mark.parametrize("seed", range(4))
def test_parallel_kalman_fuzz_matches_jax(seed):
    _hold_against_jax(_fuzz_system(seed))


def _linear_system(F, H):
    """The time-invariant x_k = F x_{k-1} + w, y_k = H x_k + v as a generic
    EKF system (identity noise Jacobians)."""
    m, n = F.shape[0], H.shape[0]
    I_m, I_n = torch.eye(m, dtype=F.dtype), torch.eye(n, dtype=F.dtype)
    mv = lambda A, s: (A @ s[..., None])[..., 0]
    return EKFSystem(
        state_dim=m, obs_dim=n, input_dim=1,
        nlin_state_update=lambda u, s, w, p, k: (u, mv(F, s) + w),
        state_jacobians=lambda u, s, w, p, k: (F, I_m),
        nlin_obs_update=lambda u, s, v, p, k: mv(H, s) + v,
        obs_jacobian=lambda u, s, v, p, k: (H, I_n),
        state_hard_margins=lambda s, p, k: s,
        obs_hard_margins=lambda x, p, k: x)


@pytest.mark.parametrize("gap", [None, (80, 120)])
def test_parallel_kalman_matches_the_sequential_ekf(gap):
    F, Q, H, R, y, m0, P0 = (torch.as_tensor(a)
                             for a in build_system(gap=gap))
    T = F.shape[0]
    par = parallel_kalman(F, Q, H, R, y, m0, P0)
    seq = ekf_smoother(_linear_system(F[1], H[0]),
                       torch.zeros(T, 1, dtype=F.dtype), y, {}, m0, P0,
                       Q=Q[1], R=R[0], gamma_discount=1.0,
                       smoother_gain="solve", device="cpu")
    for got, ref, tol in ((par.means_filt, seq.s_plus, (1e-8, 1e-10)),
                          (par.covs_filt, seq.P_plus, (1e-8, 1e-10)),
                          (par.means_smooth, seq.s_smooth, (1e-6, 1e-8)),
                          (par.covs_smooth, seq.P_smooth, (1e-6, 1e-8))):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=tol[0],
                                   atol=tol[1])


def test_parallel_kalman_runs_on_the_card_by_default():
    """NumPy inputs: the filter runs on the CUDA card, so with no card it
    raises; CPU tensors keep it on the CPU."""
    system = build_system(gap=None)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel_kalman(*system)
    got = parallel_kalman(*(torch.as_tensor(a) for a in system))
    assert all(g.device.type == "cpu" for g in got)


@pytest.mark.parametrize("n", [1, 2, 7, 64, 101])
def test_associative_scan_follows_jax_recursion(n):
    """A non-associative-in-floats combine (a sum and a product with a
    rounding step) gives the same bits only in the same combination
    order."""
    rng = np.random.default_rng(n)
    a, b = rng.standard_normal(n), rng.uniform(0.5, 1.5, n)
    fn = lambda x, y: (x[0] * y[1] + y[0], x[1] * y[1])
    ref = jax.lax.associative_scan(fn, (jnp.asarray(a), jnp.asarray(b)))
    got = associative_scan(fn, (torch.as_tensor(a), torch.as_tensor(b)))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
