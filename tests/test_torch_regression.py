"""The port's LASSO and element-wise robust regressions
(epidemicmodeling_torch/regression/lasso.py, robust.py) against the JAX
package's, batched over regions and held against JAX's vmapped result on
the same seeded float64 inputs, on the CPU.

Tolerances: rtol 1e-9 / atol 1e-10 for the lasso coefficients (each lambda
stops its coordinate descent when no coefficient moves by more than
tol = 1e-10 in a sweep, so rounding that shifts a stop by one sweep moves
coefficients by less than that; they read ~1e-14 apart, CPU run), the
lambda grid and the CV curve at rtol 1e-12, the selected lambda exactly;
rtol 1e-9 / atol 1e-12 for the robust fits.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from epidemicmodeling_tpu.regression import lasso_cv as jax_lasso_cv
from epidemicmodeling_tpu.regression import lasso_path as jax_lasso_path
from epidemicmodeling_tpu.regression import \
    robust_affine_fit_elementwise as jax_robust

from epidemicmodeling_torch.pipelines import PipelineConfig
from epidemicmodeling_torch.pipelines.core import _regress
from epidemicmodeling_torch.regression import (lasso_cv, lasso_path,
                                               robust_affine_fit_elementwise)
from epidemicmodeling_torch.utils.profiling import recording

LASSO_TOL = dict(rtol=1e-9, atol=1e-10)
ROBUST_TOL = dict(rtol=1e-9, atol=1e-12)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _npi_problems(R, n, seed, outliers=False):
    """R regression problems of the train stage's form: integer NPI gaps
    (u_max - u) against a smooth contact rate, no column constant."""
    rng = np.random.default_rng(seed)
    X = rng.integers(0, 4, (R, n, 12)).astype(float)
    X[:, 0] = np.arange(12) % 4          # rows 0 and 1 differ in every column
    X[:, 1] = (np.arange(12) + 1) % 4
    y = np.einsum("rnp,rp->rn", X, 0.02 * rng.random((R, 12))) + 0.1 \
        + 0.002 * rng.standard_normal((R, n))
    if outliers:
        y[:, 3] += 2.0
        y[:, n // 2] -= 1.0
    return X, y


def test_lasso_path_matches_jax():
    X, y = _npi_problems(3, 40, 0)
    with recording() as rec:
        B, b0, lam = lasso_path(torch.tensor(X), torch.tensor(y),
                                n_lambda=30)
    Bj, b0j, lamj = jax.vmap(lambda X_, y_: jax_lasso_path(
        X_, y_, n_lambda=30))(jnp.asarray(X), jnp.asarray(y))
    np.testing.assert_allclose(lam.numpy(), np.asarray(lamj), rtol=1e-12)
    np.testing.assert_allclose(B.numpy(), np.asarray(Bj), **LASSO_TOL)
    np.testing.assert_allclose(b0.numpy(), np.asarray(b0j), **LASSO_TOL)
    assert B.shape == (3, 30, 12) and rec.counters["lasso.sweeps"] >= 30
    # an unbatched problem is the same computation
    B1, _, _ = lasso_path(torch.tensor(X[1]), torch.tensor(y[1]),
                          n_lambda=30)
    np.testing.assert_allclose(B1.numpy(), B[1].numpy(), **LASSO_TOL)


@pytest.mark.parametrize("shuffled", [False, True],
                         ids=["interleaved", "jax_permutation"])
def test_lasso_cv_matches_jax(shuffled):
    """K-fold CV over three regions at once: the interleaved folds (i mod K)
    and the folds of JAX's own jax.random permutation, passed in."""
    X, y = _npi_problems(3, 36, 1)
    n_folds, key, perm = 6, None, None
    if shuffled:
        key = jax.random.PRNGKey(3)
        perm = np.asarray(jax.random.permutation(key, X.shape[1]))
    coef, icpt, info = lasso_cv(torch.tensor(X), torch.tensor(y),
                                n_folds=n_folds, n_lambda=30, perm=perm)
    cj, ij, infoj = jax.vmap(lambda X_, y_: jax_lasso_cv(
        X_, y_, n_folds=n_folds, n_lambda=30, key=key))(
            jnp.asarray(X), jnp.asarray(y))
    np.testing.assert_array_equal(info["index_min"].numpy(),
                                  np.asarray(infoj["index_min"]))
    np.testing.assert_allclose(info["mean_mse"].numpy(),
                               np.asarray(infoj["mean_mse"]), rtol=1e-9)
    np.testing.assert_allclose(coef.numpy(), np.asarray(cj), **LASSO_TOL)
    np.testing.assert_allclose(icpt.numpy(), np.asarray(ij), **LASSO_TOL)


def test_train_stage_lasso_shuffle_draws_from_the_seed(monkeypatch):
    """With lasso_cv_shuffle_seed >= 0 the pipeline's LASSO folds follow a
    torch.randperm draw from a generator seeded by it (one permutation for
    every region, as the JAX package's one key), not jax.random's."""
    from epidemicmodeling_torch.pipelines import core
    seen = []

    def spy(X, y, n_folds, perm):
        seen.append((n_folds, perm))
        return X[..., 0, :], y[..., 0], {}

    monkeypatch.setattr(core, "lasso_cv", spy)
    X, y = _npi_problems(2, 30, 2)
    for seed in (11, -1):
        cfg = PipelineConfig(regression_type="LASSO", lasso_cv_folds=5,
                             lasso_cv_shuffle_seed=seed)
        _regress(cfg, torch.tensor(X), torch.tensor(y))
    want = torch.randperm(30, generator=torch.Generator().manual_seed(11))
    assert seen[0][0] == 5 and torch.equal(seen[0][1], want)
    assert seen[1] == (5, None)


@pytest.mark.parametrize("n", [40, 41], ids=["even", "odd"])
def test_robust_elementwise_matches_jax(n):
    """IRLS with bisquare weights per (region, NPI) lane, with gross
    outliers, at an even and an odd row count (the median averages the two
    middle values of an even count, as jnp.median)."""
    X, y = _npi_problems(3, n, 5, outliers=True)
    a, b = robust_affine_fit_elementwise(torch.tensor(X), torch.tensor(y))
    aj, bj = jax.vmap(jax_robust)(jnp.asarray(X), jnp.asarray(y))
    np.testing.assert_allclose(a.numpy(), np.asarray(aj), **ROBUST_TOL)
    np.testing.assert_allclose(b.numpy(), np.asarray(bj), **ROBUST_TOL)
    assert (a >= 0).all()


def test_robust_constant_column_has_no_slope():
    """A column constant over the window gets slope exactly 0 (the JAX
    code's var > 0 test means that, but its var there is a rounding residue
    when its weighted mean's two sums differ in the last bit; ROADMAP Queue
    C); every other column matches JAX."""
    X, y = _npi_problems(2, 40, 6)
    X[:, :, 4] = 3.0
    a, _ = robust_affine_fit_elementwise(torch.tensor(X), torch.tensor(y))
    assert (a[:, 4] == 0).all()
    aj, _ = jax.vmap(jax_robust)(jnp.asarray(X), jnp.asarray(y))
    keep = [k for k in range(12) if k != 4]
    np.testing.assert_allclose(a[:, keep].numpy(), np.asarray(aj)[:, keep],
                               **ROBUST_TOL)
