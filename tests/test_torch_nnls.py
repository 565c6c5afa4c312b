"""The port's batched NNLS against the JAX package's, at float64.

Random problems of the families the pipeline meets (nonnegative NPI-gap
designs, gaussian designs, nonnegative truths) go through the JAX nnls /
nnls_with_intercept under vmap and through the port's batched functions;
coefficients must agree at rtol 1e-9. A singular passive set (two exactly
collinear columns) must poison the solve with NaN in both packages.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from epidemicmodeling_tpu.regression.nnls import (
    _masked_ls as jax_masked_ls, nnls as jax_nnls,
    nnls_with_intercept as jax_nnls_icpt)

from epidemicmodeling_torch.regression.nnls import (
    _masked_ls, nnls, nnls_with_intercept)
from epidemicmodeling_torch.utils.profiling import recording

TOL = dict(rtol=1e-9, atol=1e-12)


def problems(seed, R=24, n=40, p=12):
    """R problems: half NPI-gap designs (integer levels below the codebook
    maxima) against a smoothed-alpha-like target, half gaussian designs
    against a nonnegative truth plus noise."""
    rng = np.random.default_rng(seed)
    X = np.empty((R, n, p))
    y = np.empty((R, n))
    half = R // 2
    X[:half] = rng.integers(0, 5, (half, n, p)).astype(float)
    y[:half] = 0.2 + 0.01 * rng.standard_normal((half, n)) \
        - X[:half] @ (0.004 * rng.random(p))
    X[half:] = rng.standard_normal((R - half, n, p))
    truth = np.where(rng.random((R - half, p)) < 0.5, 0.0,
                     rng.random((R - half, p)))
    y[half:] = np.einsum("rnp,rp->rn", X[half:], truth) \
        + 0.1 * rng.standard_normal((R - half, n))
    return X, y


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nnls_matches_jax(seed):
    X, y = problems(seed)
    ref = np.asarray(jax.vmap(jax_nnls)(jnp.asarray(X), jnp.asarray(y)))
    with recording() as rec:
        got = nnls(torch.from_numpy(X), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert (got.numpy() >= 0).all()
    assert 0 < rec.counters["nnls.outer"] <= 36
    # the unbatched form is the batch of one
    one = nnls(torch.from_numpy(X[0]), torch.from_numpy(y[0]))
    np.testing.assert_allclose(one.numpy(), ref[0], **TOL)


@pytest.mark.parametrize("seed", [0, 3])
def test_nnls_with_intercept_matches_jax(seed):
    X, y = problems(seed)
    a_ref, b_ref = jax.vmap(jax_nnls_icpt)(jnp.asarray(X), jnp.asarray(y))
    with recording() as rec:
        a, b = nnls_with_intercept(torch.from_numpy(X), torch.from_numpy(y))
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), **TOL)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), **TOL)
    assert rec.counters["nnls.intercept"] >= 1
    a0, b0 = nnls_with_intercept(torch.from_numpy(X[1]),
                                 torch.from_numpy(y[1]))
    np.testing.assert_allclose(a0.numpy(), np.asarray(a_ref)[1], **TOL)
    np.testing.assert_allclose(float(b0), float(b_ref[1]), **TOL)


def test_collinear_passive_set_poisons_with_nan():
    """Two exactly collinear columns in the passive set make the masked
    normal equations singular: both packages return NaN, never a clamped
    finite value (regression/nnls.py:47-52). The columns are chosen so
    that every Cholesky step is exact and the second pivot is exactly 0 in
    any summation order."""
    rng = np.random.default_rng(0)
    X = np.zeros((30, 12))
    X[:3, 4] = X[:3, 5] = [1.0, 2.0, 2.0]     # |col|^2 = 9: exact pivot 3
    X[3, 1] = 4.0                             # orthogonal, pivot 4
    X[:, [0, 2, 3, 6, 7, 8, 9, 10, 11]] = rng.standard_normal((30, 9))
    y = rng.standard_normal(30)
    G, c = X.T @ X, X.T @ y
    P = np.zeros(12, bool)
    P[[1, 4, 5]] = True
    ref = np.asarray(jax_masked_ls(jnp.asarray(G), jnp.asarray(c),
                                   jnp.asarray(P)))
    got = _masked_ls(torch.from_numpy(G)[None], torch.from_numpy(c)[None],
                     torch.from_numpy(P)[None])[0].numpy()
    assert not np.isfinite(ref).all()
    assert np.isnan(got).all()
    # a regular passive set solves normally in both
    P[5] = False
    ref = np.asarray(jax_masked_ls(jnp.asarray(G), jnp.asarray(c),
                                   jnp.asarray(P)))
    got = _masked_ls(torch.from_numpy(G)[None], torch.from_numpy(c)[None],
                     torch.from_numpy(P)[None])[0].numpy()
    np.testing.assert_allclose(got, ref, **TOL)
