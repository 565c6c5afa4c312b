"""The port's ML stack (features, ridge/ARX, the custom layers, the LSTM
forecasters, epsilon-SVR) against the JAX package on the CPU.

Tolerances:
- the features that move data (lagged copies, the calendar flag, the split,
  the region window) exactly; standardize at rtol 1e-13 / atol 1e-13: its
  mean and std are float64 reductions whose summation order differs from
  XLA's (1.8e-15 apart at 440 x 37, CPU run);
- ridge at rtol 1e-10, ARX from JAX's draws at rtol 1e-9 (float64 solves);
- the float32 layers at rtol 1e-6; the LSTM forward with flax's weights
  carried across at atol 1e-5, its first-step gradients at rtol 1e-4 of
  each tensor's largest entry, 20 training epochs from JAX's initial
  weights (the learning-rate drop inside the run, the clip both idle and
  active) with the losses at rtol 1e-4 (they agree to ~1.5e-8, CPU run),
  the rollouts at rtol 1e-4 (float32 reruns of the buffer);
- SVR after 50 Adam steps at rtol 1e-9 (float64, the same draws); after
  2,000 steps the hinge's kinks may part the iterates, so the port is held
  by its objective (within 1e-9 relative of the JAX fit's, computed by the
  port's own objective at both weights) and its predictions at 1e-6 of
  the target's scale.
"""

import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import epidemicmodeling_tpu.ml as J
import epidemicmodeling_torch.ml as P
from epidemicmodeling_tpu.ml.features import region_window_mask as jax_window
from epidemicmodeling_torch.ml.svr import SVRModel, svr_objective

CPU = dict(device="cpu")


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def test_exports_match_the_jax_package():
    assert set(J.__all__) <= set(P.__all__)
    assert set(P.__all__) - set(J.__all__) == {"lstm_params_from_flax"}


def test_features_match_jax():
    rng = np.random.default_rng(0)
    X = rng.integers(0, 4, (60, 5)).astype(float)
    lags = (0, 1, 7, 14)
    got = P.lagged_features(X, lags, **CPU)
    assert got.shape == (60, 20)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(J.lagged_features(X, lags)))
    d0 = dt.date(2020, 2, 26)
    dates = [(d0 + dt.timedelta(days=k)).isoformat() for k in range(60)]
    flag = P.long_weekend_feature(dates, **CPU)
    assert flag.dtype == torch.float64
    np.testing.assert_array_equal(flag.numpy(),
                                  np.asarray(J.long_weekend_feature(dates)))
    Z = rng.standard_normal((440, 37)) * rng.uniform(0.1, 50, 37) + 3.0
    Z[:, 4] = 2.0  # a constant column keeps std 1
    for axis in (0, 1):
        for g, r in zip(P.standardize(Z, axis=axis, **CPU),
                        J.standardize(Z, axis=axis)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-13,
                                       atol=1e-13)
    y = rng.standard_normal(60)
    for frac in (0.8, 0.5, 0.33):
        for g, r in zip(P.train_test_split_time(got, y, frac),
                        J.train_test_split_time(X, y, frac)):
            assert g[0].shape[0] == r[0].shape[0]
            np.testing.assert_array_equal(g[1], r[1])
    days = np.array([int(d.replace("-", "")) for d in dates])
    conf = np.cumsum(rng.integers(0, 30, 60)).astype(float)
    conf[[3, 40]] = np.nan
    for crit in ("MIN_CASE_BASED", "DATE_BASED", "DATA_OR_MIN_CASE_BASED"):
        kw = dict(criterion=crit, min_cases=150.0, start_date=20200305,
                  end_date=20200410)
        np.testing.assert_array_equal(P.region_window_mask(days, conf, **kw),
                                      jax_window(days, conf, **kw))
    with pytest.raises(ValueError, match="unknown start_date_criterion"):
        P.region_window_mask(days, conf, criterion="BOGUS")


@pytest.mark.parametrize("fit_intercept", [True, False])
def test_ridge_matches_jax(fit_intercept):
    rng = np.random.default_rng(1)
    X = rng.standard_normal((200, 7)) * rng.uniform(0.5, 3, 7)
    y = X @ rng.standard_normal(7) + 0.7 + 0.1 * rng.standard_normal(200)
    for lam in (1e-6, 1e-2, 10.0):
        w, b = P.ridge_regression(X, y, lam, fit_intercept, **CPU)
        wj, bj = J.ridge_regression(jnp.asarray(X), jnp.asarray(y), lam,
                                    fit_intercept)
        np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=1e-10)
        np.testing.assert_allclose(float(b), float(bj), rtol=1e-10,
                                   atol=1e-14)


def test_arx_matches_jax_from_its_draws():
    t = np.arange(300)
    y = np.cos(0.1 * t) + 0.05 * np.sin(0.37 * t)
    a, pred = P.arx_fit_predict(y, order=4, n_ahead=10, **CPU)
    aj, pj = J.arx_fit_predict(y, order=4, n_ahead=10)
    np.testing.assert_allclose(a.numpy(), np.asarray(aj), rtol=1e-9)
    np.testing.assert_allclose(pred.numpy(), np.asarray(pj), rtol=1e-9)
    key = jax.random.PRNGKey(3)
    _, pj = J.arx_fit_predict(y, 14, 30, key=key)
    draws = np.asarray(jax.random.normal(key, (30,), jnp.float64))
    _, pred = P.arx_fit_predict(y, 14, 30, noise=draws, **CPU)
    np.testing.assert_allclose(pred.numpy(), np.asarray(pj), rtol=1e-9)
    # from a generator: the same draws give the same forecast
    g = torch.Generator().manual_seed(5)
    _, p1 = P.arx_fit_predict(y, 14, 30, generator=g, **CPU)
    z = torch.randn(30, generator=torch.Generator().manual_seed(5),
                    dtype=torch.float64)
    _, p2 = P.arx_fit_predict(y, 14, 30, noise=z, **CPU)
    assert torch.equal(p1, p2)


def test_layers_match_flax():
    x = np.random.default_rng(2).standard_normal((5, 3)).astype(np.float32)
    for JL, PL in ((J.ExpLayer, P.ExpLayer),
                   (J.ScaledTanhLayer, P.ScaledTanhLayer)):
        p = JL(features=3).init(jax.random.PRNGKey(0), x)
        alpha = np.asarray(p["params"]["alpha"], np.float32) \
            * np.array([1.0, -0.3, 2.0], np.float32)
        ref = JL(features=3).apply({"params": {"alpha": alpha}}, x)
        layer = PL(3, **CPU)
        with torch.no_grad():
            layer.alpha.copy_(torch.as_tensor(alpha))
        got = layer(torch.as_tensor(x))
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-6)
    # the guard: an alpha of 0 is taken as 1e-8
    layer = P.ScaledTanhLayer(2, **CPU)
    with torch.no_grad():
        layer.alpha.zero_()
    got = layer(torch.tensor([[1.0, -1.0]]))
    np.testing.assert_allclose(_np(got), [[1e-8, -1e-8]], rtol=1e-6)


def _flax_model(output_layer, x, seed=1, hidden=(8, 5)):
    m = J.LSTMForecaster(hidden_sizes=hidden, output_layer=output_layer)
    return m, m.init(jax.random.PRNGKey(seed), x)


def _port_model(params, output_layer, hidden=(8, 5)):
    pm = P.LSTMForecaster(hidden_sizes=hidden, output_layer=output_layer)
    pm.load_params(P.lstm_params_from_flax(params), **CPU)
    return pm


@pytest.mark.parametrize("output_layer", [None, "exp", "scaled_tanh"])
def test_lstm_forward_matches_flax(output_layer):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 20, 4))
    m, p = _flax_model(output_layer, x)
    pm = _port_model(p, output_layer)
    assert set(pm.state_dict()) == set(P.lstm_params_from_flax(p))
    got = pm(torch.as_tensor(x))
    assert got.dtype == torch.float32 and got.shape == (3, 20, 1)
    np.testing.assert_allclose(_np(got), np.asarray(m.apply(p, x)),
                               atol=1e-5)
    # a single (T, F) sequence
    np.testing.assert_allclose(_np(pm(torch.as_tensor(x[1]))),
                               np.asarray(m.apply(p, x[1])), atol=1e-5)


@pytest.mark.parametrize("output_layer", [None, "exp"])
def test_lstm_first_step_gradients_match_jax(output_layer):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 25, 3))
    y = rng.standard_normal((2, 25, 1))
    m, p = _flax_model(output_layer, x, seed=2)
    grads = jax.grad(lambda q: jnp.mean((m.apply(q, x) - y) ** 2))(p)
    ref = P.lstm_params_from_flax(grads)
    pm = _port_model(p, output_layer)
    loss = torch.mean((pm(torch.as_tensor(x)) - torch.as_tensor(y)) ** 2)
    names = [n for n, q in pm.named_parameters() if q.requires_grad]
    assert not any("bias_ih" in n for n in names)
    got = torch.autograd.grad(loss, [q for n, q in pm.named_parameters()
                                     if q.requires_grad])
    for n, g in zip(names, got):
        r = ref[n].numpy()
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max(), err_msg=n)


@pytest.mark.parametrize("clip", [1.0, 0.05])
def test_lstm_training_matches_optax(clip):
    """20 epochs of the JAX package's train_forecaster against the port's
    from the same initial weights (JAX's init under the same key, carried
    across), the learning rate dropping at update 10; the first gradient's
    global norm lies between the two clips, so 0.05 acts and 1.0 does
    not."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 30, 3))
    y = rng.standard_normal((2, 30, 1))
    m = J.LSTMForecaster(hidden_sizes=(8, 5), output_layer="scaled_tanh")
    key = jax.random.PRNGKey(3)
    p0 = m.init(key, x)
    norm0 = float(optax.global_norm(jax.grad(
        lambda q: jnp.mean((m.apply(q, x) - y) ** 2))(p0)))
    assert 0.05 < norm0 < 1.0
    pj, lj = J.train_forecaster(m, x, y, key, num_epochs=20, lr=0.01,
                                lr_drop_period=10, grad_clip=clip)
    pm = P.LSTMForecaster(hidden_sizes=(8, 5), output_layer="scaled_tanh")
    pt, lt = P.train_forecaster(pm, x, y, num_epochs=20, lr=0.01,
                                lr_drop_period=10, grad_clip=clip,
                                params=P.lstm_params_from_flax(p0), **CPU)
    assert len(lt) == 20 and lt[-1] < lt[0]
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    ref = P.lstm_params_from_flax(pj)
    for k, v in ref.items():
        np.testing.assert_allclose(pt[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-4 * max(float(v.abs().max()), 1.0),
                                   err_msg=k)


def test_rollouts_match_jax():
    t = np.arange(80.0)
    series = np.sin(0.3 * t)[:, None]
    m, p = _flax_model(None, series, seed=4)
    pm = _port_model(p, None)
    got = P.rollout_forecast(pm, P.lstm_params_from_flax(p), series, 12)
    ref = J.rollout_forecast(m, p, jnp.asarray(series), 12)
    assert got.shape == (12,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-6)
    rng = np.random.default_rng(6)
    hist = rng.standard_normal((50, 4))
    future = rng.standard_normal((9, 4))
    m, p = _flax_model("exp", hist, seed=5)
    pm = _port_model(p, "exp")
    for col in (0, 2):
        got = P.rollout_forecast_exog(pm, None, hist, future, col)
        ref = J.rollout_forecast_exog(m, p, jnp.asarray(hist), future, col)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-6)


def test_port_initial_weights_follow_flax_distributions():
    x = torch.zeros(1, 3, 400)
    pm = P.LSTMForecaster(hidden_sizes=(200, 50), output_layer="exp")
    params = pm.init(torch.Generator().manual_seed(0), x, **CPU)
    again = P.LSTMForecaster(hidden_sizes=(200, 50), output_layer="exp")
    same = again.init(torch.Generator().manual_seed(0), x, **CPU)
    assert all(torch.equal(params[k], same[k]) for k in params)
    for li, (n_in, n_h) in enumerate(((400, 200), (200, 50))):
        w_ih = params[f"lstms.{li}.weight_ih_l0"]
        w_hh = params[f"lstms.{li}.weight_hh_l0"]
        assert w_ih.shape == (4 * n_h, n_in) and w_hh.shape == (4 * n_h, n_h)
        for gate in range(4):
            Q = w_hh[gate * n_h:(gate + 1) * n_h].double()
            torch.testing.assert_close(Q @ Q.T, torch.eye(n_h, dtype=Q.dtype),
                                       rtol=0, atol=1e-6)
        std = (1.0 / n_in) ** 0.5 / 0.87962566103423978
        assert float(w_ih.abs().max()) <= 2 * std * (1 + 1e-6)
        if li == 0:  # 320,000 draws: the variance within 10% of 1/fan_in
            assert abs(float(w_ih.double().var()) * n_in - 1.0) < 0.1
        for b in ("bias_ih", "bias_hh"):
            assert not params[f"lstms.{li}.{b}_l0"].any()
    assert params["head.weight"].shape == (1, 50)
    assert not params["head.bias"].any()
    assert torch.isfinite(params["out_layer.alpha"]).all()
    tanh = P.LSTMForecaster(hidden_sizes=(4,), output_layer="scaled_tanh")
    assert torch.equal(tanh.init(None, x, **CPU)["out_layer.alpha"],
                       torch.ones(1))


def test_train_forecaster_learns_from_its_own_initial_weights():
    """tests/test_ml.py's task: a 32-unit LSTM fits next-step prediction
    of a sinusoid from the port's own initial weights."""
    y = np.sin(0.3 * np.arange(120, dtype=np.float64))
    model = P.LSTMForecaster(hidden_sizes=(32,))
    params, losses = P.train_forecaster(
        model, y[:-1].reshape(-1, 1), y[1:].reshape(-1, 1),
        torch.Generator().manual_seed(0), num_epochs=150, lr=0.01,
        lr_drop_period=100, **CPU)
    assert losses[-1] < 0.01 and losses[-1] < losses[0] / 10
    assert set(params) == set(model.state_dict())


def _svr_data(n=120, d=4, seed=7):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)) * rng.uniform(0.5, 3, d) + 1.0
    y = np.sin(X[:, 0]) + 0.3 * X[:, 1] + 0.05 * rng.standard_normal(n)
    return X, y


def _jax_svr(X, y, kernel, n_steps, key, **kw):
    model = J.svr_fit(jnp.asarray(X), jnp.asarray(y), kernel=kernel,
                      n_steps=n_steps, key=key, **kw)
    draws = {}
    if kernel == "rbf":
        draws = dict(omega=np.asarray(model.omega),
                     phase=np.asarray(model.phase))
    return model, draws


@pytest.mark.parametrize("kernel", ["linear", "rbf", "rbf-exact"])
def test_svr_matches_jax_after_50_steps(kernel):
    X, y = _svr_data()
    kw = dict(C=5.0, epsilon=0.05, lr=0.02, n_rff=64)
    jm, draws = _jax_svr(X, y, kernel, 50, jax.random.PRNGKey(1), **kw)
    pm = P.svr_fit(X, y, kernel=kernel, n_steps=50, **draws, **kw, **CPU)
    assert isinstance(pm, SVRModel) and pm.kernel == kernel
    for f in ("w", "b", "mu", "sd"):
        np.testing.assert_allclose(_np(getattr(pm, f)),
                                   np.asarray(getattr(jm, f)), rtol=1e-9,
                                   atol=1e-12, err_msg=f)
    Xt = np.random.default_rng(8).standard_normal((30, 4))
    np.testing.assert_allclose(P.svr_predict(pm, Xt).numpy(),
                               np.asarray(J.svr_predict(jm, Xt)),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("kernel", ["linear", "rbf", "rbf-exact"])
def test_svr_after_2000_steps_is_co_optimal(kernel):
    X, y = _svr_data(seed=9)
    kw = dict(C=5.0, epsilon=0.05, lr=0.02, n_rff=64)
    jm, draws = _jax_svr(X, y, kernel, 2000, jax.random.PRNGKey(2), **kw)
    pm = P.svr_fit(X, y, kernel=kernel, n_steps=2000, **draws, **kw, **CPU)
    jm_port = pm._replace(w=torch.as_tensor(np.array(jm.w)),
                          b=torch.as_tensor(np.array(jm.b)))
    f_port = float(svr_objective(pm, X, y, kw["C"], kw["epsilon"]))
    f_jax = float(svr_objective(jm_port, X, y, kw["C"], kw["epsilon"]))
    assert abs(f_port - f_jax) <= 1e-9 * f_jax
    np.testing.assert_allclose(P.svr_predict(pm, X).numpy(),
                               np.asarray(J.svr_predict(jm, X)), rtol=0,
                               atol=1e-6 * np.abs(y).max())


def test_svr_draws_from_a_generator():
    X, y = _svr_data()
    a = P.svr_fit(X, y, kernel="rbf", n_steps=5, n_rff=16,
                  generator=torch.Generator().manual_seed(3), **CPU)
    b = P.svr_fit(X, y, kernel="rbf", n_steps=5, n_rff=16,
                  generator=torch.Generator().manual_seed(3), **CPU)
    assert a.omega.shape == (4, 16) and torch.equal(a.w, b.w)
    assert float(a.phase.min()) >= 0 and float(a.phase.max()) < 2 * np.pi
    with pytest.raises(ValueError, match="unknown kernel"):
        P.svr_fit(X, y, kernel="poly", **CPU)


def _cpu_params(in_features):
    """The weights of a (4,)-unit forecaster, built on the CPU."""
    return P.LSTMForecaster((4,)).init(None, np.ones((3, in_features)),
                                       **CPU)


@pytest.mark.parametrize("call", [
    lambda: P.lagged_features(np.ones((4, 2)), (0, 1)),
    lambda: P.standardize(np.ones((4, 2))),
    lambda: P.ridge_regression(np.ones((4, 2)), np.ones(4)),
    lambda: P.svr_fit(np.ones((4, 2)), np.ones(4), n_steps=1),
    lambda: P.LSTMForecaster().init(None, np.ones((3, 1))),
    lambda: P.rollout_forecast(P.LSTMForecaster((4,)), _cpu_params(1),
                               np.ones((5, 1)), 2),
    lambda: P.rollout_forecast_exog(P.LSTMForecaster((4,)), _cpu_params(2),
                                    np.ones((5, 2)), np.ones((2, 2))),
])
def test_entry_points_run_on_the_card_by_default(call):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
