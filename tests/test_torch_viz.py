"""The port's figures and animations (viz/) against the JAX package's.

select_optimal_index exactly; each of the six plots rendered (Agg) from
tensors and from arrays, its line, scatter and band data equal to those of
the JAX package's figure for the same inputs; both animations write a
file."""

import numpy as np
import pytest
import torch

import epidemicmodeling_tpu.viz as jviz
import epidemicmodeling_torch.viz as tviz


def _inputs():
    rng = np.random.default_rng(0)
    T, m, P = 60, 3, 12
    maxes = np.array([3, 3, 2, 4, 2, 3, 2, 4, 2, 3, 2, 4], float)
    S = np.cumsum(rng.standard_normal((T, m)) * 0.01, axis=0) + 1.0
    Pc = np.tile(np.eye(m)[None] * 0.01, (T, 1, 1))
    s1 = np.stack([np.full(T, 0.99), np.full(T, 1e-4),
                   0.3 + 0.05 * rng.standard_normal(T)], axis=1)
    u = rng.integers(0, 3, (T, P)).astype(float)
    return {
        "plot_state_estimates": dict(
            s_plus=S, s_smooth=S * 1.01, P_plus=Pc, P_smooth=Pc * 2,
            title="states"),
        "plot_scenarios": dict(
            cases_by_scenario={"zero NPI": rng.random(T) * 1e-4 + 1e-5,
                               "max NPI": rng.random(T) * 1e-5 + 1e-6},
            population=1e7, ground_truth=rng.random(T) * 100 + 1),
        "plot_pareto_cloud": dict(
            J0_random=rng.random(50), J1_random=rng.random(50),
            J0_opt=rng.random(10) * 0.5, J1_opt=rng.random(10) * 0.5,
            front_mask=rng.random(10) < 0.6, J0_fixed=0.4, J1_fixed=0.4,
            population=2.0),
        "plot_backtest_curves": dict(
            est_error=np.abs(rng.standard_normal((30, 20))) * 10),
        "plot_training_diagnostic": dict(
            obs_new_cases=rng.random(T) * 1e-4, s_smooth_round1=s1,
            s_smooth_round2=s1 * (1 + 0.01 * rng.standard_normal((T, 3))),
            rho_round1=1 + 0.1 * rng.standard_normal(T),
            rho_round2=1 + 0.1 * rng.standard_normal(T), npi_schedule=u,
            a1=rng.random(P) * 0.01, b1=0.2, a2=rng.random(P) * 0.01,
            b2=0.21, npi_maxes=maxes, num_regression_days=40,
            population=1e7, title="region QC"),
        "plot_npi_schedule": dict(
            u_hist=u, u_prescribed=rng.integers(0, 4, (15, P)).astype(float)
            .clip(max=maxes), npi_maxes=maxes, title="schedule"),
    }


def _tensors(kw):
    conv = lambda v: (torch.as_tensor(v) if isinstance(v, np.ndarray)
                      else {k: conv(x) for k, x in v.items()}
                      if isinstance(v, dict) else v)
    return {k: conv(v) for k, v in kw.items()}


def _figure_data(fig):
    """Every axis's line data, collection offsets and band vertices."""
    out = []
    for ax in fig.axes:
        for line in ax.get_lines():
            out.append(np.asarray(line.get_xydata(), float))
        for coll in ax.collections:
            out.append(np.asarray(coll.get_offsets(), float))
            out.extend(np.asarray(p.vertices, float)
                       for p in coll.get_paths())
    return out


def test_select_optimal_index_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        J0, J1 = rng.random(25), rng.random(25)
        want = jviz.select_optimal_index(J0, J1)
        assert tviz.select_optimal_index(J0, J1) == want
        assert tviz.select_optimal_index(torch.as_tensor(J0),
                                         torch.as_tensor(J1)) == want
    assert tviz.select_optimal_index(np.array([10.0, 5.0, 1.0, 0.5]),
                                     np.array([0.0, 1.0, 2.0, 10.0])) == 2


@pytest.mark.parametrize("name", list(_inputs()))
def test_plot_matches_jax(name, tmp_path):
    import matplotlib.pyplot as plt
    kw = _inputs()[name]
    ref = getattr(jviz, name)(**kw)
    want = _figure_data(ref)
    assert want
    for tag, args in (("arrays", kw), ("tensors", _tensors(kw))):
        path = tmp_path / f"{name}_{tag}.png"
        fig = getattr(tviz, name)(**args, path=path)
        assert path.stat().st_size > 1000
        got = _figure_data(fig)
        assert len(got) == len(want) and len(fig.axes) == len(ref.axes)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        plt.close(fig)
    plt.close(ref)


def test_animations_write_files(tmp_path):
    rng = np.random.default_rng(1)
    fields = torch.as_tensor(rng.random((4, 16, 12)))
    pts = rng.random((4, 3, 2)) * 10
    out = tviz.animate_field(fields, str(tmp_path / "field.gif"), fps=5,
                             points=pts)
    assert out.endswith(".gif") and (tmp_path / "field.gif").stat().st_size
    pos = torch.as_tensor(rng.random((4, 20, 2)) * 5)
    out = tviz.animate_agents(pos, str(tmp_path / "agents.mp4"), fps=5,
                              obstacle_xy=rng.random((10, 2)) * 5,
                              bounds=(0, 5, 0, 5))
    assert out in (str(tmp_path / "agents.mp4"), str(tmp_path / "agents.gif"))
    assert (tmp_path / out.rsplit("/", 1)[-1]).stat().st_size > 0
