"""The port's pipeline over a mesh of eight CPU slots.

Port against port: run_pipeline(mesh=make_mesh(8, device="cpu")) must equal
the single-device run bit for bit (J0, J1, u_prescribed, a2, the front) on
the "lanes", "pallas" and "vmap" backends and in the stochastic pallas
case, on tests/test_mesh_pipeline.py's shapes; so must the backtest and the
CLI's prescriptions file (--cpu-devices 8 --mesh 4x2, byte for byte).

Port against JAX: the pallas mesh run against the JAX package's
run_pipeline(mesh=make_mesh(8)) on its float64 batch-last path ("lanes";
its "pallas" kernels compute in float32), and sharded_train_prescribe_step
against the JAX package's, at rtol 1e-9 / atol 1e-12 (the tolerance of
tests/test_torch_pipeline.py) with the prescriptions exact.
"""

import filecmp

import numpy as np
import pytest
import torch
import jax

from epidemicmodeling_tpu.control import epsilon_grid as jax_epsilon_grid
from epidemicmodeling_tpu.data import synthetic_oxford_frame
from epidemicmodeling_tpu.data.preprocess import (
    NPI_MAXES_DEFAULT, build_region_batch, preprocess_region)
from epidemicmodeling_tpu.parallel import make_mesh as jax_make_mesh
from epidemicmodeling_tpu.parallel import \
    sharded_train_prescribe_step as jax_step
from epidemicmodeling_tpu.pipelines import PipelineConfig as JaxConfig
from epidemicmodeling_tpu.pipelines.train_predict_prescribe import \
    run_pipeline as jax_run_pipeline

from epidemicmodeling_torch.data import write_oxford_csvs
from epidemicmodeling_torch.data import \
    synthetic_oxford_frame as port_frame
from epidemicmodeling_torch.parallel import (make_mesh,
                                             sharded_train_prescribe_step)
from epidemicmodeling_torch.pipelines import (PipelineConfig,
                                              forecast_quality_assessment,
                                              run_pipeline)
from epidemicmodeling_torch.pipelines.xprize_cli import main

TOL = dict(rtol=1e-9, atol=1e-12)


def _region_batches(n_regions, n_days, t_train, horizon, seed):
    _, _, truth = synthetic_oxford_frame(n_regions=n_regions, n_days=n_days,
                                         seed=seed)
    sers, names = [], []
    for name, tr in truth.items():
        nc = tr["s"] * tr["i"] * tr["alpha"] * tr["pop"]
        sers.append(preprocess_region(np.cumsum(nc)[:t_train], None,
                                      tr["u"][:t_train], tr["pop"]))
        names.append(name)
    return (build_region_batch(sers, names),
            build_region_batch(sers, names, horizon=horizon))


# tests/test_mesh_pipeline.py's three cases: (batches, T_hist, epsilons,
# config)
CASES = {
    "lanes": ((4, 120, 100, 19, 2), 100, 8,
              dict(backend="lanes", pareto_chunk=4, num_monte_carlo=16)),
    "pallas": ((4, 120, 100, 19, 2), 100, 8,
               dict(backend="pallas", pareto_chunk=4, num_monte_carlo=16)),
    "vmap": ((4, 100, 80, 11, 5), 80, 4,
             dict(backend="vmap", pareto_chunk=4, num_monte_carlo=8)),
    "pallas-stochastic": ((4, 100, 80, 11, 9), 80, 4,
                          dict(backend="pallas", pareto_chunk=4,
                               num_monte_carlo=8, stochastic_forecast=True)),
}


def _run(case, mesh=None, **kw):
    shapes, T_hist, n_eps, cfg = CASES[case]
    bt, bf = _region_batches(*shapes)
    return run_pipeline(
        bt, bf, None, T_hist, np.ones(12),
        np.asarray(jax_epsilon_grid(n_eps)), np.zeros(12), NPI_MAXES_DEFAULT,
        T_hist, PipelineConfig(smoother_gain="solve", **cfg),
        generator=torch.Generator().manual_seed(3), dtype=torch.float64,
        device=None if mesh is not None else "cpu", mesh=mesh, **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_pipeline_is_bit_identical(case):
    single = _run(case)
    sharded = _run(case, mesh=make_mesh(8, device="cpu"))
    for k in ("J0", "J1", "u_prescribed"):
        assert torch.equal(sharded.pareto[k], single.pareto[k]), k
    for k in ("a1", "b1", "a2", "b2"):
        assert torch.equal(getattr(sharded.trained, k),
                           getattr(single.trained, k)), k
    assert torch.equal(sharded.pareto_front, single.pareto_front)
    for name, sc in single.scenarios.items():
        assert torch.equal(sharded.scenarios[name].J0, sc.J0), name
    assert torch.equal(sharded.monte_carlo["J0"], single.monte_carlo["J0"])


def test_sharded_pallas_matches_jax_mesh_run():
    shapes, T_hist, n_eps, cfg = CASES["pallas"]
    bt, bf = _region_batches(*shapes)
    eps = np.asarray(jax_epsilon_grid(n_eps))
    ref = jax_run_pipeline(
        bt, bf, None, T_hist, np.ones(12), eps, np.zeros(12),
        NPI_MAXES_DEFAULT, T_hist,
        JaxConfig(smoother_gain="solve", **dict(cfg, backend="lanes")),
        key=jax.random.PRNGKey(0), mesh=jax_make_mesh(8))
    port = _run("pallas", mesh=make_mesh(8, device="cpu"),
                u_random=np.asarray(ref.monte_carlo["u_random"]))
    np.testing.assert_array_equal(port.pareto["u_prescribed"].numpy(),
                                  np.asarray(ref.pareto["u_prescribed"]))
    for k in ("J0", "J1"):
        np.testing.assert_allclose(port.pareto[k].numpy(),
                                   np.asarray(ref.pareto[k]), **TOL,
                                   err_msg=k)
        np.testing.assert_allclose(port.monte_carlo[k].numpy(),
                                   np.asarray(ref.monte_carlo[k]), **TOL,
                                   err_msg=k)
    np.testing.assert_allclose(port.trained.a2.numpy(),
                               np.asarray(ref.trained.a2), **TOL)
    np.testing.assert_array_equal(port.pareto_front.numpy(),
                                  np.asarray(ref.pareto_front))


@pytest.mark.parametrize("backend", ["pallas", "vmap"])
def test_sharded_backtest_is_bit_identical(backend):
    bt, _ = _region_batches(4, 130, 130, 0, 3)
    kw = dict(npi_mins=np.zeros(12), npi_maxes=NPI_MAXES_DEFAULT,
              num_regression_days=80, num_forecast_days=16,
              max_look_ahead_days=10,
              cfg=PipelineConfig(backend=backend, smoother_gain="solve"),
              dtype=torch.float64)
    single = forecast_quality_assessment(bt, device="cpu", **kw)
    sharded = forecast_quality_assessment(
        bt, mesh=make_mesh(8, device="cpu"), **kw)
    for k in ("est_error_plus", "est_error_smooth", "mean_error_smooth",
              "median_error_smooth"):
        assert torch.equal(getattr(sharded, k), getattr(single, k)), k
    assert torch.equal(sharded.trained.a2, single.trained.a2)
    with pytest.raises(ValueError, match="not divisible"):
        forecast_quality_assessment(
            bt, mesh=make_mesh(devices=["cpu"] * 3), **kw)


def test_sharded_step_matches_jax():
    """sharded_train_prescribe_step at R=4, E=4, T_hist=32, horizon=8 over
    eight slots against the JAX package's over its eight CPU devices."""
    ref = jax_step(jax_make_mesh(8), R=4, E=4, T_hist=32, horizon=8)
    port = sharded_train_prescribe_step(make_mesh(8, device="cpu"), R=4,
                                        E=4, T_hist=32, horizon=8,
                                        dtype=torch.float64)
    for k in ("a2", "J0", "J1", "J0_fixed"):
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]),
                                   **TOL, err_msg=k)


def test_cli_mesh_writes_the_same_prescriptions(tmp_path):
    frame, pops, _ = port_frame(4, 130, seed=5)
    files = write_oxford_csvs(tmp_path, frame, pops)

    def args(tag, *extra):
        return ["--data", files["data"], "--geos", files["geos"],
                "--populations", files["populations"],
                "--start-train", "2020-03-01", "--end-train", "2020-06-30",
                "--end-predict", "2020-07-08", "--num-epsilon", "8",
                "--num-prescriptions", "3", "--pareto-chunk", "4",
                "--num-monte-carlo", "8", "--float64",
                "--prescriptions-out", str(tmp_path / f"presc_{tag}.csv"),
                *extra]

    assert main(args("single", "--device", "cpu")) == 0
    assert main(args("mesh", "--device", "cpu", "--cpu-devices", "8",
                     "--mesh", "4x2")) == 0
    assert filecmp.cmp(tmp_path / "presc_single.csv",
                       tmp_path / "presc_mesh.csv", shallow=False)
    with pytest.raises(SystemExit, match="needs 16 devices, found 8"):
        main(args("big", "--cpu-devices", "8", "--mesh", "4x4"))
