"""The port's XPRIZE CLI against the JAX package's, on the same files.

The JAX CLI runs with --float64 --backend lanes, the port's with --device
cpu --float64 --backend pallas (the kernels' plain versions, float64), and
both with --backend vmap (the generic core), on
CSVs written by pandas from the JAX package's synthetic frame with per-geo
costs. The prescriptions CSVs must be byte-identical; the predictions (with
and without a future-IP plan) equal at rtol 1e-9; the summaries' J0/J1 at
rtol 1e-9, front sizes and prescription indices exactly. The checkpoint a
run writes (.npz and .mat) must reproduce its prescriptions through
--load-params, and so must the JAX CLI's checkpoint.
"""

import filecmp
import json
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from epidemicmodeling_tpu.data import OXFORD_NPI_COLUMNS, NPI_MAXES_DEFAULT
from epidemicmodeling_tpu.data import synthetic_oxford_frame
from epidemicmodeling_tpu.pipelines.xprize_cli import main as jax_main

from epidemicmodeling_torch.pipelines.xprize_cli import main

TOL = dict(rtol=1e-9, atol=1e-12)


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    df, pops, _ = synthetic_oxford_frame(n_regions=3, n_days=160, seed=5)
    df.to_csv(tmp / "oxford.csv", index=False)
    pops.to_csv(tmp / "populations.csv", index=False)
    pops[["CountryName", "RegionName"]].to_csv(tmp / "geos.csv", index=False)
    rng = np.random.default_rng(1)
    costs = pops[["CountryName", "RegionName"]].copy()
    for c in OXFORD_NPI_COLUMNS:
        costs[c] = rng.uniform(0.5, 2.0, len(costs)).round(3)
    costs.to_csv(tmp / "costs.csv", index=False)
    # a plan for two geos: every NPI at its maximum from the second day
    plan = pd.DataFrame(
        [[f"Synthland{r}", "", d] + list(NPI_MAXES_DEFAULT)
         for r in (0, 2) for d in ("2020-07-11", "2020-07-30")],
        columns=["CountryName", "RegionName", "Date"] + OXFORD_NPI_COLUMNS)
    plan.to_csv(tmp / "future_ip.csv", index=False)
    return tmp


def _args(tmp, tag, *extra):
    return [
        "--data", str(tmp / "oxford.csv"), "--geos", str(tmp / "geos.csv"),
        "--populations", str(tmp / "populations.csv"),
        "--costs", str(tmp / "costs.csv"),
        "--start-train", "2020-03-01", "--end-train", "2020-07-09",
        "--end-predict", "2020-08-08", "--num-epsilon", "8",
        "--num-prescriptions", "3", "--pareto-chunk", "3",
        "--num-monte-carlo", "8", "--float64",
        "--prescriptions-out", str(tmp / f"presc_{tag}.csv"),
        "--predictions-out", str(tmp / f"pred_{tag}.csv"),
        "--summary-out", str(tmp / f"summary_{tag}.json"), *extra]


@pytest.fixture(scope="module")
def runs(tmp):
    """Each package's CLI without and with the future-IP plan; the port's
    plain run also writes .npz and .mat checkpoints (two runs), the JAX
    one an .npz."""
    ip = ("--future-ip", str(tmp / "future_ip.csv"))
    port = ("--device", "cpu", "--backend", "pallas")
    assert jax_main(_args(tmp, "jax", "--backend", "lanes",
                          "--trained-params-out", str(tmp / "jax.npz"))) == 0
    assert jax_main(_args(tmp, "jax_ip", "--backend", "lanes", *ip)) == 0
    for fmt in ("npz", "mat"):
        assert main(_args(tmp, f"port_{fmt}", *port, "--trained-params-out",
                          str(tmp / f"port.{fmt}"))) == 0
    assert main(_args(tmp, "port_ip", *port, *ip)) == 0
    return tmp


@pytest.mark.parametrize("tag", ["", "_ip"])
def test_prescriptions_are_byte_identical(runs, tag):
    port = "port_npz" if not tag else "port_ip"
    assert filecmp.cmp(runs / f"presc_jax{tag}.csv",
                       runs / f"presc_{port}.csv", shallow=False)
    presc = pd.read_csv(runs / f"presc_{port}.csv")
    assert sorted(presc["PrescriptionIndex"].unique()) == [0, 1, 2]
    assert presc["Date"].min() == "2020-07-10"


@pytest.mark.parametrize("tag", ["", "_ip"])
def test_predictions_match_jax(runs, tag):
    port = "port_npz" if not tag else "port_ip"
    ref = pd.read_csv(runs / f"pred_jax{tag}.csv")
    got = pd.read_csv(runs / f"pred_{port}.csv")
    pd.testing.assert_frame_equal(got.drop(columns="PredictedDailyNewCases"),
                                  ref.drop(columns="PredictedDailyNewCases"))
    np.testing.assert_allclose(got["PredictedDailyNewCases"],
                               ref["PredictedDailyNewCases"], **TOL)


def test_future_plan_conditions_the_predictions(runs):
    """Every NPI at its maximum lowers the planned geos' cases over the
    horizon; the unplanned geo follows an all-zero schedule (as in the JAX
    package), so its cases rise."""
    a = pd.read_csv(runs / "pred_port_npz.csv")["PredictedDailyNewCases"]
    b = pd.read_csv(runs / "pred_port_ip.csv")["PredictedDailyNewCases"]
    a, b = a.to_numpy().reshape(3, -1), b.to_numpy().reshape(3, -1)
    assert (b[[0, 2]].sum(axis=1) < a[[0, 2]].sum(axis=1)).all()
    assert b[1].sum() > a[1].sum()


def test_summary_matches_jax(runs):
    ref = json.loads((runs / "summary_jax.json").read_text())
    got = json.loads((runs / "summary_port_npz.json").read_text())
    assert set(got) == set(ref) | {"wall_seconds"}
    assert set(got["wall_seconds"]) >= {"read_csv", "run_pipeline",
                                        "write_csv"}
    for k in ("geos", "prescription_epsilon_indices", "pareto_front_sizes"):
        assert got[k] == ref[k], k
    for k in ("epsilon", "J0_mean_per_eps", "J1_mean_per_eps"):
        np.testing.assert_allclose(got[k], ref[k], **TOL, err_msg=k)


@pytest.mark.parametrize("ckpt", ["port.npz", "port.mat", "jax.npz"])
def test_load_params_reproduces_prescriptions(runs, ckpt):
    """Prescribing from a checkpoint (either format, either package's)
    without retraining writes the trained run's prescriptions."""
    tag = "load_" + ckpt.replace(".", "_")
    assert main(_args(runs, tag, "--device", "cpu", "--load-params",
                      str(runs / ckpt))) == 0
    assert filecmp.cmp(runs / f"presc_{tag}.csv", runs / "presc_jax.csv",
                       shallow=False)


def test_cli_defaults_to_the_card_and_refuses_unported(tmp, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(_args(tmp, "card"))
    # the mesh is ported: a mesh larger than the slots is refused
    with pytest.raises(SystemExit, match="needs 2 devices, found 1"):
        main(_args(tmp, "mesh", "--device", "cpu", "--mesh", "2x1"))


def test_vmap_prescriptions_are_byte_identical(tmp):
    """--backend vmap (the generic core, the pinv smoother gain) against the
    JAX CLI's --backend vmap on the same files: the same bytes."""
    assert jax_main(_args(tmp, "jax_vmap", "--backend", "vmap")) == 0
    assert main(_args(tmp, "port_vmap", "--device", "cpu", "--backend",
                      "vmap")) == 0
    assert filecmp.cmp(tmp / "presc_port_vmap.csv",
                       tmp / "presc_jax_vmap.csv", shallow=False)
    col = "PredictedDailyNewCases"
    np.testing.assert_allclose(pd.read_csv(tmp / "pred_port_vmap.csv")[col],
                               pd.read_csv(tmp / "pred_jax_vmap.csv")[col],
                               **TOL)


def test_cli_runs_as_a_module(one_thread_children):
    out = subprocess.run(
        [sys.executable, "-m", "epidemicmodeling_torch.pipelines.xprize_cli",
         "--help"], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "--device" in out.stdout
