"""The flagship end-to-end pipeline: train -> predict -> prescribe.

Counterpart of run_pipeline in
epidemicmodeling_tpu/pipelines/train_predict_prescribe.py:235-324 (the XPRIZE
product, Tools/TrainPredictPrescribeNPI.m): a batched two-round EKF +
regression trainer, forecast scenarios, the Pareto epsilon sweep of the
6-state optimal-control EKS, and a Monte-Carlo random-policy baseline, with
no Python loop over regions. The CSV entry point (train_predict_prescribe),
the CLI and the mesh are not ported yet (ROADMAP Queue A).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..control import pareto_front_mask_batched
from .config import PipelineConfig
from .core import (TrainOutputs, TrainedRegionParams, check_config,
                   device_batch, forecast_scenarios, monte_carlo_baseline,
                   pareto_prescribe, region_init, to_tensor, train_regions)


class TrainPredictPrescribeResult(NamedTuple):
    """Everything the flagship pipeline produces for a region batch."""
    trained: TrainedRegionParams
    scenarios: dict                # fixed/zero/max(/actual) ScenarioResult
    pareto: dict                   # J0/J1 (E,R), trajectories, prescriptions
    monte_carlo: dict              # J0/J1 (N,R), u_random (N,H,P)
    pareto_front: torch.Tensor     # (E, R) bool front membership per region
    s_hist: torch.Tensor           # (R, T_hist, 3) smoothed historic states
    batch_train: object
    batch_full: object
    stage_seconds: dict            # host wall per stage, device synchronized


def _realign(trained: TrainedRegionParams, names, dtype, device):
    """Re-order a checkpoint's rows to the batch's regions, by name."""
    idx = {n: i for i, n in enumerate(trained.names)}
    missing = [n for n in names if n not in idx]
    if missing:
        raise ValueError(
            f"checkpoint is missing trained parameters for {missing}")
    order = [idx[n] for n in names]
    take = lambda v: to_tensor(v, dtype, device)[
        torch.as_tensor(order, device=device)]
    return TrainedRegionParams(
        names=tuple(names),
        population=np.asarray(trained.population)[order],
        a1=take(trained.a1), b1=take(trained.b1),
        a2=take(trained.a2), b2=take(trained.b2))


def run_pipeline(batch_train, batch_full, actual_npis, T_hist, npi_weights,
                 epsilon_values, npi_mins, npi_maxes, num_regression_days,
                 cfg: PipelineConfig = PipelineConfig(),
                 generator: torch.Generator | None = None, dtype=None,
                 trained=None, device=None,
                 u_random=None) -> TrainPredictPrescribeResult:
    """Run the batched compute pipeline on prepared RegionBatches.

    device / dtype: where and in which precision everything runs (default:
    the CPU, torch's default dtype). On a CUDA device the EKS stages run
    the hand-written kernels; on the CPU, their plain versions.
    trained: optional pre-trained TrainedRegionParams (prescribe from a
    checkpoint without retraining, testScripts/testPrescribeXPRIZE01.m);
    rows are re-aligned to the batch's regions by name.
    generator / u_random: the Monte-Carlo schedules are drawn from
    ``generator`` unless ``u_random`` (N, H, P) gives them.
    """
    check_config(cfg)
    batch_train, dtype, device = device_batch(batch_train, dtype, device)
    batch_full, _, _ = device_batch(batch_full, dtype, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    stage = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        sync()
        t1 = time.perf_counter()
        stage[name] = t1 - t0
        t0 = t1

    if trained is None:
        train_out = train_regions(batch_train, npi_mins, npi_maxes,
                                  num_regression_days, cfg)
    else:
        train_out = TrainOutputs(
            _realign(trained, batch_train.names, dtype, device),
            region_init(batch_train, cfg, dtype, device),
            None, None, None, None)
    lap("train")
    scen, s_hist = forecast_scenarios(
        batch_full, train_out.trained, train_out.init, npi_weights,
        npi_mins, npi_maxes, T_hist, cfg, actual_npis=actual_npis)
    lap("scenarios")
    par = pareto_prescribe(
        batch_full, train_out.trained, train_out.init, s_hist,
        epsilon_values, npi_weights, npi_mins, npi_maxes, T_hist, cfg)
    lap("pareto")
    mc = monte_carlo_baseline(
        batch_full, train_out.trained, train_out.init, s_hist, npi_weights,
        npi_mins, npi_maxes, T_hist, cfg, generator=generator,
        u_random=u_random)
    lap("monte_carlo")
    # per-region Pareto-front membership (TrainPredictPrescribeNPI.m:624-628)
    front = pareto_front_mask_batched(par["J0"], par["J1"])
    lap("front")
    return TrainPredictPrescribeResult(
        trained=train_out.trained, scenarios=scen, pareto=par,
        monte_carlo=mc, pareto_front=front, s_hist=s_hist,
        batch_train=batch_train, batch_full=batch_full,
        stage_seconds=stage)
