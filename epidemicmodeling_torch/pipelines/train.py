"""Training-only pipeline and the death-based mortality / beta estimates.

Counterpart of epidemicmodeling_tpu/pipelines/train.py
(Tools/TrainNPIPrescriptor.m): the two-round EKF + regression training
(:137-245, pipelines.core.train_regions, so on a CUDA device with the
"lanes"/"pallas" backends it runs the ekf3 kernel), the estimates from the
deaths series (:264-273), host NumPy as in the JAX package:
- MortalityRate = smoothed cumulative deaths / smoothed cumulative cases,
  NaN -> 0; its median and its recent-quartile median;
- CumInfections = cumsum(N * i_smooth);
- BetaEstimate = (deaths / CumInfections) / MedRecentMortalityRate, with the
  recent-quartile median as the headline estimate;
and the TrainedModelParams product saved as a checkpoint (:451-454,
pipelines/checkpoint.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from ..utils.math import host_array
from .checkpoint import save_trained_params
from .config import PipelineConfig
from .core import TrainOutputs, train_regions


class MortalityEstimates(NamedTuple):
    """Per-region mortality and beta estimates from the deaths series
    (TrainNPIPrescriptor.m:264-273), host arrays."""
    mortality_rate: np.ndarray          # (R, T)
    med_mortality: np.ndarray           # (R,)
    med_recent_mortality: np.ndarray    # (R,)
    beta_estimate: np.ndarray           # (R, T)
    med_recent_beta: np.ndarray         # (R,)


def estimate_mortality_beta(batch, deaths_smoothed, confirmed_deaths,
                            train_out: TrainOutputs) -> MortalityEstimates:
    """Death-based mortality and recovery-rate estimates
    (TrainNPIPrescriptor.m:264-273). batch: the training RegionBatch;
    deaths_smoothed: (R, T) smoothed daily deaths; confirmed_deaths: (R, T)
    cumulative deaths. Every input is brought to the host once; the
    arithmetic is the JAX package's NumPy."""
    R, T = batch.observations.shape
    pop = host_array(batch.population)
    cases_smoothed = host_array(batch.new_cases_norm) * pop[:, None]
    conf_smoothed = np.cumsum(cases_smoothed, axis=1)
    dead_smoothed_cum = np.cumsum(host_array(deaths_smoothed), axis=1)

    with np.errstate(divide="ignore", invalid="ignore"):
        mr = dead_smoothed_cum / conf_smoothed   # 0/0 before the first case
    mr[~np.isfinite(mr)] = 0.0
    med = np.median(mr, axis=1)
    q = (3 * T) // 4
    med_recent = np.median(mr[:, q:], axis=1)

    i_smooth = host_array(train_out.s_smooth_round2[:, :, 1])
    cum_inf = np.cumsum(pop[:, None] * i_smooth, axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        beta_est = host_array(confirmed_deaths) / cum_inf
    beta_est = beta_est / np.where(med_recent[:, None] > 0,
                                   med_recent[:, None], np.nan)
    med_recent_beta = np.nanmedian(beta_est[:, q:], axis=1)
    return MortalityEstimates(mr, med, med_recent, beta_est, med_recent_beta)


def train_npi_prescriptor(batch, npi_mins, npi_maxes, num_regression_days,
                          deaths_smoothed="from_batch",
                          confirmed_deaths="from_batch",
                          trained_params_file: Optional[str] = None,
                          cfg: PipelineConfig = PipelineConfig(),
                          dtype=None, device=None):
    """Training-only entry point (Tools/TrainNPIPrescriptor.m:1): two-round
    EKF + regression over all regions, the mortality / beta estimates when
    both death series are there ("from_batch": the batch's own), and the
    checkpoint save (.npz). Runs on ``device``, else where the batch's
    tensors lie, else on the CUDA card. Returns (TrainOutputs,
    MortalityEstimates | None)."""
    train_out = train_regions(batch, npi_mins, npi_maxes,
                              num_regression_days, cfg, dtype, device)
    if isinstance(deaths_smoothed, str):
        deaths_smoothed = batch.deaths_smoothed
    if isinstance(confirmed_deaths, str):
        confirmed_deaths = batch.confirmed_deaths
    mort = None
    if deaths_smoothed is not None and confirmed_deaths is not None:
        mort = estimate_mortality_beta(batch, deaths_smoothed,
                                       confirmed_deaths, train_out)
    if trained_params_file:
        save_trained_params(trained_params_file, train_out.trained)
    return train_out, mort
