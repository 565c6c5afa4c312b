"""Forecast-quality backtest: look-ahead error against horizon.

Counterpart of epidemicmodeling_tpu/pipelines/forecast_quality.py:32-225,
the paper's headline evaluation (Tools/ForecastQualityAssessment.m,
testScripts/testIEEEJSTSP2021ArticleResults.m):
- train with the flagship's front end (two EKF rounds + regression) on the
  head of the window;
- for each holdout start s = 1..S, NaN-mask the last s observations, rerun
  the 3-state EKF/EKS with the actual historic NPIs, and record the percent
  error of the reconstructed new-case curve at look-ahead horizons 1..H
  (:374-416);
- aggregate mean / median error curves over the start days (:423-429).

The reference reruns a full EKF per (region, start) serially; here the
(region, start) grid is B = R * S lanes (lane = r * S + s), so one call runs
them all: on the "lanes"/"pallas" backends one ekf3 call (the CUDA kernel B1
on a card, its plain version on the CPU; one a slot of a mesh), on "vmap"
one batch of the
generic EKF/EKS core with outputs "light"
(epidemicmodeling_tpu/pipelines/forecast_quality.py:228).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.si_alpha import si_alpha_ekf_system
from ..ops.cuda.ekf3_kernel import ekf3_lanes
from ..ops.ekf import ekf_smoother
from ..parallel.mesh import mesh_device
from ..utils.profiling import span
from .config import PipelineConfig
from .core import (check_config, device_batch, stage_params, to_tensor,
                   train_regions)


class BacktestResult(NamedTuple):
    """Look-ahead backtest error curves (ForecastQualityAssessment.m:
    374-429); the aggregates mask non-finite per-day entries (zero-truth
    days)."""
    est_error_plus: torch.Tensor       # (R, S, H) % error, filtered estimate
    est_error_smooth: torch.Tensor     # (R, S, H) % error, smoothed estimate
    mean_error_smooth: torch.Tensor    # (R, H) mean over valid start days
    median_error_smooth: torch.Tensor  # (R, H)
    trained: object


def forecast_quality_assessment(batch, npi_mins, npi_maxes,
                                num_regression_days: int,
                                num_forecast_days: int,
                                max_look_ahead_days: int = 60,
                                cfg: PipelineConfig = PipelineConfig(),
                                dtype=None, mesh=None,
                                device=None) -> BacktestResult:
    """Run the look-ahead backtest over all regions.

    batch: RegionBatch over the ENTIRE window (training + evaluation tail);
    the last ``num_forecast_days`` days serve as holdout starts, and
    training uses the window up to T - num_forecast_days. device / dtype as
    in run_pipeline: the CUDA card unless the batch's tensors lie elsewhere
    or device="cpu" is passed.

    mesh: optional ("dp", "ep") parallel.Mesh. The region inputs are
    replicated on its lead slot (parallel.mesh.shard_region_batch) and the
    (region, start) lanes of the ekf3 call (the product's largest, R x S)
    are split over every slot, one launch a slot; dp must divide the
    regions.

    Spans (utils.profiling): ``backtest`` (the call) over
    ``backtest.train`` (train_regions), ``backtest.lanes`` (the lane
    inputs), ``backtest.ekf3`` (the (region, start) filters) and
    ``backtest.errors`` (the error curves and their aggregates)."""
    with span("backtest"):
        check_config(cfg)
        R = batch.observations.shape[0]
        if mesh is not None and R % mesh.shape["dp"]:
            raise ValueError(f"{R} regions not divisible by mesh "
                             f"dp={mesh.shape['dp']}")
        batch, fd, dev = device_batch(batch, dtype,
                                      mesh_device(mesh, device))
        R, T = batch.observations.shape
        S, H = int(num_forecast_days), int(max_look_ahead_days)
        T_train = T - S
        if not (1 <= S and T_train >= 2):
            raise ValueError(
                f"num_forecast_days={S} leaves {T_train} training days of "
                f"the {T}-day series — need at least 2 (the holdout starts "
                "are the LAST num_forecast_days days)")

        # train on the head window (the flagship's front end)
        head = lambda a: a[:, :T_train]
        train_batch = batch._replace(
            observations=head(batch.observations),
            new_cases_norm=head(batch.new_cases_norm),
            confirmed_norm=head(batch.confirmed_norm),
            npis=head(batch.npis), obs_noise_var=head(batch.obs_noise_var))
        with span("backtest.train"):
            train_out = train_regions(train_batch, npi_mins, npi_maxes,
                                      num_regression_days, cfg, mesh=mesh)
        init = train_out.init
        params = stage_params(cfg, batch, train_out.trained, npi_mins,
                              npi_maxes, fd, dev)
        pop = to_tensor(batch.population, fd, dev)
        truth = to_tensor(batch.new_cases_norm, fd, dev) * pop[:, None]

        if cfg.backend == "vmap":
            s_plus, s_smooth = _run_all_vmap(
                cfg, batch.observations, batch.npis, batch.obs_noise_var,
                params, init, S)
        else:
            s_plus, s_smooth = _run_all_lanes(
                cfg, batch.observations, batch.npis, batch.obs_noise_var,
                params, init, S, mesh)
        with span("backtest.errors"):
            err_plus, err_smooth = _errors_from_states(
                s_plus, s_smooth, truth, pop, H)
            # aggregate over start days with a full look-ahead window (the
            # reference averages rows MaxLookAheadDays..end, :423-429).
            # Per-day errors keep the reference's inf on zero-truth days
            # (:390-391); the aggregates mask non-finite entries, and an
            # all-masked (region, horizon) cell aggregates to NaN.
            e = err_smooth[:, H - 1:] if S >= H else err_smooth
            finite = torch.isfinite(e)
            n_ok = finite.sum(dim=1)
            total = torch.where(finite, e, torch.zeros_like(e)).sum(dim=1)
            mean_sm = torch.where(n_ok > 0, total / n_ok.clamp_min(1),
                                  torch.full_like(total, float("nan")))
            med_sm = _nanmedian(torch.where(
                finite, e, torch.full_like(e, float("nan"))))
        return BacktestResult(err_plus, err_smooth, mean_sm, med_sm,
                              train_out.trained)


def backtest_lane_inputs(obs, npis, R_v, params, init, S):
    """The (region, start) grid as batch-last lanes (lane = r * S + s):
    the observations with their last s days NaN-masked on start s, and
    each region's inputs repeated S times. Returns the arguments of
    ops.cuda.ekf3_kernel.ekf3_lanes (u, x, Rv, params, Q, s_init,
    Ps_init)."""
    R, T = obs.shape
    t_idx = torch.arange(T, device=obs.device)
    starts = torch.arange(1, S + 1, device=obs.device)
    masked = t_idx[None, None, :] >= T - starts[None, :, None]   # (1, S, T)
    x = torch.where(masked, torch.full_like(obs[:, None, :], float("nan")),
                    obs[:, None, :])
    tile = lambda a: torch.repeat_interleave(torch.movedim(a, 0, -1), S,
                                             dim=-1)
    return (tile(npis), x.reshape(R * S, T).T, tile(R_v),
            {k: tile(v) for k, v in params.items()}, tile(init.Q),
            tile(init.s_init), tile(init.Ps_init))


def _run_all_lanes(cfg, obs, npis, R_v, params, init, S, mesh=None):
    """Every (region, start) filter in one ekf3 call (one a slot of
    ``mesh``). Returns the filtered and smoothed states, each
    (R, S, T, 3)."""
    R, T = obs.shape
    with span("backtest.lanes"):
        lanes = backtest_lane_inputs(obs, npis, R_v, params, init, S)
    with span("backtest.ekf3"):
        ss_bl, sp_bl, _ = ekf3_lanes(
            *lanes, gamma_discount=cfg.gamma_ekf,
            obs_type=cfg.observation_type, mesh=mesh)
    back = lambda a: torch.movedim(a, -1, 0).reshape(R, S, T, 3)
    return back(sp_bl), back(ss_bl)


def _run_all_vmap(cfg, obs, npis, R_v, params, init, S):
    """Every (region, start) filter as one batch of the generic core, with
    cfg.smoother_gain and outputs "light". Returns the filtered and smoothed
    states, each (R, S, T, 3)."""
    R, T = obs.shape
    with span("backtest.lanes"):
        u, x, Rv, params_bl, Q, s0, Ps0 = backtest_lane_inputs(
            obs, npis, R_v, params, init, S)
    first = lambda a: torch.movedim(a, -1, 0)
    with span("backtest.ekf3"):
        res = ekf_smoother(
            si_alpha_ekf_system(cfg.observation_type), first(u), x.T,
            {k: first(v) for k, v in params_bl.items()}, s0.T, first(Ps0),
            Q=first(Q), R=Rv.T, beta=cfg.beta_ekf,
            gamma_discount=cfg.gamma_ekf, inv_monitor_len=cfg.inv_monitor_len,
            order=cfg.order, smoother_gain=cfg.smoother_gain,
            outputs="light")
    back = lambda a: a.reshape(R, S, T, 3)
    return back(res.s_plus), back(res.s_smooth)


def _errors_from_states(s_plus, s_smooth, truth, pop, H):
    """Percent-error curves at horizons 1..H for every (region, start):
    states (R, S, T, 3), truth (R, T), pop (R,) -> two (R, S, H). Horizon h
    (1-based) of start s reads day T - s + h - 1; days past the end read
    0."""
    R, S, T, _ = s_plus.shape
    pop4 = pop[:, None, None]

    def err(s):
        est = s[..., 0] * s[..., 1] * s[..., 2] * pop4
        return 100.0 * torch.abs(truth[:, None, :] - est) / truth[:, None, :]

    starts = torch.arange(1, S + 1, device=truth.device)
    days = T - starts[:, None] + torch.arange(H, device=truth.device)
    valid = days < T
    idx = days.clamp(0, T - 1).expand(R, S, H)
    pick = lambda e: torch.where(valid, torch.gather(e, 2, idx),
                                 torch.zeros((), dtype=e.dtype,
                                             device=e.device))
    return pick(err(s_plus)), pick(err(s_smooth))


def _nanmedian(e):
    """NumPy's nanmedian over dim 1 (the mean of the two middle values of an
    even count; NaN where all are NaN). torch.nanmedian takes the lower
    middle value instead."""
    n = (~torch.isnan(e)).sum(dim=1, keepdim=True)
    srt = torch.sort(e, dim=1).values          # NaN sorts last
    lo = torch.gather(srt, 1, ((n - 1).clamp_min(0) // 2))
    hi = torch.gather(srt, 1, (n // 2).clamp_max(e.shape[1] - 1))
    med = (lo + hi) / 2
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))[:, 0]
