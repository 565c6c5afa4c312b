"""The flagship end-to-end pipeline: train -> predict -> prescribe.

Counterpart of epidemicmodeling_tpu/pipelines/train_predict_prescribe.py (the
XPRIZE product, Tools/TrainPredictPrescribeNPI.m): the CSV entry point
train_predict_prescribe, which slices the OxCGRT table into region batches
(build_batches_from_frames), and run_pipeline on those batches: a batched
two-round EKF + regression trainer, forecast scenarios, the Pareto epsilon
sweep of the 6-state optimal-control EKS, and a Monte-Carlo random-policy
baseline, with no Python loop over regions; optionally over a device mesh
(parallel.make_mesh), whose slots split the EKS kernels' lanes.
"""

from __future__ import annotations

import datetime as _dt
import time
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..control import pareto_front_mask_batched
from ..data.oxford import load_geo_list, load_oxford_data, load_populations
from ..data.preprocess import (OXFORD_NPI_COLUMNS, build_region_batch,
                               forward_fill_npis, preprocess_region)
from ..utils.dates import num_days_between
from ..parallel.mesh import mesh_device, validate_pareto_chunk
from ..utils.device import resolve_device
from ..utils.profiling import span
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
                                   # (train_predict_prescribe adds
                                   # "read_csv", the loaders' wall)


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


def _ordinal(date_num) -> int:
    d = int(date_num)
    return _dt.date(d // 10000, d // 100 % 100, d % 100).toordinal()


def build_batches_from_frames(table, pops, geo_ids, start_train, end_train,
                              end_predict, npi_columns=None,
                              cfg: PipelineConfig = PipelineConfig()):
    """Slice the OxCGRT table into training and full-horizon RegionBatches
    (train_predict_prescribe.py:41-134, the script-side extraction of
    Tools/TrainPredictPrescribeNPI.m:93-197): regions keyed by
    "Country Region", cropped to [start_train, end_train] for training, the
    horizon to end_predict appended as NaN observations.

    table: data.oxford.OxfordTable (load_oxford_data); pops: {GeoID:
    population} (load_populations). Regions with fewer than two training
    rows or no population are skipped with a warning; duplicate dates and
    calendar gaps are refused. Returns (batch_train, batch_full,
    actual_npis (R, T_full, P), T_hist, horizon)."""
    npi_columns = list(npi_columns or OXFORD_NPI_COLUMNS)
    missing_cols = [c for c in npi_columns if c not in table.npi_columns]
    if missing_cols:
        raise ValueError(
            f"data table is missing required columns {missing_cols} — "
            "load it with load_oxford_data(path, npi_columns); check "
            "npi_columns spelling against the file header")
    npis = table.npis[:, [table.npi_columns.index(c) for c in npi_columns]]
    d0 = int(str(start_train).replace("-", ""))
    d1 = int(str(end_train).replace("-", ""))
    d2 = int(str(end_predict).replace("-", ""))
    horizon = num_days_between(str(end_train), str(end_predict))

    rows_of = {}
    for k, g in enumerate(table.geo_id):
        rows_of.setdefault(g, []).append(k)
    series, names, actual_list = [], [], []
    for gid in geo_ids:
        rows = np.asarray(rows_of.get(gid, []), np.int64)
        dates = table.date_num[rows]
        rows = rows[(dates >= d0) & (dates <= d2)]
        # rows are consumed positionally as consecutive days, while the
        # horizon stays calendar-based: sort, then refuse duplicates and
        # gaps rather than silently shifting every later date
        rows = rows[np.argsort(table.date_num[rows], kind="stable")]
        dates = table.date_num[rows]
        dup = np.flatnonzero(dates[1:] == dates[:-1])
        if dup.size:
            raise ValueError(
                f"region {gid!r} has duplicate rows for date "
                f"{int(dates[dup[0]])} — each (GeoID, Date) must be unique; "
                "deduplicate the data file before training")
        if len(rows) > 1:
            dd = np.diff([_ordinal(d) for d in dates])
            bad = np.flatnonzero(dd != 1)
            if bad.size:
                i = int(bad[0])
                raise ValueError(
                    f"region {gid!r} has a {int(dd[i])}-day calendar gap "
                    f"after {int(dates[i])} inside [{start_train}, "
                    f"{end_predict}] — rows are consumed as consecutive "
                    "days, so a gap silently shifts every later date; fill "
                    "or re-export the data file")
        tr = rows[dates <= d1]
        if len(tr) < 2:
            warnings.warn(f"skipping region {gid!r}: insufficient training "
                          f"data ({len(tr)} rows)")   # reference :103-106
            continue
        if gid not in pops:
            warnings.warn(f"skipping region {gid!r}: no population entry")
            continue
        series.append(preprocess_region(
            table.confirmed[tr], table.deaths[tr], npis[tr], pops[gid],
            smoothing_win=cfg.smoothing_win,
            obs_noise_factor=cfg.obs_noise_factor))
        names.append(gid)
        actual_list.append(forward_fill_npis(npis[rows]))
    if not series:
        raise ValueError(
            "no region in the geo list has usable training data in "
            f"[{start_train}, {end_train}]" + (
                " (every one was skipped — see the warnings above for "
                "per-region reasons: too few rows, or missing from the "
                "populations file)" if geo_ids else
                " (the geo list is empty)"))
    T_hist = max(s.npis.shape[0] for s in series)
    batch_train = build_region_batch(series, names,
                                     obs_type=cfg.observation_type)
    batch_full = build_region_batch(series, names,
                                    obs_type=cfg.observation_type,
                                    horizon=horizon)
    T_full = T_hist + horizon
    actual = np.zeros((len(series), T_full, len(npi_columns)))
    for r, u in enumerate(actual_list):
        L = min(len(u), T_full)
        actual[r, :L] = u[:L]
        if L < T_full and L:
            actual[r, L:] = u[L - 1]
    return batch_train, batch_full, actual, T_hist, horizon


def train_predict_prescribe(
    npi_weights,
    epsilon_values,
    start_train_date: str,
    end_train_date: str,
    start_regression_date: str,
    end_predict_date: str,
    data_file,
    geo_file,
    populations_file,
    npi_columns=None,
    npi_mins=None,
    npi_maxes=None,
    trained_params_file: Optional[str] = None,
    cfg: PipelineConfig = PipelineConfig(),
    generator: Optional[torch.Generator] = None,
    dtype=None,
    trained=None,
    mesh=None,
    device=None,
    u_random=None,
) -> TrainPredictPrescribeResult:
    """Drop-in equivalent of Tools/TrainPredictPrescribeNPI.m:1 with the same
    argument intent (dates, files, NPI config, epsilon sweep, weights): load
    the CSVs, build the batches, run run_pipeline, and write the trained
    parameters to ``trained_params_file`` (.mat: the reference's cell table,
    else .npz) when given.

    generator seeds what is random (the Monte-Carlo schedules, stochastic
    forecasts), taking the JAX package's ``key``'s place; u_random (N, H,
    P) gives the Monte-Carlo schedules instead (see run_pipeline). device:
    the CUDA card unless told otherwise (device="cpu"); resolved before any
    file is read. mesh: optional ("dp", "ep") parallel.Mesh (see
    run_pipeline); the device is then its lead slot."""
    device = resolve_device(mesh_device(mesh, device))
    npi_columns = list(npi_columns or OXFORD_NPI_COLUMNS)
    P = len(npi_columns)
    npi_mins = np.zeros(P) if npi_mins is None else np.asarray(npi_mins, float)
    if npi_maxes is None:
        raise ValueError("npi_maxes is required (Oxford codebook maxima)")
    npi_maxes = np.asarray(npi_maxes, float)
    for nm, arr in (("npi_maxes", npi_maxes), ("npi_mins", npi_mins)):
        if arr.shape != (P,):
            raise ValueError(
                f"{nm} has shape {arr.shape}, expected ({P},) — one "
                f"entry per NPI column ({P} columns configured)")
    weights = np.asarray(npi_weights.cpu() if isinstance(
        npi_weights, torch.Tensor) else npi_weights, float)
    if weights.ndim == 1 and weights.shape != (P,):
        raise ValueError(
            f"npi_weights has shape {weights.shape}, expected ({P},) "
            f"shared weights or (R, {P}) per-region weights")
    if len(np.atleast_1d(epsilon_values)) == 0:
        raise ValueError("epsilon_values is empty — pass at least one "
                         "tradeoff point (control.epsilon_grid(n) builds "
                         "the reference's log+linear grid)")
    if not (num_days_between(start_train_date, end_train_date) >= 0
            and num_days_between(end_train_date, end_predict_date) >= 0):
        raise ValueError("Invalid input times order.")
    num_regression_days = num_days_between(start_regression_date,
                                           end_train_date)

    t0 = time.perf_counter()
    table = load_oxford_data(data_file, npi_columns, start_train_date,
                             end_predict_date)
    pops = load_populations(populations_file)
    requested = load_geo_list(geo_file)
    present = set(table.geo_id)
    geo_ids = [g for g in requested if g in present]
    if requested and not geo_ids:
        raise ValueError(
            f"none of the {len(requested)} regions in {str(geo_file)!r} "
            f"appear in {str(data_file)!r} (first requested: "
            f"{requested[0]!r}) — wrong data file, or CountryName/"
            "RegionName spelling mismatch")
    batch_train, batch_full, actual_npis, T_hist, _ = \
        build_batches_from_frames(table, pops, geo_ids, start_train_date,
                                  end_train_date, end_predict_date,
                                  npi_columns, cfg)
    read_s = time.perf_counter() - t0

    result = run_pipeline(batch_train, batch_full, actual_npis, T_hist,
                          weights, epsilon_values, npi_mins, npi_maxes,
                          num_regression_days, cfg, generator, dtype,
                          trained=trained, device=device, u_random=u_random,
                          mesh=mesh)
    result.stage_seconds["read_csv"] = read_s
    if trained_params_file:
        from .checkpoint import save_checkpoint
        save_checkpoint(trained_params_file, result.trained)
    return result


def run_pipeline(batch_train, batch_full, actual_npis, T_hist, npi_weights,
                 epsilon_values, npi_mins, npi_maxes, num_regression_days,
                 cfg: PipelineConfig = PipelineConfig(),
                 generator: torch.Generator | None = None, dtype=None,
                 trained=None, device=None, u_random=None,
                 mesh=None) -> TrainPredictPrescribeResult:
    """Run the batched compute pipeline on prepared RegionBatches.

    device / dtype: where and in which precision everything runs. device
    None: the device the batch's tensors already lie on, else the CUDA card
    (a RuntimeError on a machine without one; pass device="cpu" for the
    CPU). dtype None: the batch's, else torch's default dtype. On the
    "lanes"/"pallas" backends the EKS stages run the hand-written kernels
    on a CUDA device, in that dtype (float32 or float64: each kernel has an
    instance of each; any other raises), and their plain versions on the
    CPU; on "vmap" they run the generic EKF/EKS core (tensor ops) on
    either.
    Spans (utils.profiling): ``pipeline`` > ``pipeline.train`` (with
    train_regions' spans), ``pipeline.forecast``, ``pareto`` (with
    pareto_prescribe's), ``mc``, ``front``; each stage's span ends after
    the wait for the card that ``stage_seconds`` already makes.
    trained: optional pre-trained TrainedRegionParams (prescribe from a
    checkpoint without retraining, testScripts/testPrescribeXPRIZE01.m);
    rows are re-aligned to the batch's regions by name.
    generator / u_random: the Monte-Carlo schedules are drawn from
    ``generator`` unless ``u_random`` (N, H, P) gives them; so is the
    rollouts' noise with cfg.stochastic_forecast (scenarios, sweep, Monte
    Carlo, in that order).
    mesh: optional ("dp", "ep") parallel.Mesh (parallel.make_mesh). The
    region inputs (and actual_npis) are replicated on its lead slot, which
    is then the device (see parallel.mesh.shard_region_batch for why:
    bit-parity of the NNLS support selection, multi-host readability), and
    every EKS call splits its lanes over the slots: the sweep's
    epsilon-major lanes over ("ep", "dp"), ekf3's region lanes over ("dp",
    "ep"). The regions must divide by dp, cfg.pareto_chunk by ep.
    """
    check_config(cfg)
    if mesh is not None:
        R = len(batch_train.names)
        if R % mesh.shape["dp"]:
            raise ValueError(
                f"{R} regions not divisible by mesh dp={mesh.shape['dp']}; "
                "pad the geo list or pick a different mesh")
        # the sweep pads epsilon to whole chunks of exactly cfg.pareto_chunk,
        # and each chunk's lanes are split with 'ep' major
        validate_pareto_chunk(cfg.pareto_chunk, mesh)
        device = mesh_device(mesh, device)
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

    with span("pipeline"):
        with span("pipeline.train"):
            if trained is None:
                train_out = train_regions(batch_train, npi_mins, npi_maxes,
                                          num_regression_days, cfg,
                                          mesh=mesh)
            else:
                train_out = TrainOutputs(
                    _realign(trained, batch_train.names, dtype, device),
                    region_init(batch_train, cfg, dtype, device),
                    None, None, None, None)
            lap("train")
        with span("pipeline.forecast"):
            scen, s_hist = forecast_scenarios(
                batch_full, train_out.trained, train_out.init, npi_weights,
                npi_mins, npi_maxes, T_hist, cfg, actual_npis=actual_npis,
                generator=generator, mesh=mesh)
            lap("scenarios")
        with span("pareto"):
            par = pareto_prescribe(
                batch_full, train_out.trained, train_out.init, s_hist,
                epsilon_values, npi_weights, npi_mins, npi_maxes, T_hist,
                cfg, generator=generator, mesh=mesh)
            lap("pareto")
        with span("mc"):
            mc = monte_carlo_baseline(
                batch_full, train_out.trained, train_out.init, s_hist,
                npi_weights, npi_mins, npi_maxes, T_hist, cfg,
                generator=generator, u_random=u_random)
            lap("monte_carlo")
        # per-region Pareto-front membership
        # (TrainPredictPrescribeNPI.m:624-628)
        with span("front"):
            front = pareto_front_mask_batched(par["J0"], par["J1"])
            lap("front")
    return TrainPredictPrescribeResult(
        trained=train_out.trained, scenarios=scen, pareto=par,
        monte_carlo=mc, pareto_front=front, s_hist=s_hist,
        batch_train=batch_train, batch_full=batch_full,
        stage_seconds=stage)
