"""Batched pipeline stages: two-round training, forecast scenarios, the
Pareto prescription sweep, and the Monte-Carlo baseline.

Counterpart of epidemicmodeling_tpu/pipelines/core.py for the batch-last
backends. Every stage runs over all regions at once: region-major tensors
(R, ...) at the stage boundaries, lanes-last (T, C, B) inside the EKF/EKS.
The Pareto sweep tiles an epsilon chunk over the regions into
B = pareto_chunk * R lanes, epsilon-major (lane = e * R + r).

Backends (cfg.backend): "lanes" and "pallas" both take this batch-last
path, and the device decides what runs the EKF/EKS: the hand-written CUDA
kernels (ops/cuda/) for CUDA tensors, their plain versions (the batch-last
core, ops/ekf_bl.py) for CPU tensors. "vmap" runs the generic EKF/EKS core
(ops/ekf.py, tensor ops on either device) over the same lanes, with
cfg.smoother_gain (the MATLAB-exact "pinv" by default) and any
cfg.beta_ekf; it launches no hand-written EKS kernel. The SI-alpha
rollouts of the scenarios, the sweep and the Monte Carlo follow the device
alone, on every backend: one launch of the rollout kernel a call on a card
(ops/cuda/rollout_kernel.py), the plain version's eager loop on the CPU.
The device is the one the batch tensors live on (see device_batch).

mesh= (parallel.Mesh): the stages run on the mesh's lead slot, and each EKS
call splits its lanes over the slots (ops/cuda/shard.py): ekf3 region-major,
the sweep's ekf6 (or, on "vmap", its generic EKS) epsilon-major. The region
inputs, the rollouts, the costs, the regressions and the Monte Carlo stay
replicated on the lead slot (parallel.mesh.shard_region_batch).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..control import npi_cost, random_npi_schedules
from ..models.costate import si_alpha_costate_ekf_system
from ..models.si_alpha import si_alpha_ekf_system
from ..ops.cuda import ekf6_kernel, rollout_kernel
from ..ops.cuda.ekf3_kernel import ekf3_lanes, rho_from_priors
from ..ops.cuda.shard import map_lanes
from ..ops.ekf import ekf_smoother
from ..parallel.mesh import mesh_device, validate_pareto_chunk
from ..regression import (lasso_cv, nnls_with_intercept,
                          robust_affine_fit_elementwise)
from ..utils.device import resolve_device
from ..utils.profiling import count_on_close, span
from .config import PipelineConfig


class RegionInit(NamedTuple):
    """Per-region derived EKF initialization, (R,)-batched."""
    I0: torch.Tensor           # (R,) initial case estimate
    s_init: torch.Tensor       # (R, 3)
    Ps_init: torch.Tensor      # (R, 3, 3)
    Q: torch.Tensor            # (R, 3, 3)
    s_noise_std: torch.Tensor  # (R,)
    i_noise_std: torch.Tensor  # (R,)


class TrainedRegionParams(NamedTuple):
    """The persisted training product (TrainPredictPrescribeNPI.m:910)."""
    names: tuple
    population: np.ndarray     # (R,)
    a1: torch.Tensor           # (R, P) round-1 NPI influence weights
    b1: torch.Tensor           # (R,)
    a2: torch.Tensor           # (R, P) round-2 (refined)
    b2: torch.Tensor           # (R,)


class TrainOutputs(NamedTuple):
    """Two-round training results (TrainPredictPrescribeNPI.m:199-354)."""
    trained: TrainedRegionParams
    init: RegionInit
    s_smooth_round1: Optional[torch.Tensor]   # (R, T, 3)
    s_smooth_round2: Optional[torch.Tensor]   # (R, T, 3)
    rho_round1: Optional[torch.Tensor]        # (R, T)
    rho_round2: Optional[torch.Tensor]        # (R, T)


class ScenarioResult(NamedTuple):
    """One forecast scenario's trajectories, applied schedule and (J0, J1)
    costs (TrainPredictPrescribeNPI.m:367-412)."""
    s: torch.Tensor        # (R, T_full)
    i: torch.Tensor        # (R, T_full)
    alpha: torch.Tensor    # (R, T_full)
    u: torch.Tensor        # (R, T_full, P) applied NPI schedule
    J0: torch.Tensor       # (R,)
    J1: torch.Tensor       # (R,)


class EKF3Result(NamedTuple):
    """What the pipeline reads from a 3-state EKS run (region-major)."""
    s_smooth: torch.Tensor   # (R, T, 3)
    rho: torch.Tensor        # (R, T)


def to_tensor(a, dtype=None, device=None) -> torch.Tensor:
    """``a`` as a tensor in ``dtype`` on ``device``. Non-tensor input is
    copied into a float64 NumPy array first (arrays handed over from JAX are
    read-only, which torch does not support)."""
    if not isinstance(a, torch.Tensor):
        a = np.array(a, dtype=float)
    return torch.as_tensor(a, dtype=dtype, device=device)


REGRESSION_TYPES = ("NONNEGATIVELS", "LASSO", "NONNEGATIVELS-ELEMENT-WISE")


def check_config(cfg: PipelineConfig) -> None:
    """Refuse a configuration that cannot run, before any work is done."""
    if cfg.backend not in ("vmap", "lanes", "pallas"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    if cfg.order != 1:
        # the SI-alpha systems define no Hessian terms: the JAX package
        # fails on them too (it calls the missing obs_hessian_terms)
        raise TypeError(f"order={cfg.order} needs second-order terms, and "
                        "the SI-alpha systems define no obs_hessian_terms "
                        "or state_hessian_terms")
    if cfg.regression_type not in REGRESSION_TYPES:
        raise ValueError(f"unknown regression_type {cfg.regression_type!r}")
    if cfg.smoother_gain not in ("pinv", "solve"):
        raise ValueError(f"unknown smoother_gain {cfg.smoother_gain!r}")
    if cfg.observation_type not in ("NEWCASES", "TOTALCASES"):
        raise ValueError(
            f"unknown observation type {cfg.observation_type!r}")
    if cfg.pareto_chunk < 1:
        raise ValueError(f"pareto_chunk={cfg.pareto_chunk} must be >= 1")


def device_batch(batch, dtype=None, device=None):
    """Move a RegionBatch's hot fields (observations, npis, obs_noise_var)
    to ``device`` in ``dtype``. The fields that host logic reads
    (new_cases_norm, population) stay NumPy. Defaults: the device and dtype
    the batch's observations already have, else the CUDA card (a RuntimeError
    without one) and torch's default dtype. Returns (batch, dtype, device)."""
    obs = batch.observations
    device = resolve_device(device, obs)
    if dtype is None:
        dtype = (obs.dtype if isinstance(obs, torch.Tensor)
                 else torch.get_default_dtype())
    t = lambda a: to_tensor(a, dtype, device)
    batch = batch._replace(observations=t(batch.observations),
                           npis=t(batch.npis),
                           obs_noise_var=t(batch.obs_noise_var))
    return batch, dtype, device


def region_init(batch, cfg: PipelineConfig, dtype=None,
                device=None) -> RegionInit:
    """Derive per-region I0 and the EKF initialization
    (TrainPredictPrescribeNPI.m:200-237). Host-side NumPy (a data-dependent
    first-positive search), done once per dataset."""
    R = len(batch.names)
    N = np.asarray(batch.population, float)
    nc_smooth = np.asarray(batch.new_cases_norm, float) * N[:, None]
    I0 = np.zeros(R)
    for r in range(R):
        x = nc_smooth[r]
        pos = x[np.isfinite(x) & (x > 0)][
            : cfg.first_num_days_for_case_estimation]
        I0[r] = max(cfg.min_cases, float(pos.mean()) if pos.size else 0.0)
    s_noise = cfg.s_noise_factor * I0 / N
    i_noise = cfg.i_noise_factor * I0 / N
    a_noise = np.full(R, cfg.alpha_noise_std)
    dt2 = cfg.dt ** 2
    Q = dt2 * np.stack([np.diag(v) for v in
                        np.stack([s_noise, i_noise, a_noise], -1) ** 2])
    Ps = dt2 * np.stack([np.diag(v) for v in
                         (cfg.init_cov_factor
                          * np.stack([s_noise, i_noise, a_noise], -1)) ** 2])
    s_init = np.stack([(N - I0) / N, I0 / N, np.full(R, cfg.alpha0)], -1)
    t = lambda a: to_tensor(a, dtype or torch.get_default_dtype(), device)
    return RegionInit(t(I0), t(s_init), t(Ps), t(Q), t(s_noise), t(i_noise))


def _base_params(cfg: PipelineConfig, npi_mins, npi_maxes, R, dtype, device):
    """Region-batched SI-alpha params dict with zero NPI influence."""
    P = len(npi_maxes)
    kw = dict(dtype=dtype, device=device)
    z = torch.zeros((R,), **kw)
    t = lambda a: to_tensor(a, **kw)
    return {
        "dt": z + cfg.dt,
        "beta": z + cfg.beta_model,
        "gamma": z + cfg.gamma_model,
        "a": torch.zeros((R, P), **kw),
        "b": z,
        "u_min": t(npi_mins).expand(R, P),
        "u_max": t(npi_maxes).expand(R, P),
        "s_min": z,
        "i_min": z,
        "alpha_min": z + cfg.alpha_min,
        "alpha_max": z + cfg.alpha_max,
        "epsilon": z + float("nan"),
        "w": torch.full((R, P), float("nan"), **kw),
        "sigma": z + cfg.sigma,
    }


def _region_weights(npi_weights, R, P, dtype, device):
    """NPI cost weights: a shared (P,) vector or per-region (R, P) weights
    (TrainPredictPrescribeNPI.m:109-127). Returns (R, P)."""
    w = to_tensor(npi_weights, dtype, device)
    if w.dim() == 1:
        if w.shape[0] != P:
            raise ValueError(
                f"npi_weights has length {w.shape[0]}, expected {P} "
                f"(one weight per NPI) or per-region ({R}, {P})")
        w = w[None, :].expand(R, P)
    if tuple(w.shape) != (R, P):
        raise ValueError(f"npi_weights must be (P,)=({P},) or "
                         f"(R,P)=({R},{P}); got {tuple(w.shape)}")
    return w


def stage_params(cfg, batch, trained, npi_mins, npi_maxes, dtype, device):
    """The stages' params dict: per-region margins (min_cases / population)
    and, when ``trained`` is given, its round-2 coefficients (zero NPI
    influence otherwise)."""
    R = batch.observations.shape[0]
    params = _base_params(cfg, npi_mins, npi_maxes, R, dtype, device)
    pop = to_tensor(batch.population, dtype, device)
    params["s_min"] = cfg.min_cases / pop
    params["i_min"] = cfg.min_cases / pop
    if trained is not None:
        params["a"] = to_tensor(trained.a2, dtype, device)
        params["b"] = to_tensor(trained.b2, dtype, device)
    return params


def ekf3_lane_inputs(u, obs, params, R_v, init):
    """Region-major 3-state EKS inputs -> batch-last (u_bl, x_bl, Rv_bl,
    params_bl, Q_bl, s_init_bl, Ps_init_bl): the lane axis is the region."""
    bl = lambda a: torch.movedim(a, 0, -1)
    return (bl(u), obs.T, R_v.T, {k: bl(v) for k, v in params.items()},
            bl(init.Q), bl(init.s_init), bl(init.Ps_init))


def _run_ekf3(cfg, u, obs, params, R_v, init, mesh=None) -> EKF3Result:
    """3-state EKF/EKS over all regions: u (R, T, P), obs and R_v (R, T).
    "vmap": the generic core, one filter a region (replicated: a mesh does
    not split it, as the JAX package's vmap backend does not). Otherwise the
    CUDA kernel on a card (its plain version on the CPU), its region lanes
    split over ``mesh``, rho from the stored priors."""
    if cfg.backend == "vmap":
        res = ekf_smoother(
            si_alpha_ekf_system(cfg.observation_type), u, obs, params,
            init.s_init, init.Ps_init, Q=init.Q, R=R_v, beta=cfg.beta_ekf,
            gamma_discount=cfg.gamma_ekf,
            inv_monitor_len=cfg.inv_monitor_len, order=cfg.order,
            smoother_gain=cfg.smoother_gain)
        return EKF3Result(res.s_smooth, res.rho[..., 0, 0])
    u_bl, x_bl, Rv_bl, params_bl, Q_bl, s0_bl, Ps0_bl = ekf3_lane_inputs(
        u, obs, params, R_v, init)
    ssm, _, sm = ekf3_lanes(
        u_bl, x_bl, Rv_bl, params_bl, Q_bl, s0_bl, Ps0_bl,
        gamma_discount=cfg.gamma_ekf, obs_type=cfg.observation_type,
        mesh=mesh)
    rho = rho_from_priors(sm, x_bl, Rv_bl, cfg.inv_monitor_len,
                          obs_type=cfg.observation_type)
    return EKF3Result(torch.movedim(ssm, -1, 0), rho.T)


def _regress(cfg: PipelineConfig, x_data, y_data):
    """Batched regression: x_data (R, n, P), y_data (R, n) ->
    (a (R, P), b (R,))."""
    if cfg.regression_type == "NONNEGATIVELS":
        return nnls_with_intercept(x_data, y_data,
                                   iterations=cfg.nonneg_iterations)
    if cfg.regression_type == "LASSO":
        # MATLAB's cvpartition shuffles the folds (:255 lasso(...,'CV',50))
        # when a seed is configured: one permutation shared by the regions,
        # drawn from torch's generator (jax.random's cannot be reproduced);
        # the default is the deterministic interleave i mod K
        perm = None
        if cfg.lasso_cv_shuffle_seed >= 0:
            perm = torch.randperm(x_data.shape[-2], generator=torch.Generator(
                ).manual_seed(cfg.lasso_cv_shuffle_seed))
        coef, intercept, _ = lasso_cv(x_data, y_data,
                                      n_folds=cfg.lasso_cv_folds, perm=perm)
        return coef, intercept
    if cfg.regression_type == "NONNEGATIVELS-ELEMENT-WISE":
        return robust_affine_fit_elementwise(x_data, y_data)
    raise ValueError(f"unknown regression_type {cfg.regression_type!r}")


def train_regions(batch, npi_mins, npi_maxes, num_regression_days,
                  cfg: PipelineConfig = PipelineConfig(), dtype=None,
                  device=None, mesh=None) -> TrainOutputs:
    """Two-round EKF + regression training over all regions at once
    (TrainPredictPrescribeNPI.m:199-354). batch: RegionBatch over the
    TRAINING window (no forecast horizon). mesh: see the module
    docstring. Spans (utils.profiling): ``train.init``, ``train.ekf3`` and
    ``train.regress`` (each of the last two once a round)."""
    check_config(cfg)
    batch, fd, dev = device_batch(batch, dtype, mesh_device(mesh, device))
    with span("train.init"):
        init = region_init(batch, cfg, fd, dev)
    obs, npis = batch.observations, batch.npis
    R, T = obs.shape
    nrd = int(num_regression_days)
    params = stage_params(cfg, batch, None, npi_mins, npi_maxes, fd, dev)
    R_v = batch.obs_noise_var

    # ROUND 1: zero control input, zero NPI influence (:199-248)
    with span("train.ekf3"):
        res1 = _run_ekf3(cfg, torch.zeros_like(npis), obs, params, R_v, init,
                         mesh)

    # regression 1: alpha ~ (NPI_MAX - NPI) over the last regression window
    maxes = to_tensor(npi_maxes, fd, dev)
    x_win = (maxes[None, None, :] - npis)[:, T - nrd:, :]
    with span("train.regress"):
        a1, b1 = _regress(cfg, x_win, res1.s_smooth[:, T - nrd:, 2])

    # ROUND 2: historic NPIs + learned influence (:295-307)
    with span("train.ekf3"):
        res2 = _run_ekf3(cfg, npis, obs, dict(params, a=a1, b=b1), R_v, init,
                         mesh)
    with span("train.regress"):
        a2, b2 = _regress(cfg, x_win, res2.s_smooth[:, T - nrd:, 2])

    trained = TrainedRegionParams(
        names=tuple(batch.names), population=np.asarray(batch.population),
        a1=a1, b1=b1, a2=a2, b2=b2)
    return TrainOutputs(trained, init, res1.s_smooth, res2.s_smooth,
                        res1.rho, res2.rho)


def _rollout_params(cfg, init, params):
    return {
        "dt": params["dt"], "beta": params["beta"],
        "gamma": params["gamma"], "a": params["a"], "b": params["b"],
        "u_max": params["u_max"], "alpha_min": params["alpha_min"],
        "alpha_max": params["alpha_max"],
        "s_noise_std": init.s_noise_std.to(params["dt"].dtype),
        "i_noise_std": init.i_noise_std.to(params["dt"].dtype),
        "alpha_noise_std": torch.full_like(params["dt"],
                                           cfg.alpha_noise_std),
    }


def forecast_noise(cfg, shape, dtype, device, generator=None, noise=None):
    """The standard-normal process noise of stochastic forecasts
    (SIalpha_Controlled.m noise terms), or None when cfg.stochastic_forecast
    is off. ``noise`` gives it explicitly (e.g. the JAX package's
    jax.random draws, for parity); else it is drawn from ``generator`` on
    the generator's device (torch's default generator on ``device`` when
    None). Returns a tensor of ``shape`` on ``device``."""
    if not cfg.stochastic_forecast:
        return None
    if noise is None:
        gdev = device if generator is None else generator.device
        noise = torch.randn(shape, generator=generator, dtype=dtype,
                            device=gdev)
    noise = to_tensor(noise, dtype, device)
    if tuple(noise.shape) != tuple(shape):
        raise ValueError(f"noise has shape {tuple(noise.shape)}, expected "
                         f"{tuple(shape)}")
    return noise


def _rollout_fields(cfg, init, params, s_hist, u_future, noise=None):
    """SI-alpha rollouts of G schedules from the end-of-history state
    (Tools/SIalpha_Controlled.m semantics, batched over schedules and
    regions; one launch of the rollout kernel on a card, ops/cuda/
    rollout_kernel.py), each joined to the history. s_hist: (R, T_hist, 3)
    historic states; u_future: (G, R, H, P); noise: (R, H, 3)
    standard-normal draws, shared by the G rollouts and scaled by the
    per-region noise stds (cfg.stochastic_forecast), or None for the
    deterministic rollout. Returns the fields s, i, alpha as one
    (3, G, R, T_hist + H) tensor."""
    G, R, H, _ = u_future.shape
    T_hist = s_hist.shape[1]
    fields = s_hist.new_empty((3, G, R, T_hist + H))
    fields[..., :T_hist] = s_hist.permute(2, 0, 1)[:, None]
    rollout_kernel.rollout(
        s_hist[:, -1, :], _rollout_params(cfg, init, params), u_future,
        None if noise is None else noise.expand(G, R, H, 3),
        out=tuple(fields[k, ..., T_hist:] for k in range(3)))
    return fields


def forecast_scenarios(batch_full, trained: TrainedRegionParams,
                       init: RegionInit, npi_weights, npi_mins, npi_maxes,
                       T_hist: int, cfg: PipelineConfig = PipelineConfig(),
                       actual_npis=None, dtype=None, device=None,
                       generator: Optional[torch.Generator] = None,
                       noise=None, mesh=None):
    """Fixed / zero / max (+ optional actual) NPI forecast scenarios
    (TrainPredictPrescribeNPI.m:367-412).

    batch_full: RegionBatch over T_full = T_hist + horizon with NaN
    observations in the horizon. With cfg.stochastic_forecast the three
    rollouts share one (R, H, 3) noise draw, as the JAX package's share one
    key: ``noise``, or drawn from ``generator`` (see forecast_noise).
    mesh: see the module docstring. Returns (dict of ScenarioResult, the
    historic smoothed states s_hist (R, T_hist, 3))."""
    check_config(cfg)
    batch_full, fd, dev = device_batch(batch_full, dtype,
                                       mesh_device(mesh, device))
    obs, npis = batch_full.observations, batch_full.npis
    R, T_full = obs.shape
    P = npis.shape[-1]
    H = T_full - T_hist
    params = stage_params(cfg, batch_full, trained, npi_mins, npi_maxes,
                           fd, dev)
    R_v = batch_full.obs_noise_var
    w = _region_weights(npi_weights, R, P, fd, dev)[:, None, :]
    t = lambda a: to_tensor(a, fd, dev)

    ip_hist = npis[:, :T_hist, :]
    hold = lambda level: torch.cat(
        [ip_hist[:, :-1, :], level.expand(R, H + 1, P)], dim=1)
    # the fixed, zero and max schedules, (3, R, T_full, P)
    u_sc = torch.stack([hold(ip_hist[:, -1:, :]),
                        hold(t(npi_mins)[None, None, :]),
                        hold(t(npi_maxes)[None, None, :])])

    # A) the fixed-input scenario first: its smoothed states are the shared
    # historic trajectory of every rollout (:380-382,398,408,481)
    s_hist = _run_ekf3(cfg, u_sc[0], obs, params, R_v, init, mesh).s_smooth[
        :, :T_hist, :]
    noise = forecast_noise(cfg, (R, H, 3), fd, dev, generator, noise)
    # the three rollouts share s_hist's last state and the noise: one call
    f = _rollout_fields(cfg, init, params, s_hist, u_sc[:, :, T_hist:],
                        noise)
    out = {}
    for g, name in enumerate(("fixed", "zero", "max")):
        s, i, al = f[0, g], f[1, g], f[2, g]
        J0, J1 = npi_cost(s * i * al, u_sc[g], w)
        out[name] = ScenarioResult(s, i, al, u_sc[g], J0, J1)
    if actual_npis is not None:
        # Z) the actual NPIs (:367-370): their own EKS trajectory, no rollout
        u_act = to_tensor(actual_npis, fd, dev)
        ssm = _run_ekf3(cfg, u_act, obs, params, R_v, init, mesh).s_smooth
        s, i, al = ssm[..., 0], ssm[..., 1], ssm[..., 2]
        J0, J1 = npi_cost(s * i * al, u_act, w)
        out["actual"] = ScenarioResult(s, i, al, u_act, J0, J1)
    return out, s_hist


def pareto_prep(cfg, batch_full, trained, init, npi_weights, npi_mins,
                 npi_maxes, T_hist, dtype, device):
    """The 6-state augmentation, terminal conditions and NaN future inputs
    of the sweep (TrainPredictPrescribeNPI.m:425-458)."""
    obs, npis = batch_full.observations, batch_full.npis
    R, T_full = obs.shape
    P = npis.shape[-1]
    H = T_full - T_hist
    kw = dict(dtype=dtype, device=device)
    params = stage_params(cfg, batch_full, trained, npi_mins, npi_maxes,
                           dtype, device)
    w_rp = _region_weights(npi_weights, R, P, dtype, device)
    params["w"] = w_rp

    q2 = cfg.dt ** 2 * cfg.q_lambda ** 2
    QQ = torch.zeros((R, 6, 6), **kw)
    QQ[:, :3, :3] = init.Q.to(dtype)
    PPs = torch.zeros((R, 6, 6), **kw)
    PPs[:, :3, :3] = init.Ps_init.to(dtype)
    for k in (3, 4, 5):
        QQ[:, k, k] = q2
        PPs[:, k, k] = 10.0 * q2
    ss_init = torch.cat([init.s_init.to(dtype),
                         torch.full((R, 3), cfg.lambda0, **kw)], dim=1)
    # terminal conditions: zero costates with a tiny covariance, the state
    # block unconstrained (finial_conditions_setup == 1, :444-453)
    nan = float("nan")
    s_final = torch.tensor([nan, nan, nan, 0.0, 0.0, 0.0], **kw).expand(R, 6)
    Pf = torch.zeros((6, 6), **kw)
    Pf[:3, :3] = nan
    Pf[3, 3] = Pf[4, 4] = Pf[5, 5] = 1e-8
    Ps_final = Pf.expand(R, 6, 6)
    # inputs: historic NPIs, then NaN = optimal control requested (:458)
    u_in = torch.cat([npis[:, :T_hist, :],
                      torch.full((R, H, P), nan, **kw)], dim=1)
    return dict(u_in=u_in, obs=obs, R_v=batch_full.obs_noise_var,
                params=params, QQ=QQ, PPs=PPs, ss_init=ss_init,
                s_final=s_final, Ps_final=Ps_final, w_rp=w_rp,
                rollout=_rollout_params(cfg, init, params))


def _tile_lanes(arr, Ec):
    """Region-major (R, ...) -> batch-last (..., Ec * R), repeated for each
    of Ec epsilons, epsilon-major (lane = e * R + r)."""
    R = arr.shape[0]
    a = torch.movedim(arr, 0, -1)
    a = a[..., None, :].expand(a.shape[:-1] + (Ec, R))
    return a.reshape(a.shape[:-2] + (Ec * R,))


def sweep_lane_inputs(prep, eps_chunk):
    """Tile the sweep inputs of ``pareto_prep`` over Ec * R lanes with
    epsilon = eps_chunk[e] on lanes e * R + r: dict of batch-last u, x, Rv,
    params, s_init, Ps_init, s_final, Ps_final, Q and the weights w."""
    R = prep["obs"].shape[0]
    Ec = eps_chunk.shape[0]
    rp = {k: _tile_lanes(v, Ec) for k, v in prep["params"].items()}
    rp["epsilon"] = eps_chunk[:, None].expand(Ec, R).reshape(Ec * R)
    names = dict(u="u_in", x="obs", Rv="R_v", s_init="ss_init",
                 Ps_init="PPs", s_final="s_final", Ps_final="Ps_final",
                 Q="QQ", w="w_rp")
    out = {k: _tile_lanes(prep[v], Ec) for k, v in names.items()}
    out["params"] = rp
    return out


def sweep_eks_vmap(cfg, lanes, outputs="light"):
    """The 6-state optimal-control EKS of a sweep chunk on the generic core
    (epidemicmodeling_tpu/pipelines/core.py:533-569): the batch-last lanes
    of sweep_lane_inputs as one batch of Bl filters. Returns its EKFResult
    (lanes first)."""
    first = lambda a: torch.movedim(a, -1, 0)
    return ekf_smoother(
        si_alpha_costate_ekf_system(cfg.observation_type), first(lanes["u"]),
        lanes["x"].T, {k: first(v) for k, v in lanes["params"].items()},
        lanes["s_init"].T, first(lanes["Ps_init"]),
        lanes["s_final"].T, first(lanes["Ps_final"]),
        Q=first(lanes["Q"]), R=lanes["Rv"].T, beta=cfg.beta_ekf,
        gamma_discount=cfg.gamma_ekf, inv_monitor_len=cfg.inv_monitor_len,
        order=cfg.order, smoother_gain=cfg.smoother_gain, outputs=outputs)


def _sweep_chunk_body(eps_chunk, prep, s0, hist_cases, *, cfg, T_hist, Ec,
                      noise=None, mesh=None, out=None):
    """One epsilon chunk of the Pareto sweep on Ec * R lanes (epsilon-major,
    lane = e * R + r): the 6-state EKS with NaN future inputs (the ekf6
    kernel, or on "vmap" the generic core, sweep_eks_vmap), the rollout of
    the prescribed schedule from the end-of-history state s0 (R, 3) (one
    rollout_kernel call), and the costs. J0 averages s i alpha over the
    history, the regions' sums hist_cases (R,), and the rolled-out horizon.
    J1 averages w * u over ALL rows of the smoothed schedule: the history,
    the prescription, and the smoother's zero last row (core.py:690).
    noise: (Ec, R, H, 3) standard-normal draws of the rollout, one (R, H, 3)
    draw an epsilon as the JAX package's keys give them, or None for the
    deterministic rollout. mesh: the EKS lanes split over its slots,
    epsilon-major ("ep", "dp"), the rest on the lead slot. out: None, or
    the (Ec, R, H) s, i, alpha tensors the rollout's trajectory is written
    into.
    Spans (utils.profiling): ``pareto.ekf6`` (the EKS), ``pareto.rollout``
    and ``pareto.score``; on "lanes"/"pallas" the recording's counter
    ``ekf6.costate_nonfinite`` gets the smoothed costates that are not
    finite, over every lane the EKS runs (reduced on the device, read when
    the recording closes).
    Returns (J0, J1 (Ec, R), u_prescribed (Ec, R, H, P))."""
    obs = prep["obs"]
    fdtype = obs.dtype
    R, T_full = obs.shape
    P = prep["u_in"].shape[-1]
    H = T_full - T_hist
    lanes = sweep_lane_inputs(prep, eps_chunk)
    rp = lanes["params"]

    with span("pareto.ekf6"):
        if cfg.backend == "vmap":
            keys = ["u", "x", "Rv", "s_init", "Ps_init", "s_final",
                    "Ps_final", "Q"]
            names = list(rp)

            def run(*a):
                part = dict(zip(keys, a),
                            params=dict(zip(names, a[len(keys):])))
                return (sweep_eks_vmap(cfg, part).u_opt_smooth.permute(
                    1, 2, 0),)

            u_sm, = map_lanes(run, mesh, [lanes[k] for k in keys]
                              + [rp[k] for k in names], ("ep", "dp"), 1)
        else:
            # the kernel (its plain version on the CPU) in the caller's
            # dtype: float32 or float64 on a card, any other raises
            def run(*a):
                s_sm, u_sm, _ = ekf6_kernel.ekf6(
                    *a, gamma_discount=cfg.gamma_ekf,
                    obs_type=cfg.observation_type)
                count_on_close(("ekf6.costate_nonfinite",), lambda: (
                    ~torch.isfinite(s_sm[:, 3:])).sum().reshape(1, 1))
                return (u_sm,)

            u_sm, = map_lanes(run, mesh,
                              ekf6_kernel.pack_ekf6_args(lanes, fdtype),
                              ("ep", "dp"), 1)             # (T, P, Bl)

    # the prescription (H, P, Bl) seen as (Ec, R, H, P), no copy
    u_out = u_sm[T_hist:].reshape(H, P, Ec, R).permute(2, 3, 0, 1)
    with span("pareto.rollout"):
        fut_cases = rollout_kernel.rollout(s0, prep["rollout"], u_out, noise,
                                           out)
    with span("pareto.score"):
        J0 = (hist_cases[None, :] + fut_cases) / T_full
        J1 = torch.mean(lanes["w"][None] * u_sm,
                        dim=(0, 1)).reshape(Ec, R)
    return J0, J1, u_out


def pareto_prescribe(batch_full, trained: TrainedRegionParams,
                     init: RegionInit, s_hist, epsilon_values, npi_weights,
                     npi_mins, npi_maxes, T_hist: int,
                     cfg: PipelineConfig = PipelineConfig(), dtype=None,
                     device=None, generator: Optional[torch.Generator] = None,
                     noise=None, mesh=None):
    """The Pareto sweep (TrainPredictPrescribeNPI.m:414-494): for every
    epsilon, the 6-state optimal-control EKS with NaN future inputs and
    costate terminal conditions, the re-simulated prescribed schedule, and
    its (J0, J1). Epsilon is processed in chunks of ``cfg.pareto_chunk``
    (the last chunk padded with the last epsilon), each chunk a ``pareto.chunk`` span
    (utils.profiling; _sweep_chunk_body has the spans inside it). With
    cfg.stochastic_forecast each epsilon's rollout takes its own (R, H, 3)
    draw: ``noise`` (E, R, H, 3), else drawn chunk by chunk from
    ``generator``. mesh: see the module docstring (cfg.pareto_chunk must
    be a multiple of its ep axis). Returns a dict with J0/J1 (E, R), trajectories s/i/alpha
    (E, R, T_full) or None, prescriptions u_prescribed (E, R, H, P) and
    epsilon (E,)."""
    check_config(cfg)
    E = len(epsilon_values)
    if E == 0:
        raise ValueError("epsilon_values is empty — pass at least one "
                         "tradeoff point (control.epsilon_grid(n) builds "
                         "the reference's log+linear grid)")
    validate_pareto_chunk(cfg.pareto_chunk, mesh)
    batch_full, fd, dev = device_batch(batch_full, dtype,
                                       mesh_device(mesh, device))
    prep = pareto_prep(cfg, batch_full, trained, init, npi_weights,
                        npi_mins, npi_maxes, T_hist, fd, dev)
    s_hist = to_tensor(s_hist, fd, dev)
    eps = np.array(epsilon_values, dtype=float)
    chunk = cfg.pareto_chunk
    E_pad = -(-E // chunk) * chunk
    eps_padded = to_tensor(np.concatenate([eps, np.full(E_pad - E, eps[-1])]),
                           fd, dev)
    R, T_full = prep["obs"].shape
    P = prep["u_in"].shape[-1]
    H = T_full - T_hist
    if noise is not None:
        noise = forecast_noise(cfg, (E, R, H, 3), fd, dev, noise=noise)
        if noise is not None and E_pad > E:
            # the pad epsilons' rollouts are dropped: any draw will do
            noise = torch.cat([noise, noise.new_zeros((E_pad - E, R, H, 3))])
    # every chunk writes into buffers allocated once for all E_pad
    # epsilons; the stored trajectories take the history once and each
    # chunk's rollout writes its horizon straight into them
    J0, J1 = (s_hist.new_empty((E_pad, R)) for _ in range(2))
    u_presc = s_hist.new_empty((E_pad, R, H, P))
    traj = None
    if cfg.pareto_store_trajectories:
        traj = [s_hist.new_empty((E_pad, R, T_full)) for _ in range(3)]
        for k in range(3):
            traj[k][..., :T_hist] = s_hist[None, :, :, k]
    hist_cases = torch.sum(s_hist[..., 0] * s_hist[..., 1] * s_hist[..., 2],
                           dim=-1)
    for c0 in range(0, E_pad, chunk):
        c = slice(c0, c0 + chunk)
        with span("pareto.chunk"):
            J0[c], J1[c], u_presc[c] = _sweep_chunk_body(
                eps_padded[c], prep, s_hist[:, -1, :], hist_cases, cfg=cfg,
                T_hist=T_hist, Ec=chunk, mesh=mesh,
                noise=(noise[c] if noise is not None else
                       forecast_noise(cfg, (chunk, R, H, 3), fd, dev,
                                      generator)),
                out=(None if traj is None
                     else tuple(f[c, :, T_hist:] for f in traj)))
    s, i, al = (None,) * 3 if traj is None else (f[:E] for f in traj)
    return {"J0": J0[:E], "J1": J1[:E], "s": s, "i": i, "alpha": al,
            "u_prescribed": u_presc[:E], "epsilon": to_tensor(eps, fd, dev)}


def monte_carlo_baseline(batch_full, trained: TrainedRegionParams,
                         init: RegionInit, s_hist, npi_weights, npi_mins,
                         npi_maxes, T_hist: int,
                         cfg: PipelineConfig = PipelineConfig(),
                         generator: Optional[torch.Generator] = None,
                         dtype=None, device=None, u_random=None, noise=None):
    """cfg.num_monte_carlo random-NPI rollouts per region
    (TrainPredictPrescribeNPI.m:496-522): half constant over time, half
    redrawn daily, each scored with npi_cost over [historic NPIs, random
    future]. The N scenarios x R regions run as one (N, R) batch through one
    rollout loop.

    u_random: optional (N, H, P) schedules to score (e.g. the JAX package's,
    for parity); drawn from ``generator`` when None. noise: with
    cfg.stochastic_forecast, the (N, R, H, 3) draws of the rollouts (one
    (R, H, 3) draw a scenario, as the JAX package's keys give them); drawn
    from ``generator`` after the schedules when None. Returns dict J0, J1
    (N, R) and u_random."""
    check_config(cfg)
    batch_full, fd, dev = device_batch(batch_full, dtype, device)
    npis = batch_full.npis
    R, T_full, P = npis.shape
    H = T_full - T_hist
    N = cfg.num_monte_carlo
    if u_random is None:
        u_random = random_npi_schedules(generator, N, npi_mins, npi_maxes, H,
                                        dtype=fd, device=dev)
    u_random = to_tensor(u_random, fd, dev)
    if tuple(u_random.shape) != (N, H, P):
        raise ValueError(f"u_random has shape {tuple(u_random.shape)}, "
                         f"expected (N, H, P) = ({N}, {H}, {P})")
    s_hist = to_tensor(s_hist, fd, dev)
    params = stage_params(cfg, batch_full, trained, npi_mins, npi_maxes,
                           fd, dev)
    p = _rollout_params(cfg, init, params)
    w = _region_weights(npi_weights, R, P, fd, dev)

    noise = forecast_noise(cfg, (N, R, H, 3), fd, dev, generator, noise)
    # one rollout call, lane = n * R + r, the schedules read at stride 0
    # over the regions; only each lane's horizon sum is kept
    fut_cases = rollout_kernel.rollout(
        s_hist[:, -1, :], p, u_random[:, None].expand(N, R, H, P), noise)
    hist_cases = torch.sum(s_hist[..., 0] * s_hist[..., 1] * s_hist[..., 2],
                           dim=-1)
    J0 = (hist_cases[None, :] + fut_cases) / T_full
    hist_w = torch.sum(w[:, None, :] * npis[:, :T_hist, :], dim=(1, 2))
    fut_w = torch.einsum("nhp,rp->nr", u_random, w)
    J1 = (hist_w[None, :] + fut_w) / (T_full * P)
    return {"J0": J0, "J1": J1, "u_random": u_random}


def scenario_from_schedule(batch_full, trained: TrainedRegionParams,
                           init: RegionInit, s_hist, u_future, npi_weights,
                           npi_mins, npi_maxes, T_hist: int,
                           cfg: PipelineConfig = PipelineConfig(),
                           generator: Optional[torch.Generator] = None,
                           dtype=None, device=None,
                           noise=None) -> ScenarioResult:
    """Forecast under an externally supplied NPI plan (the XPRIZE
    ``future_ip.csv`` semantics: new cases conditioned on a given future
    intervention schedule; see data.read_future_ip), rolled out from the
    end of the historic states (core.py:941-984).

    u_future: (R, H, P) plan over the forecast horizon. noise: the
    (R, H, 3) draws with cfg.stochastic_forecast (see forecast_noise)."""
    batch_full, fd, dev = device_batch(batch_full, dtype, device)
    npis = batch_full.npis
    R, T_full, P = npis.shape
    u_future = to_tensor(u_future, fd, dev)
    s_hist = to_tensor(s_hist, fd, dev)
    params = stage_params(cfg, batch_full, trained, npi_mins, npi_maxes, fd,
                          dev)
    noise = forecast_noise(cfg, tuple(u_future.shape[:2]) + (3,), fd, dev,
                           generator, noise)
    f = _rollout_fields(cfg, init, params, s_hist, u_future[None], noise)
    s, i, al = f[0, 0], f[1, 0], f[2, 0]
    u_full = torch.cat([npis[:, :T_hist, :], u_future], dim=1)
    w = _region_weights(npi_weights, R, P, fd, dev)[:, None, :]
    J0, J1 = npi_cost(s * i * al, u_full, w)
    return ScenarioResult(s, i, al, u_full, J0, J1)
