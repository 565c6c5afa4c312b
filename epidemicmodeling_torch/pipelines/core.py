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
core, ops/ekf_bl.py) for CPU tensors. The device is the one the batch
tensors live on (see device_batch).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..control import npi_cost, random_npi_schedules
from ..models.batch_last import _dot_p
from ..models.si_alpha import si_alpha_step_fields
from ..ops.cuda import ekf6_kernel
from ..ops.cuda.ekf3_kernel import ekf3_lanes, rho_from_priors
from ..regression import nnls_with_intercept
from ..utils.math import clip_lo_hi
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


def check_config(cfg: PipelineConfig) -> None:
    """Refuse what this port does not run yet, before any work is done."""
    if cfg.backend == "vmap":
        raise NotImplementedError(
            "backend='vmap' (the generic EKF core, epidemicmodeling_tpu/ops/"
            "ekf.py) is not ported yet (ROADMAP A11); use 'lanes' or "
            "'pallas'")
    if cfg.backend not in ("lanes", "pallas"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    if cfg.order != 1:
        raise NotImplementedError("order != 1 needs the generic EKF core "
                                  "(ROADMAP A11)")
    if cfg.observation_type not in ("NEWCASES", "TOTALCASES"):
        raise ValueError(
            f"unknown observation type {cfg.observation_type!r}")
    if cfg.stochastic_forecast:
        raise NotImplementedError("stochastic_forecast=True is not ported "
                                  "yet (ROADMAP Queue A)")
    if cfg.pareto_chunk < 1:
        raise ValueError(f"pareto_chunk={cfg.pareto_chunk} must be >= 1")


def device_batch(batch, dtype=None, device=None):
    """Move a RegionBatch's hot fields (observations, npis, obs_noise_var)
    to ``device`` in ``dtype``. The fields that host logic reads
    (new_cases_norm, population) stay NumPy. Defaults: the device and dtype
    the batch's observations already have, else the CPU and torch's default
    dtype. Returns (batch, dtype, device)."""
    obs = batch.observations
    if device is None:
        device = obs.device if isinstance(obs, torch.Tensor) else "cpu"
    if dtype is None:
        dtype = (obs.dtype if isinstance(obs, torch.Tensor)
                 else torch.get_default_dtype())
    device = torch.device(device)
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


def _run_ekf3(cfg, u, obs, params, R_v, init) -> EKF3Result:
    """3-state EKF/EKS over all regions: u (R, T, P), obs and R_v (R, T).
    The CUDA kernel on a card (its plain version on the CPU); rho from the
    stored priors."""
    u_bl, x_bl, Rv_bl, params_bl, Q_bl, s0_bl, Ps0_bl = ekf3_lane_inputs(
        u, obs, params, R_v, init)
    ssm, _, sm = ekf3_lanes(
        u_bl, x_bl, Rv_bl, params_bl, Q_bl, s0_bl, Ps0_bl,
        gamma_discount=cfg.gamma_ekf, obs_type=cfg.observation_type)
    rho = rho_from_priors(sm, x_bl, Rv_bl, cfg.inv_monitor_len,
                          obs_type=cfg.observation_type)
    return EKF3Result(torch.movedim(ssm, -1, 0), rho.T)


def _regress(cfg: PipelineConfig, x_data, y_data):
    """Batched regression: x_data (R, n, P), y_data (R, n) ->
    (a (R, P), b (R,))."""
    if cfg.regression_type == "NONNEGATIVELS":
        return nnls_with_intercept(x_data, y_data,
                                   iterations=cfg.nonneg_iterations)
    raise NotImplementedError(
        f"regression_type={cfg.regression_type!r} is not ported yet "
        "(ROADMAP A13); use 'NONNEGATIVELS'")


def train_regions(batch, npi_mins, npi_maxes, num_regression_days,
                  cfg: PipelineConfig = PipelineConfig(), dtype=None,
                  device=None) -> TrainOutputs:
    """Two-round EKF + regression training over all regions at once
    (TrainPredictPrescribeNPI.m:199-354). batch: RegionBatch over the
    TRAINING window (no forecast horizon)."""
    check_config(cfg)
    batch, fd, dev = device_batch(batch, dtype, device)
    init = region_init(batch, cfg, fd, dev)
    obs, npis = batch.observations, batch.npis
    R, T = obs.shape
    nrd = int(num_regression_days)
    params = stage_params(cfg, batch, None, npi_mins, npi_maxes, fd, dev)
    R_v = batch.obs_noise_var

    # ROUND 1: zero control input, zero NPI influence (:199-248)
    res1 = _run_ekf3(cfg, torch.zeros_like(npis), obs, params, R_v, init)

    # regression 1: alpha ~ (NPI_MAX - NPI) over the last regression window
    maxes = to_tensor(npi_maxes, fd, dev)
    x_win = (maxes[None, None, :] - npis)[:, T - nrd:, :]
    a1, b1 = _regress(cfg, x_win, res1.s_smooth[:, T - nrd:, 2])

    # ROUND 2: historic NPIs + learned influence (:295-307)
    res2 = _run_ekf3(cfg, npis, obs, dict(params, a=a1, b=b1), R_v, init)
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


def _rollout_from(cfg, init, params, s0, u_future):
    """Deterministic SI-alpha rollout from the end-of-history state
    (Tools/SIalpha_Controlled.m semantics, batched over regions).
    s0: (R, 3); u_future: (R, H, P). Returns (R, H, 3), the initial
    condition excluded."""
    R, H, _ = u_future.shape
    p = _rollout_params(cfg, init, params)
    zero = torch.zeros_like(s0[:, 0])
    s, i, al = s0[:, 0], s0[:, 1], s0[:, 2]
    out = []
    for t in range(H):
        s, i, al = si_alpha_step_fields(s, i, al, u_future[:, t], zero,
                                        zero, zero, p)
        out.append(torch.stack([s, i, al], dim=-1))
    if not out:
        return s0.new_zeros((R, 0, 3))
    return torch.stack(out, dim=1)


def forecast_scenarios(batch_full, trained: TrainedRegionParams,
                       init: RegionInit, npi_weights, npi_mins, npi_maxes,
                       T_hist: int, cfg: PipelineConfig = PipelineConfig(),
                       actual_npis=None, dtype=None, device=None):
    """Fixed / zero / max (+ optional actual) NPI forecast scenarios
    (TrainPredictPrescribeNPI.m:367-412).

    batch_full: RegionBatch over T_full = T_hist + horizon with NaN
    observations in the horizon. Returns (dict of ScenarioResult, the
    historic smoothed states s_hist (R, T_hist, 3))."""
    check_config(cfg)
    batch_full, fd, dev = device_batch(batch_full, dtype, device)
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
    u_fixed = hold(ip_hist[:, -1:, :])
    u_zero = hold(t(npi_mins)[None, None, :])
    u_max_sched = hold(t(npi_maxes)[None, None, :])

    # A) the fixed-input scenario first: its smoothed states are the shared
    # historic trajectory of every rollout (:380-382,398,408,481)
    s_hist = _run_ekf3(cfg, u_fixed, obs, params, R_v, init).s_smooth[
        :, :T_hist, :]

    def scenario(u_full):
        traj = _rollout_from(cfg, init, params, s_hist[:, -1, :],
                             u_full[:, T_hist:, :])
        s, i, al = (torch.cat([s_hist[..., k], traj[..., k]], dim=1)
                    for k in range(3))
        J0, J1 = npi_cost(s * i * al, u_full, w)
        return ScenarioResult(s, i, al, u_full, J0, J1)

    out = {"fixed": scenario(u_fixed), "zero": scenario(u_zero),
           "max": scenario(u_max_sched)}
    if actual_npis is not None:
        # Z) the actual NPIs (:367-370): their own EKS trajectory, no rollout
        u_act = to_tensor(actual_npis, fd, dev)
        ssm = _run_ekf3(cfg, u_act, obs, params, R_v, init).s_smooth
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
                s_final=s_final, Ps_final=Ps_final, w_rp=w_rp)


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


def _sweep_chunk_lanes_body(eps_chunk, prep, s_hist, *, cfg, T_hist, Ec):
    """One epsilon chunk of the Pareto sweep on Ec * R lanes (epsilon-major,
    lane = e * R + r): the 6-state EKS with NaN future inputs, the rollout of
    the prescribed schedule from the end-of-history state, and the costs.
    J1 averages w * u over ALL rows of the smoothed schedule: the history,
    the prescription, and the smoother's zero last row (core.py:690).
    Returns (J0, J1 (Ec, R), s, i, alpha (Ec, R, T) or None,
    u_prescribed (Ec, R, H, P))."""
    obs = prep["obs"]
    fdtype = obs.dtype
    R, T_full = obs.shape
    P = prep["u_in"].shape[-1]
    H = T_full - T_hist
    lanes = sweep_lane_inputs(prep, eps_chunk)
    rp = lanes["params"]

    # the kernel runs float32 on a card; its plain version runs the
    # caller's dtype on the CPU
    kdt = torch.float32 if obs.is_cuda else fdtype
    _, u_sm, _ = ekf6_kernel.ekf6(
        *ekf6_kernel.pack_ekf6_args(lanes, kdt),
        gamma_discount=cfg.gamma_ekf, obs_type=cfg.observation_type)
    u_sm = u_sm.to(fdtype)                                # (T, P, Bl)

    u_presc_bl = u_sm[T_hist:]                            # (H, P, Bl)
    s_hist_bl = _tile_lanes(s_hist, Ec)                   # (T_hist, 3, Bl)
    sv = s_hist_bl[-1]
    dt = rp["dt"]
    traj = []
    for t in range(H):
        s_, i_, al_ = sv[0], sv[1], sv[2]
        s1 = clip_lo_hi(s_ - dt * (al_ * s_ * i_), 0.0, 1.0)
        i1 = clip_lo_hi(i_ + dt * (al_ * s_ * i_ - rp["beta"] * i_),
                        0.0, 1.0)
        drive = (-rp["gamma"] * al_ + rp["gamma"] * rp["b"]
                 + rp["gamma"] * _dot_p(rp["a"], rp["u_max"] - u_presc_bl[t]))
        a1 = clip_lo_hi(al_ + dt * drive, rp["alpha_min"], rp["alpha_max"])
        sv = torch.stack([s1, i1, a1])
        traj.append(sv)
    full_states = (torch.cat([s_hist_bl, torch.stack(traj)], dim=0)
                   if traj else s_hist_bl)                # (T, 3, Bl)
    cases = full_states[:, 0] * full_states[:, 1] * full_states[:, 2]
    J0 = torch.mean(cases, dim=0).reshape(Ec, R)
    J1 = torch.mean(lanes["w"][None] * u_sm,
                    dim=(0, 1)).reshape(Ec, R)
    u_out = u_presc_bl.reshape(H, P, Ec, R).permute(2, 3, 0, 1)
    if not cfg.pareto_store_trajectories:
        return J0, J1, None, None, None, u_out
    unb = lambda a: torch.movedim(a.reshape(a.shape[:-1] + (Ec, R)),
                                  (-2, -1), (0, 1))
    return (J0, J1, unb(full_states[:, 0]), unb(full_states[:, 1]),
            unb(full_states[:, 2]), u_out)


def pareto_prescribe(batch_full, trained: TrainedRegionParams,
                     init: RegionInit, s_hist, epsilon_values, npi_weights,
                     npi_mins, npi_maxes, T_hist: int,
                     cfg: PipelineConfig = PipelineConfig(), dtype=None,
                     device=None):
    """The Pareto sweep (TrainPredictPrescribeNPI.m:414-494): for every
    epsilon, the 6-state optimal-control EKS with NaN future inputs and
    costate terminal conditions, the re-simulated prescribed schedule, and
    its (J0, J1). Epsilon is processed in chunks of ``cfg.pareto_chunk``
    (the last chunk padded with the last epsilon). Returns a dict with J0/J1
    (E, R), trajectories s/i/alpha (E, R, T_full) or None, prescriptions
    u_prescribed (E, R, H, P) and epsilon (E,)."""
    check_config(cfg)
    E = len(epsilon_values)
    if E == 0:
        raise ValueError("epsilon_values is empty — pass at least one "
                         "tradeoff point (control.epsilon_grid(n) builds "
                         "the reference's log+linear grid)")
    batch_full, fd, dev = device_batch(batch_full, dtype, device)
    prep = pareto_prep(cfg, batch_full, trained, init, npi_weights,
                        npi_mins, npi_maxes, T_hist, fd, dev)
    s_hist = to_tensor(s_hist, fd, dev)
    eps = np.array(epsilon_values, dtype=float)
    chunk = cfg.pareto_chunk
    E_pad = -(-E // chunk) * chunk
    eps_padded = to_tensor(np.concatenate([eps, np.full(E_pad - E, eps[-1])]),
                           fd, dev)
    outs = [_sweep_chunk_lanes_body(eps_padded[c0:c0 + chunk], prep, s_hist,
                                    cfg=cfg, T_hist=T_hist, Ec=chunk)
            for c0 in range(0, E_pad, chunk)]
    cat = lambda idx: (None if outs[0][idx] is None else
                       torch.cat([o[idx] for o in outs], dim=0)[:E])
    return {"J0": cat(0), "J1": cat(1), "s": cat(2), "i": cat(3),
            "alpha": cat(4), "u_prescribed": cat(5),
            "epsilon": to_tensor(eps, fd, dev)}


def monte_carlo_baseline(batch_full, trained: TrainedRegionParams,
                         init: RegionInit, s_hist, npi_weights, npi_mins,
                         npi_maxes, T_hist: int,
                         cfg: PipelineConfig = PipelineConfig(),
                         generator: Optional[torch.Generator] = None,
                         dtype=None, device=None, u_random=None):
    """cfg.num_monte_carlo random-NPI rollouts per region
    (TrainPredictPrescribeNPI.m:496-522): half constant over time, half
    redrawn daily, each scored with npi_cost over [historic NPIs, random
    future]. The N scenarios x R regions run as one (N, R) batch through one
    rollout loop.

    u_random: optional (N, H, P) schedules to score (e.g. the JAX package's,
    for parity); drawn from ``generator`` when None. Returns dict J0, J1
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

    zero = torch.zeros((N, R), dtype=fd, device=dev)
    s, i, al = (s_hist[:, -1, k].expand(N, R) for k in range(3))
    fut_cases = torch.zeros((N, R), dtype=fd, device=dev)
    for t in range(H):
        s, i, al = si_alpha_step_fields(s, i, al, u_random[:, t, None, :],
                                        zero, zero, zero, p)
        fut_cases = fut_cases + s * i * al
    hist_cases = torch.sum(s_hist[..., 0] * s_hist[..., 1] * s_hist[..., 2],
                           dim=-1)
    J0 = (hist_cases[None, :] + fut_cases) / T_full
    hist_w = torch.sum(w[:, None, :] * npis[:, :T_hist, :], dim=(1, 2))
    fut_w = torch.einsum("nhp,rp->nr", u_random, w)
    J1 = (hist_w[None, :] + fut_w) / (T_full * P)
    return {"J0": J0, "J1": J1, "u_random": u_random}
