"""The standalone NPI prescriptor: prescribe from trained parameters.

Counterpart of epidemicmodeling_tpu/pipelines/prescribe.py
(Tools/PrescribeNPI.m, the older standalone prescriptor, and
testScripts/testPrescribeXPRIZE01.m, prescription from a saved checkpoint
without retraining):
- AR(ar_order) forecasting of the contact rate alpha from its training tail
  (PrescribeNPI.m:202-214), then random-input Monte-Carlo scenarios scored
  with SI rollouts on the forecast alpha modulated by the NPI influence
  model (:222-256), the scenarios as one leading batch;
- finite-horizon optimal control with the pre-generic 6-state estimator
  (NewCaseEKFEstimatorWithOptimalNPI: the generic core with joseph=False,
  no symmetrization, the solve smoother gain and R adapted on every valid
  step, :265-287);
- the checkpoint sweep of testPrescribeXPRIZE01.m:160-198 (up to 2000
  epsilon values a region from saved (a, b) coefficients) and its
  Monte-Carlo baseline, through the pipeline's own stages, so on a CUDA
  device the sweep runs the ekf6 kernel.

Random draws come from a ``torch.Generator`` or are passed in (the JAX
package's jax.random draws, for parity).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..control import npi_cost
from ..control.pareto import npi_level_draws
from ..models import si_alpha_costate_ekf_system
from ..models.si_alpha import si_controlled_rollout
from ..ops.ar import ar_fit, ar_forecast
from ..ops.ekf import ekf_smoother
from ..utils.device import resolve_device
from ..utils.math import as_device_tensor, float_tensor
from .config import PipelineConfig
from .core import (RegionInit, TrainedRegionParams, monte_carlo_baseline,
                   pareto_prescribe)


def new_case_ekf_optimal_npi(u, x, params, s_init, Ps_init, s_final=None,
                             Ps_final=None, w_bar=None, v_bar=None, Q=1.0,
                             R=1.0, beta=1.0, gamma=1.0, inv_monitor_len=21,
                             order=1, obs_type="NEWCASES", device=None):
    """Tools/NewCaseEKFEstimatorWithOptimalNPI.m: the 6-state optimal-NPI
    EKF/EKS with the pre-generic numerics (no Joseph form, no covariance
    symmetrization, mrdivide smoother gain, R adapted on every valid step).
    One sequence, or a batch over the leading dimensions of ``s_init`` (see
    ops.ekf.ekf_smoother). Runs on ``device``, else where ``x`` (or
    ``s_init``, ``u``) lies when it is a tensor, else on the CUDA card.

    As in the JAX package, a partially-NaN Ps_final keeps the generic
    element-wise semantics (GEKF.m:198-202), not the MATLAB's rectangular
    cross-product write (NewCaseEKFEstimatorWithOptimalNPI.m:125-127); every
    active call site of the reference passes Ps_final = nan(6), where both
    readings are the same no-op."""
    return ekf_smoother(
        si_alpha_costate_ekf_system(obs_type), u, x, params, s_init, Ps_init,
        s_final, Ps_final, w_bar, v_bar, Q, R, beta=beta,
        gamma_discount=gamma, inv_monitor_len=inv_monitor_len, order=order,
        joseph=False, symmetrize_covs=False, smoother_gain="solve",
        adaptive_R_always=True, device=device)


class ARPrescriptionResult(NamedTuple):
    """AR-forecast prescription outputs (PrescribeNPI.m:202-256)."""
    alpha_forecast: torch.Tensor    # (H,) AR-forecast alpha
    J0_random: torch.Tensor         # (N_mc,) random-scenario human costs
    J1_random: torch.Tensor         # (N_mc,)
    s_scenarios: torch.Tensor       # (N_mc, T_hist_tail + H)
    i_scenarios: torch.Tensor


def ar_alpha_prescription(alpha_train, a_coef, b_coef, beta_model,
                          gamma_model, npi_mins, npi_maxes, npi_weights,
                          s0, i0, n_ahead: int, ar_order: int = 24,
                          ar_learning_history: int = 90,
                          n_monte_carlo: int = 10,
                          generator: Optional[torch.Generator] = None,
                          u_draw=None, ar_noise=None, device=None):
    """AR-forecast alpha and score random NPI scenarios with SI rollouts
    (PrescribeNPI.m:202-256).

    alpha_train: (T,) smoothed alpha from training. The AR model is fitted
    to its last ``ar_learning_history`` days and rolled ``n_ahead`` days
    with noise. For each scenario the future alpha is that forecast plus
    gamma (a'u + b), the whole series clipped at 0; the SI model then rolls
    (s, i) over it and the scenario is scored with npi_cost.

    The draws: ``ar_noise`` (n_ahead,) standard normals of the forecast
    and ``u_draw`` (n_monte_carlo, n_ahead, P) integer NPI levels (the JAX
    package's k_ar / k_mc draws, for parity); each one not given is drawn
    from ``generator``, the forecast's first (torch.Generator seeded 0 when
    None, as the JAX package takes PRNGKey(0)). The scenarios run as one
    leading batch. Runs on ``device``, else where ``alpha_train`` lies when
    it is a tensor, else on the CUDA card."""
    dev = resolve_device(device, alpha_train)
    alpha_train = float_tensor(alpha_train, dev).reshape(-1)
    fd = alpha_train.dtype
    f = lambda v: as_device_tensor(v, dev, fd)
    tail = alpha_train[-ar_learning_history:]
    a_ar, nv = ar_fit(tail, ar_order)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    y_pred = ar_forecast(tail, a_ar, nv, n_ahead, generator=generator,
                         noise=ar_noise)

    P = len(npi_maxes)
    if u_draw is None:
        u_draw = npi_level_draws(generator, (n_monte_carlo, n_ahead, P),
                                 npi_mins, npi_maxes)
    u_draw = as_device_tensor(u_draw, dev, fd)
    w_daywise = f(npi_weights)[None, :] * torch.ones(
        (ar_learning_history + n_ahead, P), dtype=fd, device=dev)

    alpha_mod = y_pred + gamma_model * (u_draw @ f(a_coef) + b_coef)
    alpha_full = torch.cat([tail.expand(u_draw.shape[0], -1), alpha_mod],
                           dim=-1)
    alpha_full = torch.clamp_min(alpha_full, 0.0)  # (:215 clip at zero)
    s, i = si_controlled_rollout(alpha_full, beta_model, s0, i0,
                                 alpha_full.shape[-1], 1.0)
    u_full = torch.cat([u_draw.new_zeros(u_draw.shape[0],
                                         ar_learning_history, P), u_draw],
                       dim=1)
    J0, J1 = npi_cost(s * i * alpha_full, u_full.transpose(-1, -2),
                      w_daywise.T)
    return ARPrescriptionResult(y_pred, J0, J1, s, i)


def prescribe_from_checkpoint(trained: TrainedRegionParams, batch_full,
                              s_hist, init: RegionInit, epsilon_values,
                              npi_weights, npi_mins, npi_maxes, T_hist,
                              cfg: PipelineConfig = PipelineConfig(),
                              generator: Optional[torch.Generator] = None,
                              dtype=None, device=None, u_random=None,
                              noise=None, mc_noise=None):
    """testPrescribeXPRIZE01-style prescription from saved parameters: the
    full epsilon sweep (core.pareto_prescribe) and the Monte-Carlo baseline
    (core.monte_carlo_baseline), no retraining. Returns (pareto dict,
    Monte-Carlo dict).

    ``generator`` serves both stages, the sweep first (as the JAX package
    hands its one key to both). u_random: the (N, H, P) Monte-Carlo
    schedules; noise / mc_noise: with cfg.stochastic_forecast, the sweep's
    (E, R, H, 3) and the baseline's (N, R, H, 3) rollout draws; each is
    drawn from ``generator`` when None. device / dtype as in
    core.pareto_prescribe (the CUDA card unless the batch's tensors lie
    elsewhere or device says otherwise)."""
    par = pareto_prescribe(batch_full, trained, init, s_hist, epsilon_values,
                           npi_weights, npi_mins, npi_maxes, T_hist, cfg,
                           dtype=dtype, device=device, generator=generator,
                           noise=noise)
    mc = monte_carlo_baseline(batch_full, trained, init, s_hist, npi_weights,
                              npi_mins, npi_maxes, T_hist, cfg,
                              generator=generator, dtype=dtype, device=device,
                              u_random=u_random, noise=mc_noise)
    return par, mc
