"""Pipeline configuration.

All the knobs that appear as constants at the top of
Tools/TrainPredictPrescribeNPI.m:12-22 and the EKF settings at :224-237,
gathered into one dataclass. Field for field the same class as
epidemicmodeling_tpu.pipelines.config.PipelineConfig (a test pins the names
and defaults), so one configuration drives both packages.

The PyTorch port runs the batch-last path only, for "lanes" and "pallas"
alike: the device decides between the hand-written CUDA kernels (CUDA
tensors) and their plain versions (CPU tensors). "vmap" and
stochastic_forecast raise NotImplementedError (ROADMAP A11 and Queue A).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Every knob of the train-predict-prescribe pipeline (frozen, so it
    hashes). Defaults reproduce the reference driver
    (testScripts/testPrescribeXPRIZE02.m + TrainPredictPrescribeNPI.m)."""

    # data cleaning (TrainPredictPrescribeNPI.m:13-15)
    smoothing_win: int = 7
    min_cases: float = 1.0
    first_num_days_for_case_estimation: int = 7

    # SI-alpha model constants (:16-22, :212-231)
    model_gamma_param: float = 7.0          # contact influence time constant
    observation_type: str = "NEWCASES"      # or "TOTALCASES"
    num_days_for_beta_calculation: float = 21.0
    prob_contagion_after_Tdays: float = 0.01
    R0: float = 2.5
    dt: float = 1.0
    alpha_min: float = 1e-8
    alpha_max: float = 100.0
    sigma: float = 1e6                      # bang-bang Jacobian band slope

    # regression (:21-22)
    regression_type: str = "NONNEGATIVELS"  # LASSO | NONNEGATIVELS |
                                            # NONNEGATIVELS-ELEMENT-WISE
    nonneg_iterations: int = 100
    lasso_cv_folds: int = 50
    lasso_cv_shuffle_seed: int = -1         # >= 0 randomizes the CV fold
                                            # assignment like MATLAB's
                                            # cvpartition (lasso(...,'CV'));
                                            # -1 keeps the deterministic
                                            # interleaved (i mod K) folds

    # EKF settings (:224-237)
    beta_ekf: float = 1.0                   # adaptive-R blending (1 = off).
                                            # NOTE: the generic filter only
                                            # adapts a FIXED R prior
                                            # (GEKF.m:180); the pipeline's
                                            # R_v is per-day, so this toggle
                                            # is inert here in EVERY backend
                                            # (kept for GEKF API parity —
                                            # fixed-R callers of the cores/
                                            # kernels pass beta directly)
    gamma_ekf: float = 0.995                # gain stability discount
    inv_monitor_len: int = 21
    order: int = 1
    alpha_noise_std: float = 1e-2
    s_noise_factor: float = 10.0            # s_noise_std = factor*I0/N
    i_noise_factor: float = 30.0
    init_cov_factor: float = 10.0           # Ps_init stds = factor * noise std
    obs_noise_factor: float = 0.1           # R_v = factor * (smooth resid)^2

    # optimal control (:425-457)
    lambda0: float = 0.0
    q_lambda: float = 1e-4

    # Monte-Carlo baseline (:497)
    num_monte_carlo: int = 500

    # execution
    pareto_chunk: int = 32                  # epsilon values per device batch
    pareto_store_trajectories: bool = True  # False drops the (E, R, T) s/i/
                                            # alpha outputs (costs and
                                            # prescriptions only) — needed
                                            # for very large epsilon sweeps
                                            # that would exhaust HBM
    stochastic_forecast: bool = False       # inject rollout process noise
    smoother_gain: str = "pinv"             # "pinv" (MATLAB parity) |
                                            # "solve". Applies to the generic
                                            # "vmap" backend only: the
                                            # lanes/pallas paths ALWAYS use
                                            # the Cholesky solve gain
    backend: str = "vmap"                   # "vmap" (generic core; not
                                            # ported) | "lanes" | "pallas"
                                            # (both the batch-last path: the
                                            # CUDA kernels of ops/cuda/ on a
                                            # card; NEWCASES or TOTALCASES
                                            # observations, order=1 only)
    scan_unroll: int = 1                    # JAX lax.scan unroll; kept for
                                            # field parity, unused here

    @property
    def gamma_model(self) -> float:
        """Contact-rate relaxation rate (TrainPredictPrescribeNPI.m:212)."""
        return 1.0 / (self.dt * self.model_gamma_param)

    @property
    def beta_model(self) -> float:
        """Recovery rate from the contagion-probability horizon (:216-218)."""
        import math
        Tdays = self.num_days_for_beta_calculation * self.dt
        return -math.log(self.prob_contagion_after_Tdays) / Tdays

    @property
    def alpha0(self) -> float:
        """Initial contact rate from R0 (:219-221)."""
        import math
        return self.beta_model + math.log(self.R0) / self.dt
