#!/usr/bin/env python3
"""Smoke run of the PyTorch port's slices on one NVIDIA GPU.

    python3 chip_smoke.py

Run it from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit (nvcc). In order, it:

1. finds the card (and fails without one);
2. builds the hand-written CUDA kernels from epidemicmodeling_torch/csrc/
   (one nvcc per source, all started together) and prints their ptxas
   register and spill lines;
3. holds each EKS kernel against its plain PyTorch version on the card,
   float32, at the shapes the XPRIZE path gives it, and times both with CUDA
   events. ekf3 runs on the pipeline's own inputs. ekf6 runs on three inputs
   of the sweep's shape (T = 532, B = 5,875): the pipeline's own sweep chunk,
   whose float32 costates overflow on this data (a check that the kernel
   runs, with its errors printed), and two per-capita inputs whose states
   and costates stay finite, one without and one with active control, both
   held at the bounds (the pipeline's chunk and the active case timed);
4. checks run_pipeline on a small input against the same call with the
   kernels swapped for their plain versions (same trained parameters, same
   Monte-Carlo schedules);
5. drives run_pipeline at the XPRIZE size (235 regions, 440 training days
   plus a 92-day horizon, 250 epsilons in chunks of 25, 500 Monte-Carlo
   schedules) cold then warm, counts the kernel launches of the warm run and
   checks its outputs (one ekf3 launch per ekf3 call); then the same
   request in float64, as the MATLAB reference computes it, cold then warm:
   the normal path launches the kernels' double instances (4 ekf3, 10
   ekf6 a request, the kernels line's f64_launches), every output float64
   and bang-bang, with the recording's count of non-finite smoothed
   costates; each double launch of the warm run is held on its own inputs
   against the plain version in float64 (F64_BOUND on the lanes the plain
   version's card and CPU runs agree on, and its spread elsewhere) and
   both are timed (the kernels line's f64 entries); then holds the NNLS
   kernel against its plain version on the round-2 regression of the
   xprize-backtest cell's training (235 x 380 x 12, float32), times both
   and logs the kernel's iteration totals and launches; then holds the
   SI-alpha rollout kernel (one launch a sweep chunk, one for the
   scenarios, one for the Monte Carlo: SI_ROLLOUT_CALLS a request, checked
   on the main path, the float64 path, the CLI and the mesh) against its
   plain version at a sweep chunk's shape, float64 and float32, and
   times both;
6. holds the diffusion-stencil kernel against its plain version (both
   schemes, four shapes up to 8191 x 8193) and times kernel, plain version
   and one conv2d as a yardstick; then holds the multi-step kernel (many
   steps a launch) against the one-step loop, bit for bit, and against the
   plain version, without and with dense sources, and its sparse
   injections against the plain version;
7. drives the spatial stack's three entry points on the card without
   device=: diffusion_rollout (2048 x 2048, 249 steps, both schemes,
   without and with dense sources, cold then warm from the example's NumPy
   field, then warm from the field on the card, ms per step beside the
   bound per step), walking_sources_sim (1024 x 1024, 64 walkers, 500
   steps) and population_motion_sim (20,000 agents in the default
   environment, 200 steps, cold then warm), each with its checks and launch
   counts (ceil(n / K) stencil launches a rollout, one a sim step);
8. holds the pairwise-force kernel against its plain version at N = 20,000
   (uniform positions and three frames of the sim's own trajectory) and times
   both, then times the kernel alone at N = 100,000 and holds 2,048 sampled
   rows against the plain law for those rows. Each agent's force is held on
   its own scale, the sum of the magnitudes of its terms (with slack for
   terms at the law's discontinuities, the optimal distance and the
   cutoff, where float32 rounding of a distance decides), and four mutants
   of the plain law (no cutoff, no attraction, no obstacles, obstacle
   weight off by 20%) must read above the same bound. Every case is
   launched twice, and the two results must agree bit for bit.

9. runs the card's roofline anchors (csrc/roofline.cu, the counterpart of
   bench.py's Pallas microkernels): a 1 GiB device-memory copy (x + 1, a
   persistent ring of TMA bulk copies) and a 512-deep FMA chain, held
   against their plain versions (the copy bit for bit, also at ragged
   sizes through its C entry), the copy timed in turns with PyTorch's
   x + 1, and prints the copy rate beside the 3.35 TB/s that bound()
   assumes;
10. drives the XPRIZE product's own CLI (xprize_cli.main, on the card,
   --backend pallas) on XPRIZE-size CSVs written by the port's pandas-free
   synthetic frame (235 regions x 532 days): 250 epsilons in chunks of 25,
   500 Monte-Carlo schedules, a checkpoint and a summary, cold then warm
   (the warm run's launches counted and its wall split into reading the
   CSVs, run_pipeline and writing the CSVs); checks the prescriptions (10 x
   235 x 92 rows of integer levels in [0, max]) and the predictions (finite,
   >= 0); reruns from the checkpoint (--load-params: the same prescriptions
   file, byte for byte) and with a future-IP plan (the predictions move);
11. runs the forecast-quality backtest at the paper's scale (235 regions x
   60 holdout starts x 60-day look-ahead at T = 440), cold then warm:
   exactly three ekf3 launches (two training rounds at T = 380, B = 235,
   then one at T = 440, B = 14,100, its step records in the device
   scratch), that launch's outputs held against ekf3's plain version at
   EKF3_BOUNDS with both timed, and the error curves finite where the truth
   is positive; prints the warm wall and the filter-days/s;
12. drives the generic EKF/EKS core (backend "vmap", the default, with the
   MATLAB-exact pinv smoother gain) and the LASSO and element-wise
   regressions: run_pipeline on a small input in float64 on the card
   against the CPU, once per regression type (prescriptions and fronts
   equal, the rest at rtol 1e-9); the pinv's knife-edge inputs on the card
   against the CPU, and its time over a sweep chunk's gains; run_pipeline
   at the XPRIZE size cold then warm (stage walls, no EKS kernel launch,
   device busy share, the main path's output checks), its train stage
   against the "pallas" backend's; the backtest on the core against the
   pallas backtest; the train stage with LASSO (50 folds) and with the
   element-wise fits, with LASSO's sweep count;
13. drives the standalone trainer and prescriptor and the modules around
   them: train_npi_prescriptor ("pallas") on the CLI phase's CSVs (235 x
   440), cold then warm, with its ekf3 launches (those train_regions makes
   inside run_pipeline), its mortality estimates and its .npz reloaded
   equal; prescribe_from_checkpoint from that checkpoint at the paper's
   scale (2000 epsilons x 235 regions x 532 days in chunks of 25: 80 ekf6
   launches; 500 Monte-Carlo schedules), cold then warm, with its sweep's
   filter-days/s and peak device memory, then on the XPRIZE run's own
   inputs (its outputs bit for bit) and with the kernels against their
   plain versions at 16 regions; new_case_ekf_optimal_npi (the pre-generic
   6-state EKS) card against CPU in float64 on per-capita inputs, and its
   float32 wall at 235 lanes; ar_alpha_prescription for all 235 regions,
   card against CPU in float64 from the same draws; the four Rt estimators
   and smooth_series's five filter types, card against CPU in float64;
   filter_health on the trained states; train_predict_prescribe on the
   realistic-artefact frame's CSVs, cold then warm, and the OxCGRT_latest
   form of that frame, whose batches equal the minimal file's bit for bit;
14. drives the theory studies and the ML stack on the card without
   device=, each against the same call on the CPU (no kernel runs here):
   the five SEIRP scenarios at dt = 0.1 (up to 40,000 steps), the
   saturated-resource comparison, the early-phase observability rank and
   eigenvalues (float64 at rtol 1e-9); the three shooting variants at
   tests/test_analysis.py's settings with the Hamiltonian certificates on
   the card's series; examples/lstm_forecast.py's 100-unit LSTM (250
   epochs, a 30-day closed-loop forecast); a (32, 16)-unit forecaster with
   each head trained 10 epochs on the card and on the CPU, at bounds that
   cuDNN's TF32 fails (PERF.md); test04's deep stack (hidden
   200, 200, 100, 50, 20, with and without the exp head) on 235 regions x
   440 days x 37 features, 10 timed epochs, its peak memory and its
   forward against the CPU's; the three SVR modes at n = 400, d = 12
   (2,000 steps), ridge and ARX on each of the 235 regions;
15. drives the device mesh (slice 7) with MESH_SLOTS = 5 slots on the one
   card (a mesh shows here the split, the per-slot kernel geometry, the
   gather, the rendezvous and bit parity, never scaling): the XPRIZE cell
   as dp x ep = 5 x 1 and 1 x 5, cold then warm, bit for bit against the
   single slot (J0, J1, u_prescribed, a2, the front, s_hist) with
   MESH_SLOTS times the single slot's ekf3 and ekf6 launches; the CLI with
   --mesh 5x1 --device cuda --cpu-devices 5 on the CLI phase's CSVs, its
   prescriptions file byte for byte the single-device CLI's; the backtest
   with dp = 5, bit for bit; the "vmap" backend at 16 regions on two slots
   (bit for bit, else graded by ROADMAP's pinv rule with what differed
   printed); run_multihost_dryrun with 2 processes x 2 slots, both on
   cuda:0 through Gloo, for "lanes" and "pallas" (J0 and a2 within 1e-9 of
   one process); parallel_kalman at T = 4096, m = 3 on the card against
   the CPU in float64 (PKF_TOL). Each wall is printed beside the single
   slot's with the card's name and power limit;
16. drives the native deployment artefact (slice 8, deploy/): the Pareto
   sweep of the 6-state optimal-NPI EKF/EKS for one region (the first
   lane of the per-capita case with active control, 2,000 epsilons
   log-spaced over [1e-8, 1e-2], T = 532, P = 12, float64, adaptive R)
   through newcase_ekf_pareto_sweep_native on the card (one launch of the
   hand-written kernel, csrc/newcase_ekf.cu), held against the CPU build
   (deploy/src/newcase_ekf.cpp: prescriptions equal, J0 and J1 at rtol
   1e-12, bit for bit expected) and against the plain version on the card
   (prescriptions equal, J0 and J1 at rtol 1e-9); the single-epsilon entry
   against the CPU build at beta_ekf 1 and 0.9; the kernel's geometry
   (lanes a block, blocks, and the SMs they ran on, which the kernel
   records: at least DEPLOY_MIN_SMS) and ptxas' registers, stack and
   spills; then the kernel's time (CUDA events around the device-pointer
   entry), the host-pointer entry's wall with its copies and its parts
   (allocation, copies in, kernel, copies out, free), the threaded CPU
   build's and the plain version's walls beside the float64 bound;
17. runs the example drivers (slice 9, epidemicmodeling_torch/examples/,
   the counterparts of examples/*.py) through their main functions, each
   in a temporary working directory, on the card (timed, its kernel
   launches counted: ekf3 and ekf6 for xprize_prescribe,
   prescribe_from_checkpoint, realistic_data_pipeline and make_figures,
   ekf3 for forecast_quality, stencil and pairwise for spatial_sims must
   launch) and again with device="cpu"
   from the same draws, printing each driver's lines as "example <name> |
   ..." and then its walls, launches and card-against-CPU readings: the
   pipeline drivers (float32) by their training (EXAMPLE_TRAIN_BOUND) and
   by each kernel on its own launches' inputs against the plain version
   (EXAMPLE_KERNEL_BOUNDS, each mutant read above a bound), the two runs'
   own flips, costs and fronts printed; the backtest's curves, the spatial
   fields bit for bit and the pairwise kernel on the agent sim's own
   positions (its trajectories' gap printed), the studies at
   SLICE5_TOL / SLICE6_TOL, the LSTMs' first EXAMPLE_LSTM_EPOCHS epochs at
   LSTM_RMS_TOL, ml_comparison's MAEs at EXAMPLE_ML_TOL (two sizes cut,
   EXAMPLE_CUTS); then xprize_prescribe's file branch at full width (235
   regions over its Phase-II window, CSVs under EXAMPLES_DIR) with its
   launches and output checks, and a "slice 9 (examples): ..." summary.

Every failed check raises, so the exit code is non-zero. Only when all
phases pass does it print the kernel JSON line, the card's name and power
limit, and, last, {"ok": true, "device": {...}}. The kernel line also
gives ekf6's time on the per-capita input with active control,
pairwise's at N = 100,000, ekf3's at the backtest's (T = 440, B = 14,100)
and each EKS kernel's launches on the CLI's and the backtest's warm runs,
ekf3's on train_npi_prescriptor's and ekf6's on prescribe_from_checkpoint's,
and every EKS, stencil, pairwise and roofline kernel's launches on the
5 x 1 mesh run (mesh_launches), all measured in the same run; newcase_ekf's
entry (not a TPU kernel) adds the CPU build's and the host entry's walls,
the host entry's parts, the geometry and the ptxas lines; each entry's
examples_launches gives its launches per example driver on the card;
roofline's entry is its copy kernel, launched by
phase 9 alone (no path of the system runs it).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from epidemicmodeling_torch import viz
from epidemicmodeling_torch.analysis import (
    SEIRP_SCENARIOS, obsv, run_seirp_scenario, seirp_early_eigen,
    seirp_early_phase_matrix, si_alpha_hamiltonian_shooting,
    si_alpha_multiplicative_shooting, si_continuous_control)
from epidemicmodeling_torch.analysis.seirp_scenarios import (
    N_POP, RATE_NAMES, scenario_schedules)
from epidemicmodeling_torch.control import (epsilon_grid,
                                            pareto_front_mask_batched,
                                            random_npi_schedules)
from epidemicmodeling_torch.control.pareto import npi_level_draws
from epidemicmodeling_torch.data import (NPI_MAXES_DEFAULT,
                                         OXFORD_NPI_COLUMNS,
                                         build_region_batch, load_geo_list,
                                         load_oxford_data, load_populations,
                                         preprocess_region,
                                         realistic_oxford_frame,
                                         synthetic_oxford_frame,
                                         synthetic_regions,
                                         to_oxcgrt_latest_schema,
                                         write_oxford_csvs)
from epidemicmodeling_torch.data.csvio import (parse_floats,
                                               read_csv_columns,
                                               write_csv_columns)
from epidemicmodeling_torch.deploy import (newcase_ekf_optimal_npi_native,
                                           newcase_ekf_pareto_sweep_native,
                                           pareto_sweep_plain)
from epidemicmodeling_torch.deploy import native as deploy_native
from epidemicmodeling_torch.examples import NAMES as EXAMPLE_NAMES
from epidemicmodeling_torch.ml import (LSTMForecaster, arx_fit_predict,
                                       lagged_features, long_weekend_feature,
                                       ridge_regression, rollout_forecast,
                                       standardize, svr_fit, svr_predict,
                                       train_forecaster)
from epidemicmodeling_torch.ml.svr import svr_objective
from epidemicmodeling_torch.models import (seirp_rollout,
                                           seirp_saturated_rollout)
from epidemicmodeling_torch.ops.cuda import (build, ekf3_kernel, ekf6_kernel,
                                             nnls_kernel, pairwise_kernel,
                                             roofline_kernel, rollout_kernel,
                                             stencil_kernel)
from epidemicmodeling_torch.ops.diagnostics import (filter_health,
                                                    summarize_health)
from epidemicmodeling_torch.ops.ar import ar_design, ar_normal_matrix
from epidemicmodeling_torch.ops.ekf import _matlab_pinv
from epidemicmodeling_torch.ops.parallel_kf import parallel_kalman
from epidemicmodeling_torch.ops.smoothing import smooth_series
from epidemicmodeling_torch.parallel import Mesh, make_mesh
from epidemicmodeling_torch.parallel.multihost import run_multihost_dryrun
from epidemicmodeling_torch.pipelines import (PipelineConfig,
                                              build_batches_from_frames,
                                              forecast_quality_assessment,
                                              load_trained_params,
                                              pareto_prescribe,
                                              prescribe_from_checkpoint,
                                              run_pipeline,
                                              train_npi_prescriptor,
                                              train_predict_prescribe,
                                              trained_params_from_numpy,
                                              xprize_cli)
from epidemicmodeling_torch.pipelines import core
from epidemicmodeling_torch.pipelines import prescribe as prescribe_mod
from epidemicmodeling_torch.pipelines.core import (
    device_batch, ekf3_lane_inputs, forecast_scenarios, pareto_prep,
    region_init, stage_params, sweep_eks_vmap, sweep_lane_inputs, to_tensor,
    train_regions)
from epidemicmodeling_torch.pipelines.prescribe import (
    ARPrescriptionResult, ar_alpha_prescription, new_case_ekf_optimal_npi)
from epidemicmodeling_torch.regression import nnls_with_intercept
from epidemicmodeling_torch.regression.nnls import nnls_with_intercept_plain
from epidemicmodeling_torch.rt import (rt_expfit_ekf, rt_expfit_gen_ratios,
                                       rt_expfit_log_lin_reg,
                                       rt_expfit_nonlin_ls)
from epidemicmodeling_torch.spatial import (PopulationSimConfig,
                                            diffusion_rollout,
                                            population_motion_sim)
from epidemicmodeling_torch.spatial.agents import default_environment
from epidemicmodeling_torch.spatial.walkers import walking_sources_sim
from epidemicmodeling_torch.utils.dates import date_range_days
from epidemicmodeling_torch.utils.profiling import recording
from tests._torch_helpers import (deploy_history, make_inputs, masked_err,
                                  npi_levels, packed_args, rollout_params,
                                  scaled_err)

R_REGIONS, T_HIST, HORIZON = 235, 440, 92
# slots of the one card in the mesh phase; parallel_kalman's card-vs-CPU
# bound (float64, relative to each output's largest magnitude)
MESH_SLOTS = 5
PKF_TOL = 1e-9
N_EPS, CHUNK, N_MC = 250, 25, 500
# rollout kernel launches a run_pipeline: one a sweep chunk, one for the
# three forecast scenarios, one for the Monte Carlo
SI_ROLLOUT_CALLS = -(-N_EPS // CHUNK) + 2
MINS = np.zeros(12)
WEIGHTS = np.ones(12)
F32 = torch.float32
# Kernel-vs-plain bounds: the CPU tests' (tests/test_ekf6_kernel.py:83-86,
# 188-190), on the scaled error |a - b| / (|b| + 1) over every component,
# and the share of prescribed cells (rows T_hist .. T-2) that differ. A
# bound on a "_nonfinite" share of 0 requires both sides finite there.
EKF3_BOUNDS = {"s_plus": 1e-4, "s_smooth": 1e-3}
# NNLS kernel vs plain version, float32: the largest relative gap of a
# problem's squared residual (nnls_agreement). On backtest_regression's
# seeds 0-2 the two read <= 7.8e-8 apart, while the float32 answers lie up
# to 7.6e-4-3.6e-3 above the float64 optimum and zeroing the largest
# coefficient reads >= 4.9e-2 (NVIDIA H100 80GB HBM3, 700 W).
NNLS_F32_SSE_GAP = 1e-4
# rollout kernel vs plain version on the card, per output, |a - b| /
# (|b| + 1): they differ in the order of the 12-term sum over the NPIs, a
# rounding a step (tests/test_torch_rollout_emulated.py reads <= 2.2e-16
# in double, 1.4e-7 in float on the CPU)
SI_ROLLOUT_BOUNDS = {torch.float64: 1e-12, torch.float32: 1e-5}
# operations a lane-step as csrc/rollout.cu writes them, noise off: the
# 12-term drive (36), the three derivatives (8), three Euler steps and
# their clips (12), the horizon sum (3)
SI_ROLLOUT_OPS = 59
SI_ROLLOUT_REPS = 20
EKF6_FINITE = {"s_plus": 1e-3, "s_smooth": 1e-2, "u_diff": 5e-3,
               "s_plus_nonfinite": 0.0, "s_plus_nonfinite_mismatch": 0.0,
               "s_smooth_nonfinite": 0.0,
               "s_smooth_nonfinite_mismatch": 0.0}
# the same bounds; the active case must also prescribe u_max on at least
# MIN_U_MAX_SHARE of its cells
EKF6_ACTIVE = dict(EKF6_FINITE)
MIN_U_MAX_SHARE = 0.1
# run_pipeline (and prescribe_from_checkpoint) with the kernels against the
# same call with their plain versions, float32: the historic states and
# the scenario and Monte-Carlo costs relative, the share of prescribed
# cells that differ, the median relative difference of the sweep's J1
SMALL_REF_BOUNDS = {"s_hist": 1e-3, "scenario_J0": 1e-3,
                    "pareto_u_diff": 5e-3, "pareto_J1_med": 1e-2,
                    "mc_J0": 1e-3}
KERNELS = {
    "ekf3": dict(run=ekf3_kernel.ekf3, plain=ekf3_kernel.ekf3_plain,
                 source="epidemicmodeling_torch/csrc/ekf3.cu",
                 replaces="epidemicmodeling_tpu/ops/pallas/ekf3_kernel.py:306"),
    "ekf6": dict(run=ekf6_kernel.ekf6, plain=ekf6_kernel.ekf6_plain,
                 source="epidemicmodeling_torch/csrc/ekf6.cu",
                 replaces="epidemicmodeling_tpu/ops/pallas/ekf6_kernel.py:446"),
    "stencil": dict(
        run=stencil_kernel.stencil, plain=stencil_kernel.stencil_plain,
        source="epidemicmodeling_torch/csrc/stencil.cu",
        replaces="epidemicmodeling_tpu/ops/pallas/stencil.py:44",
        also_replaces="epidemicmodeling_tpu/ops/pallas/stencil.py:82"),
    "pairwise": dict(
        run=pairwise_kernel.social_forces,
        plain=pairwise_kernel.social_forces_plain,
        source="epidemicmodeling_torch/csrc/pairwise.cu",
        replaces="epidemicmodeling_tpu/ops/pallas/pairwise.py:79"),
    "roofline": dict(
        run=roofline_kernel.copy_plus_one,
        plain=roofline_kernel.copy_plus_one_plain,
        source="epidemicmodeling_torch/csrc/roofline.cu",
        replaces="bench.py:119"),
    # not a TPU kernel: the card build of the JAX package's CPU library
    "newcase_ekf": dict(
        run=deploy_native.newcase_ekf_sweep, plain=pareto_sweep_plain,
        source="epidemicmodeling_torch/csrc/newcase_ekf.cu",
        replaces="epidemicmodeling_tpu/deploy/src/newcase_ekf.cpp:352",
        note="not a TPU kernel: the JAX package's native CPU library "
             "(newcase_ekf_pareto_sweep), built for the card"),
    # not a TPU kernel: the JAX package nests lax.while_loops under vmap
    "nnls": dict(
        run=nnls_with_intercept, plain=nnls_with_intercept_plain,
        source="epidemicmodeling_torch/csrc/nnls.cu",
        note="not a TPU kernel: the JAX package runs the NNLS and its "
             "intercept loop as lax.while_loops under vmap "
             "(epidemicmodeling_tpu/regression/nnls.py:86, :158); it "
             "replaces the port's eager loop, which synced the host at "
             "every loop test"),
    # not a Pallas kernel: the JAX package's compiled lax.scan rollouts
    "rollout": dict(
        run=rollout_kernel.rollout, plain=rollout_kernel.rollout_plain,
        source="epidemicmodeling_torch/csrc/rollout.cu",
        note="not a Pallas kernel: it replaces the JAX package's lax.scan "
             "rollouts of the sweep, the forecast scenarios and the Monte "
             "Carlo (epidemicmodeling_tpu/pipelines/core.py), which the "
             "port ran as eager Python loops of small launches"),
}
LAUNCH_COUNTERS = {"ekf3": ekf3_kernel, "ekf6": ekf6_kernel,
                   "stencil": stencil_kernel, "pairwise": pairwise_kernel,
                   "roofline": roofline_kernel,
                   "newcase_ekf": deploy_native, "nnls": nnls_kernel,
                   "rollout": rollout_kernel}

# The card's published peaks (H100 SXM, 700 W):
# device memory and float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# float32 operations per lane and time step of the EKS kernels (forward +
# backward). ekf3: counted from csrc/ekf3.cu as written. ekf6: the work its
# outputs need, whatever implements it, every division and square root one
# operation, a compare-and-select one. A product with the Jacobian A skips
# A's structural zeros: row i of A has JAC_NNZ[i] nonzeros (21 of 36), so
# each column of A X, and each row of X A^T, takes sum_i (2 nnz_i - 1) = 36
# operations, 216 a product. C has one row with 3 nonzeros, so KC is rank
# one: (I - KC) P = P - K (P C^T)^T reuses P C^T (72), and
# X (I - KC)^T = X - (X C^T) K^T takes 30 + 72. The smoothed covariance,
# which no output reads, is not counted.
JAC_NNZ = (3, 3, 2, 4, 4, 5)
A_PRODUCT_OPS = 6 * sum(2 * n - 1 for n in JAC_NNZ)
EKF6_OPS = {
    # forward
    "observation, innovation": 7, "P C^T, S, K": 43,
    "(I - KC) P": 72, "((I - KC) P) (I - KC)^T": 30 + 72,
    "+ K K^T R, / gamma": 144,
    "two symmetrizations": 60, "filtered state, margins": 18,
    "12 inputs: bang-bang fill, drive, band terms": 12 * 18 + 4,
    "Euler step, margins": 40, "Jacobian entries": 40,
    "A Pp A^T + Q": 2 * A_PRODUCT_OPS + 6,
    # backward
    "Jacobian: band terms, entries": 12 * 11 + 40, "Pp A^T": A_PRODUCT_OPS,
    "Cholesky of P-": 91, "six gain rows": 6 * 72,
    "smoothed state, margins": 114, "bang-bang law on it": 12 * 6,
}
EKF_OPS_PER_LANE_STEP = {"ekf3": 610, "ekf6": sum(EKF6_OPS.values())}
# float32 operations per pair of the force law (csrc/pairwise.cu): two
# differences, two squares and a sum, opt_dist - d, w * sign, d2 * d, two
# products and two sums, plus the square root and the division
PAIR_OPS = 14
# per interior cell of one stencil step: 4-neighbour 7, 8-neighbour 12
STENCIL_OPS = {False: 7, True: 12}

# the spatial phases: the stencil's float32 bound is the JAX package's
# (bench.py:448)
STENCIL_BOUND = 3e-7
# The pairwise check holds each agent's force on its own scale: per row and
# component, |F_kernel - F_plain| <= PAIRWISE_ROW_BOUND * sum_k |t_k| +
# slack, sum_k |t_k| being the sum of that row's force terms
# (pairwise_kernel.pair_terms) and so the scale of its float32 roundoff.
# The law is discontinuous where d crosses the optimal distance (the sign
# flips) and the cutoff (the term vanishes), so a term whose d lies within
# rounding of either may take either value: the slack is sum 2 |w| / d^2
# over the row's pairs within BOUNDARY_REL of one. The bound must also tell
# the kernel from these mutants of the plain law, each of which it checks
# reads above it.
PAIRWISE_ROW_BOUND = 1e-4
BOUNDARY_REL = 2e-6
PAIRWISE_MUTANTS = {
    "no cutoff": lambda obs, cfg: (obs, dataclasses.replace(
        cfg, no_further_effect_dist=float("inf"))),
    # sign(inf - d) = +1: every subject within the cutoff repels
    "no attraction": lambda obs, cfg: (obs, dataclasses.replace(
        cfg, inter_subject_opt_dist=float("inf"))),
    "no obstacles": lambda obs, cfg: (obs[:0], cfg),
    "w_so x 1.2": lambda obs, cfg: (obs, dataclasses.replace(
        cfg, subject_obstacle_weight=1.2 * cfg.subject_obstacle_weight)),
}
ROW_CHUNK = 2048
# the roofline copy and x + 1: timed samples of each, in turns; calls a
# sample when timed back to back
COPY_TURNS = 20
COPY_BATCH = 5
# dx != dy so that an ax/ay axis swap cannot cancel out
STENCIL_D, STENCIL_DT, STENCIL_DX, STENCIL_DY = 1e-1, 0.004, 0.1, 0.14
STENCIL_SHAPES = ((51, 51), (234, 167), (2048, 2048), (8191, 8193))
STENCIL_TIMED = ((2048, 2048), (8191, 8193))
# the multi-step kernel: held bit for bit against the one-step loop at
# these shapes over 3K + 1 steps (K steps a launch), and its sparse
# injections against the plain version on the CPU, which adds duplicate
# cells in walker order as the kernel does (bound: the float32 rounding of
# a field of order one, STENCIL_BOUND)
MULTI_SHAPES = ((234, 167), (1000, 777), (2048, 2048))
INJECT_L, INJECT_W = 1024, 64
# the example's parameters (examples/spatial_sims.py:30-31)
ROLLOUT_L, ROLLOUT_STEPS = 2048, 249
# the dense-source rollout: a point source of this strength a step at the
# reference's first source cell
ROLLOUT_SOURCE = 1e-3
WALK_L, WALKERS, WALK_STEPS = 1024, 64, 500
SIM_N, SIM_STEPS = 20_000, 200
SIM_FRAMES = (0, 100, 199)
SIM_PATH = f"population_motion_sim (N={SIM_N}, {SIM_STEPS} steps, warm)"
BIG_N, BIG_ROWS = 100_000, 2048
# the CLI phase: files under the checkout's git-ignored build directory
CLI_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_cli"
CLI_START = "2020-03-01"
N_PRESCRIPTIONS = 10
# the backtest phase: bench.py's backtest leg (bench.py:768-800)
BT_STARTS, BT_AHEAD = 60, 60
# the vmap phase: the generic core on the card against the CPU in float64
# at the tolerance the CPU tests hold it to against the JAX package; at the
# XPRIZE width, float32, its train stage against the "pallas" backend's at
# VMAP_TRAIN_BOUND (on the CPU at 16 regions x 440 days the two read
# 1.5e-6 apart) and its backtest's error curves against the pallas
# backtest's at VMAP_BACKTEST_BOUND (CPU, same size: 2.6e-4), both on the
# scaled error |a - b| / (|b| + 1) (scripts/vmap_cpu_probe.py bounds)
VMAP_REF_TOL = dict(rtol=1e-9, atol=1e-12)
# the costate system's bound against the JAX package
# (tests/test_torch_ekf_generic.py; its costates cross zero, and are
# chaotic at the ulp level)
VMAP_COSTATE_TOL = dict(rtol=1e-4, atol=1e-8)
# prior covariances at or above this condition number fix the smoother
# gains only to cond * eps >= 1e-4 (float64) on either device
ILL_COND = 1e12
# LASSO's coordinate descent stops once no coefficient moves by more than
# 1e-10 in a sweep, so the card's and the CPU's summation orders may leave
# its coefficients that far apart: the CPU tests' lasso bound
VMAP_LASSO_COEF_TOL = dict(rtol=1e-9, atol=1e-10)
VMAP_TRAIN_BOUND = 1e-4
VMAP_BACKTEST_BOUND = 1e-2
REGRESSIONS = ("NONNEGATIVELS", "LASSO", "NONNEGATIVELS-ELEMENT-WISE")
# slice 5: the paper's sweep (testPrescribeXPRIZE01.m:160-198); the
# kernels-vs-plain check of prescribe_from_checkpoint at 16 regions in
# chunks of 500 epsilons (the plain version's time is per chunk); AR-alpha
# as PrescribeNPI.m:202-214 runs it; the pre-generic EKS's lanes and its
# adaptive-R factor; the realistic-artefact frame's seed and files
SLICE5_EPS = 2000
PLAIN_CHECK_REGIONS, PLAIN_CHECK_CHUNK = 16, 500
AR_ORDER, AR_HISTORY, AR_SCENARIOS = 24, 90, 10
NEWCASE_LANES, NEWCASE_BETA = 300, 0.9
REALISTIC_DIR = Path(__file__).resolve().parent / "build" / \
    "chip_smoke_realistic"
REALISTIC_SEED = 7
FILTER_TYPES = ("BYPASS", "TIKHONOV", "MOVINGAVERAGE-CAUSAL",
                "MOVINGAVERAGE-NONCAUSAL", "MOVINGMEDIAN")
# card against CPU in float64: the CPU tests' tolerance against the JAX
# package; rt_expfit_nonlin_ls's LM fixes its fit only to ~1e-9, so it is
# held by co-optimality (window costs within LM_COST_RTOL) and at LM_RTOL
# (tests/test_torch_rt_smoothing.py)
SLICE5_TOL = dict(rtol=1e-9, atol=1e-12)
LM_RTOL, LM_COST_RTOL = 5e-9, 1e-11
# slice 6: examples/seirp_scenarios.py's saturated comparison; the
# shooting settings of tests/test_analysis.py; examples/lstm_forecast.py;
# test04's deep stack and features; the SVR size of
# test03ExpfitVsIPRegression.m:198-246. Float64 card against CPU at
# SLICE6_TOL; the float32 LSTM's training (20 epochs from the same
# weights) by its RMS residuals sqrt(loss) at LSTM_RMS_TOL (an output
# difference of 1e-5 moves sqrt(loss) by at most 1e-5, whatever the loss),
# the small forecaster's 10 epochs by their losses at LSTM_LOSS_RTOL and
# every forward at LSTM_FWD_TOL: with cuDNN's TF32 in place of IEEE
# float32 the small losses read >= 5.3 and the forwards >= 1.6 of these
# bounds, IEEE <= 0.25 (scripts/lstm_tf32_probe.py, H100; the 100-unit
# LSTM's 20 epochs cannot tell them apart: its one-input forward takes no
# TF32); ARX by its forecast at ARX_FORECAST_TOL
# and its fit by co-optimality (an AR(14) fit of a smooth alpha fixes the
# coefficients only along its well-conditioned directions: port and JAX
# differ by O(1) relative in some coefficients, by 1.0e-9 in the forecast
# and 4.7e-14 in the residual cost, CPU run)
SLICE6_TOL = dict(rtol=1e-9, atol=1e-12)
SAT_K = 4000
SHOOT_P, SHOOT_K, SHOOT_DT, SHOOT_RANDOM = 12, 500, 0.1, 10
MULT_K, CONT_K = 400, 300
SHOOT_U_MAX = np.array([3, 3, 2, 4, 2, 3, 2, 4, 2, 3, 2, 4], float)
LSTM_EPOCHS, LSTM_TEST_DAYS = 250, 30
LSTM_RMS_TOL = dict(rtol=1e-4, atol=1e-5)
LSTM_FWD_TOL = dict(rtol=2e-5, atol=2e-5)
LSTM_LOSS_RTOL = 1e-6
SMALL_LSTM_HIDDEN, SMALL_LSTM_EPOCHS = (32, 16), 10
DEEP_HIDDEN, DEEP_EPOCHS = (200, 200, 100, 50, 20), 10
NPI_LAGS = (1, 7, 14)
SVR_N, SVR_STEPS = 400, 2000
ARX_ORDER = 14
ARX_FORECAST_TOL = dict(rtol=1e-8, atol=1e-12)
ARX_COST_RTOL = 1e-11
# slice 8: the native deployment artefact's sweep for one region at the
# paper's 2,000 epsilons, log-spaced over per_capita_case(True)'s active
# range, with the reference's deployed adaptive R (beta_ekf = 0.9); the
# card's sweep against the CPU build (bit for bit expected: both compile
# csrc/newcase_ekf.cuh without fused multiply-adds) and against the plain
# version (the generic core: another operation order); the single-epsilon
# entry at both beta_ekf
DEPLOY_EPS, DEPLOY_EPS_RANGE = 2000, (-8, -2)
DEPLOY_BETA = 0.9
DEPLOY_CPU_RTOL, DEPLOY_PLAIN_RTOL = 1e-12, 1e-9
# the SMs the sweep's blocks must land on (2,000 lanes are 125 blocks)
DEPLOY_MIN_SMS = 120
# the card's float64 peak outside the tensor cores (H100 SXM data sheet)
PEAK_F64_PER_S = 34e12
# f64_path: each launch of the kernels' double instances in the warm
# float64 run_pipeline, held on its own inputs against the plain version in
# float64 on the card. The two differ in the order of the operations and in
# nvcc's fused multiply-adds: a few ulps a step where a lane is well posed.
# Over 532 days most sweep lanes are not (their smoother's P- fixed only to
# cond * eps: the smoothed costates of two correct runs part by up to 1e12
# scaled, and the reference's card and CPU runs prescribe differently in
# ~6% of the cells, PERF.md), so the plain version of each launch also
# runs on the CPU and on the card on inputs one ulp off (ulp_perturbed).
# Each output (F64_OUTPUTS: ekf3's S_SMOOTH and S_PLUS; ekf6's S_PLUS,
# S_SMOOTH's epidemic states and its costates) is held:
# - on its well-posed lanes, those where both runs agree with the plain
#   version on it within F64_WELL_POSED (scaled, |a - b| / (|b| + 1),
#   every cell finite in both) and, for ekf6's smoothed states, whose
#   smoothed costates are finite in all three, at F64_BOUND (the card
#   tests' bound, tests/test_torch_cuda.py), lane by lane: a fault
#   confined to a block or a chunk of lanes shows there. The CPU run alone
#   does not find every lane that rounding decides: it shares the plain
#   version's order of operations, so it can round alike where the kernel
#   does not (where a costate overflows, the law's NaN semantics set the
#   states; and on lanes of 2 of the 10 sweep chunks the kernel's states
#   read 0.53 from the plain version's while its CPU run agreed within
#   1e-12, on an NVIDIA H100);
# - over every lane, the filtered states S_PLUS at F64_BOUND (the forward
#   filter is well posed: the plain version's card and CPU runs read
#   <= 3.3e-12 apart on every lane, on an NVIDIA H100), the smoothed
#   outputs at the larger of F64_BOUND and F64_SPREAD_FACTOR times the
#   CPU run's distance (the card tests' factor for ill-conditioned
#   lanes), as are the shares of cells finite on one side only and (ekf6)
#   of prescribed cells that differ, over every lane and over the lanes
#   whose costates are well posed.
# Each mutant of the plain outputs (lanes one region over, one epsilon
# over, one day over; one block of 32 lanes one day over in every output,
# and in the smoothed outputs only) must exceed a bound.
F64_BOUND, F64_WELL_POSED, F64_SPREAD_FACTOR = 1e-10, 1e-12, 3
# name: (output, first row, end row)
F64_OUTPUTS = {"ekf3": {"s_plus": (1, 0, 3), "s_smooth": (0, 0, 3)},
               "ekf6": {"s_plus": (2, 0, 6), "s_smooth_states": (0, 0, 3),
                        "s_smooth_costates": (0, 3, 6)}}
# slice 9: the example drivers (epidemicmodeling_torch/examples/), each
# through its main on the card (device=None) and again with device="cpu"
# from the same draws (the drivers draw on CPU generators), each in a
# temporary working directory. The kernels each driver must launch on the
# card; the cuts that keep the phase near a minute and a half (PERF.md):
# the studies, one Python loop of small launches a step on the
# card, at smaller sizes (the SEIRP scenarios at dt 1 for 0.5, the
# 100-unit LSTM 60 epochs for 250, ml_comparison's SVRs 200 Adam steps for
# 2,000 and its LSTMs 50 epochs for 150); the pipeline drivers run at
# their own sizes and dtype (float32), the XPRIZE driver's Phase-II run at
# 235 regions on CSVs from 2020-03-15 through 2021-08-29 (its fixed
# window) under EXAMPLES_DIR.
EXAMPLE_KERNELS = {"xprize_prescribe": ("ekf3", "ekf6", "nnls", "rollout"),
                   "prescribe_from_checkpoint": ("ekf3", "ekf6", "nnls",
                                                 "rollout"),
                   "forecast_quality": ("ekf3", "nnls"),
                   "realistic_data_pipeline": ("ekf3", "ekf6", "nnls",
                                               "rollout"),
                   "spatial_sims": ("stencil", "pairwise"),
                   "make_figures": ("ekf3", "ekf6", "nnls", "rollout")}
EXAMPLE_ARGS = {"xprize_prescribe": (["xprize_prescribe", "--synthetic"],),
                "prescribe_from_checkpoint": (["prescribe_from_checkpoint"],)}
EXAMPLE_CUTS = {"seirp_scenarios": dict(dt=1.0),
                "lstm_forecast": dict(num_epochs=60, lr_drop_period=30),
                "ml_comparison": dict(svr_steps=200, lstm_epochs=50)}
# the CPU runs of prescribe_from_checkpoint sweep its 2,000 epsilons in
# one chunk, not 125 of 16: the plain ekf6 steps all of a chunk's lanes
# at once (~100 s less); a lane's formulas do not change, its float32
# rounding may (the CPU vectorizes a wider batch otherwise)
EXAMPLE_CPU_CHUNK = {"prescribe_from_checkpoint": 2000}
# the drivers whose sweep goes through core.pareto_prescribe
EXAMPLE_PIPELINES = ("xprize_prescribe", "prescribe_from_checkpoint",
                     "realistic_data_pipeline", "make_figures")
EXAMPLES_DIR = Path(__file__).resolve().parent / "build" / \
    "chip_smoke_examples"
PHASE2_START, PHASE2_DAYS, PHASE2_HORIZON = "2020-03-15", 533, 92
# card against CPU for the pipeline drivers (float32). Held:
# - the training (ekf3 on the card, its plain version on the CPU, each
#   side training on the same data): the trained a2 and the historic
#   states s_hist, scaled_err at most EXAMPLE_TRAIN_BOUND;
# - each kernel on the inputs of its own launches in the card run (all of
#   a driver's launches of one kernel and T joined along the lanes), run
#   again through the plain version on the card: ekf3 at EKF3_BOUNDS;
#   ekf6 at EKF6_FINITE's bounds on its forward filter S_PLUS, its
#   smoothed epidemic states (S_SMOOTH's first three rows) and the share
#   of prescribed cells that differ, with no cell finite on one side
#   only. The smoother's two (EXAMPLE_SPREAD_HELD) are held at the larger
#   of that bound and EXAMPLE_SPREAD_FACTOR times the distance between
#   the plain version on the card and on the CPU on the same inputs: on
#   these inputs two correct float32 runs prescribe differently in 5-14%
#   of the cells, and in realistic_data_pipeline their smoothed states
#   part by 0.42 (PERF.md). The smoothed costates (1e3-1e5 apart,
#   scaled, between the plain version's two runs) are printed.
# Each bound must sit below what a fault reads, computed in the run: the
# historic states one day off, a1 in place of a2 (a run that skipped the
# second ekf3 round); the plain outputs one region over, one epsilon
# over (ekf6) or one day over (ekf3); each mutant must exceed a bound on
# at least one held measure. The two independent runs' own readings
# (flips in each band of the epsilon grid, costs over the region's
# largest, the front gap) are printed.
EXAMPLE_TRAIN_BOUND = dict(a2=1e-4, s_hist=1e-4)
EXAMPLE_KERNEL_BOUNDS = {
    "ekf3": EKF3_BOUNDS,
    "ekf6": {"s_plus": EKF6_FINITE["s_plus"],
             "s_plus_nonfinite_mismatch": 0.0,
             "s_smooth_states": EKF6_FINITE["s_smooth"],
             "s_smooth_states_nonfinite_mismatch": 0.0,
             "u_diff": EKF6_FINITE["u_diff"]}}
EXAMPLE_SPREAD_HELD, EXAMPLE_SPREAD_FACTOR = ("s_smooth_states", "u_diff"), 2
# the backtest's median error curves (% of truth), float32
EXAMPLE_BACKTEST_TOL = dict(rtol=1e-3, atol=1e-3)
# the agent sim (150 agents): its pairwise launches held on the sim's own
# positions (the inputs to these steps) against the plain version row by
# row at PAIRWISE_ROW_BOUND, each PAIRWISE_MUTANTS above it; the card's
# and the CPU's trajectories part as a chaotic system's do (by an e-fold
# every ~7 steps), so their gap is printed, not held
EXAMPLE_SIM_STEPS = (0, 99, 249, 498)
EXAMPLE_LSTM_EPOCHS = 20
# ml_comparison's float64 MAEs: ridge and ARX relative, the SVRs (held by
# their predictions within 1e-6 of the target's scale in slice 6; the growth
# rate lambda is O(0.1) a day) absolute
EXAMPLE_ML_TOL = {"ridge": dict(rtol=1e-6, atol=0.0),
                  "arx": dict(rtol=1e-8, atol=0.0),
                  "svr_linear": dict(rtol=0.0, atol=1e-6),
                  "svr_rbf": dict(rtol=0.0, atol=1e-6)}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def xprize_inputs(n_regions, t_hist, horizon, seed):
    """Synthetic regions -> (batch_train, batch_full, actual NPIs, the
    generating coefficients as trained parameters)."""
    truth = synthetic_regions(n_regions, t_hist + horizon, seed=seed)
    sers = []
    for tr in truth.values():
        nc = tr["s"] * tr["i"] * tr["alpha"] * tr["pop"]
        sers.append(preprocess_region(np.cumsum(nc)[:t_hist], None,
                                      tr["u"][:t_hist], tr["pop"]))
    names = list(truth)
    bt = build_region_batch(sers, names)
    bf = build_region_batch(sers, names, horizon=horizon)
    actual = np.stack([tr["u"] for tr in truth.values()])
    a = np.stack([tr["a"] for tr in truth.values()])
    b = np.array([tr["b"] for tr in truth.values()])
    coefs = dict(names=names, population=bt.population, a1=a, b1=b, a2=a,
                 b2=b)
    return bt, bf, actual, coefs


def cuda_ms(fn, reps: int = 5) -> float:
    """Median of ``reps`` warm runs, CUDA events around each."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def rel_err(a, b) -> float:
    return float((torch.abs(a.double() - b.double())
                  / torch.abs(b.double())).max())


def reset_launches() -> None:
    for mod in LAUNCH_COUNTERS.values():
        mod.launches = 0


def read_launches() -> dict:
    return {name: mod.launches for name, mod in LAUNCH_COUNTERS.items()}


def other_launches(n: dict) -> dict:
    """The launches ``n`` of every kernel but the NNLS, which every
    training at NONNEGATIVELS makes, and the rollout, which every rollout
    on the card makes, whatever runs the filters."""
    return {k: v for k, v in n.items() if k not in ("nnls", "rollout")}


def bound(nbytes: float, ops: float, peak: float = PEAK_F32_PER_S):
    """(least time in ms, what sets it): the bytes over the card's memory
    rate or the operations over ``peak`` (float32 by default), whichever
    is larger."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ekf_bound(name: str, T: int, B: int, word: int = 4):
    """Bound of one ekf3 / ekf6 call at (T, B): every input read once and
    every returned output written once, in words of ``word`` bytes (4:
    float32 at its peak; 8: float64 at PEAK_F64_PER_S)."""
    if name == "ekf3":
        per_tb = 12 + 2 + 3 * 3        # u, x, Rv; S_SMOOTH, S_PLUS, S_MINUS
        per_b = 11 + 2 * 12 + 3 + 9 + 3 + 9
    else:
        per_tb = 12 + 2 + 6 + 12 + 6   # u, x, Rv; S_SMOOTH, U_SM, S_PLUS
        per_b = 14 + 4 * 12 + 6 + 36 + 6 + 36
    return bound(word * (T * B * per_tb + B * per_b),
                 EKF_OPS_PER_LANE_STEP[name] * T * B,
                 PEAK_F64_PER_S if word == 8 else PEAK_F32_PER_S)


def per_capita_case(active: bool):
    """ekf6 arguments at the sweep's shape from the per-capita recipe of the
    kernel tests, with slow dynamics (dt = 0.25, rates x 0.2) so that the
    float32 costates stay finite over T = 532 (their growth per step is
    about 1 + dt * rate).

    Without active control: epsilon in [1e-4, 1] and the main path's band
    slope sigma = 1e6, so every phi lies outside the band and every
    prescribed cell is u_min. With it: epsilon in [1e-8, 1e-2], so about a
    third of the cells switch to u_max, and sigma = 10, so the band term
    of the Jacobian enters every optimized step. At sigma = 1e6 each band
    hit adds gamma * dt * sigma / 2 * a * (u_max - u_min), tens here, to
    A[2][5], and with control active the float32 smoother then goes
    non-finite on some lanes in either operation order (PERF.md)."""
    B, T = CHUNK * R_REGIONS, T_HIST + HORIZON
    d = make_inputs(6, B=B, T=T, T_hist=T_HIST, seed=4, dtype=np.float32)
    p = d["params"]
    p["dt"] = np.full(B, 0.25, np.float32)
    p["beta"] = p["beta"] * np.float32(0.2)
    p["gamma"] = p["gamma"] * np.float32(0.2)
    lo, hi = (-8, -2) if active else (-4, 0)
    p["epsilon"] = (10 ** np.random.default_rng(9).uniform(lo, hi, B)
                    ).astype(np.float32)
    if active:
        p["sigma"] = np.full(B, 10.0, np.float32)
    return d


def kernel_cases(bt, bf, actual, cfg, device):
    """(kernel, tag, arguments, bounds, timed) at the main path's shapes.
    The pipeline's own inputs come from its input code: the first training
    round, then (from the coefficients a kernel-path training returns) the
    actual-NPI scenario and one Pareto chunk whose 25 epsilons span the
    whole grid. bounds None: a check that the kernel runs, errors printed."""
    bt_d, _, _ = device_batch(bt, F32, device)
    bf_d, _, _ = device_batch(bf, F32, device)
    init = region_init(bt_d, cfg, F32, device)
    p_r1 = stage_params(cfg, bt_d, None, MINS, NPI_MAXES_DEFAULT, F32,
                        device)
    yield "ekf3", "train round 1", ekf3_kernel.pack_ekf3_args(
        *ekf3_lane_inputs(torch.zeros_like(bt_d.npis), bt_d.observations,
                          p_r1, bt_d.obs_noise_var, init)), EKF3_BOUNDS, True
    trained = train_regions(bt, MINS, NPI_MAXES_DEFAULT, T_HIST, cfg,
                            dtype=F32, device=device).trained
    p_full = stage_params(cfg, bf_d, trained, MINS, NPI_MAXES_DEFAULT, F32,
                          device)
    yield "ekf3", "actual scenario", ekf3_kernel.pack_ekf3_args(
        *ekf3_lane_inputs(to_tensor(actual, F32, device), bf_d.observations,
                          p_full, bf_d.obs_noise_var, init)), EKF3_BOUNDS, True
    prep = pareto_prep(cfg, bf_d, trained, init, WEIGHTS, MINS,
                       NPI_MAXES_DEFAULT, T_HIST, F32, device)
    eps = epsilon_grid(N_EPS, F32, device)[::N_EPS // CHUNK]
    yield "ekf6", "sweep chunk", ekf6_kernel.pack_ekf6_args(
        sweep_lane_inputs(prep, eps)), None, True
    yield "ekf6", "per-capita", packed_args(
        6, per_capita_case(False), device), EKF6_FINITE, False
    yield "ekf6", "per-capita, control active", packed_args(
        6, per_capita_case(True), device), EKF6_ACTIVE, True


def compare_kernel(name, tag, args, device, bounds, timed):
    k = KERNELS[name]
    kw = dict(gamma_discount=0.995)
    before = LAUNCH_COUNTERS[name].launches
    got = k["run"](*args, **kw)
    ref = k["plain"](*args, **kw)
    torch.cuda.synchronize()
    T, _, B = args[0].shape
    if name == "ekf3":
        made = LAUNCH_COUNTERS[name].launches - before
        check(made == 1, f"ekf3 {tag}: {made} launches for one call")
    check(all(o.device == device for o in got),
          f"{name} {tag}: kernel output not on {device}")
    if name == "ekf3":
        pairs = {"s_plus": (got[1], ref[1]), "s_smooth": (got[0], ref[0])}
        check(all(bool(torch.isfinite(o).all()) for o in got),
              f"{name} {tag}: non-finite output")
        errs = {n: scaled_err(a, b) for n, (a, b) in pairs.items()}
    else:
        pairs = {"s_plus": (got[2], ref[2]), "s_smooth": (got[0], ref[0])}
        errs = {}
        for n, (a, b) in pairs.items():
            errs[n], errs[n + "_nonfinite_mismatch"] = masked_err(a, b)
            errs[n + "_nonfinite"] = float((~torch.isfinite(b)).double()
                                           .mean())
            check(bool(torch.isfinite(a[:, :3]).all()),
                  f"{name} {tag}: non-finite epidemic state in {n}")
        u, r_u = got[1][T_HIST:-1], ref[1][T_HIST:-1]
        lo, hi = args[4][1], args[4][2]
        check(bool(((u == lo) | (u == hi)).all()),
              f"{name} {tag}: a prescribed cell is neither u_min nor u_max")
        check(bool((got[1][-1] == 0).all()), f"{name} {tag}: last U_SM row "
                                             "not 0")
        errs["u_diff"] = float((u != r_u).double().mean())
        errs["u_max_share"] = float((u == hi).double().mean())
        if bounds is EKF6_ACTIVE:
            check(errs["u_max_share"] >= MIN_U_MAX_SHARE,
                  f"{name} {tag}: control not active")
    # the largest absolute difference over the bounded comparisons
    abs_err = max((float(torch.abs(pairs[n][0] - pairs[n][1]).max())
                   for n in (bounds or {}) if n in pairs), default=0.0)
    line = (f"kernel {name} [{tag}] T={T} B={B}: "
            + " ".join(f"{n}={v:.3e}" for n, v in errs.items()))
    ms = plain_ms = None
    if timed:
        ms = cuda_ms(lambda: k["run"](*args, **kw))
        plain_ms = cuda_ms(lambda: k["plain"](*args, **kw))
        line += f" kernel_ms={ms:.3f} plain_ms={plain_ms:.3f}"
    log(line + ("" if bounds else " (runs; not bounded)"))
    for n, bound in (bounds or {}).items():
        check(errs[n] <= bound, f"{name} {tag}: {n} {errs[n]:.3e} > {bound}")
    return dict(tag=tag, abs_err=abs_err, ms=ms, plain_ms=plain_ms, T=T, B=B)


def sweep_errs(k_par, p_par, k_mc, p_mc) -> dict:
    """The sweep's and the Monte-Carlo baseline's kernels-vs-plain errors
    of SMALL_REF_BOUNDS: the share of prescribed cells that differ (the
    last row, 0 by convention, left out), the median relative difference
    of J1, the largest relative difference of the Monte-Carlo J0."""
    return {
        "pareto_u_diff": float((k_par["u_prescribed"][:, :, :-1].cpu()
                                != p_par["u_prescribed"][:, :, :-1].cpu())
                               .double().mean()),
        "pareto_J1_med": float(torch.median(torch.abs(
            k_par["J1"].cpu() / p_par["J1"].cpu() - 1))),
        "mc_J0": rel_err(k_mc["J0"].cpu(), p_mc["J0"].cpu()),
    }


@contextlib.contextmanager
def plain_versions():
    """Route the pipeline's kernel calls to the kernels' plain versions
    (the NNLS's aside: its route follows the device alone)."""
    saved = ekf3_kernel.ekf3, ekf6_kernel.ekf6, rollout_kernel.rollout
    ekf3_kernel.ekf3 = ekf3_kernel.ekf3_plain
    ekf6_kernel.ekf6 = ekf6_kernel.ekf6_plain
    rollout_kernel.rollout = rollout_kernel.rollout_plain
    try:
        yield
    finally:
        ekf3_kernel.ekf3, ekf6_kernel.ekf6, rollout_kernel.rollout = saved


def small_reference_check(device):
    """run_pipeline with the kernels against the same call with their plain
    versions, on the same card, float32, from the same trained parameters
    and Monte-Carlo schedules."""
    T_h, H = 100, 20
    bt, bf, actual, coefs = xprize_inputs(16, T_h, H, seed=1)
    eps = epsilon_grid(16).numpy()
    cfg = PipelineConfig(backend="pallas", smoother_gain="solve",
                         pareto_chunk=4, num_monte_carlo=32)
    u_random = random_npi_schedules(torch.Generator().manual_seed(1), 32,
                                    MINS, NPI_MAXES_DEFAULT, H)
    run = lambda: run_pipeline(
        bt, bf, actual, T_h, WEIGHTS, eps, MINS, NPI_MAXES_DEFAULT, T_h, cfg,
        dtype=F32, device=device, u_random=u_random,
        trained=trained_params_from_numpy(coefs, F32, device))
    k = run()
    with plain_versions():
        p = run()
    errs = {
        "s_hist": scaled_err(k.s_hist, p.s_hist),
        "scenario_J0": max(rel_err(k.scenarios[n].J0, p.scenarios[n].J0)
                           for n in p.scenarios),
        **sweep_errs(k.pareto, p.pareto, k.monte_carlo, p.monte_carlo)}
    log("small reference (kernels vs plain versions, 16 regions x "
        f"{T_h}+{H} days, 16 eps): "
        + " ".join(f"{n}={v:.3e}" for n, v in errs.items()))
    for n, bound in SMALL_REF_BOUNDS.items():
        check(errs[n] <= bound, f"small reference {n} {errs[n]:.3e} > "
                                f"{bound}")


def all_tensors(res):
    sc = [t for s in res.scenarios.values() for t in s]
    yield from (res.trained.a1, res.trained.b1, res.trained.a2,
                res.trained.b2, res.pareto_front, res.s_hist, *sc)
    yield from (v for v in res.pareto.values() if v is not None)
    yield from res.monte_carlo.values()


def xprize_run(device, bt, bf, actual, cfg, eps, tag, profile=True):
    """run_pipeline at the XPRIZE size, cold then warm, each with its
    stage walls and kernel launches; with profile, the device busy share of
    one more (profiled) run; then the outputs' checks. Returns (the warm
    result, its wall, its launches)."""
    def run():
        reset_launches()
        t0 = time.perf_counter()
        res = run_pipeline(bt, bf, actual, T_HIST, WEIGHTS, eps, MINS,
                           NPI_MAXES_DEFAULT, T_HIST, cfg,
                           generator=torch.Generator().manual_seed(0),
                           dtype=F32, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return res, wall, read_launches()

    for run_tag in ("cold", "warm"):
        res, wall, launches = run()
        stages = " ".join(f"{k}={v:.3f}s" for k, v in
                          res.stage_seconds.items())
        log(f"{tag} {run_tag}: wall={wall:.3f}s {stages} "
            f"launches={launches}")
    if profile:
        device_time(run, wall)
    fd_rate = len(eps) * R_REGIONS * (T_HIST + HORIZON) \
        / res.stage_seconds["pareto"]
    log(f"{tag}: sweep filter-days/s (warm, pareto stage wall): "
        f"{fd_rate:.4e}")
    log(f"{tag}: peak device memory: "
        f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    check_xprize_outputs(res, eps, device, tag)
    return res, wall, launches


def check_xprize_outputs(res, eps, device, tag):
    """The XPRIZE run's outputs: on the card, finite costs, a2 >= 0,
    bang-bang prescriptions of the right shape, a non-empty front."""
    check(all(t.device == device for t in all_tensors(res)),
          f"{tag}: an output tensor is not on {device}")
    a2 = res.trained.a2
    check(bool(torch.isfinite(a2).all() and (a2 >= 0).all()),
          f"{tag}: a2 not finite and >= 0")
    for src, d in (("pareto", res.pareto), ("monte carlo", res.monte_carlo),
                   *((f"scenario {n}", s._asdict())
                     for n, s in res.scenarios.items())):
        check(bool(torch.isfinite(d["J0"]).all()
                   and torch.isfinite(d["J1"]).all()),
              f"{tag}: {src} costs not finite")
    u = res.pareto["u_prescribed"]
    check(tuple(u.shape) == (len(eps), R_REGIONS, HORIZON, 12),
          f"{tag}: u_prescribed shape {tuple(u.shape)}")
    hi = to_tensor(NPI_MAXES_DEFAULT, F32, device)
    check(bool(((u == 0) | (u == hi)).all()),
          f"{tag}: a prescribed cell is neither u_min nor u_max")
    lo_eps, hi_eps = float(u[0].mean()), float(u[-1].mean())
    log(f"{tag}: mean prescribed NPI level: eps={eps[0]:.0e} -> "
        f"{lo_eps:.4f}, eps={eps[-1]:.6f} -> {hi_eps:.4f}")
    check(lo_eps >= hi_eps,
          f"{tag}: NPI level at eps=1e-12 below that at eps~1")
    check(int(res.pareto_front.sum(dim=0).min()) >= 1,
          f"{tag}: a region has an empty Pareto front")
    check(tuple(res.monte_carlo["J0"].shape) == (N_MC, R_REGIONS),
          f"{tag}: monte carlo shape")


def main_path(device, bt, bf, actual):
    cfg = PipelineConfig(backend="pallas", smoother_gain="solve",
                         pareto_chunk=CHUNK, num_monte_carlo=N_MC)
    res, wall, launches = xprize_run(device, bt, bf, actual, cfg,
                                     epsilon_grid(N_EPS).numpy(),
                                     "main path")
    check(launches["ekf3"] >= 3, f"ekf3 launched {launches['ekf3']} times")
    check(launches["ekf6"] >= 10, f"ekf6 launched {launches['ekf6']} times")
    check(launches["nnls"] == 2, f"nnls launched {launches['nnls']} times, "
                                 "one a training regression expected")
    check(launches["rollout"] == SI_ROLLOUT_CALLS,
          f"rollout launched {launches['rollout']} times, one a sweep "
          "chunk, the scenarios and the Monte Carlo expected")
    return res, wall, launches


def f64_path(device, bt, bf, actual):
    """run_pipeline at the XPRIZE size in float64 (the MATLAB reference's
    precision), cold then warm: the caller's dtype reaches the kernels, so
    the normal path launches their double instances. Checks the launches
    (4 ekf3, one ekf6 a chunk, 2 NNLS), that every output is float64 and
    every prescribed cell u_min or u_max, and logs the walls, the stages
    and the recording's ekf6.costate_nonfinite (the reference's smoothed
    costates not finite, a share of those the sweep forms). Then holds
    each double launch of the warm run on its own inputs (f64_lane_holds)
    and times both instances and their plain versions on the largest.
    Returns {kernel: the kernels line's f64 entry}."""
    cfg = PipelineConfig(backend="pallas", smoother_gain="solve",
                         pareto_chunk=CHUNK, num_monte_carlo=N_MC)
    eps = epsilon_grid(N_EPS).numpy()
    rec_launches = []

    def spy(real, kn):
        def call(*a, **k):
            out = real(*a, **k)
            rec_launches.append((kn, a, k, out))
            return out
        return call

    real3, real6 = ekf3_kernel.ekf3, ekf6_kernel.ekf6
    for run_tag in ("cold", "warm"):
        reset_launches()
        if run_tag == "warm":
            ekf3_kernel.ekf3 = spy(real3, "ekf3")
            ekf6_kernel.ekf6 = spy(real6, "ekf6")
        try:
            with recording() as rec:
                t0 = time.perf_counter()
                res = run_pipeline(bt, bf, actual, T_HIST, WEIGHTS, eps,
                                   MINS, NPI_MAXES_DEFAULT, T_HIST, cfg,
                                   generator=torch.Generator().manual_seed(0),
                                   dtype=torch.float64, device=device)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            ekf3_kernel.ekf3, ekf6_kernel.ekf6 = real3, real6
        launches = read_launches()
        c = rec.counters
        share = c["ekf6.costate_nonfinite"] / (
            3 * (T_HIST + HORIZON) * c["ekf6.lanes"])
        stages = " ".join(f"{k}={v:.3f}s" for k, v in
                          res.stage_seconds.items())
        log(f"float64 main path {run_tag}: wall={wall:.3f}s {stages} "
            f"launches={launches} ekf6.lanes={c['ekf6.lanes']} "
            f"ekf6.costate_nonfinite={c['ekf6.costate_nonfinite']} "
            f"({share:.4%} of the smoothed costates)")
    check(launches["ekf3"] == 4 and launches["ekf6"] == -(-N_EPS // CHUNK)
          and launches["nnls"] == 2
          and launches["rollout"] == SI_ROLLOUT_CALLS,
          f"float64 main path: launches {launches}")
    check([kn for kn, *_ in rec_launches].count("ekf6") == launches["ekf6"]
          and len(rec_launches) == launches["ekf3"] + launches["ekf6"],
          "float64 main path: a launch went round the wrappers")
    check(all(t.dtype == torch.float64 for t in all_tensors(res)
              if t.is_floating_point()),
          "float64 main path: an output is not float64")
    u = res.pareto["u_prescribed"]
    hi = to_tensor(NPI_MAXES_DEFAULT, torch.float64, device)
    check(bool(((u == 0) | (u == hi)).all()),
          "float64 main path: a prescribed cell is neither u_min nor u_max")
    log(f"float64 main path: u_max share at eps={eps[0]:.0e} "
        f"{float((u[0] == hi).double().mean()):.4f}, at eps={eps[-1]:.6f} "
        f"{float((u[-1] == hi).double().mean()):.4f}; peak device memory "
        f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    del res
    fails = []
    holds = f64_lane_holds(rec_launches, fails)
    check(not fails, "float64 main path: " + "; ".join(fails))
    entries = {}
    for kn in ("ekf3", "ekf6"):
        mine = [h for h in holds if h["kernel"] == kn]
        _, a, k, _ = max((r for r in rec_launches if r[0] == kn),
                         key=lambda r: r[1][0].shape[0] * r[1][0].shape[-1])
        T, B = a[0].shape[0], a[0].shape[-1]
        ms = cuda_ms(lambda: KERNELS[kn]["run"](*a, **k))
        plain_ms = cuda_ms(lambda: KERNELS[kn]["plain"](*a, **k), reps=3)
        b_ms, b_by = ekf_bound(kn, T, B, word=8)
        errs = {n: max(h["errs"][n] for h in mine) for n in mine[0]["errs"]}
        entries[kn] = dict(
            launches=launches[kn], shape=f"T={T} B={B} float64", ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, errs=errs,
            well_posed_share={n: min(h["well_posed_share"][n] for h in mine)
                              for n in mine[0]["well_posed_share"]})
        log(f"kernel {kn} [float64 main path, {len(mine)} launches held] "
            f"T={T} B={B}: kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
            f"bound_ms={b_ms:.4f} ({b_by}, 8-byte words, "
            f"{PEAK_F64_PER_S / 1e12:.0f} TFLOP/s); largest errors "
            + " ".join(f"{n}={v:.3e}" for n, v in errs.items()))
    entries["rollout_launches"] = launches["rollout"]
    return entries


def lane_errs(a, b):
    """Per lane (the last axis): the largest scaled error |a - b| / (|b| +
    1) over the cells finite in both, and whether every cell is finite in
    both; and the share of cells finite in one only."""
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    both = fa & fb
    d = torch.where(both, torch.abs(a - b) / (torch.abs(b) + 1.0),
                    torch.zeros_like(a))
    flat = lambda x: x.reshape(-1, x.shape[-1])
    return (flat(d).amax(0), flat(both).all(0),
            float((fa != fb).double().mean()))


def f64_lane_numbers(kn, got, ref, wells):
    """The held numbers of ``got`` against ``ref``: each output's
    (F64_OUTPUTS) largest error over its lanes ``wells[name]`` and over
    every lane and its share of cells finite on one side only; for ekf6
    the share of prescribed cells (rows T_HIST .. T-2) that differ, over
    every lane and over the lanes whose costates are well posed."""
    e = {}
    for n, (j, lo, hi) in F64_OUTPUTS[kn].items():
        err, _, mismatch = lane_errs(got[j][:, lo:hi], ref[j][:, lo:hi])
        w = wells[n]
        e[n + "_well_posed"] = float(err[w].max()) if bool(w.any()) else 0.0
        e[n] = float(err.max())
        e[n + "_nonfinite_mismatch"] = mismatch
    if kn == "ekf6":
        diff = got[1][T_HIST:-1] != ref[1][T_HIST:-1]
        e["u_diff"] = float(diff.double().mean())
        w = wells["s_smooth_costates"]
        e["u_diff_well_posed"] = float(diff[..., w].double().mean()) \
            if bool(w.any()) else 0.0
    return e


def f64_bound(name: str, spread: float) -> float:
    """The bound of a held number of f64_lane_numbers, from the same number
    of the plain version's card run against its CPU run."""
    if name.endswith("_well_posed") and not name.startswith("u_diff"):
        return F64_BOUND
    if name == "s_plus":
        return F64_BOUND
    floor = 0.0 if "diff" in name or "mismatch" in name else F64_BOUND
    return max(floor, F64_SPREAD_FACTOR * spread)


def ulp_perturbed(args, seed=0):
    """Every value of ``args`` moved up or down, at random, by the dtype's
    epsilon relative (a value 0 or NaN stays): the inputs as rounding could
    have left them."""
    g = torch.Generator(device=args[0].device).manual_seed(seed)
    sign = lambda a: (2 * torch.randint(0, 2, a.shape, generator=g,
                                        device=a.device) - 1).to(a.dtype)
    return [a * (1 + sign(a) * torch.finfo(a.dtype).eps) for a in args]


def f64_lane_holds(launches, fails):
    """Each recorded double ekf3 / ekf6 launch, (kernel, arguments,
    keywords, outputs), against the plain version on the same inputs on
    the card, held as F64_BOUND's comment says; the plain version's runs on
    the CPU and on inputs one ulp off set the well-posed lanes, the CPU run
    the spread bounds. Each mutant must exceed a bound. Returns the
    readings, one a launch."""
    out = []
    for i, (kn, args, kw, got) in enumerate(launches):
        plain = KERNELS[kn]["plain"]
        ref = plain(*args, **kw)
        dev = ref[0].device
        others = [[r.to(dev) for r in plain(*(a.cpu() for a in args), **kw)],
                  list(plain(*ulp_perturbed(args, i), **kw))]
        T, B = args[0].shape[0], args[0].shape[-1]
        wells, agree = {}, {}
        for n, (j, lo, hi) in F64_OUTPUTS[kn].items():
            ok = []
            for o in others:
                err, finite, _ = lane_errs(ref[j][:, lo:hi], o[j][:, lo:hi])
                ok.append(finite & (err <= F64_WELL_POSED))
            wells[n], agree[n] = ok[0] & ok[1], ok[0]
        note = ""
        if kn == "ekf6":
            costates = torch.ones_like(wells["s_plus"])
            for o in others:
                costates &= lane_errs(ref[0][:, 3:], o[0][:, 3:])[1]
            states = "s_smooth_states"
            wells[states] &= costates
            # lanes that the CPU run passes and a rounding of the inputs
            # does not, and their epsilons
            moved = agree[states] & ~wells[states]
            eps = args[3][4][moved]
            note = (f" (states that rounding moves, or costates not finite: "
                    f"{int(moved.sum())} lanes" + (
                        f", epsilon {float(eps.min()):.17g} .. "
                        f"{float(eps.max()):.17g}" if eps.numel() else "")
                    + ")")
        # two correct runs' distance: the CPU run's (the run on inputs one
        # ulp off answers other inputs: it prescribes ~18% of the cells
        # otherwise, three times as many)
        spread = f64_lane_numbers(kn, ref, others[0], wells)
        bounds = {n: f64_bound(n, v) for n, v in spread.items()}
        e = f64_lane_numbers(kn, got, ref, wells)
        tag = f"{kn} launch {i} T={T} B={B}"
        for n, b in bounds.items():
            if not e[n] <= b:
                fails.append(f"{tag} {n} {e[n]:.3e} > {b:.3e}")
        R = R_REGIONS
        smoothed = [j for n, (j, _, _) in F64_OUTPUTS[kn].items()
                    if n.startswith("s_smooth")][:1]
        w = wells["s_smooth_states" if kn == "ekf6" else "s_smooth"]
        b0 = int(torch.nonzero(w)[0]) if bool(w.any()) else 0

        def block_day_off(outs, only=None, b0=b0):
            res = []
            for j, x in enumerate(outs):
                y = x
                if only is None or j in only:
                    y = x.clone()
                    y[..., b0:b0 + 32] = torch.roll(x[..., b0:b0 + 32], 1,
                                                    dims=0)
                res.append(y)
            return res
        each = lambda f: lambda outs: [f(x) for x in outs]
        shift = {"regions_rolled": each(lambda x: torch.roll(x, 1, dims=-1)),
                 "day_off": each(lambda x: torch.roll(x, 1, dims=0)),
                 "block_day_off": block_day_off,
                 "block_day_off_smoothed": lambda outs: block_day_off(
                     outs, smoothed)}
        if kn == "ekf6" and B > R:
            shift["epsilon_off"] = each(lambda x: torch.roll(x, R, dims=-1))
        mutants = {}
        for m, f in shift.items():
            mutants[m] = f64_lane_numbers(kn, got, f(list(ref)), wells)
            if not any(mutants[m][n] > b for n, b in bounds.items()):
                fails.append(f"{tag}: mutant {m} reads {mutants[m]}, within "
                             f"the bounds {bounds}")
        shares = {n: float(w.double().mean()) for n, w in wells.items()}
        log(f"f64 hold {tag}: well-posed lanes "
            + " ".join(f"{n} {v:.4f}" for n, v in shares.items())
            + note + "; "
            + " ".join(f"{n}={e[n]:.3e} (bound {bounds[n]:.3e})"
                       for n in e))
        out.append(dict(kernel=kn, T=T, B=B, errs=e, bounds=bounds,
                        spread=spread, well_posed_share=shares,
                        mutants=mutants))
    return out


def device_time(run, wall):
    """Device busy time of one more main-path run under torch.profiler, as
    a share of the warm (unprofiled) wall, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
    # kernels and copies only: the host ops that launch them carry the
    # same device time again
    events = sorted((e for e in prof.key_averages()
                     if str(e.device_type).endswith("CUDA")),
                    key=dev, reverse=True)
    busy_ms = sum(dev(e) for e in events) / 1e3
    if busy_ms == 0:
        log("device time: not measured (the profiler saw no device time)")
        return
    log(f"device busy (profiled run): {busy_ms:.3f} ms = "
        f"{busy_ms / 1e3 / wall:.4f} of the warm wall (idle "
        f"{1 - busy_ms / 1e3 / wall:.4f}); device launches "
        f"{sum(e.count for e in events)}")
    for e in events[:8]:
        log(f"  {dev(e) / 1e3:9.3f} ms x{e.count:6d}  {e.key[:90]}")


def backtest_regression(device, seed: int = 0):
    """The round-2 regression of backtest_phase's training at its size: the
    port's synthetic regions (xprize_inputs, drawn from ``seed``) over
    T_HIST - BT_STARTS days, trained by train_regions at backtest_phase's
    configuration with every day a regression day, as
    forecast_quality_assessment trains, float32 on ``device``. Returns
    (X (235, 380, 12), y (235, 380), a strided view)."""
    T = T_HIST - BT_STARTS
    bt, _, _, _ = xprize_inputs(R_REGIONS, T, HORIZON, seed)
    cfg = PipelineConfig(backend="pallas", smoother_gain="solve")
    out = train_regions(bt, MINS, NPI_MAXES_DEFAULT, T, cfg, dtype=F32,
                        device=device)
    bt_d, _, _ = device_batch(bt, F32, device)
    X = to_tensor(NPI_MAXES_DEFAULT, F32, device)[None, None, :] - bt_d.npis
    return X, out.s_smooth_round2[:, :, 2]


def nnls_sse(X, y, a, b):
    """Each problem's squared residual ||y - X a - b||^2, in float64."""
    X, y, a, b = (t.double() for t in (X, y, a, b))
    return torch.sum((y - (X @ a[..., None])[..., 0] - b[:, None]) ** 2, -1)


def nnls_agreement(X, y, got, want) -> dict:
    """Two NNLS-with-intercept solutions (a, b) of the same problems: how
    many problems' supports (a > 0) differ, the largest coefficient and
    intercept differences where they agree, and the largest relative gap
    of a problem's squared residual (nnls_sse). A support that differs is
    a co-optimal solution, not a divergence, when its residual matches the
    other's (tests/test_backend_fuzz.py's certificate, on equal
    problems)."""
    (a_g, b_g), (a_w, b_w) = got, want
    same = ((a_g > 0) == (a_w > 0)).all(-1)
    s_g, s_w = nnls_sse(X, y, a_g, b_g), nnls_sse(X, y, a_w, b_w)
    err = lambda d: float(d[same].abs().max()) if bool(same.any()) else 0.0
    return dict(flips=int((~same).sum()),
                a_err=err((a_g - a_w).double()),
                b_err=err((b_g - b_w).double()[:, None]),
                sse_gap=float(((s_g - s_w).abs()
                               / s_w.clamp_min(1e-300)).max()))


def nnls_counts(device, seed: int = 0):
    """The NNLS kernel against its plain version on the card, float32, on
    backtest_phase's round-2 regression (backtest_regression): every
    problem's squared residual within NNLS_F32_SSE_GAP of the plain
    version's, which certifies a support that differs as co-optimal
    (nnls_agreement), both timed with CUDA events beside the kernel's byte
    bound (X and y read once, a and b written once); the kernel's
    per-problem iteration totals and launches beside the plain version's
    batched loop trips and host syncs. Returns the kernel's measurements
    for its kernels-line entry."""
    X, y = backtest_regression(device, seed)
    R, n, p = X.shape
    reset_launches()
    with recording() as rk:
        got = nnls_with_intercept(X, y)
    launched = read_launches()
    with recording() as rp:
        want = nnls_with_intercept_plain(X, y)
    agree = nnls_agreement(X, y, got, want)
    ms = cuda_ms(lambda: nnls_with_intercept(X, y))
    plain_ms = cuda_ms(lambda: nnls_with_intercept_plain(X, y), reps=3)
    bound_ms = 4 * (R * n * (p + 1) + R * (p + 1)) / PEAK_BYTES_PER_S * 1e3
    log(f"nnls kernel [backtest round-2 regression] {R} x {n} x {p} "
        f"float32: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, byte bound "
        f"{bound_ms:.5f} ms; kernel vs plain {agree}; kernel counters "
        f"{rk.counters}, plain counters {rp.counters}; launches "
        f"{launched} a regression")
    check(rk.counters.get("host_sync") == 0 and launched["nnls"] == 1
          and sum(launched.values()) == 1,
          f"the NNLS kernel's route synced or launched again: {rk.counters}"
          f", launches {launched}")
    check(agree["sse_gap"] <= NNLS_F32_SSE_GAP,
          f"the NNLS kernel's residuals part from the plain version's: "
          f"{agree}")
    return dict(max_abs_err=max(agree["a_err"], agree["b_err"]),
                sse_gap=agree["sse_gap"], support_flips=agree["flips"],
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None,
                lane_counters={k: v for k, v in rk.counters.items()
                               if k.startswith("nnls.lane_")},
                shape=f"R={R} n={n} p={p} float32 (backtest round-2 "
                      "regression)")


def si_rollout_chunk(device, dtype):
    """(s0, params, u, noise, out) of the rollout kernel at a sweep chunk of
    the main path: 25 x 235 lanes, H = 92, P = 12, the prescription
    batch-last (H, P, lanes) as ekf6 leaves it, the trajectory written into
    the horizon of (E, R, T_HIST + H) buffers, no noise."""
    R, H, G = R_REGIONS, HORIZON, CHUNK
    g = torch.Generator().manual_seed(11)
    s0, p = rollout_params(R, dtype, 0, device)
    u_bl = npi_levels(g, (H, G * R, 12), dtype, device).permute(0, 2, 1)
    u = u_bl.contiguous().reshape(H, 12, G, R).permute(2, 3, 0, 1)
    out = tuple(torch.empty((G, R, T_HIST + H), dtype=dtype,
                            device=device)[..., T_HIST:] for _ in range(3))
    return s0, p, u, None, out


def si_rollout_counts(device):
    """The rollout kernel against its plain version on the card at a sweep
    chunk's shape (si_rollout_chunk), in float64 (the
    xprize-pipeline-f64 cell's) and float32 (the xprize-phase2 path's):
    each lane's horizon sum and every trajectory field within
    SI_ROLLOUT_BOUNDS, one launch a call; the kernel timed back to back
    (SI_ROLLOUT_REPS calls between CUDA events, so the wrapper's host time
    overlaps the card's) and one call alone, the plain version once, beside
    the bound: the prescription read and the trajectory written once, or
    SI_ROLLOUT_OPS a lane-step at the dtype's peak, the larger. Returns the
    kernels-line entry (float64) with the float32 readings under
    ``f32``."""
    entry = {}
    for dtype in (torch.float64, F32):
        args = si_rollout_chunk(device, dtype)
        s0, p, u, _, out = args
        G, R, H, P = u.shape
        reset_launches()
        got = rollout_kernel.rollout(*args)
        check(read_launches()["rollout"] == 1,
              "rollout kernel: one launch a call expected")
        ref_out = tuple(torch.empty_like(o) for o in out)
        want = rollout_kernel.rollout_plain(s0, p, u, None, ref_out)
        errs = {"cases": scaled_err(got, want),
                **{f: scaled_err(a, b) for f, a, b in
                   zip(("s", "i", "alpha"), out, ref_out)}}
        calls = lambda: [rollout_kernel.rollout(*args)
                         for _ in range(SI_ROLLOUT_REPS)]
        ms = cuda_ms(calls) / SI_ROLLOUT_REPS
        call_ms = cuda_ms(lambda: rollout_kernel.rollout(*args))
        plain_ms = cuda_ms(lambda: rollout_kernel.rollout_plain(*args),
                           reps=3)
        w = u.element_size()
        bound_ms, bound_by = bound(
            w * (G * R * H * (P + 3) + G * R + R * (3 + 9 + 2 * P)),
            SI_ROLLOUT_OPS * G * R * H,
            PEAK_F64_PER_S if dtype == torch.float64 else PEAK_F32_PER_S)
        name = str(dtype).replace("torch.", "")
        log(f"kernel rollout [sweep chunk] {G} x {R} lanes, H={H}, P={P}, "
            f"{name}: kernel {ms:.4f} ms a call back to back ({call_ms:.4f} "
            f"alone), plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms "
            f"({bound_by}); kernel vs plain {errs}")
        check(all(bool(torch.isfinite(o).all()) for o in (got, *out)),
              f"rollout kernel {name}: a non-finite output")
        check(max(errs.values()) <= SI_ROLLOUT_BOUNDS[dtype],
              f"rollout kernel {name}: {errs} above "
              f"{SI_ROLLOUT_BOUNDS[dtype]}")
        entry[name] = dict(
            max_abs_err=max(errs.values()), ms=ms, call_ms=call_ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None,
            shape=f"G={G} R={R} H={H} P={P} {name} (sweep chunk)")
    return dict(entry["float64"], f32=entry["float32"])


def stencil_phase(device):
    """The stencil kernel against its plain version on fields in [0, 1),
    both schemes, at STENCIL_SHAPES; kernel, plain version and the conv2d
    yardstick timed at STENCIL_TIMED. Returns one dict per case."""
    ax = STENCIL_D * STENCIL_DT / STENCIL_DX ** 2
    ay = STENCIL_D * STENCIL_DT / STENCIL_DY ** 2
    axy8 = STENCIL_D * STENCIL_DT / (STENCIL_DX ** 2 + STENCIL_DY ** 2)
    gen = torch.Generator(device).manual_seed(5)
    out = []
    for shape in STENCIL_SHAPES:
        C = torch.rand(shape, generator=gen, device=device)
        for eight in (False, True):
            axy = axy8 if eight else 0.0
            got = stencil_kernel.stencil(C, ax, ay, axy)
            ref = stencil_kernel.stencil_plain(C, ax, ay, axy)
            torch.cuda.synchronize()
            check(got.device == device and got.dtype == F32,
                  f"stencil {shape}: output not float32 on {device}")
            m = dict(shape=shape, eight=eight,
                     abs_err=float(torch.abs(got - ref).max()), ms=None)
            line = (f"kernel stencil [{shape[0]}x{shape[1]}, "
                    f"{8 if eight else 4}-neighbour]: "
                    f"max_abs_err={m['abs_err']:.3e}")
            if shape in STENCIL_TIMED:
                m["ms"] = cuda_ms(lambda: stencil_kernel.stencil(
                    C, ax, ay, axy), reps=20)
                m["plain_ms"] = cuda_ms(lambda: stencil_kernel.stencil_plain(
                    C, ax, ay, axy))
                m["library_ms"], lib_err = conv2d_yardstick(C, ax, ay, axy,
                                                            ref)
                m["bound_ms"], m["bound_by"] = bound(
                    2 * 4 * shape[0] * shape[1],
                    STENCIL_OPS[eight] * (shape[0] - 2) * (shape[1] - 2))
                line += (f" kernel_ms={m['ms']:.4f} "
                         f"plain_ms={m['plain_ms']:.4f} "
                         f"conv2d_ms={m['library_ms']:.4f} "
                         f"(conv2d vs plain interior {lib_err:.2e}) "
                         f"bound_ms={m['bound_ms']:.4f} ({m['bound_by']})")
            log(line)
            check(m["abs_err"] <= STENCIL_BOUND,
                  f"stencil {shape} eight={eight}: {m['abs_err']:.3e} > "
                  f"{STENCIL_BOUND}")
            out.append(m)
    return out


def multistep_phase(device):
    """The multi-step kernel: at MULTI_SHAPES, float32 and float64, both
    schemes, 3K + 1 steps (K steps a launch, so four launches, the last of
    one step), without and with a dense source stack, its frames equal the
    one-step kernel's loop bit for bit (each cell is the same expression
    in the same order) and the plain version within STENCIL_BOUND (float32;
    float64 at 1e-12 relative); then sparse injections with duplicate cells
    against the plain version on the CPU. Returns one dict per case."""
    ax = STENCIL_D * STENCIL_DT / STENCIL_DX ** 2
    ay = STENCIL_D * STENCIL_DT / STENCIL_DY ** 2
    axy8 = STENCIL_D * STENCIL_DT / (STENCIL_DX ** 2 + STENCIL_DY ** 2)
    gen = torch.Generator(device).manual_seed(6)
    out = []
    for dt in (F32, torch.float64):
        k = stencil_kernel.STEPS_PER_LAUNCH[dt]
        n = 3 * k + 1
        bound_ = STENCIL_BOUND if dt == F32 else 1e-12
        for shape in MULTI_SHAPES:
            C = torch.rand(shape, generator=gen, device=device, dtype=dt)
            src = 1e-2 * torch.rand((n,) + shape, generator=gen,
                                    device=device, dtype=dt)
            for eight in (False, True):
                w = (ax, ay, axy8 if eight else 0.0)
                for sources in (None, src):
                    frames = torch.empty((n,) + shape, dtype=dt,
                                         device=device)
                    before = stencil_kernel.launches
                    stencil_kernel.stencil_rollout(C, n, w, sources=sources,
                                                   frames=frames)
                    launched = stencil_kernel.launches - before
                    cur, loop = C, []
                    for t in range(n):
                        x = cur if sources is None else cur + sources[t]
                        cur = stencil_kernel.stencil(x, *w)
                        loop.append(cur)
                    plain = stencil_kernel.stencil_rollout_plain(
                        C, n, w, sources=sources)
                    torch.cuda.synchronize()
                    bitwise = torch.equal(frames, torch.stack(loop))
                    err = float(torch.abs(frames[-1] - plain).max())
                    rel = err / float(torch.abs(plain).max())
                    tag = (f"{shape[0]}x{shape[1]} {str(dt)[6:]} "
                           f"{8 if eight else 4}-neighbour "
                           f"{'dense sources' if sources is not None else 'no sources'}")
                    log(f"kernel stencil multi-step [{tag}, {n} steps]: "
                        f"launches={launched} equal to the one-step loop bit "
                        f"for bit: {bitwise}; vs plain max_abs_err={err:.3e}")
                    check(launched == -(-n // k),
                          f"multi-step {tag}: {launched} launches")
                    check(bitwise, f"multi-step {tag}: frames differ from "
                                   "the one-step loop")
                    check((err if dt == F32 else rel) <= bound_,
                          f"multi-step {tag}: {err:.3e} from the plain "
                          "version")
                    out.append(dict(abs_err=err if dt == F32 else 0.0))
    # sparse injections: 64 walkers a step over 3K + 1 steps, a third of
    # them on one cell (duplicates sum in walker order), some on the
    # boundary and some switched off (cell -1)
    rng = np.random.default_rng(8)
    n = 3 * stencil_kernel.STEPS_PER_LAUNCH[F32] + 1
    L = INJECT_L
    cells = rng.integers(0, L * L, (n, INJECT_W))
    cells[:, ::3] = cells[:, :1]
    cells[:, 1] = rng.integers(0, L, n)          # row 0, the boundary
    cells[::2, 2] = -1
    cells = torch.tensor(cells, dtype=torch.int32, device=device)
    amounts = torch.rand((n, INJECT_W), generator=gen, device=device)
    C = torch.rand((L, L), generator=gen, device=device)
    got = stencil_kernel.stencil_rollout(C, n, (ax, ay, axy8), cells=cells,
                                         amounts=amounts)
    ref = stencil_kernel.stencil_rollout_plain(
        C.cpu(), n, (ax, ay, axy8), cells=cells.cpu(), amounts=amounts.cpu())
    err = float(torch.abs(got.cpu() - ref).max())
    log(f"kernel stencil multi-step [{L}x{L} float32 8-neighbour, "
        f"{INJECT_W} injections a step with duplicates, {n} steps]: vs "
        f"plain (CPU, walker order) max_abs_err={err:.3e}")
    check(err <= STENCIL_BOUND, f"sparse injections: {err:.3e} from the "
                                "plain version")
    out.append(dict(abs_err=err))
    return out


def conv2d_yardstick(C, ax, ay, axy, ref):
    """One torch.nn.functional.conv2d with the 3 x 3 weights over the
    interior, TF32 off: its time (ms) and its largest difference from the
    plain version's interior. A yardstick only: the port never calls it."""
    c0 = 1.0 - 2.0 * ax - 2.0 * ay - 4.0 * axy
    w = torch.tensor([[axy, ax, axy], [ay, c0, ay], [axy, ax, axy]],
                     dtype=C.dtype, device=C.device)[None, None]
    x = C[None, None]
    conv = lambda: torch.nn.functional.conv2d(x, w)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ms = cuda_ms(conv, reps=20)
        err = float(torch.abs(conv()[0, 0] - ref[1:-1, 1:-1]).max())
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return ms, err


def rollout_bound_ms(L: int, sources: bool) -> float:
    """Least time of one rollout step at L x L float32 that keeps its
    frame: one write of the frame, plus one read of the step's source."""
    return bound((2 if sources else 1) * 4 * L * L,
                 STENCIL_OPS[True] * (L - 2) ** 2)[0]


def rollout_phase(device):
    """diffusion_rollout on the card without device=, both schemes, at the
    example's parameters on a 2048 x 2048 field with the reference's two
    point sources (testCellularAutomataForPDESolution.m:25-26), without and
    with a dense source stack (ROLLOUT_SOURCE a step at the first source
    cell), each cold then warm from the example's NumPy field, then warm
    from the same field already on the card (the NumPy field's float64 copy
    to the card is part of the first two walls). Returns the warm walls by
    case and input."""
    L = ROLLOUT_L
    C0 = np.zeros((L, L))
    C0[round(L / 2) - 1, round(L / 2) - 1] = 1.0
    C0[round(L / 3) - 1, round(L / 4) - 1] = 1.0
    C0_card = torch.tensor(C0, dtype=F32, device=device)
    src = torch.zeros((ROLLOUT_STEPS, L, L), dtype=F32, device=device)
    src[:, round(L / 2) - 1, round(L / 2) - 1] = ROLLOUT_SOURCE
    k = stencil_kernel.STEPS_PER_LAUNCH[F32]
    walls = {}
    for nb in (4, 8):
        for sources in (None, src):
            case = f"{nb}-neighbour{'' if sources is None else ', sources'}"
            for tag, field in (("cold", C0), ("warm", C0),
                               ("warm, field on the card", C0_card)):
                reset_launches()
                t0 = time.perf_counter()
                traj = diffusion_rollout(field, 1e-1, 0.01, 0.1, 0.1,
                                         ROLLOUT_STEPS, neighborhood=nb,
                                         sources=sources, dtype=F32)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                n = read_launches()
                # the support grows one cell per step and never reaches the
                # frozen boundary, so the interior mass is 2 plus what the
                # sources added
                mass = 2.0 + ROLLOUT_SOURCE * torch.arange(
                    ROLLOUT_STEPS + 1, device=device, dtype=torch.float64
                ) * (sources is not None)
                mass_err = float(torch.abs(traj.sum(dim=(1, 2)) / mass
                                           - 1.0).max())
                per_step = wall / ROLLOUT_STEPS * 1e3
                log(f"diffusion_rollout {L}x{L} x {ROLLOUT_STEPS} steps, "
                    f"{case}, {tag}: wall={wall:.4f}s ({per_step:.4f} "
                    f"ms/step; bound {rollout_bound_ms(L, sources is not None):.4f}"
                    f" ms/step) mass_rel_err={mass_err:.2e} launches={n}")
                check(traj.device == device
                      and tuple(traj.shape) == (ROLLOUT_STEPS + 1, L, L),
                      "rollout: trajectory not (steps + 1, L, L) on "
                      f"{device}")
                check(bool(torch.isfinite(traj).all()),
                      "rollout: non-finite field")
                check(mass_err <= 1e-4, f"rollout: mass {mass_err:.2e} > "
                                        "1e-4")
                check(n["stencil"] <= -(-ROLLOUT_STEPS // k),
                      f"rollout: {n['stencil']} stencil launches, expected "
                      f"at most ceil({ROLLOUT_STEPS} / {k})")
                del traj
                walls[f"{case}, {tag}"] = wall
    return walls


def walkers_phase(device):
    """walking_sources_sim on the card without device=, cold then warm (the
    cold call also loads the PyTorch kernels it is the first to use)."""
    injected = WALKERS * WALK_STEPS * 1.0
    for tag in ("cold", "warm"):
        reset_launches()
        t0 = time.perf_counter()
        C, traj = walking_sources_sim(
            WALK_L, WALK_L, WALKERS, WALK_STEPS, 1e-2, 0.01, 0.1, 0.1, 1.0,
            torch.Generator(device).manual_seed(0), dtype=F32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = read_launches()
        total = float(C.sum(dtype=torch.float64))
        log(f"walking_sources_sim {tag} {WALK_L}x{WALK_L}, {WALKERS} walkers "
            f"x {WALK_STEPS} steps: wall={wall:.4f}s mass={total:.3f} of "
            f"{injected:.0f} injected launches={n}")
    check(C.device == device and traj.device == device,
          f"walkers: output not on {device}")
    check(tuple(traj.shape) == (WALK_STEPS, WALKERS, 2), "walkers: shape")
    check(bool(torch.isfinite(C).all() and (C >= 0).all()),
          "walkers: field not finite and >= 0")
    check(0 < total <= injected * (1 + 1e-5),
          f"walkers: mass {total} not in (0, {injected}]")
    k = stencil_kernel.STEPS_PER_LAUNCH[F32]
    check(n["stencil"] <= -(-WALK_STEPS // k),
          f"walkers: {n['stencil']} stencil launches, expected at most "
          f"ceil({WALK_STEPS} / {k})")
    return wall


def sim_phase(device):
    """population_motion_sim at N = 20,000 in the default environment on
    the card without device=, cold then warm, then once more under
    torch.profiler. Returns (the warm result, its launch counts)."""
    cfg = PopulationSimConfig(n_subjects=SIM_N, force_backend="pallas")

    def run():
        reset_launches()
        t0 = time.perf_counter()
        res = population_motion_sim(cfg, SIM_STEPS,
                                    torch.Generator(device).manual_seed(0),
                                    dtype=F32)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, read_launches()

    for tag in ("cold", "warm"):
        res, wall, n = run()
        log(f"population_motion_sim {tag}: N={SIM_N} steps={SIM_STEPS} "
            f"wall={wall:.3f}s ({wall / SIM_STEPS * 1e3:.3f} ms/step) "
            f"launches={n}")
    device_time(run, wall)
    # float32 clips: a limit rounds to the nearest float32, up to 1e-7 over
    slack = 1 + 1e-6
    p, v, a = res.p, res.v, res.a
    check(all(t.device == device for t in res),
          f"sim: output not on {device}")
    check(tuple(p.shape) == (SIM_STEPS, SIM_N, 2), "sim: shape")
    check(bool((p[..., 0] >= cfg.x_min).all() and (p[..., 1] >= cfg.y_min)
               .all() and (p[..., 0] <= cfg.x_max * slack).all()
               and (p[..., 1] <= cfg.y_max * slack).all()),
          "sim: a position left the arena")
    check(bool((v.abs() <= cfg.v_max * slack).all()), "sim: |v| > v_max")
    check(bool((a.abs() <= cfg.a_max * slack).all()), "sim: |a| > a_max")
    check(bool(torch.isfinite(res.C).all()) and float(res.C.sum()) > 0,
          "sim: field not finite with a positive sum")
    check(n["pairwise"] == SIM_STEPS and n["stencil"] == SIM_STEPS,
          f"sim: launches {n}, expected pairwise {SIM_STEPS}, stencil "
          f"{SIM_STEPS} (one two-step launch a sim step)")
    return res, n


def law_rows(pos, obs, cfg, rows):
    """The plain float32 law on the agents ``rows``, ROW_CHUNK rows at a
    time: (forces (R, 2), the rows' scale sum_k |t_k| (R, 2), their slack
    for terms at a discontinuity of the law (R, 1))."""
    src = torch.cat([pos, obs])
    N, M = pos.shape[0], src.shape[0]
    subject = torch.arange(M, device=pos.device) < N
    w = torch.where(subject, abs(cfg.subject_subject_weight),
                    abs(cfg.subject_obstacle_weight))
    opt, cut = cfg.inter_subject_opt_dist, cfg.no_further_effect_dist
    f, scale, slack = [], [], []
    for part in rows.split(ROW_CHUNK):
        tx, ty = pairwise_kernel.pair_terms(pos, obs, cfg, part)
        f.append(torch.stack([tx.sum(dim=1), ty.sum(dim=1)], dim=-1))
        scale.append(torch.stack([tx.abs().sum(dim=1), ty.abs().sum(dim=1)],
                                 dim=-1))
        d = torch.cdist(pos[part], src,
                        compute_mode="donot_use_mm_for_euclid_dist")
        near = (((d - opt).abs() <= BOUNDARY_REL * opt) & subject
                | ((d - cut).abs() <= BOUNDARY_REL * cut))
        slack.append(torch.where(near, 2 * w / d ** 2, 0.0)
                     .sum(dim=1, keepdim=True))
    return torch.cat(f), torch.cat(scale), torch.cat(slack)


def row_err(a, b, scale, slack=0.0) -> float:
    """The largest (|a - b| - slack) / scale over rows and components."""
    scale = torch.clamp_min(scale, torch.finfo(F32).tiny)
    return float((torch.clamp_min(torch.abs(a - b) - slack, 0.0)
                  / scale).max())


def hold_pairwise(tag, got, ref, pos, obs, cfg, rows):
    """The kernel's forces ``got`` on ``rows`` against the plain version's
    ``ref``, row by row on each row's scale; the same reading of each
    mutant of the plain law against ``ref``; and, as a statistic, the
    largest error over the largest force. Logs one line; returns a dict."""
    _, scale, slack = law_rows(pos, obs, cfg, rows)
    abs_err = float(torch.abs(got - ref).max())
    m = dict(tag=tag, N=pos.shape[0], O=obs.shape[0], rows=len(rows),
             abs_err=abs_err, row_err=row_err(got, ref, scale, slack),
             scaled_err=abs_err / float(torch.abs(ref).max()), ms=None,
             mutants={name: row_err(law_rows(pos, *mutant(obs, cfg),
                                             rows)[0], ref, scale, slack)
                      for name, mutant in PAIRWISE_MUTANTS.items()})
    log(f"kernel pairwise [{tag}, N={m['N']}, O={m['O']}, {m['rows']} "
        f"rows]: row_err={m['row_err']:.3e} (bound {PAIRWISE_ROW_BOUND}; "
        f"{row_err(got, ref, scale):.3e} without slack, "
        f"{int((slack > 0).sum())} rows with a boundary pair) "
        f"max_abs_err={abs_err:.3e} max_abs_err/max|F|="
        f"{m['scaled_err']:.3e}; mutants' row_err: "
        + " ".join(f"{n}={v:.3e}" for n, v in m["mutants"].items()))
    return m


def pairwise_phase(device, sim_p):
    """The pairwise kernel against its plain version at N = 20,000 in the
    default environment: uniform positions (timed) and frames of the sim's
    trajectory; then the kernel alone at N = 100,000 (timed), with sampled
    rows held against the plain law for those rows. Every case is held row
    by row at PAIRWISE_ROW_BOUND, and every mutant must read above it.
    Returns one dict per case."""
    cfg = PopulationSimConfig(n_subjects=SIM_N)
    _, obs_np = default_environment(cfg)
    obs = torch.tensor(obs_np, dtype=F32, device=device)
    O = obs.shape[0]
    gen = torch.Generator(device).manual_seed(7)
    lo = torch.tensor([cfg.x_min, cfg.y_min], device=device)
    span = torch.tensor([cfg.x_max - cfg.x_min, cfg.y_max - cfg.y_min],
                        device=device)
    uniform = lambda n: lo + span * torch.rand((n, 2), generator=gen,
                                               device=device)
    cases = [("uniform", uniform(SIM_N))] + [
        (f"sim step {t}", sim_p[t].contiguous()) for t in SIM_FRAMES]
    out = []
    for tag, pos in cases:
        got = pairwise_kernel.social_forces(pos, obs, cfg)
        again = pairwise_kernel.social_forces(pos, obs, cfg)
        ref = pairwise_kernel.social_forces_plain(pos, obs, cfg)
        torch.cuda.synchronize()
        check(got.device == device and bool(torch.isfinite(got).all()),
              f"pairwise {tag}: output not finite on {device}")
        check(torch.equal(got, again),
              f"pairwise {tag}: two launches differ (the sums' order is "
              "fixed, so they must not)")
        m = hold_pairwise(tag, got, ref, pos, obs, cfg,
                          torch.arange(SIM_N, device=device))
        del ref
        if tag == "uniform":
            m["ms"] = cuda_ms(lambda: pairwise_kernel.social_forces(
                pos, obs, cfg))
            m["plain_ms"] = cuda_ms(
                lambda: pairwise_kernel.social_forces_plain(pos, obs, cfg))
            m["bound_ms"], m["bound_by"] = bound(
                4 * (2 * SIM_N + 2 * O + 2 * SIM_N),
                PAIR_OPS * SIM_N * (SIM_N + O))
            log(f"kernel pairwise [uniform, N={SIM_N}, O={O}]: "
                f"kernel_ms={m['ms']:.3f} plain_ms={m['plain_ms']:.3f} "
                f"bound_ms={m['bound_ms']:.4f} ({m['bound_by']})")
        out.append(m)

    cfg_big = PopulationSimConfig(n_subjects=BIG_N)
    pos = uniform(BIG_N)
    ms = cuda_ms(lambda: pairwise_kernel.social_forces(pos, obs, cfg_big))
    got = pairwise_kernel.social_forces(pos, obs, cfg_big)
    check(bool(torch.isfinite(got).all()), "pairwise N=100k: non-finite")
    check(torch.equal(got, pairwise_kernel.social_forces(pos, obs, cfg_big)),
          "pairwise N=100k: two launches differ")
    rows = torch.randperm(BIG_N, generator=gen, device=device)[:BIG_ROWS]
    ref = law_rows(pos, obs, cfg_big, rows)[0]
    out.append(hold_pairwise("uniform, sampled", got[rows], ref, pos, obs,
                             cfg_big, rows))
    big_bound, big_by = bound(4 * (4 * BIG_N + 2 * O),
                              PAIR_OPS * BIG_N * (BIG_N + O))
    log(f"kernel pairwise [uniform, N={BIG_N}, O={O}]: kernel_ms={ms:.3f} "
        f"bound_ms={big_bound:.4f} ({big_by}); two launches bitwise equal")
    out[-1].update(big_ms=ms, big_bound_ms=big_bound)
    for m in out:
        check(m["row_err"] <= PAIRWISE_ROW_BOUND,
              f"pairwise {m['tag']} N={m['N']}: row_err {m['row_err']:.3e} "
              f"> {PAIRWISE_ROW_BOUND}")
        for name, v in m["mutants"].items():
            check(v > PAIRWISE_ROW_BOUND,
                  f"pairwise {m['tag']} N={m['N']}: mutant {name} reads "
                  f"{v:.3e} <= {PAIRWISE_ROW_BOUND}, the bound cannot tell "
                  "it from the kernel")
    return out


def copy_check_sizes(sms: int) -> list:
    """n (float32) at the copy's schedule edges on a card of ``sms`` SMs:
    one vector, one chunk and one full wave of chunks (a chunk for every
    block), each +- 4 floats, two waves and a bit, a size with no round
    factor, and 2**28 (1 GiB)."""
    chunk = roofline_kernel.CHUNK_BYTES // 4
    wave = roofline_kernel.BLOCKS_PER_SM * sms * chunk
    return [4, chunk - 4, chunk, chunk + 4, wave - 4, wave, wave + 4,
            2 * wave + 12, 4 * 3_000_017, 1 << 28]


def copy_into(lib, x, out) -> None:
    """x + 1 into ``out`` through a library's C entry roofline_copy (no
    launch counted)."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(lib, "roofline", "roofline_copy",
                lib.roofline_copy(x.data_ptr(), out.data_ptr(), x.numel(),
                                  stream))


def turns_ms(runs: dict, reps: int) -> dict:
    """Each of ``runs`` timed in turns, ``reps`` times: a round calls them
    in order, the next in reverse, one CUDA-event pair around each call
    (after a warm call of each). Returns {name: [ms, ...]}."""
    for fn in runs.values():
        fn()
    torch.cuda.synchronize()
    names = list(runs)
    times = {name: [] for name in names}
    for r in range(reps):
        for name in names if r % 2 == 0 else names[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            runs[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return times


def ptxas_usage(report: str, kernel: str, what: str = "registers") -> str:
    """A -Xptxas -v line of the kernel whose mangled name holds ``kernel``:
    "Used ... registers, ..." (what="registers") or "... bytes stack frame,
    ... spill stores, ... spill loads" (what="stack frame")."""
    lines = report.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            for nxt in lines[i + 1:]:
                if "Compiling entry function" in nxt:
                    break
                if what in nxt and (what != "registers" or "Used" in nxt):
                    return nxt.split(":", 1)[-1].strip()
    return "not in the ptxas report"


def roofline_phase(device):
    """The card's roofline anchors: a copy (x + 1) of 1 GiB and a 512-deep
    fused multiply-add chain over 128 MiB, each held against its plain
    version and timed. The copy (a persistent ring of TMA bulk copies) is
    first held bit for bit against x + 1 through its C entry, into
    NaN-filled outputs, at every size of copy_check_sizes (ragged chunks
    and waves, 1 GiB) with the library's launch geometry equal to
    roofline_kernel.copy_geometry's; then the wrapper at 1 GiB, and the
    wrapper and x + 1 timed in turns (COPY_TURNS samples each, one call a
    sample, then COPY_BATCH calls back to back a sample). Prints the copy
    rate beside PEAK_BYTES_PER_S, the ratio to x + 1 (a shortfall is
    printed, not failed), the geometry and the kernel's registers, and the
    FMA rate beside PEAK_F32_PER_S. Returns the kernels-line entry of the
    copy (the phase's launches, its error, kernel, plain-version and bound
    times; x + 1 is one PyTorch call, so the library time is the plain
    version's)."""
    reset_launches()
    gen = torch.Generator(device).manual_seed(9)
    lib = build.load("roofline", roofline_kernel._SIGNATURES)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    sizes = copy_check_sizes(sms)
    for n in sizes:
        geo = roofline_kernel.library_copy_geometry(n)
        check(geo == roofline_kernel.copy_geometry(n, sms),
              f"roofline copy n={n}: the library's geometry {geo} is not "
              "roofline_kernel.copy_geometry's")
        x = torch.rand(n, generator=gen, device=device)
        out = torch.full_like(x, float("nan"))
        copy_into(lib, x, out)
        check(torch.equal(out, x + 1),
              f"roofline copy n={n}: differs from x + 1 "
              f"({int((out != x + 1).sum())} elements)")
        del x, out
    log(f"roofline copy: bit for bit x + 1 through the C entry into "
        f"NaN-filled outputs at n = {sizes}")
    x = torch.rand(1 << 28, generator=gen, device=device)
    got = roofline_kernel.copy_plus_one(x)
    copy_err = float((got - roofline_kernel.copy_plus_one_plain(x)).abs()
                     .max())
    check(torch.equal(got, x + 1), "roofline copy: differs from x + 1")
    del got
    copy_bound = bound(2 * 4 * x.numel(), x.numel())
    runs = {"kernel": lambda: roofline_kernel.copy_plus_one(x),
            "x + 1": lambda: roofline_kernel.copy_plus_one_plain(x)}
    times = turns_ms(runs, COPY_TURNS)
    copy_ms, plain_ms = (float(np.median(times[k])) for k in runs)
    # COPY_BATCH calls back to back a sample: the device, not the host's
    # launch path, sets the time
    batched = turns_ms({k: (lambda f=f: [f() for _ in range(COPY_BATCH)])
                        for k, f in runs.items()}, COPY_TURNS)
    b2b_ms, b2b_plain_ms = (float(np.median(batched[k])) / COPY_BATCH
                            for k in runs)
    rate = 2 * 4 * x.numel() / (copy_ms * 1e-3)
    plain_rate = 2 * 4 * x.numel() / (plain_ms * 1e-3)
    geo = roofline_kernel.library_copy_geometry(x.numel())
    usage = ptxas_usage(build.build("roofline")[1], "copy_kernel")
    del x
    y = torch.rand(1 << 25, generator=gen, device=device)
    got, ref = (roofline_kernel.fma_chain(y),
                roofline_kernel.fma_chain_plain(y))
    rel = float((torch.abs(got.double() - ref.double())
                 / torch.abs(ref.double())).max())
    # one rounding to float32 a step, and the plain version's last one
    check(rel <= (roofline_kernel.DEPTH + 1) * 2.0 ** -24,
          f"roofline fma: {rel:.3e} from the float64 plain version")
    fma_ms = cuda_ms(lambda: roofline_kernel.fma_chain(y), reps=5)
    flops = 2 * roofline_kernel.DEPTH * y.numel() / (fma_ms * 1e-3)
    ratio = copy_ms / plain_ms
    log(f"roofline copy 1 GiB (x + 1), in turns, median of {COPY_TURNS} "
        f"each: kernel {copy_ms:.4f} ms = {rate / 1e12:.4f} TB/s "
        f"({rate / PEAK_BYTES_PER_S:.3f} of the "
        f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s bound() assumes; runs "
        f"{min(times['kernel']):.4f}-{max(times['kernel']):.4f}), x + 1 "
        f"{plain_ms:.4f} ms = {plain_rate / 1e12:.4f} TB/s "
        f"({plain_rate / PEAK_BYTES_PER_S:.3f}; runs "
        f"{min(times['x + 1']):.4f}-{max(times['x + 1']):.4f}); kernel / "
        f"x + 1 = {ratio:.4f}; {COPY_BATCH} calls back to back: kernel "
        f"{b2b_ms:.4f} ms a call ({copy_bound[0] / b2b_ms:.3f}"
        f" of its bound), x + 1 {b2b_plain_ms:.4f} ms, kernel / x + 1 = "
        f"{b2b_ms / b2b_plain_ms:.4f}")
    if ratio > 1.0:
        log(f"roofline copy: slower than x + 1 by {ratio - 1:.2%} (printed, "
            "not failed)")
    log(f"roofline copy geometry: {geo.blocks} blocks of "
        f"{roofline_kernel.COPY_THREADS} threads on {sms} SMs, "
        f"{geo.stages} stages of {geo.chunk_bytes} B, {geo.smem_bytes} B "
        f"dynamic shared memory a block; ptxas copy_kernel: {usage}")
    log(f"roofline fma 512-deep over 128 MiB: {fma_ms:.4f} ms = "
        f"{flops / 1e12:.3f} TFLOP/s float32 against {PEAK_F32_PER_S / 1e12:.0f}"
        f" ({flops / PEAK_F32_PER_S:.3f}); max rel err vs float64 plain "
        f"{rel:.3e}")
    b_ms, b_by = copy_bound
    return dict(launches=read_launches()["roofline"], max_abs_err=copy_err,
                ms=copy_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=plain_ms, ratio_to_library=ratio,
                timed_in_turns=COPY_TURNS, back_to_back_ms=b2b_ms,
                back_to_back_library_ms=b2b_plain_ms,
                geometry=geo._asdict(),
                registers=usage, fma_ms=fma_ms, fma_max_rel_err=rel,
                path="chip_smoke.roofline_phase (measures the card; no "
                     "path of the system runs it)",
                shape="copy 1 GiB float32; FMA chain 512-deep over 128 MiB")


def write_cli_csvs():
    """The XPRIZE-size CSVs (235 regions x 532 days, the port's synthetic
    frame, with deaths) and a future-IP plan (every NPI at its maximum over
    the horizon) under CLI_DIR. Returns (the files, the ISO days)."""
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    frame, pops, _ = synthetic_oxford_frame(R_REGIONS, T_HIST + HORIZON,
                                            CLI_START, seed=0)
    files = write_oxford_csvs(CLI_DIR, frame, pops)
    days = date_range_days(CLI_START, T_HIST + HORIZON)
    presc_start = days[T_HIST]
    # the plan: every NPI at its maximum over the whole horizon
    write_csv_columns(CLI_DIR / "future_ip.csv", dict(
        CountryName=pops["CountryName"], RegionName=pops["RegionName"],
        Date=[presc_start] * R_REGIONS,
        **{c: [float(m)] * R_REGIONS
           for c, m in zip(OXFORD_NPI_COLUMNS, NPI_MAXES_DEFAULT)}))
    log(f"cli: wrote the XPRIZE-size CSVs ({R_REGIONS} regions x "
        f"{T_HIST + HORIZON} days, "
        f"{Path(files['data']).stat().st_size / 2**20:.1f} MiB) in "
        f"{time.perf_counter() - t0:.3f}s")
    return files, days


def cli_phase(device):
    """The XPRIZE CLI on the card at the XPRIZE size, from CSV files the
    port's synthetic frame writes: cold then warm (launches of the warm run
    counted, its wall split as the summary records it), then from the warm
    run's checkpoint, then with a future-IP plan. Returns the warm launch
    counts, its wall split and (the CSV files, the ISO days)."""
    files, days = write_cli_csvs()
    presc_start = days[T_HIST]

    def run(tag, *extra):
        out = {k: str(CLI_DIR / f"{k}_{tag}.{ext}") for k, ext in
               (("presc", "csv"), ("pred", "csv"), ("summary", "json"))}
        argv = ["--data", files["data"], "--geos", files["geos"],
                "--populations", files["populations"],
                "--start-train", CLI_START, "--end-train", days[T_HIST - 1],
                "--end-predict", days[-1], "--backend", "pallas",
                "--num-epsilon", str(N_EPS), "--pareto-chunk", str(CHUNK),
                "--num-monte-carlo", str(N_MC),
                "--num-prescriptions", str(N_PRESCRIPTIONS),
                "--prescriptions-out", out["presc"],
                "--predictions-out", out["pred"],
                "--summary-out", out["summary"], *extra]
        reset_launches()
        t0 = time.perf_counter()
        check(xprize_cli.main(argv) == 0, f"cli {tag}: exit code")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = read_launches()
        summary = json.loads(Path(out["summary"]).read_text())
        split = " ".join(f"{k}={v:.3f}s" for k, v in
                         summary["wall_seconds"].items())
        log(f"cli {tag}: wall={wall:.3f}s {split} launches={n}")
        return out, summary, wall, n

    ckpt = str(CLI_DIR / "trained.npz")
    run("cold", "--trained-params-out", ckpt)
    out, summary, wall, launches = run("warm", "--trained-params-out", ckpt)
    cols = read_csv_columns(out["presc"])
    levels = np.stack([parse_floats(cols[c], c) for c in OXFORD_NPI_COLUMNS],
                      axis=1)
    check(levels.shape == (N_PRESCRIPTIONS * R_REGIONS * HORIZON, 12),
          f"cli: {levels.shape[0]} prescription rows, expected "
          f"{N_PRESCRIPTIONS} x {R_REGIONS} x {HORIZON}")
    check(bool((levels == np.round(levels)).all() and (levels >= 0).all()
               and (levels <= NPI_MAXES_DEFAULT).all()),
          "cli: a prescribed level is not an integer in [0, max]")
    check(cols["Date"][0] == presc_start, "cli: prescriptions' first day")
    pred = parse_floats(read_csv_columns(out["pred"])[
        "PredictedDailyNewCases"])
    check(pred.shape == (R_REGIONS * HORIZON,)
          and bool(np.isfinite(pred).all() and (pred >= 0).all()),
          "cli: predictions not finite and >= 0")
    check(launches["ekf3"] >= 4 and launches["ekf6"] == N_EPS // CHUNK
          and launches["rollout"] == SI_ROLLOUT_CALLS,
          f"cli: launches {launches}")
    check(summary["pareto_front_sizes"] and min(
        summary["pareto_front_sizes"]) >= 1, "cli: an empty Pareto front")
    loaded, _, _, _ = run("load_params", "--load-params", ckpt)
    read = lambda f: Path(f).read_bytes()
    check(read(loaded["presc"]) == read(out["presc"]), "cli: --load-params rerun wrote other prescriptions")
    planned, _, _, ip_n = run("future_ip", "--future-ip",
                              str(CLI_DIR / "future_ip.csv"))
    check(ip_n["rollout"] == SI_ROLLOUT_CALLS + 1,
          f"cli future_ip: launches {ip_n}, one more rollout expected (the "
          "plan's scenario)")
    pred_ip = parse_floats(read_csv_columns(planned["pred"])[
        "PredictedDailyNewCases"])
    check(bool(np.isfinite(pred_ip).all() and (pred_ip >= 0).all()),
          "cli: future-IP predictions not finite and >= 0")
    moved = float(np.mean(pred_ip != pred))
    log(f"cli future_ip: every NPI at its maximum: total predicted cases "
        f"{pred_ip.sum():.6e} against {pred.sum():.6e} on the frozen NPIs; "
        f"{moved:.4f} of the cells moved")
    check(moved > 0.5 and pred_ip.sum() < pred.sum(),
          "cli: the future-IP plan did not condition the predictions")
    return launches, dict(summary["wall_seconds"], total=wall), (files, days)


def backtest_phase(device, bt):
    """forecast_quality_assessment on the card at 235 regions x 60 starts x
    60-day look-ahead, T = 440, cold then warm: three ekf3 launches, the
    last over all B = 14,100 (region, start) lanes; that launch's own
    arguments held against the plain version and both timed; the error
    curves checked. Returns (the measurement dict of compare_kernel plus
    the launches, the warm wall)."""
    cfg = PipelineConfig(backend="pallas", smoother_gain="solve")
    T = bt.observations.shape[1]
    calls = []
    real = ekf3_kernel.ekf3

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    ekf3_kernel.ekf3 = spy
    try:
        for tag in ("cold", "warm"):
            calls.clear()
            reset_launches()
            t0 = time.perf_counter()
            res = forecast_quality_assessment(
                bt, MINS, NPI_MAXES_DEFAULT, T - BT_STARTS, BT_STARTS,
                BT_AHEAD, cfg, dtype=F32)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = read_launches()
            log(f"backtest {tag}: {R_REGIONS} regions x {BT_STARTS} starts x "
                f"{BT_AHEAD} days ahead, T={T}: wall={wall:.3f}s "
                f"filter-days/s={R_REGIONS * BT_STARTS * T / wall:.4e} "
                f"launches={n}")
    finally:
        ekf3_kernel.ekf3 = real
    shapes = [tuple(a[0].shape) for a, _ in calls]
    check(n["ekf3"] == 3 and len(calls) == 3 and n["nnls"] == 2,
          f"backtest: launches {n}, expected 3 ekf3 and 2 nnls")
    B = R_REGIONS * BT_STARTS
    check(shapes == [(T - BT_STARTS, 12, R_REGIONS)] * 2 + [(T, 12, B)],
          f"backtest: ekf3 shapes {shapes}")
    check(not ekf3_kernel.ekf3_geometry(T, B).smem_hist,
          "backtest: expected the device-scratch path at B = 14,100")
    m = compare_kernel("ekf3", "backtest", calls[-1][0], device, EKF3_BOUNDS,
                       True)
    m["launches"], m["nnls_launches"] = n["ekf3"], n["nnls"]
    # the error curves: finite per-day errors where the truth is positive,
    # and every aggregate finite where one of its start days is
    pop = to_tensor(bt.population, F32, device)
    truth = to_tensor(bt.new_cases_norm, F32, device) * pop[:, None]
    starts = torch.arange(1, BT_STARTS + 1, device=device)
    days = T - starts[:, None] + torch.arange(BT_AHEAD, device=device)
    valid = days < T
    pos = (truth[:, days.clamp(0, T - 1)] > 0) & valid
    e = res.est_error_smooth
    check(tuple(e.shape) == (R_REGIONS, BT_STARTS, BT_AHEAD)
          and e.device == device, f"backtest: errors {tuple(e.shape)}")
    check(bool(torch.isfinite(e[pos]).all() and (e[pos] >= 0).all()),
          "backtest: a per-day error is not finite where the truth > 0")
    agg = pos[:, BT_AHEAD - 1:].any(dim=1)
    for name in ("mean_error_smooth", "median_error_smooth"):
        v = getattr(res, name)
        check(bool(torch.isfinite(v[agg]).all()),
              f"backtest: {name} not finite where the truth > 0")
    med = res.median_error_smooth
    log(f"backtest: median over regions (a region's NaN left out) of the "
        f"median smoothed error (%) at look-ahead 1 / {BT_AHEAD // 2} / "
        f"{BT_AHEAD} days: "
        + " / ".join(f"{float(med[:, h].nanmedian()):.3f}"
                     for h in (0, BT_AHEAD // 2 - 1, BT_AHEAD - 1))
        + f"; positive-truth share "
        f"{float(pos[valid.expand_as(pos)].double().mean()):.4f}")
    return m, wall


def close_ratio(a, b, tol) -> float:
    """max |a - b| / (atol + rtol |b|) over the cells finite in b (<= 1:
    within tol); inf when a and b are not finite in the same cells."""
    a, b = a.double().cpu(), b.double().cpu()
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
        return float("inf")
    ok = torch.isfinite(b)
    if not bool(ok.any()):
        return 0.0
    return float((torch.abs(a - b) / (tol["atol"] + tol["rtol"]
                                      * torch.abs(b)))[ok].max())


def vmap_reference_check(device):
    """The "vmap" backend on a small input, float64, on the card against the
    CPU, each stage from the same inputs (the pipeline is so sensitive to
    its trained coefficients that a 1e-11 relative change moves one
    region's historic states by 6.3e5 times rtol 1e-9 after the
    element-wise fit: scripts/vmap_cpu_probe.py sensitivity, CPU run):
    train_regions once per regression type (the coefficients at
    VMAP_REF_TOL, LASSO's at VMAP_LASSO_COEF_TOL; the first round's
    smoothed states and rho at VMAP_REF_TOL); then run_pipeline on both
    from the CPU's NNLS coefficients: the historic states, the scenarios and
    the Monte-Carlo costs at VMAP_REF_TOL; in the sweep, a lane (epsilon,
    region) whose prior covariances reach cond >= ILL_COND (sweep_max_cond)
    may differ, since its smoother gains are fixed only to cond * eps on
    either device, and every other lane's prescriptions are equal and its
    states and costs at VMAP_REF_TOL, and so the fronts of the regions
    without such a lane (vmap_sweep_check holds the sweep's EKS where every
    lane is well conditioned). No EKS kernel launch. 400 training days give
    the regressions a full-rank design (the synthetic NPIs hold a level for
    30 days, so 14 blocks against 12 NPIs and the intercept; at 100 days the
    optimum is degenerate and the card and the CPU pick different
    co-optimal NNLS supports). LASSO runs 5 folds here (50 at the XPRIZE
    width) on the first 4 of the 16 regions: on the CPU its train stage at
    16 regions took ~2 minutes, most of this check's time."""
    T_h, H = 400, 20
    f64, cpu = torch.float64, torch.device("cpu")
    bt, bf, actual, _ = xprize_inputs(16, T_h, H, seed=1)

    def both(fn):
        out, walls = [], []
        for dev in (device, cpu):
            reset_launches()
            t0 = time.perf_counter()
            out.append(fn(dev))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            check(not any(other_launches(read_launches()).values()),
                  "vmap reference: an EKS kernel launched")
        return out, f"card {walls[0]:.3f}s cpu {walls[1]:.3f}s"

    def hold(tag, pairs, tol):
        ratios = {n: close_ratio(a, b, tol(n)) for n, (a, b) in pairs.items()}
        worst = max(ratios, key=ratios.get)
        for n, r in ratios.items():
            check(r <= 1.0, f"vmap reference {tag}: {n} at {r:.3e} of "
                            f"{tol(n)}")
        return f"worst {worst}: {ratios[worst]:.3e} of {tol(worst)}"

    for reg in REGRESSIONS:
        cfg = PipelineConfig(backend="vmap", regression_type=reg,
                             lasso_cv_folds=5)
        b = bt if reg != "LASSO" else xprize_inputs(4, T_h, H, seed=1)[0]
        (k, c), walls = both(lambda dev: train_regions(
            b, MINS, NPI_MAXES_DEFAULT, T_h, cfg, dtype=f64, device=dev))
        pairs = {n: (getattr(k.trained, n), getattr(c.trained, n))
                 for n in ("a1", "b1", "a2", "b2")}
        pairs["s_smooth_round1"] = (k.s_smooth_round1, c.s_smooth_round1)
        pairs["rho_round1"] = (k.rho_round1, c.rho_round1)
        coef = VMAP_LASSO_COEF_TOL if reg == "LASSO" else VMAP_REF_TOL
        worst = hold(f"train {reg}", pairs,
                     lambda n: VMAP_REF_TOL if "round1" in n else coef)
        log(f"vmap reference train {reg} (card vs CPU, float64, "
            f"{len(b.names)} regions x {T_h} days): {worst}; {walls}")
        if reg == "NONNEGATIVELS":
            trained = c.trained

    cfg = PipelineConfig(backend="vmap", pareto_chunk=4, num_monte_carlo=32)
    eps = epsilon_grid(8).numpy()
    u_random = random_npi_schedules(torch.Generator().manual_seed(1), 32,
                                    MINS, NPI_MAXES_DEFAULT, H)
    (k, c), walls = both(lambda dev: run_pipeline(
        bt, bf, actual, T_h, WEIGHTS, eps, MINS, NPI_MAXES_DEFAULT, T_h, cfg,
        dtype=f64, device=dev, u_random=u_random, trained=trained))
    pairs = {"s_hist": (k.s_hist, c.s_hist)}
    for n, sc in c.scenarios.items():
        for f in ("s", "i", "alpha", "J0", "J1"):
            pairs[f"scenario {n} {f}"] = (getattr(k.scenarios[n], f),
                                          getattr(sc, f))
    for f in ("J0", "J1"):
        pairs[f"monte carlo {f}"] = (k.monte_carlo[f], c.monte_carlo[f])
    cond = sweep_max_cond(cfg, bt, trained, bf, eps, T_h)
    calm = cond < ILL_COND                                     # (E, R)
    for f in ("J0", "J1", "s", "i", "alpha"):
        pairs[f"pareto {f} (well-conditioned lanes)"] = (
            k.pareto[f].cpu()[calm], c.pareto[f][calm])
    worst = hold("run_pipeline", pairs, lambda n: VMAP_REF_TOL)
    u_k, u_c = k.pareto["u_prescribed"].cpu(), c.pareto["u_prescribed"]
    u_diff = (u_k != u_c).flatten(2).any(dim=-1)
    calm_regions = calm.all(dim=0)
    front_same = torch.equal(k.pareto_front.cpu()[:, calm_regions],
                             c.pareto_front[:, calm_regions])
    log(f"vmap reference run_pipeline (card vs CPU from the CPU's NNLS "
        f"coefficients, float64, 16 regions x {T_h}+{H} days, 8 eps): "
        f"{worst}; {int((~calm).sum())} of {calm.numel()} sweep lanes reach "
        f"cond(P-) >= {ILL_COND:.0e} (max {float(cond.max()):.2e}); "
        f"prescriptions differ on {int(u_diff.sum())} lanes "
        f"({float((u_k != u_c).double().mean()):.4f} of the cells; "
        f"{int((u_diff & calm).sum())} well-conditioned); fronts of the "
        f"{int(calm_regions.sum())} regions with only well-conditioned "
        f"lanes equal={front_same}; {walls}")
    check(not bool((u_diff & calm).any()) and front_same,
          "vmap reference: a well-conditioned sweep lane differs")
    hi = to_tensor(NPI_MAXES_DEFAULT, f64, cpu)
    for name, u in (("card", u_k), ("cpu", u_c)):
        check(bool(((u == 0) | (u == hi)).all()),
              f"vmap reference: a {name} prescription is not bang-bang")
    check(all(bool(torch.isfinite(r.pareto[f]).all())
              for r in (k, c) for f in ("J0", "J1")),
          "vmap reference: sweep costs not finite")


def vmap_sweep_check(device):
    """The sweep's 6-state EKS on the generic core (pipelines.core.
    sweep_eks_vmap's system and options) on the card against the CPU,
    float64, on the per-capita inputs of the ekf6 phase (300 lanes, T = 532;
    without and with active control), where every prior covariance stays
    below cond 1e8: prescriptions equal, the rest at the costate bound
    VMAP_COSTATE_TOL, both smoother gains."""
    from epidemicmodeling_torch.models import si_alpha_costate_ekf_system
    from epidemicmodeling_torch.ops.ekf import ekf_smoother
    for active in (False, True):
        d = per_capita_case(active)
        t = lambda a: torch.movedim(torch.from_numpy(
            np.asarray(a, np.float64)), -1, 0)[:300]
        args = dict(u=torch.from_numpy(np.asarray(d["u"], np.float64)
                                       ).permute(2, 0, 1)[:300],
                    x=t(d["x"]), params={k: t(v) for k, v in
                                         d["params"].items()},
                    s_init=t(d["s_init"]), Ps_init=t(d["Ps_init"]),
                    s_final=t(d["s_final"]), Ps_final=t(d["Ps_final"]),
                    Q=t(d["Q"]), R=t(d["Rv"]))
        for gain in ("pinv", "solve"):
            res = []
            for dev in (device, torch.device("cpu")):
                a = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                         if isinstance(v, dict) else v.to(dev))
                     for k, v in args.items()}
                res.append(ekf_smoother(
                    si_alpha_costate_ekf_system(), a["u"], a["x"],
                    a["params"], a["s_init"], a["Ps_init"], a["s_final"],
                    a["Ps_final"], Q=a["Q"], R=a["R"], gamma_discount=0.995,
                    smoother_gain=gain, outputs="full"))
            g, c = res
            cond = float(max_cond(c.P_minus).max())
            ratios = {f: close_ratio(getattr(g, f), getattr(c, f),
                                     VMAP_COSTATE_TOL)
                      for f in ("s_plus", "s_smooth", "P_smooth")}
            same = torch.equal(g.u_opt_smooth.cpu(), c.u_opt_smooth)
            share = float((c.u_opt_smooth[:, T_HIST:-1] != 0).double().mean())
            log(f"vmap sweep EKS, per-capita{', control active' if active else ''}"
                f" ({gain}; card vs CPU, float64, 300 lanes, T={c.s_plus.shape[1]}):"
                f" max cond(P-) {cond:.2e}; prescriptions equal={same} "
                f"(u_max share {share:.4f}); " + " ".join(
                    f"{f}={r:.3e}" for f, r in ratios.items())
                + " of the bound")
            check(cond < 1e8 and same and max(ratios.values()) <= 1.0,
                  f"vmap sweep EKS ({gain}, active={active}): card and CPU "
                  "differ")


def max_cond(P_minus):
    """The largest condition number, per lane (...), of the finite prior
    covariances P-(t), t >= 1, of a stack (..., T, m, m): the matrices the
    smoother gains invert. A gain's relative error on a card against a CPU
    is about cond * eps (the pinv's, and MATLAB's cutoff is decided within
    the SVD's own error, pinv_ranks_agree)."""
    P = P_minus[..., 1:, :, :]
    fin = torch.isfinite(P).all(dim=-1).all(dim=-1)
    eye = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device)
    s = torch.linalg.svdvals(torch.where(fin[..., None, None], P, eye))
    return (s[..., 0] / s[..., -1]).amax(dim=-1)


def sweep_max_cond(cfg, bt, trained, bf, eps, T_hist):
    """max_cond of every (epsilon, region) lane of run_pipeline's sweep (its
    6-state EKS rerun on the CPU, float64, with the covariances kept),
    (E, R)."""
    cpu, f64 = torch.device("cpu"), torch.float64
    bt_d, _, _ = device_batch(bt, f64, cpu)
    bf_d, _, _ = device_batch(bf, f64, cpu)
    prep = pareto_prep(cfg, bf_d, trained, region_init(bt_d, cfg, f64, cpu),
                       WEIGHTS, MINS, NPI_MAXES_DEFAULT, T_hist, f64, cpu)
    R = bf_d.observations.shape[0]
    out = []
    for e in torch.as_tensor(eps, dtype=f64).split(cfg.pareto_chunk):
        res = sweep_eks_vmap(cfg, sweep_lane_inputs(prep, e), "full")
        out.append(max_cond(res.P_minus).reshape(len(e), R))
    return torch.cat(out)


def pinv_ranks_agree(got, ref, A):
    """(kept ranks equal, error within bound) of two _matlab_pinv results
    of A. Where the ranks differ, every singular value between them must
    lie within the SVD's own error, max(size) eps sigma_max (= the cutoff
    tol), of the cutoff: there no SVD decides the kept set (MATLAB's rule
    applied to singular values computed to that error). Where they agree,
    the values must agree to kappa * 1e-12 of their scale, kappa =
    sigma_max / (smallest kept sigma)."""
    s = torch.linalg.svdvals(A)
    tol = max(A.shape) * float(torch.nextafter(s[0], torch.tensor(
        float("inf"), dtype=s.dtype)) - s[0])
    rank = sorted(round(float(torch.trace(p @ A))) for p in (got, ref))
    if rank[0] != rank[1]:
        between = s[rank[0]:rank[1]]
        return False, bool((torch.abs(between - tol) <= tol).all())
    kappa = float(s[0] / s[rank[0] - 1])
    err = float(torch.abs(got - ref).max()
                / max(float(torch.abs(ref).max()), 1.0))
    return True, err <= max(kappa * 1e-12, 1e-9)


def pinv_check(device):
    """MATLAB's pinv cutoff on the card: the knife-edge inputs of
    tests/test_matlab_pinv.py (cond 1e6-1e16, float64) against the CPU
    (pinv_ranks_agree); then the time of one pinv over a sweep chunk's
    gains (531 steps x 5,875 lanes of 6 x 6, float32), beside the SVD
    alone."""
    rng = np.random.default_rng(1)
    same = []
    for cond in (1e6, 1e14, 1e15, 1e16):
        for k in range(5):
            q, _ = np.linalg.qr(rng.standard_normal((6, 6)))
            A = torch.from_numpy(
                (q * np.logspace(0, -np.log10(cond), 6)) @ q.T)
            agree, ok = pinv_ranks_agree(_matlab_pinv(A.to(device)).cpu(),
                                         _matlab_pinv(A), A)
            check(ok, f"pinv cond {cond:.0e} #{k}: card and CPU differ "
                      "outside the SVD's error")
            if not agree:
                log(f"pinv cond {cond:.0e} #{k}: the card keeps another "
                    "rank than the CPU (a singular value within the "
                    "SVD's error of the cutoff)")
            same.append(agree)
    log(f"pinv knife-edge (card vs CPU, float64): {sum(same)} of "
        f"{len(same)} inputs keep the same rank, all within their bounds")
    n = (T_HIST + HORIZON - 1) * CHUNK * R_REGIONS
    M = torch.randn(n, 6, 6, device=device, dtype=F32)
    M = M @ M.transpose(-1, -2) + 1e-3 * torch.eye(6, device=device)
    t0 = time.perf_counter()
    _matlab_pinv(M)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    pinv_ms = cuda_ms(lambda: _matlab_pinv(M), reps=3)
    svd_ms = cuda_ms(lambda: torch.linalg.svd(M), reps=3)
    log(f"pinv of {n} 6x6 float32 matrices (one sweep chunk's gains): "
        f"{pinv_ms:.3f} ms (first call {cold * 1e3:.3f} ms), of which the "
        f"SVD {svd_ms:.3f} ms")


def vmap_backtest(device, bt):
    """forecast_quality_assessment(backend="vmap") at 235 regions x 60
    starts x 60 days ahead, T = 440, cold then warm: no ekf3 launch; its
    error curves against the pallas backtest's at VMAP_BACKTEST_BOUND."""
    T = bt.observations.shape[1]
    run = lambda cfg: forecast_quality_assessment(
        bt, MINS, NPI_MAXES_DEFAULT, T - BT_STARTS, BT_STARTS, BT_AHEAD, cfg,
        dtype=F32)
    for tag in ("cold", "warm"):
        reset_launches()
        t0 = time.perf_counter()
        res = run(PipelineConfig(backend="vmap"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = read_launches()
        log(f"vmap backtest {tag}: {R_REGIONS} regions x {BT_STARTS} starts "
            f"x {BT_AHEAD} days ahead, T={T}: wall={wall:.3f}s "
            f"filter-days/s={R_REGIONS * BT_STARTS * T / wall:.4e} "
            f"launches={n}")
        check(n["ekf3"] == 0, f"vmap backtest: {n['ekf3']} ekf3 launches")
    ref = run(PipelineConfig(backend="pallas", smoother_gain="solve"))
    errs = {}
    for f in ("mean_error_smooth", "median_error_smooth"):
        a, b = getattr(res, f), getattr(ref, f)
        same = torch.equal(torch.isfinite(a), torch.isfinite(b))
        ok = torch.isfinite(b)
        errs[f] = (float((torch.abs(a - b) / (torch.abs(b) + 1))[ok].max())
                   if same else float("inf"))
    log("vmap backtest against the pallas backtest: " + " ".join(
        f"{f}={v:.3e}" for f, v in errs.items())
        + f" (bound {VMAP_BACKTEST_BOUND})")
    for f, v in errs.items():
        check(v <= VMAP_BACKTEST_BOUND, f"vmap backtest: {f} {v:.3e}")
    return wall


def vmap_regressions(device, bt):
    """The train stage at the XPRIZE width with LASSO (50 folds) and with
    the element-wise robust fits, on the generic core: its wall, finite
    coefficients (non-negative slopes for the element-wise fits), and
    LASSO's sweeps and host syncs over the stage's two lasso_cv calls (the
    recording's counters)."""
    for reg in ("LASSO", "NONNEGATIVELS-ELEMENT-WISE"):
        cfg = PipelineConfig(backend="vmap", regression_type=reg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recording() as rec:
            tr = train_regions(bt, MINS, NPI_MAXES_DEFAULT, T_HIST, cfg,
                               dtype=F32, device=device).trained
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(all(bool(torch.isfinite(t).all())
                  for t in (tr.a1, tr.b1, tr.a2, tr.b2)),
              f"train {reg}: a coefficient is not finite")
        if reg != "LASSO":
            check(bool((tr.a2 >= 0).all()), f"train {reg}: a2 < 0")
        log(f"vmap train {reg} at {R_REGIONS} regions x {T_HIST} days: "
            f"wall={wall:.3f}s "
            + (f"lasso_cv {rec.counters}" if reg == "LASSO" else
               "(no host sync in the regression)"))


def vmap_phase(device, bt, bf, actual):
    """Slice 4: the generic EKF/EKS core ("vmap" backend) and the LASSO and
    element-wise regressions, through the user's entry points."""
    vmap_reference_check(device)
    vmap_sweep_check(device)
    pinv_check(device)
    cfg = PipelineConfig(backend="vmap", pareto_chunk=CHUNK,
                         num_monte_carlo=N_MC)
    res, wall, launches = xprize_run(device, bt, bf, actual, cfg,
                                     epsilon_grid(N_EPS).numpy(),
                                     "vmap main path", profile=False)
    check(launches["ekf3"] == 0 and launches["ekf6"] == 0,
          f"vmap main path: EKS kernel launches {launches}")
    # recording the full run's launches (about ten sweep chunks') under the
    # profiler outlasts the smoke's time limit: profile one sweep chunk, the
    # Pareto stage's unit
    bt_d, _, _ = device_batch(bt, F32, device)
    init = region_init(bt_d, cfg, F32, device)

    def chunk():
        pareto_prescribe(bf, res.trained, init, res.s_hist,
                         epsilon_grid(N_EPS).numpy()[:CHUNK], WEIGHTS, MINS,
                         NPI_MAXES_DEFAULT, T_HIST, cfg, dtype=F32,
                         device=device)
        torch.cuda.synchronize()

    chunk()
    t0 = time.perf_counter()
    chunk()
    chunk_wall = time.perf_counter() - t0
    log(f"vmap sweep chunk ({CHUNK} eps x {R_REGIONS} regions): warm wall "
        f"{chunk_wall:.3f}s")
    device_time(chunk, chunk_wall)
    ref = train_regions(bt, MINS, NPI_MAXES_DEFAULT, T_HIST,
                        PipelineConfig(backend="pallas"), dtype=F32,
                        device=device).trained
    errs = {k: scaled_err(getattr(res.trained, k), getattr(ref, k))
            for k in ("a1", "b1", "a2", "b2")}
    log("vmap train against the pallas train (float32): " + " ".join(
        f"{k}={v:.3e}" for k, v in errs.items())
        + f" (bound {VMAP_TRAIN_BOUND})")
    for k, v in errs.items():
        check(v <= VMAP_TRAIN_BOUND, f"vmap train: {k} {v:.3e}")
    vmap_backtest(device, bt)
    vmap_regressions(device, bt)
    return wall


# ---------------------------------------------------------------------------
# slice 5: the standalone trainer and prescriptor, AR-alpha, the pre-generic
# 6-state EKS, Rt, smoothing, filter health and the realistic-artefact data


def xprize_cfg(**kw):
    """The XPRIZE cell's kernel-path configuration."""
    return PipelineConfig(**dict(dict(
        backend="pallas", smoother_gain="solve", pareto_chunk=CHUNK,
        num_monte_carlo=N_MC), **kw))


def csv_batches(files, days, cfg):
    """The XPRIZE CLI's batches from an oxford / populations / geos file
    set, through the port's loaders: (batch_train, batch_full, actual
    NPIs, T_hist, horizon) over CLI_START .. days[-1], training to
    days[T_HIST - 1]."""
    table = load_oxford_data(files["data"], OXFORD_NPI_COLUMNS, CLI_START,
                             days[-1])
    return build_batches_from_frames(
        table, load_populations(files["populations"]),
        load_geo_list(files["geos"]), CLI_START, days[T_HIST - 1], days[-1],
        None, cfg)


def same_batches(a, b) -> bool:
    """Two build_batches_from_frames results equal field by field, bit for
    bit (NaN where NaN)."""
    def same(x, y):
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return all(same(getattr(x, f), getattr(y, f)) for f in x._fields)
        if isinstance(x, np.ndarray):
            return (x.shape == y.shape and x.dtype == y.dtype
                    and bool(np.array_equal(x, y, equal_nan=x.dtype.kind
                                            == "f")))
        return x == y
    return all(same(x, y) for x, y in zip(a, b))


@contextlib.contextmanager
def stage_walls(module, names, walls):
    """Wrap module.<name> for each name so that every call's wall, ended by
    a device sync, adds up in walls[name]."""
    saved = {n: getattr(module, n) for n in names}

    def timed(n, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            walls[n] = walls.get(n, 0.0) + time.perf_counter() - t0
            return out
        return call

    for n, fn in saved.items():
        setattr(module, n, timed(n, fn))
    try:
        yield walls
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def trainer_phase(device, files, days):
    """train_npi_prescriptor (backend "pallas") on the XPRIZE-size batch
    from the CLI phase's CSVs, cold then warm: its ekf3 launches equal those
    train_regions makes inside run_pipeline, the mortality estimates are
    defined (the files carry deaths), and its .npz reloads equal."""
    cfg = xprize_cfg()
    bt, bf, _, T_h, _ = csv_batches(files, days, cfg)
    check(bt.observations.shape == (R_REGIONS, T_HIST) and T_h == T_HIST,
          f"trainer: batch {bt.observations.shape}")
    ckpt = CLI_DIR / "slice5_trained.npz"
    for tag in ("cold", "warm"):
        reset_launches()
        t0 = time.perf_counter()
        out, mort = train_npi_prescriptor(
            bt, MINS, NPI_MAXES_DEFAULT, T_HIST,
            trained_params_file=str(ckpt), cfg=cfg, dtype=F32,
            device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = read_launches()
        check(mort is not None, "trainer: no mortality estimates")
        finite = float(np.isfinite(mort.med_recent_beta).mean())
        log(f"train_npi_prescriptor {tag}: {R_REGIONS} regions x {T_HIST} "
            f"days from the CLI's CSVs: wall={wall:.3f}s launches={n}; "
            f"med_recent_beta finite share {finite:.4f} (median "
            f"{np.nanmedian(mort.med_recent_beta):.4e}), "
            f"med_recent_mortality median "
            f"{np.median(mort.med_recent_mortality):.4e}")
    reset_launches()
    train_regions(bt, MINS, NPI_MAXES_DEFAULT, T_HIST, cfg, dtype=F32,
                  device=device)
    torch.cuda.synchronize()
    in_pipeline = read_launches()
    check(n == in_pipeline and n["ekf3"] == 2 and n["ekf6"] == 0,
          f"trainer: launches {n}, train_regions makes {in_pipeline}")
    check(finite == 1.0, f"trainer: med_recent_beta finite share {finite}")
    check(all(t.device == device for t in (out.trained.a2, out.init.s_init,
                                           out.s_smooth_round2)),
          f"trainer: an output is not on {device}")
    loaded = load_trained_params(ckpt)
    same = loaded.names == out.trained.names and all(
        np.array_equal(getattr(loaded, k), getattr(out.trained, k).cpu()
                       .numpy()) for k in ("a1", "b1", "a2", "b2")) and \
        np.array_equal(loaded.population, out.trained.population)
    check(same, "trainer: the checkpoint does not reload equal")
    return dict(out=out, mort=mort, bf=bf, cfg=cfg, ckpt=ckpt, launches=n,
                wall=wall)


def prescriber_phase(device, tr, main_res, bt_syn, bf_syn):
    """prescribe_from_checkpoint at the paper's scale (testPrescribeXPRIZE01
    .m:160: 2000 epsilons x 235 regions x 532 days in chunks of 25, 500
    Monte-Carlo schedules) from the trainer's checkpoint, cold then warm;
    then on the XPRIZE run's own inputs (bit for bit its outputs), then
    with the kernels against their plain versions at 16 regions."""
    cfg = tr["cfg"]
    trained = trained_params_from_numpy(load_trained_params(tr["ckpt"]),
                                        F32, device)
    init = tr["out"].init
    _, s_hist = forecast_scenarios(tr["bf"], trained, init, WEIGHTS, MINS,
                                   NPI_MAXES_DEFAULT, T_HIST, cfg,
                                   dtype=F32, device=device)
    eps = epsilon_grid(SLICE5_EPS).numpy()
    days = SLICE5_EPS * R_REGIONS * (T_HIST + HORIZON)
    for tag in ("cold", "warm"):
        par = mc = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        walls = {}
        reset_launches()
        t0 = time.perf_counter()
        with stage_walls(prescribe_mod, ("pareto_prescribe",
                                         "monte_carlo_baseline"), walls):
            par, mc = prescribe_from_checkpoint(
                trained, tr["bf"], s_hist, init, eps, WEIGHTS, MINS,
                NPI_MAXES_DEFAULT, T_HIST, cfg,
                generator=torch.Generator().manual_seed(0), dtype=F32,
                device=device)
        wall = time.perf_counter() - t0
        n = read_launches()
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        log(f"prescribe_from_checkpoint {tag}: {SLICE5_EPS} eps x "
            f"{R_REGIONS} regions x {T_HIST + HORIZON} days, chunks of "
            f"{CHUNK}: wall={wall:.3f}s sweep="
            f"{walls['pareto_prescribe']:.3f}s monte_carlo="
            f"{walls['monte_carlo_baseline']:.3f}s sweep filter-days/s="
            f"{days / walls['pareto_prescribe']:.4e} launches={n} peak "
            f"device memory {peak:.2f} GiB")
    check(n["ekf6"] == SLICE5_EPS // CHUNK and n["ekf3"] == 0,
          f"prescriber: launches {n}")
    u = par["u_prescribed"]
    check(tuple(u.shape) == (SLICE5_EPS, R_REGIONS, HORIZON, 12)
          and u.device == device, f"prescriber: u_prescribed {u.shape}")
    hi = to_tensor(NPI_MAXES_DEFAULT, F32, device)
    check(bool(((u == 0) | (u == hi)).all()),
          "prescriber: a prescribed cell is neither u_min nor u_max")
    for src, d in (("sweep", par), ("monte carlo", mc)):
        check(bool(torch.isfinite(d["J0"]).all()
                   and torch.isfinite(d["J1"]).all()),
              f"prescriber: {src} costs not finite")
    check(tuple(mc["J0"].shape) == (N_MC, R_REGIONS),
          "prescriber: monte carlo shape")
    front = pareto_front_mask_batched(par["J0"], par["J1"])
    check(int(front.sum(dim=0).min()) >= 1,
          "prescriber: a region has an empty Pareto front")
    one = bool((u == u[:1]).all())
    log(f"prescriber: {u.numel() * 4 / 2**30:.2f} GiB of float32 "
        f"prescriptions, bang-bang; front sizes min/median/max "
        f"{int(front.sum(0).min())}/{int(front.sum(0).median())}/"
        f"{int(front.sum(0).max())}; every epsilon prescribes the same "
        f"schedule: {one}" + (" (the control never activates on this "
                              "synthetic data, ROADMAP Queue C)" if one
                              else ""))
    del par, mc, u, front

    # the XPRIZE run's own 250 epsilons, chunks, trained parameters,
    # historic states and Monte-Carlo schedules: the same kernels on the
    # same inputs, so its outputs bit for bit
    bt_d, _, _ = device_batch(bt_syn, F32, device)
    p2, m2 = prescribe_from_checkpoint(
        main_res.trained, bf_syn, main_res.s_hist,
        region_init(bt_d, cfg, F32, device), epsilon_grid(N_EPS).numpy(),
        WEIGHTS, MINS, NPI_MAXES_DEFAULT, T_HIST, cfg, dtype=F32,
        device=device, u_random=main_res.monte_carlo["u_random"])
    same = {k: torch.equal(p2[k], main_res.pareto[k])
            for k in ("J0", "J1", "u_prescribed")}
    same.update({f"mc_{k}": torch.equal(m2[k], main_res.monte_carlo[k])
                 for k in ("J0", "J1")})
    log(f"prescribe_from_checkpoint on the XPRIZE run's inputs ({N_EPS} "
        f"eps): equal to its outputs bit for bit: {same}")
    check(all(same.values()), "prescriber: differs from the XPRIZE run")
    prescribe_plain_check(device)
    return dict(launches=n, wall=wall, sweep=walls["pareto_prescribe"])


def prescribe_plain_check(device):
    """prescribe_from_checkpoint with the kernels against the same call
    with their plain versions at 16 regions (small_reference_check's
    inputs, 100 + 20 days; the 2000 epsilons in chunks of 500 so that the
    plain version's four chunks stay short), float32, from the same
    trained parameters, historic states and Monte-Carlo schedules, at
    SMALL_REF_BOUNDS."""
    T_h, H = 100, 20
    _, bf, _, coefs = xprize_inputs(PLAIN_CHECK_REGIONS, T_h, H, seed=1)
    cfg = xprize_cfg(pareto_chunk=PLAIN_CHECK_CHUNK, num_monte_carlo=32)
    trained = trained_params_from_numpy(coefs, F32, device)
    bf_d, _, _ = device_batch(bf, F32, device)
    init = region_init(bf_d, cfg, F32, device)
    _, s_hist = forecast_scenarios(bf, trained, init, WEIGHTS, MINS,
                                   NPI_MAXES_DEFAULT, T_h, cfg, dtype=F32,
                                   device=device)
    u_random = random_npi_schedules(torch.Generator().manual_seed(1), 32,
                                    MINS, NPI_MAXES_DEFAULT, H)
    run = lambda: prescribe_from_checkpoint(
        trained, bf, s_hist, init, epsilon_grid(SLICE5_EPS).numpy(),
        WEIGHTS, MINS, NPI_MAXES_DEFAULT, T_h, cfg, dtype=F32,
        device=device, u_random=u_random)
    reset_launches()
    kp, km = run()
    n = read_launches()
    with plain_versions():
        pp, pm = run()
    check(n["ekf6"] == SLICE5_EPS // PLAIN_CHECK_CHUNK,
          f"prescriber plain check: launches {n}")
    errs = sweep_errs(kp, pp, km, pm)
    log(f"prescribe_from_checkpoint, kernels vs plain versions "
        f"({PLAIN_CHECK_REGIONS} regions x {T_h}+{H} days, {SLICE5_EPS} eps "
        f"in chunks of {PLAIN_CHECK_CHUNK}, {n['ekf6']} ekf6 launches): "
        + " ".join(f"{k}={v:.3e}" for k, v in errs.items()))
    for k, v in errs.items():
        check(v <= SMALL_REF_BOUNDS[k],
              f"prescriber plain check: {k} {v:.3e} > {SMALL_REF_BOUNDS[k]}")


def new_case_phase(device):
    """new_case_ekf_optimal_npi (the pre-generic 6-state EKS) on the card
    against the CPU, float64, on the per-capita inputs with active control
    (300 lanes, T = 532, every P- below cond 1e8): prescriptions equal, the
    epidemic states at SLICE5_TOL, the costates at the costate bound
    VMAP_COSTATE_TOL; then its float32 wall on the card at 235 lanes."""
    d = per_capita_case(True)
    t = lambda a, n: torch.movedim(torch.from_numpy(
        np.asarray(a, np.float64)), -1, 0)[:n]

    def args(n, dtype, dev):
        a = dict(u=torch.from_numpy(np.asarray(d["u"], np.float64)
                                    ).permute(2, 0, 1)[:n],
                 x=t(d["x"], n), s_init=t(d["s_init"], n),
                 Ps_init=t(d["Ps_init"], n), s_final=t(d["s_final"], n),
                 Ps_final=t(d["Ps_final"], n), Q=t(d["Q"], n),
                 R=t(d["Rv"], n))
        a = {k: v.to(dev, dtype) for k, v in a.items()}
        a["params"] = {k: t(v, n).to(dev, dtype)
                       for k, v in d["params"].items()}
        return a

    run = lambda a: new_case_ekf_optimal_npi(
        a["u"], a["x"], a["params"], a["s_init"], a["Ps_init"], a["s_final"],
        a["Ps_final"], Q=a["Q"], R=a["R"], beta=NEWCASE_BETA,
        gamma=0.995)
    g = run(args(NEWCASE_LANES, torch.float64, device))
    c = run(args(NEWCASE_LANES, torch.float64, torch.device("cpu")))
    cond = float(max_cond(c.P_minus).max())
    same = torch.equal(g.u_opt_smooth.cpu(), c.u_opt_smooth)
    share = float((c.u_opt_smooth[:, T_HIST:-1] != 0).double().mean())
    ratios = {}
    for f in ("s_plus", "s_smooth", "s_minus"):
        ratios[f] = close_ratio(getattr(g, f)[..., :3],
                                getattr(c, f)[..., :3], SLICE5_TOL)
        ratios[f + "_costates"] = close_ratio(
            getattr(g, f)[..., 3:], getattr(c, f)[..., 3:], VMAP_COSTATE_TOL)
    ratios["P_smooth"] = close_ratio(g.P_smooth, c.P_smooth,
                                     VMAP_COSTATE_TOL)
    log(f"new_case_ekf_optimal_npi (card vs CPU, float64, {NEWCASE_LANES} "
        f"per-capita lanes, T={c.s_plus.shape[1]}, control active, beta="
        f"{NEWCASE_BETA}): max cond(P-) {cond:.2e}; prescriptions equal="
        f"{same} (u_max share {share:.4f}); " + " ".join(
            f"{k}={v:.3e}" for k, v in ratios.items()) + " of the bound")
    check(cond < 1e8 and same and max(ratios.values()) <= 1.0,
          "new_case_ekf_optimal_npi: card and CPU differ")
    a32 = args(R_REGIONS, F32, device)
    for tag in ("cold", "warm"):
        t0 = time.perf_counter()
        res = run(a32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(bool(torch.isfinite(res.s_smooth[..., :3]).all()),
          "new_case_ekf_optimal_npi float32: non-finite states")
    log(f"new_case_ekf_optimal_npi float32 on the card, {R_REGIONS} lanes "
        f"x T={res.s_plus.shape[1]}: warm wall={wall:.3f}s (generic core, "
        f"no kernel)")


def ar_phase(device, tr):
    """ar_alpha_prescription for each of the 235 regions on the smoothed
    alpha of the trainer's round 2 (AR(24) on the last 90 days, 92 days
    ahead, 10 scenarios, the region's trained a2 / b2), in float64 on the
    card and on the CPU from the same draws: the scenario costs and
    trajectories at SLICE5_TOL, the alpha forecast at rtol
    max(1e-9, p kappa eps) with kappa the condition number of the region's
    AR normal matrix (the two devices' LU solves of it agree only to about
    that); the card's wall for all regions."""
    out, cfg = tr["out"], tr["cfg"]
    S = out.s_smooth_round2.double().cpu()
    a2, b2 = out.trained.a2.double().cpu(), out.trained.b2.double().cpu()
    g = torch.Generator().manual_seed(0)
    draws = [(torch.randn(HORIZON, generator=g, dtype=torch.float64),
              npi_level_draws(g, (AR_SCENARIOS, HORIZON, 12), MINS,
                              NPI_MAXES_DEFAULT))
             for _ in range(R_REGIONS)]
    t0 = T_HIST - AR_HISTORY

    def run(dev):
        start = time.perf_counter()
        res = [ar_alpha_prescription(
            S[r, :, 2].to(dev), a2[r], float(b2[r]), cfg.beta_model,
            cfg.gamma_model, MINS, NPI_MAXES_DEFAULT, WEIGHTS,
            float(S[r, t0, 0]), float(S[r, t0, 1]), HORIZON, AR_ORDER,
            AR_HISTORY, AR_SCENARIOS, u_draw=draws[r][1],
            ar_noise=draws[r][0], device=dev) for r in range(R_REGIONS)]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return res, time.perf_counter() - start

    run(device)
    card, wall = run(device)
    cpu, cpu_wall = run(torch.device("cpu"))
    kappa = torch.stack([torch.linalg.cond(ar_normal_matrix(
        ar_design(S[r, -AR_HISTORY:, 2], AR_ORDER)[0], AR_ORDER))
        for r in range(R_REGIONS)])
    fc_tol = [dict(rtol=max(1e-9, AR_ORDER * float(k) * 2.0 ** -52),
                   atol=1e-12) for k in kappa]
    ratios = {f: max(close_ratio(getattr(a, f), getattr(b, f), SLICE5_TOL)
                     for a, b in zip(card, cpu))
              for f in ARPrescriptionResult._fields}
    fc_ratio = max(close_ratio(a.alpha_forecast, b.alpha_forecast, tol)
                   for a, b, tol in zip(card, cpu, fc_tol))
    j0 = torch.stack([r.J0_random for r in card])
    log(f"ar_alpha_prescription, {R_REGIONS} regions (AR({AR_ORDER}) on "
        f"{AR_HISTORY} days, {HORIZON} ahead, {AR_SCENARIOS} scenarios), "
        f"float64: card warm wall={wall:.3f}s (CPU {cpu_wall:.3f}s); card "
        f"vs CPU at rtol 1e-9: " + " ".join(
            f"{k}={v:.3e}" for k, v in ratios.items())
        + f" of the bound; the AR normal matrices' cond median "
        f"{float(kappa.median()):.3e} max {float(kappa.max()):.3e}, the "
        f"forecast at rtol max(1e-9, p cond eps): {fc_ratio:.3e} of the "
        f"bound; J0 median {float(j0.median()):.4e}")
    held = [v for k, v in ratios.items() if k != "alpha_forecast"]
    check(max(held) <= 1.0 and fc_ratio <= 1.0 and all(
        bool(torch.isfinite(r.J0_random).all()) for r in card),
        "ar_alpha_prescription: card and CPU differ")


def rt_series():
    """examples/rt_comparison.py's series: one synthetic region, 200 days,
    floored at 1e-3."""
    tr = next(iter(synthetic_regions(1, 200, seed=1).values()))
    return np.maximum(tr["s"] * tr["i"] * tr["alpha"] * tr["pop"], 1e-3)


def lm_costs(x, A, lam, wlen):
    """Every causal window's cost sum (y - A exp(lambda t))^2 at an
    rt_expfit_nonlin_ls fit (time unit 1), float64 on the host."""
    A, lam = A.double().cpu().numpy(), lam.double().cpu().numpy()
    n = np.arange(-wlen + 1, 1)
    idx = np.arange(len(x) - wlen + 1) + wlen - 1
    win = np.lib.stride_tricks.sliding_window_view(x, wlen)
    return ((win - A[idx, None] * np.exp(lam[idx, None] * n)) ** 2).sum(1)


def rt_smoothing_phase(device, tr):
    """The four Rt estimators (the EKF at order 2, as the example runs it)
    on examples/rt_comparison.py's series and smooth_series with every
    filter type, float64 on the card against the CPU at SLICE5_TOL (the
    nonlinear least squares by co-optimality and at LM_RTOL: its LM fixes
    A and lambda only to ~1e-9, tests/test_torch_rt_smoothing.py); then
    filter_health / summarize_health on the trainer's round 2."""
    x = rt_series()
    ekf_kw = dict(s_init=np.array([x[0], 0.0]), time_scale=1.0, alpha=1.0,
                  sigma=1.0, w_bar=np.zeros(2), v_bar=np.zeros(1),
                  Ps_init=np.diag([1.0, 0.1]), Q_w=np.diag([1e-1, 1e-4]),
                  R_v=np.array([[1e-1]]), order=2)

    def estimators(dev):
        xt = torch.tensor(x, device=dev)
        ekf = rt_expfit_ekf(xt, **ekf_kw)
        return {"gen_ratios": rt_expfit_gen_ratios(xt, 7, 3, 1.0),
                "log_lin_reg": rt_expfit_log_lin_reg(xt, 14, 1.0),
                "nonlin_ls": rt_expfit_nonlin_ls(xt, 14, 1.0),
                "ekf": (ekf.s_smooth, ekf.s_plus, ekf.P_smooth),
                **{f"smooth {ft}": (smooth_series(xt, ft),)
                   for ft in FILTER_TYPES}}

    t0 = time.perf_counter()
    card = estimators(device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cpu = estimators(torch.device("cpu"))
    ratios = {}
    for name, outs in cpu.items():
        got = card[name]
        check(all(o.device == device for o in got),
              f"rt/smoothing {name}: not on {device}")
        if name == "nonlin_ls":
            c_g, c_c = lm_costs(x, got[1], got[2], 14), lm_costs(
                x, outs[1], outs[2], 14)
            ratios["nonlin_ls_cost"] = float(np.max(
                np.abs(c_g - c_c) / (LM_COST_RTOL * c_c)))
            ratios[name] = max(close_ratio(got[k], outs[k], dict(
                rtol=LM_RTOL, atol=0.0)) for k in (0, 1, 3))
            lam_atol = LM_RTOL * float(outs[2].abs().max())
            ratios["nonlin_ls_lambda"] = close_ratio(
                got[2], outs[2], dict(rtol=0.0, atol=lam_atol))
        else:
            ratios[name] = max(close_ratio(g, c, SLICE5_TOL)
                               for g, c in zip(got, outs))
    lam = {k: card[k][2] for k in ("log_lin_reg", "nonlin_ls")}
    lam["gen_ratios"] = card["gen_ratios"][3]
    lam["ekf"] = card["ekf"][0][:, 1]
    log(f"rt estimators and smoothing (card vs CPU, float64, T={len(x)}): "
        f"card wall {wall:.3f}s; " + " ".join(
            f"{k}={v:.3e}" for k, v in ratios.items()) + " of the bound; "
        "growth rate at days 30/90/150 " + " ".join(
            f"{k}=" + "/".join(f"{float(v[d]):.4f}" for d in (30, 90, 150))
            for k, v in lam.items()))
    check(max(ratios.values()) <= 1.0, "rt/smoothing: card and CPU differ")
    out = tr["out"]
    health = filter_health(out.s_smooth_round2, out.rho_round2)
    summary = summarize_health(health, out.trained.names).splitlines()
    log(f"filter_health on the trainer's round 2: {summary[0]}; non-finite "
        f"{int(health.nan_states.sum())}, exploded "
        f"{int(health.state_explosion.sum())}, rho outside [0.1, 10] "
        f"{int((~health.rho_consistent).sum())}, median tail rho "
        f"{float(np.nanmedian(health.rho_mean)):.4f}"
        + (f"; first: {summary[1].strip()}" if len(summary) > 1 else ""))
    check(not health.nan_states.any(),
          "filter_health: non-finite states after training")


def realistic_phase(device):
    """The realistic-artefact frame (235 regions x 532 days, seed 7)
    written as CSVs, train_predict_prescribe on it on the card (the XPRIZE
    cell's epsilons, chunks and Monte Carlo), cold then warm, its outputs
    checked; then the same frame in the OxCGRT_latest schema, whose batches
    through the port's loaders equal the minimal file's bit for bit."""
    shutil.rmtree(REALISTIC_DIR, ignore_errors=True)
    (REALISTIC_DIR / "latest").mkdir(parents=True)
    t0 = time.perf_counter()
    frame, pops, _ = realistic_oxford_frame(R_REGIONS, T_HIST + HORIZON,
                                            CLI_START, seed=REALISTIC_SEED)
    files = write_oxford_csvs(REALISTIC_DIR, frame, pops)
    wide = write_oxford_csvs(REALISTIC_DIR / "latest",
                             to_oxcgrt_latest_schema(frame,
                                                     seed=REALISTIC_SEED),
                             pops)
    days = date_range_days(CLI_START, T_HIST + HORIZON)
    mib = lambda f: Path(f["data"]).stat().st_size / 2**20
    log(f"realistic: wrote the artefact frame ({mib(files):.1f} MiB) and its "
        f"OxCGRT_latest form ({mib(wide):.1f} MiB) in "
        f"{time.perf_counter() - t0:.3f}s")
    cfg = xprize_cfg()
    eps = epsilon_grid(N_EPS).numpy()
    for tag in ("cold", "warm"):
        reset_launches()
        t0 = time.perf_counter()
        res = train_predict_prescribe(
            WEIGHTS, eps, CLI_START, days[T_HIST - 1], CLI_START, days[-1],
            files["data"], files["geos"], files["populations"],
            npi_maxes=NPI_MAXES_DEFAULT, cfg=cfg,
            generator=torch.Generator().manual_seed(0), dtype=F32,
            device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = read_launches()
        stages = " ".join(f"{k}={v:.3f}s" for k, v in
                          res.stage_seconds.items())
        log(f"realistic train_predict_prescribe {tag}: wall={wall:.3f}s "
            f"{stages} launches={n}")
    check_xprize_outputs(res, eps, device, "realistic")
    check(n["ekf3"] >= 4 and n["ekf6"] == N_EPS // CHUNK,
          f"realistic: launches {n}")
    t0 = time.perf_counter()
    small = csv_batches(files, days, cfg)
    t1 = time.perf_counter()
    latest = csv_batches(wide, days, cfg)
    t2 = time.perf_counter()
    same = same_batches(small, latest)
    log(f"realistic: batches from the OxCGRT_latest file equal the minimal "
        f"file's bit for bit: {same} (loaded in {t2 - t1:.3f}s against "
        f"{t1 - t0:.3f}s)")
    check(same, "realistic: the latest-schema batches differ")
    return n


def slice5_phase(device, main_res, bt_syn, bf_syn, files, days):
    """Slice 5: the standalone trainer and prescriptor, AR-alpha, the
    pre-generic 6-state EKS, Rt, smoothing, filter health and the
    realistic-artefact data, through the user's entry points (the trainer
    on the CLI phase's CSVs ``files`` over ``days``). Returns the EKS
    kernels' launches on the trainer's and the prescriptor's warm runs."""
    tr = trainer_phase(device, files, days)
    pr = prescriber_phase(device, tr, main_res, bt_syn, bf_syn)
    new_case_phase(device)
    ar_phase(device, tr)
    rt_smoothing_phase(device, tr)
    realistic_phase(device)
    return {"train": tr["launches"], "prescribe": pr["launches"]}


def shooting_certificates(res, eps, w, a, u_min, u_max, beta, gamma=None,
                          c=None, optimal=True):
    """tests/test_analysis_fuzz.py's structural checks of a shooting run,
    from its own carried series (NumPy): the largest |H - sum of its terms|
    over 1e-11 of the step's term scale (the largest term or intermediate
    product; <= 1 passes), and, for the bang-bang law, whether no
    single-NPI flip of u lowers H given the realized costates (H is linear
    in u with coefficient phi). ``c`` selects the multiplicative model,
    else ``gamma`` the additive one. w: (K, P)."""
    s, i, al, lam, u, H = (np.asarray(v.double().cpu()) for v in (
        res.s, res.i, res.alpha, res.lambdas, res.u, res.H))
    w = np.broadcast_to(np.asarray(w, float), u.shape)
    rho = lam[:, 0] - lam[:, 1] - (1.0 - eps)
    if c is None:
        drive = (u_max - u) @ a
        last = lam[:, 2] * (-gamma * al + gamma * drive)
        big = np.abs(lam[:, 2]) * gamma * (al + drive)
        phi = eps * w - gamma * lam[:, 2:3] * a
    else:
        au = u @ a + c
        last = -lam[:, 2] * al * au
        big = np.abs(lam[:, 2]) * al * np.maximum(au, 1.0)
        phi = eps * w - lam[:, 2:3] * al[:, None] * a
    terms = np.stack([-rho * al * s * i, -beta * lam[:, 1] * i,
                      eps * (w * u).sum(1), last])
    scale = np.max(np.stack([np.abs(terms).max(0), np.abs(rho) * al,
                             beta * np.abs(lam[:, 1]), big,
                             np.full_like(s, 1e-300)]), 0)
    h_ratio = float((np.abs(H - terms.sum(0)) / (1e-11 * scale)).max())
    if not optimal:
        return h_ratio, True
    dH = phi * (u_max - u_min)
    signed = np.where(u == u_min, dH, -dH)
    floor = -1e-11 * np.maximum(1.0, np.abs(dH).max(1, keepdims=True))
    return h_ratio, bool((signed >= floor).all())


def rms_loss_ratio(card, cpu) -> float:
    """max |sqrt(l_card) - sqrt(l_cpu)| over atol + rtol sqrt(l_cpu) of
    LSTM_RMS_TOL, epoch by epoch (<= 1 passes): the RMS residual moves by
    no more than the outputs do, while the loss's relative change grows
    as the loss falls."""
    a, b = np.sqrt(np.asarray(card)), np.sqrt(np.asarray(cpu))
    return float(np.max(np.abs(a - b) / (LSTM_RMS_TOL["atol"]
                                         + LSTM_RMS_TOL["rtol"] * b)))


def _walls(run, device):
    """(result, wall in s) of run() on ``device``, the card synchronized."""
    t0 = time.perf_counter()
    out = run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def seirp_card_runs(device):
    """The five scenarios on the card at the default dt: A and C through
    run_seirp_scenario (no device=), B, D and E (T = 4,000 days each, K =
    40,000 steps) batched as one leading dimension of seirp_rollout, since
    one by one they took 38 s on an H100 (PERF.md). Returns
    {name: (t, s, e, i, r, p)} and the wall."""
    t0 = time.perf_counter()
    out = {}
    long = [n for n in SEIRP_SCENARIOS if SEIRP_SCENARIOS[n]["T"] == 4000]
    for name in SEIRP_SCENARIOS:
        if name not in long:
            res = run_seirp_scenario(name)
            out[name] = tuple(res[k] for k in ("t", "s", "e", "i", "r", "p"))
    T, _ = scenario_schedules(long[0])
    rates = [scenario_schedules(n)[1] for n in long]
    e0 = 1.0 / N_POP
    batch = seirp_rollout(*(np.stack([r[k] for r in rates])
                            for k in RATE_NAMES), 1.0 - e0, e0, 0.0, 0.0,
                          0.0, T, 0.1)
    t = 0.1 * torch.arange(batch[0].shape[-1], dtype=torch.float64,
                           device=device)
    for b, name in enumerate(long):
        out[name] = (t,) + tuple(x[b] for x in batch)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def seirp_phase(device):
    """The five SEIRP scenarios of testSEIRP01.m at the default dt = 0.1
    (K up to 40,000 steps; seirp_card_runs), the example's
    saturated-against-unlimited comparison (K = 4,000), the early-phase
    observability rank and eigenvalues: float64 on the card against
    run_seirp_scenario on the CPU at SLICE6_TOL, the eigenvalues against
    torch.linalg.eigvals of the card's own matrix; the card's walls beside
    the CPU's."""
    card, wall = seirp_card_runs(device)
    parts, cpu_wall = [], 0.0
    for name in SEIRP_SCENARIOS:
        cpu, w = _walls(lambda: run_seirp_scenario(name, device="cpu"),
                        torch.device("cpu"))
        cpu_wall += w
        got = dict(zip(("t", "s", "e", "i", "r", "p"), card[name]))
        check(got["p"].device == device, f"seirp {name}: not on the card")
        ratio = max(close_ratio(got[k], cpu[k], SLICE6_TOL) for k in got)
        mass = got["s"] + got["e"] + got["i"] + got["r"] + got["p"]
        rates = {k: float(v[0]) for k, v in cpu["rates"].items()}
        lam = seirp_early_eigen(**rates)
        num = torch.linalg.eigvals(seirp_early_phase_matrix(**rates)).real
        eig_err = float((torch.sort(lam).values
                         - torch.sort(num).values).abs().max())
        parts.append(dict(name=name, K=len(got["t"]), ratio=ratio,
                          eig_err=eig_err, mass=float((mass - 1).abs().max()),
                          peak_i=float(got["i"].max()),
                          deaths=float(got["p"][-1]), lam3=float(lam[2])))
        check(ratio <= 1.0 and eig_err <= 1e-12 and parts[-1]["mass"] < 1e-6,
              f"seirp {name}: card vs CPU {ratio:.3e}, eigenvalues "
              f"{eig_err:.3e}, mass {parts[-1]['mass']:.3e}")
    log(f"seirp scenarios (float64, dt=0.1; card: A, C one by one, B, D, E "
        f"batched; against run_seirp_scenario on the CPU at rtol 1e-9): "
        f"card {wall:.3f}s, CPU one by one {cpu_wall:.3f}s; " + "; ".join(
            f"{p['name']} K={p['K']} ratio={p['ratio']:.3e} peak_i="
            f"{p['peak_i']:.4f} deaths={p['deaths']:.5f} eig3="
            f"{p['lam3']:+.4f} eig_err={p['eig_err']:.1e}" for p in parts))
    r5 = [np.full(SAT_K, v) for v in (0.9, 0.5, 0.3, 0.0, 0.0)]
    x0 = (0.99, 0.005, 0.005, 0.0, 0.0, 400.0, 0.1)
    sat = {"saturated": (0.1, 0.05, 0.02, 0.2, 0.01, 0.05),
           "unlimited": (0.1, 0.1, 0.02, 0.02, 0.01, 0.05)}
    out = {}
    for tag, hs in sat.items():
        card, wall = _walls(lambda: seirp_saturated_rollout(*r5, *x0, *hs),
                            device)
        cpu, cpu_wall = _walls(lambda: seirp_saturated_rollout(
            *r5, *x0, *hs, device="cpu"), torch.device("cpu"))
        out[tag] = (float(card[4][-1]), wall, cpu_wall, max(
            close_ratio(g, c, SLICE6_TOL) for g, c in zip(card, cpu)))
    A = seirp_early_phase_matrix(**{k: SEIRP_SCENARIOS["A"][k]
                                    for k in RATE_NAMES})
    C = np.concatenate([np.zeros((3, 1)), np.eye(3)], axis=1)
    rank = int(torch.linalg.matrix_rank(obsv(A, C)))
    rank_p = int(torch.linalg.matrix_rank(obsv(A, np.array([[0., 0, 0, 1]]))))
    log(f"seirp saturated vs unlimited (K={SAT_K}): deaths "
        + " vs ".join(f"{t} {v[0]:.4f} (card {v[1]:.3f}s, CPU {v[2]:.3f}s, "
                      f"ratio={v[3]:.3e})" for t, v in out.items())
        + f"; observability rank observing (i, r, p) {rank} / 4, observing p "
        f"only {rank_p} / 4")
    check(max(v[3] for v in out.values()) <= 1.0
          and out["saturated"][0] > out["unlimited"][0] and rank == 4
          and rank_p < 4, "seirp: saturation or observability check failed")


def shooting_phase(device):
    """tests/test_analysis.py's shooting settings: the bang-bang run (P =
    12, K = 500, dt = 0.1) and 10 random schedules, the multiplicative
    model (K = 400) and the continuous law (K = 300), without device= on
    the card and on the CPU, float64: controls equal, the series at
    SLICE6_TOL; the H certificates on the card's own series, the bang-bang
    controls, and the optimal cost against the random ones."""
    P, K = SHOOT_P, SHOOT_K
    kw = dict(epsilon=0.2, w=np.ones(P), a=0.01 * np.ones(P),
              u_min=np.zeros(P), u_max=SHOOT_U_MAX, gamma=1 / 7, beta=1 / 7,
              s0=0.99, i0=0.01, alpha0=0.1,
              lambda_init=np.array([-1.0, 1.0, 1.0]), K=K, dt=SHOOT_DT)
    mult = dict(epsilon=0.2, w=np.ones(P), a=0.0001 * np.ones(P), c=0.0004,
                u_min=np.zeros(P), u_max=SHOOT_U_MAX, beta=1 / 7, s0=0.99,
                i0=0.01, alpha0=0.1, lambda_init=np.zeros(3), K=MULT_K,
                dt=SHOOT_DT, alpha_max=10.0)
    cont = dict(A_coefs=0.002 * np.ones(P), w=np.ones(P), u_min=np.zeros(P),
                u_max=SHOOT_U_MAX, gamma=0.0, beta=1 / 7, s0=0.99, i0=0.01,
                rho0=-1.0, lambda20=0.0, K=CONT_K, dt=SHOOT_DT)
    rng = np.random.default_rng(0)
    scheds = [None] + [rng.integers(0, 4, (K, P)).astype(float)
                       for _ in range(SHOOT_RANDOM)]

    def run(**dev):
        return ([si_alpha_hamiltonian_shooting(**kw, u_schedule=s, **dev)
                 for s in scheds],
                si_alpha_multiplicative_shooting(**mult, **dev),
                si_continuous_control(**cont, **dev))

    card, wall = _walls(run, device)
    cpu, cpu_wall = _walls(lambda: run(device="cpu"), torch.device("cpu"))
    pairs = list(zip(card[0], cpu[0])) + [(card[1], cpu[1])]
    same_u = all(torch.equal(g.u.cpu(), c.u) for g, c in pairs) and \
        torch.equal(card[2]["u"].cpu(), cpu[2]["u"])
    ratio = max([close_ratio(getattr(g, f), getattr(c, f), SLICE6_TOL)
                 for g, c in pairs for f in ("s", "i", "alpha", "lambdas",
                                             "J0", "J1")]
                + [close_ratio(card[2][k], cpu[2][k], SLICE6_TOL)
                   for k in ("s", "i", "alpha", "J0", "J1")])
    cert = [shooting_certificates(r, 0.2, kw["w"], kw["a"], kw["u_min"],
                                  SHOOT_U_MAX, kw["beta"], gamma=kw["gamma"],
                                  optimal=s is None)
            for r, s in zip(card[0], scheds)]
    cert.append(shooting_certificates(card[1], 0.2, mult["w"], mult["a"],
                                      mult["u_min"], SHOOT_U_MAX,
                                      mult["beta"], c=mult["c"]))
    bang = all(bool(((r.u == 0) | (r.u == r.u.new_tensor(SHOOT_U_MAX)))
                    .all()) for r in (card[0][0], card[1]))
    cost = [float(0.8 * r.J0.mean() + 0.2 * r.J1.mean()) for r in card[0]]
    log(f"shooting (float64; P={P}, K={K} optimal + {SHOOT_RANDOM} random "
        f"schedules, multiplicative K={MULT_K}, continuous K={CONT_K}): card "
        f"{wall:.3f}s, CPU {cpu_wall:.3f}s; controls equal {same_u}, series "
        f"at rtol 1e-9 {ratio:.3e} of the bound; H certificate "
        f"{max(c[0] for c in cert):.3e} of 1e-11 term scale, no flip lowers "
        f"H {all(c[1] for c in cert)}, bang-bang {bang}; cost optimal "
        f"{cost[0]:.5f} vs best random {min(cost[1:]):.5f}")
    check(same_u and ratio <= 1.0 and max(c[0] for c in cert) <= 1.0
          and all(c[1] for c in cert) and bang
          and cost[0] <= min(cost[1:]) * 1.05
          and bool((card[2]["u"] == 0).all()),
          "shooting: card vs CPU or certificate failed")


def lstm_series():
    """examples/lstm_forecast.py's data: the new cases of
    synthetic_oxford_frame(1, 220, seed=2) and the first 190 days
    standardized on the card. Returns (cases, xs, mu, sd)."""
    _, _, truth = synthetic_oxford_frame(1, 220, seed=2)
    tr = next(iter(truth.values()))
    cases = tr["s"] * tr["i"] * tr["alpha"] * tr["pop"]
    xs, mu, sd = standardize(cases[:-LSTM_TEST_DAYS].reshape(-1, 1))
    return cases, xs, mu, sd


def lstm_parity(x_in, y_out, device):
    """The 100-unit LSTM's first 20 epochs from the same initial weights on
    the card and on the CPU: (card losses, CPU losses, card wall, CPU
    wall)."""
    p0 = LSTMForecaster((100,)).init(torch.Generator().manual_seed(0), x_in,
                                     device="cpu")
    kw = dict(num_epochs=20, lr=0.005, lr_drop_period=125, params=p0)
    (_, l_card), w20 = _walls(lambda: train_forecaster(
        LSTMForecaster((100,)), x_in, y_out, **kw), device)
    (_, l_cpu), c20 = _walls(lambda: train_forecaster(
        LSTMForecaster((100,)), x_in.cpu(), y_out.cpu(), device="cpu", **kw),
        torch.device("cpu"))
    return l_card, l_cpu, w20, c20


def small_lstm_parity(device, x, y, head):
    """The (32, 16)-unit forecaster with ``head`` trained SMALL_LSTM_EPOCHS
    from the same initial weights on the card (``x``, ``y`` lie there) and
    on the CPU. Returns (card model, CPU model holding the card's trained
    weights, the losses' reading at rtol LSTM_LOSS_RTOL, the forward's at
    LSTM_FWD_TOL); each reading <= 1 passes."""
    p0 = LSTMForecaster(SMALL_LSTM_HIDDEN, output_layer=head).init(
        torch.Generator().manual_seed(0), x, device="cpu")
    card, cpu = (LSTMForecaster(SMALL_LSTM_HIDDEN, output_layer=head)
                 for _ in range(2))
    p_card, l_card = train_forecaster(card, x, y, params=p0,
                                      num_epochs=SMALL_LSTM_EPOCHS)
    _, l_cpu = train_forecaster(cpu, x.cpu(), y.cpu(), params=p0,
                                num_epochs=SMALL_LSTM_EPOCHS, device="cpu")
    loss = float(np.max(np.abs(np.subtract(l_card, l_cpu))
                        / np.asarray(l_cpu))) / LSTM_LOSS_RTOL
    cpu.load_params({k: v.cpu() for k, v in p_card.items()})
    with torch.no_grad():
        fwd = close_ratio(card(x), cpu(x.cpu()), LSTM_FWD_TOL)
    return card, cpu, loss, fwd


def lstm_phase(device):
    """examples/lstm_forecast.py on the card: the 100-unit LSTM trained 250
    epochs (lr 0.005, x0.2 from update 125) on the standardized new cases
    of lstm_series() less 30 days, then the 30-day closed-loop rollout; the
    loss must fall 10x and the forecast be finite. The first 20 epochs from
    the same initial weights on the card and on the CPU, held by
    rms_loss_ratio; then small_lstm_parity with each head on 4 x 60 x 5
    normal draws (seed 2)."""
    cases, xs, mu, sd = lstm_series()
    x_in, y_out = xs[:-1], xs[1:]
    model = LSTMForecaster(hidden_sizes=(100,))
    (params, losses), wall = _walls(lambda: train_forecaster(
        model, x_in, y_out, torch.Generator().manual_seed(0),
        num_epochs=LSTM_EPOCHS, lr=0.005, lr_drop_period=125), device)
    pred, r_wall = _walls(lambda: rollout_forecast(model, params, xs,
                                                   LSTM_TEST_DAYS), device)
    pred = pred.double() * sd[0, 0] + mu[0, 0]
    tail = torch.as_tensor(cases[-LSTM_TEST_DAYS:], device=device)
    mape = float((pred - tail).abs().div(tail.clamp(min=1e-9)).mean() * 100)
    l_card, l_cpu, w20, c20 = lstm_parity(x_in, y_out, device)
    ratio = rms_loss_ratio(l_card, l_cpu)
    rng = np.random.default_rng(2)
    xs4, ys4 = (torch.as_tensor(rng.standard_normal((4, 60, n)),
                                device=device) for n in (5, 1))
    small = {head: small_lstm_parity(device, xs4, ys4, head)[2:]
             for head in (None, "exp", "scaled_tanh")}
    log(f"lstm_forecast (hidden 100, {LSTM_EPOCHS} epochs, T={len(x_in)}): "
        f"card train {wall:.3f}s ({wall / LSTM_EPOCHS * 1e3:.2f} ms/epoch), "
        f"loss {losses[0]:.4f} -> {losses[-1]:.5f}; {LSTM_TEST_DAYS}-day "
        f"rollout {r_wall:.3f}s, MAPE {mape:.1f}%; 20 epochs from the same "
        f"weights card {w20:.3f}s vs CPU {c20:.3f}s, sqrt(loss) at rtol 1e-4 "
        f"atol 1e-5 {ratio:.3e} of the bound (losses {l_cpu[0]:.4f} -> "
        f"{l_cpu[-1]:.5f}, largest relative difference "
        f"{float(np.max(np.abs(np.subtract(l_card, l_cpu)) / l_cpu)):.2e}); "
        f"hidden {SMALL_LSTM_HIDDEN}, {SMALL_LSTM_EPOCHS} epochs on 4 x 60 x "
        f"5, losses at rtol {LSTM_LOSS_RTOL:g} / forward at rtol = atol "
        f"{LSTM_FWD_TOL['rtol']:g}: " + ", ".join(
            f"{head} {lo:.3e} / {fw:.3e}" for head, (lo, fw) in small.items())
        + " of the bounds")
    check(losses[0] >= 10 * losses[-1] and bool(torch.isfinite(pred).all())
          and ratio <= 1.0 and max(max(v) for v in small.values()) <= 1.0,
          "lstm_forecast: loss, forecast or parity failed")


def deep_features(device, U, alpha):
    """test04's inputs on the card: 235 regions x 440 days x 37 features
    (12 NPIs at lags 1, 7, 14 and the long-weekend flag, standardized per
    region) and the contact rate alpha as targets, standardized (no head)
    and over its mean (the exp head). Returns (X, {head: targets})."""
    weekend = long_weekend_feature(date_range_days(CLI_START, T_HIST))
    X = torch.stack([torch.cat([lagged_features(u, NPI_LAGS),
                                weekend[:, None]], 1) for u in U])
    X = standardize(X, axis=1)[0]
    a = torch.as_tensor(alpha, device=device)[..., None]
    return X, {None: standardize(a, axis=1)[0], "exp": a / a.mean()}


def train_deep(device, X, y, head):
    """test04's deep stack trained on the card: one cold epoch, then
    DEEP_EPOCHS timed. Returns (model, params, losses, cold wall, wall,
    peak device memory in GiB)."""
    model = LSTMForecaster(DEEP_HIDDEN, output_layer=head)
    (params, _), c_wall = _walls(lambda: train_forecaster(
        model, X, y, torch.Generator().manual_seed(1), num_epochs=1), device)
    torch.cuda.reset_peak_memory_stats()
    (params, losses), wall = _walls(lambda: train_forecaster(
        model, X, y, params=params, num_epochs=DEEP_EPOCHS), device)
    peak = torch.cuda.max_memory_allocated() / 2**30
    return model, params, losses, c_wall, wall, peak


def deep_lstm_phase(device, U, alpha):
    """test04's deep stack (hidden 200, 200, 100, 50, 20) with and without
    the exp head on deep_features(): one cold epoch, then 10 timed, with
    the peak device memory; the forward with the trained weights on the
    card and on the CPU at LSTM_FWD_TOL. Returns the features and targets
    for the linear phase."""
    X, targets = deep_features(device, U, alpha)
    lines = []
    for head, y in targets.items():
        model, params, losses, c_wall, wall, peak = train_deep(device, X, y,
                                                               head)
        with torch.no_grad():
            out, f_wall = _walls(lambda: model(X), device)
        cpu_model = LSTMForecaster(DEEP_HIDDEN, output_layer=head)
        cpu_model.load_params(params, device="cpu")
        with torch.no_grad():
            ref, cpu_wall = _walls(lambda: cpu_model(X.cpu()),
                                   torch.device("cpu"))
        ratio = close_ratio(out, ref, LSTM_FWD_TOL)
        lines.append(
            f"head {head}: cold epoch {c_wall:.3f}s, {DEEP_EPOCHS} epochs "
            f"{wall:.3f}s ({wall / DEEP_EPOCHS * 1e3:.1f} ms/epoch), loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}, peak {peak:.2f} GiB; "
            f"forward card {f_wall * 1e3:.1f} ms vs CPU {cpu_wall:.3f}s, "
            f"{ratio:.3e} of the bound")
        check(ratio <= 1.0 and all(np.isfinite(losses))
              and bool(torch.isfinite(out).all()),
              f"deep lstm ({head}): card vs CPU or finiteness failed")
    log(f"deep lstm (hidden {DEEP_HIDDEN}, {R_REGIONS} x {T_HIST} x "
        f"{X.shape[-1]}, float32, forward at rtol = atol "
        f"{LSTM_FWD_TOL['rtol']:g}): "
        + "; ".join(lines))
    return X, targets[None][..., 0]


def linear_svr_phase(device, U, alpha, X, y):
    """The three SVR modes at the reference's size (n = 400 days, d = 12
    NPIs, test03ExpfitVsIPRegression.m:198-246; region 0's levels against
    its alpha), 2,000 steps each, card and CPU from the same draws (held by
    the objective within 1e-9 relative and the predictions within 1e-6 of
    the target's scale: the hinge's kinks may part the iterates); ridge
    (lambda 1e-2) on each region's 37 standardized features normwise, each
    weight within max(1e-9, n cond eps) max|w| (the n = 440 rows summed
    into X'X in another order move it by up to n eps, and the solve of the
    regularized normal matrix multiplies that by its cond; normwise, as a
    solve fixes the weights relative to their norm, not each small weight
    to its own size); ARX (AR(14) on each region's first 352 days
    of alpha, 88 ahead): forecasts at ARX_FORECAST_TOL, fits by their
    residual costs within ARX_COST_RTOL."""
    Xr, yr = U[0][:SVR_N], alpha[0][:SVR_N]
    parts = []
    for kernel in ("linear", "rbf", "rbf-exact"):
        fit = lambda **d: svr_fit(Xr, yr, kernel, n_steps=SVR_STEPS,
                                  generator=torch.Generator().manual_seed(2),
                                  **d)
        card, wall = _walls(fit, device)
        cpu, cpu_wall = _walls(lambda: fit(device="cpu"), torch.device("cpu"))
        on_cpu = card._replace(**{f: getattr(card, f).cpu() for f in (
            "w", "b", "mu", "sd", "omega", "phase", "X_train")
            if getattr(card, f) is not None})
        f_card = float(svr_objective(on_cpu, Xr, yr))
        f_cpu = float(svr_objective(cpu, Xr, yr))
        obj = abs(f_card - f_cpu) / (1e-9 * f_cpu)
        pred = float((svr_predict(card, Xr).cpu() - svr_predict(cpu, Xr))
                     .abs().max()) / (1e-6 * np.abs(yr).max())
        parts.append(f"{kernel} card {wall:.3f}s CPU {cpu_wall:.3f}s "
                     f"objective {f_card:.6e} ({obj:.3e} of the bound), "
                     f"predictions {pred:.3e} of the bound")
        check(obj <= 1.0 and pred <= 1.0, f"svr {kernel}: card vs CPU")
    def ridge(dev):
        Xd, yd = X.to(dev), y.to(dev)
        return [ridge_regression(Xd[r], yd[r], lam=1e-2)
                for r in range(R_REGIONS)]

    card_r, r_wall = _walls(lambda: ridge(device), device)
    cpu_r, r_cpu = _walls(lambda: ridge(torch.device("cpu")),
                          torch.device("cpu"))
    F = X.shape[-1]
    Xc = X.cpu() - X.cpu().mean(dim=1, keepdim=True)
    r_cond = torch.linalg.cond(Xc.transpose(1, 2) @ Xc
                               + 1e-2 * torch.eye(F, dtype=X.dtype))
    r_ratio = 0.0
    for (w, b), (w_c, b_c), k in zip(card_r, cpu_r, r_cond):
        rho = max(1e-9, X.shape[1] * float(k) * 2.0 ** -52)
        scale = float(w_c.abs().max())
        r_ratio = max(r_ratio, close_ratio(w, w_c, dict(rtol=0.0,
                                                        atol=rho * scale)),
                      close_ratio(b, b_c, dict(rtol=rho, atol=rho * scale)))
    n_fit = T_HIST * 4 // 5
    arx = lambda **d: [arx_fit_predict(alpha[r][:n_fit], ARX_ORDER,
                                       T_HIST - n_fit, **d)
                       for r in range(R_REGIONS)]
    card_a, a_wall = _walls(arx, device)
    cpu_a, a_cpu = _walls(lambda: arx(device="cpu"), torch.device("cpu"))
    fc_ratio = max(close_ratio(g[1], c[1], ARX_FORECAST_TOL)
                   for g, c in zip(card_a, cpu_a))
    cost_ratio = 0.0
    for r, (g, c) in enumerate(zip(card_a, cpu_a)):
        Xa, t = ar_design(alpha[r][:n_fit], ARX_ORDER, device="cpu")
        cost = [float(torch.mean((t + Xa @ v.cpu()) ** 2)) for v in (g[0],
                                                                     c[0])]
        cost_ratio = max(cost_ratio, abs(cost[0] - cost[1])
                         / (ARX_COST_RTOL * cost[1]))
    log(f"svr (n={SVR_N}, d={Xr.shape[1]}, {SVR_STEPS} steps, float64): "
        + "; ".join(parts) + f"; ridge x{R_REGIONS} card {r_wall:.3f}s CPU "
        f"{r_cpu:.3f}s {r_ratio:.3e} of max(1e-9, n cond eps) max|w| (cond "
        f"max {float(r_cond.max()):.3e}); arx AR({ARX_ORDER}) x{R_REGIONS} "
        f"card {a_wall:.3f}s CPU {a_cpu:.3f}s, forecasts {fc_ratio:.3e} of "
        f"rtol 1e-8, residual costs {cost_ratio:.3e} of 1e-11")
    check(r_ratio <= 1.0 and fc_ratio <= 1.0 and cost_ratio <= 1.0,
          "ridge / arx: card vs CPU")


def slice6_phase(device):
    """Slice 6: the theory studies (SEIRP scenarios, linear systems,
    Hamiltonian shooting) and the ML stack (the univariate and the deep
    LSTM, SVR, ridge, ARX) through the user's entry points on the card,
    each held against the CPU; none of them launches a kernel."""
    reset_launches()
    t0 = time.perf_counter()
    seirp_phase(device)
    shooting_phase(device)
    lstm_phase(device)
    truth = synthetic_regions(R_REGIONS, T_HIST, seed=0)
    U = [tr["u"] for tr in truth.values()]
    alpha = np.stack([tr["alpha"] for tr in truth.values()])
    X, y = deep_lstm_phase(device, U, alpha)
    linear_svr_phase(device, U, alpha, X, y)
    n = read_launches()
    log(f"slice 6: {time.perf_counter() - t0:.1f}s, kernel launches {n} "
        f"(none expected); {card_line()}")
    check(not any(n.values()), f"slice 6 launched kernels: {n}")


def bit_equal(a, b) -> bool:
    """Equal bit for bit, NaN where NaN."""
    if a.is_floating_point():
        nan = torch.isnan(a)
        return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan],
                                                                b[~nan])
    return torch.equal(a, b)


def same_bits(got: dict, ref: dict, tag: str) -> None:
    """Fails naming the fields of ``got`` that are not ``ref``'s bit for
    bit."""
    diff = [n for n in ref if not bit_equal(got[n], ref[n])]
    check(not diff, f"{tag}: differs from the single-slot run in {diff}")


def xprize_fields(res) -> dict:
    return {"J0": res.pareto["J0"], "J1": res.pareto["J1"],
            "u_prescribed": res.pareto["u_prescribed"],
            "a2": res.trained.a2, "front": res.pareto_front,
            "s_hist": res.s_hist}


def mesh_xprize_runs(device, bt, bf, actual, card):
    """The XPRIZE cell (pallas, float32) on one slot and on MESH_SLOTS
    slots of the one card, as dp x ep = 5 x 1 and 1 x 5, each cold then
    warm; the mesh runs' outputs equal the single slot's bit for bit and
    launch each EKS kernel MESH_SLOTS times a call. Returns the 5 x 1 warm
    run's launches."""
    cfg = PipelineConfig(backend="pallas", smoother_gain="solve",
                         pareto_chunk=CHUNK, num_monte_carlo=N_MC)
    eps = epsilon_grid(N_EPS).numpy()

    def run(mesh):
        reset_launches()
        t0 = time.perf_counter()
        res = run_pipeline(bt, bf, actual, T_HIST, WEIGHTS, eps, MINS,
                           NPI_MAXES_DEFAULT, T_HIST, cfg,
                           generator=torch.Generator().manual_seed(0),
                           dtype=F32, device=None if mesh else device,
                           mesh=mesh)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, read_launches()

    slots = [device] * MESH_SLOTS
    grid = np.empty(MESH_SLOTS, dtype=object)
    grid[:] = slots
    meshes = {"1 slot": None, "5x1": make_mesh(devices=slots),
              "1x5": Mesh(grid.reshape(1, MESH_SLOTS))}
    check(meshes["5x1"].shape == {"dp": MESH_SLOTS, "ep": 1},
          f"make_mesh of {MESH_SLOTS} slots: {meshes['5x1'].shape}")
    out = {}
    for name, mesh in meshes.items():
        run(mesh)
        out[name] = run(mesh)
    ref, ref_wall, ref_n = out["1 slot"]
    for name in ("5x1", "1x5"):
        res, wall, n = out[name]
        same_bits(xprize_fields(res), xprize_fields(ref),
                  f"mesh {name} XPRIZE")
        # the regressions and the rollouts stay on the lead slot
        check(n["ekf3"] == MESH_SLOTS * ref_n["ekf3"]
              and n["ekf6"] == MESH_SLOTS * ref_n["ekf6"]
              and n["nnls"] == ref_n["nnls"]
              and n["rollout"] == ref_n["rollout"] == SI_ROLLOUT_CALLS,
              f"mesh {name}: launches {n}, one slot {ref_n}")
        stages = " ".join(f"{k}={v:.3f}s" for k, v in
                          res.stage_seconds.items())
        log(f"mesh {name} XPRIZE (pallas, float32, {MESH_SLOTS} slots on "
            f"one card, warm): wall={wall:.3f}s against {ref_wall:.3f}s on "
            f"one slot; {stages}; launches={n} ({n['ekf3'] // MESH_SLOTS} "
            f"ekf3 / {n['ekf6'] // MESH_SLOTS} ekf6 a slot); bit-identical "
            f"J0, J1, u_prescribed, a2, front, s_hist [{card}]")
    return out["5x1"][2]


def mesh_cli_run(files, days, card):
    """The CLI on the CLI cell's CSVs with --mesh 5x1 (5 slots on the one
    card): its prescriptions file equals the single-device warm run's
    (cli_phase's presc_warm.csv) byte for byte."""
    out = CLI_DIR / "presc_mesh.csv"
    argv = ["--data", files["data"], "--geos", files["geos"],
            "--populations", files["populations"],
            "--start-train", CLI_START, "--end-train", days[T_HIST - 1],
            "--end-predict", days[-1], "--backend", "pallas",
            "--num-epsilon", str(N_EPS), "--pareto-chunk", str(CHUNK),
            "--num-monte-carlo", str(N_MC),
            "--num-prescriptions", str(N_PRESCRIPTIONS),
            "--prescriptions-out", str(out),
            "--mesh", f"{MESH_SLOTS}x1", "--device", "cuda",
            "--cpu-devices", str(MESH_SLOTS)]
    for tag in ("cold", "warm"):
        reset_launches()
        t0 = time.perf_counter()
        check(xprize_cli.main(argv) == 0, "mesh cli: exit code")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = read_launches()
    same = out.read_bytes() == (CLI_DIR / "presc_warm.csv").read_bytes()
    log(f"mesh cli --mesh {MESH_SLOTS}x1 (warm): wall={wall:.3f}s "
        f"launches={n}; prescriptions byte-identical to the single-device "
        f"CLI's: {same} [{card}]")
    check(same, "mesh cli: other prescriptions than the single-device CLI")
    check(n["ekf3"] >= 4 * MESH_SLOTS
          and n["ekf6"] == MESH_SLOTS * N_EPS // CHUNK,
          f"mesh cli: launches {n}")


def mesh_backtest_run(device, bt, card):
    """The backtest cell with dp = 5 (5 slots on the one card) against the
    single-device run, bit for bit."""
    cfg = PipelineConfig(backend="pallas", smoother_gain="solve")
    T = bt.observations.shape[1]
    args = (bt, MINS, NPI_MAXES_DEFAULT, T - BT_STARTS, BT_STARTS, BT_AHEAD,
            cfg)
    out = {}
    for name, mesh in (("1 slot", None),
                       ("dp=5", make_mesh(devices=[device] * MESH_SLOTS))):
        for _ in range(2):
            reset_launches()
            t0 = time.perf_counter()
            res = forecast_quality_assessment(*args, dtype=F32, mesh=mesh)
            torch.cuda.synchronize()
            out[name] = res, time.perf_counter() - t0, read_launches()
    (ref, ref_wall, _), (res, wall, n) = out["1 slot"], out["dp=5"]
    fields = lambda r: {"a2": r.trained.a2} | {
        k: getattr(r, k) for k in ("est_error_plus", "est_error_smooth",
                                   "mean_error_smooth",
                                   "median_error_smooth")}
    same_bits(fields(res), fields(ref), "mesh backtest")
    check(n["ekf3"] == 3 * MESH_SLOTS, f"mesh backtest: launches {n}")
    log(f"mesh backtest dp={MESH_SLOTS} ({R_REGIONS} x {BT_STARTS} lanes, "
        f"warm): wall={wall:.3f}s against {ref_wall:.3f}s on one slot; "
        f"launches={n}; bit-identical [{card}]")


def mesh_vmap_run(device, card):
    """The "vmap" backend at vmap_reference_check's size (16 regions x
    400 + 20 days, 8 eps in chunks of 4, float64) on one slot and on two
    slots of the one card (dp = 2): the sweep's generic EKS at half the
    batch. Bit for bit where cuSOLVER's batched SVD gives the same bits at
    half the batch; otherwise graded by ROADMAP's pinv rule (a lane whose
    prior covariances reach cond >= ILL_COND may differ; every other lane's
    prescriptions equal, its costs at VMAP_REF_TOL), with what differed
    printed."""
    T_h, H = 400, 20
    f64 = torch.float64
    bt, bf, actual, _ = xprize_inputs(16, T_h, H, seed=1)
    cfg = PipelineConfig(backend="vmap", pareto_chunk=4, num_monte_carlo=32)
    eps = epsilon_grid(8).numpy()
    u_random = random_npi_schedules(torch.Generator().manual_seed(1), 32,
                                    MINS, NPI_MAXES_DEFAULT, H)
    out = {}
    for name, mesh in (("1 slot", None),
                       ("dp=2", make_mesh(devices=[device] * 2))):
        reset_launches()
        t0 = time.perf_counter()
        out[name] = run_pipeline(
            bt, bf, actual, T_h, WEIGHTS, eps, MINS, NPI_MAXES_DEFAULT, T_h,
            cfg, dtype=f64, device=None if mesh else device,
            u_random=u_random, mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(not any(other_launches(read_launches()).values()),
              "mesh vmap: an EKS kernel launched")
        log(f"mesh vmap {name}: wall={wall:.3f}s [{card}]")
    ref, res = out["1 slot"], out["dp=2"]
    got, want = xprize_fields(res), xprize_fields(ref)
    bits = {n: bit_equal(got[n], want[n]) for n in want}
    if all(bits.values()):
        log("mesh vmap dp=2: bit-identical J0, J1, u_prescribed, a2, front, "
            "s_hist")
        return
    check(bits["a2"], "mesh vmap: the replicated train stage differs")
    cond = sweep_max_cond(cfg, bt, ref.trained, bf, eps, T_h)
    calm = cond < ILL_COND
    u_diff = (res.pareto["u_prescribed"] != ref.pareto["u_prescribed"]
              ).flatten(2).any(dim=-1).cpu()
    ratios = {f: close_ratio(res.pareto[f].cpu()[calm],
                             ref.pareto[f].cpu()[calm], VMAP_REF_TOL)
              for f in ("J0", "J1")}
    log(f"mesh vmap dp=2: not bit-identical ({bits}); prescriptions differ "
        f"on {int(u_diff.sum())} of {u_diff.numel()} lanes "
        f"({int((u_diff & calm).sum())} with cond(P-) < {ILL_COND:.0e}); "
        f"well-conditioned costs at {ratios} of {VMAP_REF_TOL}")
    check(not bool((u_diff & calm).any()) and max(ratios.values()) <= 1.0,
          "mesh vmap: a well-conditioned sweep lane differs")


def mesh_multihost_runs(card):
    """The 2-process x 2-slot dry run, both processes on cuda:0 through
    Gloo, for "lanes" and "pallas": J0 and a2 within 1e-9 of the
    single-process reference (run_multihost_dryrun raises otherwise), the
    workers' kernels launched."""
    for backend in ("lanes", "pallas"):
        t0 = time.perf_counter()
        out = run_multihost_dryrun(n_devices=4, n_processes=2,
                                   backend=backend, timeout=300,
                                   verbose=False, device="cuda:0")
        wall = time.perf_counter() - t0
        workers = [line for log_ in out["logs"] for line in
                   log_.splitlines() if line.startswith("[worker")]
        check(len(workers) == 2 and all("backend=gloo" in w
                                        and "'ekf6': 0" not in w
                                        and "'ekf3': 0" not in w
                                        for w in workers),
              f"multihost {backend}: {workers}")
        log(f"multihost dry run [{backend}]: 2 processes x 2 slots on "
            f"cuda:0 (Gloo): max|dJ0|={out['max_abs_diff']:.3e} "
            f"max|da2|={out['max_abs_diff_a2']:.3e} against one process; "
            f"{wall:.1f}s with 3 process starts [{card}]")
        for w in workers:
            log(f"  {w}")


def parallel_kf_check(card):
    """parallel_kalman at T = 4096, m = 3 (a multi-year daily series), on
    the card against the CPU, float64: every output within 1e-9 of its
    largest magnitude."""
    T, m, n = 4096, 3, 1
    rng = np.random.default_rng(11)
    A0 = np.eye(m) + 0.05 * rng.standard_normal((m, m))
    A0 = 0.97 * A0 / np.max(np.abs(np.linalg.eigvals(A0)))
    Hm = rng.standard_normal((n, m))
    x, ys = rng.standard_normal(m), []
    for _ in range(T):
        x = A0 @ x + 0.1 * rng.standard_normal(m)
        ys.append(Hm @ x + 0.3 * rng.standard_normal(n))
    y = np.stack(ys)
    y[1000:1100] = np.nan
    y[-200:] = np.nan
    system = (np.tile(A0, (T, 1, 1)), np.tile(0.01 * np.eye(m), (T, 1, 1)),
              np.tile(Hm, (T, 1, 1)), np.tile(0.09 * np.eye(n), (T, 1, 1)),
              y, np.zeros(m), np.eye(m))
    walls, res = {}, {}
    # the card side as a user calls it: NumPy arrays, which go to the card
    sides = (("card", system),
             ("cpu", [torch.as_tensor(a, dtype=torch.float64)
                      for a in system]))
    for side, args in sides:
        for _ in range(2):
            t0 = time.perf_counter()
            res[side] = parallel_kalman(*args)
            torch.cuda.synchronize()
            walls[side] = time.perf_counter() - t0
    errs = {}
    for name, a, b in zip(res["cpu"]._fields, res["card"], res["cpu"]):
        check(a.device.type == "cuda" and a.dtype == torch.float64
              and bool(torch.isfinite(a).all()),
              f"parallel_kalman: {name} not finite on the card")
        errs[name] = float((a.cpu() - b).abs().max() / b.abs().max())
    log(f"parallel_kalman T={T} m={m} float64, card vs CPU (max error over "
        f"the largest magnitude): "
        + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + f"; warm card {walls['card']:.3f}s, CPU {walls['cpu']:.3f}s "
        f"[{card}]")
    check(max(errs.values()) <= PKF_TOL,
          f"parallel_kalman: card vs CPU {errs} > {PKF_TOL}")


def mesh_phase(device, bt, bf, actual, cli_files):
    """The device mesh and the multi-process runs (slice 7), then the
    associative-scan Kalman filter. The one card carries every slot: the
    runs check the split, the per-slot kernel geometry, the gather, the
    rendezvous and bit parity, and say nothing of scaling. Returns the
    5 x 1 XPRIZE run's launches."""
    t0 = time.perf_counter()
    card = card_line()
    log(f"viz: {viz.__name__} imported; matplotlib "
        f"{'present' if importlib.util.find_spec('matplotlib') else 'absent'}"
        " on this machine (viz imports it on the first plot)")
    launches = mesh_xprize_runs(device, bt, bf, actual, card)
    mesh_cli_run(*cli_files, card)
    mesh_backtest_run(device, bt, card)
    mesh_vmap_run(device, card)
    mesh_multihost_runs(card)
    parallel_kf_check(card)
    log(f"slice 7 (mesh, multi-process, parallel_kalman): "
        f"{time.perf_counter() - t0:.1f}s [{card}]")
    return launches


# ---------------------------------------------------------------------------
# slice 8: the native deployment artefact (deploy/): the 6-state optimal-NPI
# EKF/EKS's Pareto sweep for one region, card build against CPU build


def deploy_case() -> dict:
    """The sweep's arguments for one region, float64: the first lane of
    per_capita_case(True) (its parameters, initial states, covariances,
    observations and inputs, T = T_HIST + HORIZON, P = 12), its historic
    (s, i, alpha) by the noise-free roll of tests/test_deploy.py:114-122
    (tests._torch_helpers.deploy_history) with that lane's dt, rates and
    historic inputs, and DEPLOY_EPS epsilons log-spaced over
    DEPLOY_EPS_RANGE in place of its one."""
    d = per_capita_case(True)
    lane = lambda v: np.asarray(v[..., 0], np.float64)
    p = {k: lane(v) for k, v in d["params"].items()}
    u = lane(d["u"])
    return dict(u=u, x=lane(d["x"]), T_hist=T_HIST, params=p,
                eps_values=np.logspace(*DEPLOY_EPS_RANGE, DEPLOY_EPS),
                s_init=lane(d["s_init"]), Ps_init=lane(d["Ps_init"]),
                s_final=lane(d["s_final"]), Ps_final=lane(d["Ps_final"]),
                Q=lane(d["Q"]), R_v=lane(d["Rv"]),
                sia_hist=deploy_history(u, p, lane(d["s_init"]), T_HIST),
                beta_ekf=DEPLOY_BETA)


def newcase_ops(case: dict) -> float:
    """float64 operations (add, sub, mul, div) that the sweep needs on these
    inputs, each counted once where the function can share it: products of
    state fields, terms that are constant over a lane (1 - epsilon, dt gamma,
    epsilon w, the band's slope) and sums over rows that are the same in
    every lane are not counted again. Per lane:

    - T - 1 predictions (the last step's feeds nothing): the state update
      (29 + 3 P), the Jacobian's 21 structural nonzeros at the same point
      (13; the smoother's step t uses this same matrix) and A P+ A^T + Q
      over those nonzeros (2 x 216 + 36);
    - on a finite x: C's 3 nonzeros and the predicted observation (4), then
      P- C^T (30), S (7), the innovation (1), K (6), P- - K (C P-) over
      gamma (30 + 108), s+ (12); with beta_ekf != 1 the monitor as running
      sums over its length (7 a finite x, 5 another step) and R (4), with
      beta_ekf = 1 nothing, as nothing reads it;
    - T - 1 smoother steps: P+ A^T (216), the gain by an LU factorization
      with 6 right-hand sides (521), the smoothed state (78), gamma s5 (1);
      the smoothed covariance (P- - Ps, J (.) J^T, P+ - that) feeds no
      output and is not counted;
    - the bang-bang law, 2 for each optimized cell of rows 0..T-2, in each
      pass (the last row's inputs are 0);
    - the horizon's re-simulation (15 + 3 P a step) and the two divisions.

    Once for all lanes: the history's new cases (3 a day) and w * u over the
    cells that every lane shares (2 each). The band term of A[2][5] (1 add
    for each optimized cell whose phi lies in the band) is left out: it
    depends on the states. newcase_ops_as_written counts the kernel's own
    arithmetic beside it."""
    T, P = case["u"].shape
    T_hist, E = case["T_hist"], len(case["eps_values"])
    adaptive = case["beta_ekf"] != 1.0
    opt = int(np.isnan(case["u"][:-1]).sum())   # optimized cells, rows < T-1
    valid = int((~np.isnan(case["x"])).sum())
    sparse = 6 * (2 * 21 - 6)         # 6 x 6 times A^T (A's 21 nonzeros)
    predict = 29 + 3 * P + 13 + 2 * sparse + 36
    update = 4 + 30 + 7 + 1 + 6 + 30 + 108 + 12
    monitor = (valid * (7 + 4) + (T - valid) * 5) if adaptive else 0
    fwd = (T - 1) * predict + valid * update + monitor + 2 * opt
    lu = sum(m + 2 * m * m for m in range(6)) + 6 * (30 + 36)
    bwd = (T - 1) * (sparse + lu + 78 + 1) + 2 * opt
    score = (T - T_hist) * (15 + 3 * P) + 2 * opt + 2
    shared = 3 * T_hist + 2 * (T * P - opt)
    return float(E * (fwd + bwd + score) + shared)


def newcase_ops_as_written(case: dict) -> float:
    """float64 operations (add, sub, mul, div) of the sweep on these inputs,
    counted from csrc/newcase_ekf.cu as written, each element once (not the
    team's redundant copies of the cheap shared terms), every product of 6
    x 6 matrices dense: per step a forward (C and the observation, the
    state update, the Jacobian, A P+, (A P+) A^T + Q and the smoother's
    P+ A^T; its update where x is finite; with beta_ekf != 1 the monitor),
    and, but for the last step, a smoother step (mrdivide's divisions and
    eliminations on the columns still read: the 6 right-hand columns and
    the 5 - c left columns after pivot column c; the smoothed state); the
    bang-bang law (4) per optimized input cell in each pass and the band
    test (2 divisions) in the forward; then the horizon's re-simulation and
    the costs. The band term itself (7 where phi lies in the band) is left
    out: it depends on the states."""
    T, P = case["u"].shape
    T_hist, E = case["T_hist"], len(case["eps_values"])
    L, adaptive = 21, case["beta_ekf"] != 1.0
    nan_cells = int(np.isnan(case["u"]).sum())
    valid = int((~np.isnan(case["x"])).sum())
    product = 6 * 6 * 12             # a dense 6 x 6 product
    state_update, jacobian = 36 + 3 * P, 49
    fwd_step = 5 + state_update + jacobian + 3 * product + 36
    # P- C^T, S, the innovation, K, (I - K C) P- / gamma, s+
    update = 72 + 13 + 1 + 6 + 36 * 24 + 36 + 12
    # the monitor: the mean and squared deviation, then the deviations'
    # mean and R on a finite x; the mean and its square on another step
    monitor = ((valid * ((L + 1) + 3 + (L + 1) + 4) + (T - valid) * (L + 2))
               if adaptive else 0)
    fwd = (T * fwd_step + valid * update + monitor + nan_cells * (4 + 2))
    left = sum(5 - c for c in range(6))
    mrdivide = (36 + left) + 5 * 2 * (36 + left)
    bwd = (T - 1) * (mrdivide + 6 + 72) + nan_cells * 4
    score = (T - T_hist) * (20 + 3 * P) + 3 * T_hist + 2 * T * P + 2
    return float(E * (fwd + bwd + score))


def newcase_bound(case: dict):
    """(least time in ms, what sets it) of the sweep: each input read once,
    each output (U_OPT_SMOOTH, J0, J1) written once, against its float64
    operations over the card's float64 peak outside the tensor cores. The
    kernel's own scratch (P-, P+, s-, s+ of every step, written once and
    read once) is the design's traffic, not the function's: its time at
    3.35 TB/s is returned beside, as the third value."""
    T, P = case["u"].shape
    E, T_hist = len(case["eps_values"]), case["T_hist"]
    n_in = T * P + 3 * T + E + 3 * T_hist + 4 * P + 5 * 6 * 6
    n_out = E * T * P + 2 * E
    t_bytes = 8 * (n_in + n_out) / PEAK_BYTES_PER_S * 1e3
    t_ops = newcase_ops(case) / PEAK_F64_PER_S * 1e3
    scratch_ms = (8 * 2 * E * T * deploy_native.SCRATCH_PER_LANE_STEP
                  / PEAK_BYTES_PER_S * 1e3)
    if t_bytes >= t_ops:
        return t_bytes, "bytes", scratch_ms
    return t_ops, "operations", scratch_ms


def max_rel(a, b) -> float:
    """max |a - b| / |b|; equal entries count 0 (also where b is 0), an
    entry that differs from a b of 0 inf."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    diff = np.abs(a - b)
    rel = np.divide(diff, np.abs(b), out=np.where(diff == 0, 0.0, np.inf),
                    where=b != 0)
    return float(np.max(rel))


def deploy_single_checks(case: dict, eps: float) -> dict:
    """The single-epsilon entry (the kernel at E = 1, S_PLUS and S_SMOOTH
    written too) on the card against the CPU build, at beta_ekf = 1 and
    0.9: prescriptions equal, the states at DEPLOY_CPU_RTOL. Returns, per
    beta_ekf, whether every output was equal bit for bit."""
    args = {k: case[k] for k in ("u", "x", "params", "s_init", "Ps_init",
                                 "s_final", "Ps_final", "Q", "R_v")}
    args["params"] = dict(case["params"], epsilon=eps)
    same = {}
    for beta in (1.0, 0.9):
        card = newcase_ekf_optimal_npi_native(**args, beta_ekf=beta)
        cpu = newcase_ekf_optimal_npi_native(**args, beta_ekf=beta,
                                             device="cpu")
        check(np.array_equal(card["U_OPT_SMOOTH"], cpu["U_OPT_SMOOTH"]),
              f"deploy single-epsilon beta={beta}: prescriptions differ")
        for k in ("S_PLUS", "S_SMOOTH"):
            check(np.allclose(card[k], cpu[k], rtol=DEPLOY_CPU_RTOL, atol=0)
                  and np.isfinite(card[k]).all(),
                  f"deploy single-epsilon beta={beta}: {k} differs "
                  f"({max_rel(card[k], cpu[k]):.3e})")
        same[beta] = all(np.array_equal(card[k], cpu[k]) for k in card)
    return same


def deploy_phase(device):
    """Slice 8: the native deployment artefact's Pareto sweep for one region
    (deploy_case: 2,000 epsilons x T = 532 x P = 12, float64, control
    active) through newcase_ekf_pareto_sweep_native on the card, its
    launches counted; held against the CPU build (prescriptions equal, J0
    and J1 at DEPLOY_CPU_RTOL) and the plain version on the card
    (prescriptions equal, J0 and J1 at DEPLOY_PLAIN_RTOL); the
    single-epsilon entry at both beta_ekf; then the kernel's time (CUDA
    events around the device-pointer entry, median of 5 warm calls), the
    host-pointer entry's wall (copies included), the threaded CPU build's
    and the plain version's walls, and the bound. Returns the kernels-line
    entry."""
    t0 = time.perf_counter()
    card = card_line()
    so = deploy_native.build_library()
    _, report = build.build("newcase_ekf")
    ptxas = {w: ptxas_usage(report, "newcase_ekf_kernel", w)
             for w in ("registers", "stack frame")}
    log(f"deploy: CPU build {Path(so).name} in "
        f"{time.perf_counter() - t0:.1f}s; ptxas newcase_ekf_kernel: "
        f"{ptxas['registers']}; {ptxas['stack frame']}")
    case = deploy_case()
    reset_launches()
    t1 = time.perf_counter()
    got = newcase_ekf_pareto_sweep_native(**case)
    wall = time.perf_counter() - t1
    n = read_launches()
    check(n["newcase_ekf"] == 1 and sum(n.values()) == 1,
          f"deploy sweep: launches {n}, one newcase_ekf launch expected")
    sms = deploy_native.block_sms(DEPLOY_EPS)
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    geometry = dict(lanes_a_block=deploy_native.LANES,
                    threads_a_block=(deploy_native.M + 1)
                    * deploy_native.LANES,
                    blocks=len(sms), sms_used=len(set(sms.tolist())),
                    sms=n_sms)
    log(f"deploy kernel geometry: {geometry['lanes_a_block']} lanes a block "
        f"({geometry['threads_a_block']} threads), {geometry['blocks']} "
        f"blocks on {geometry['sms_used']} of {n_sms} SMs "
        f"(the SM of each block, recorded by the kernel)")
    check(geometry["sms_used"] >= min(DEPLOY_MIN_SMS, len(sms)),
          f"deploy sweep: {geometry['blocks']} blocks ran on "
          f"{geometry['sms_used']} SMs")
    threads, cpu_walls = os.cpu_count(), []
    for _ in range(3):
        t1 = time.perf_counter()
        cpu = newcase_ekf_pareto_sweep_native(**case, n_threads=threads,
                                              device="cpu")
        cpu_walls.append(time.perf_counter() - t1)
    cpu_wall = float(np.median(cpu_walls))
    T_hist, u_max = case["T_hist"], case["params"]["u_max"]
    fut = got["U_OPT_SMOOTH"][:, T_hist:-1]
    share = float((fut == u_max).mean())
    log(f"deploy sweep E={DEPLOY_EPS} T={case['u'].shape[0]} "
        f"P={case['u'].shape[1]} eps 1e{DEPLOY_EPS_RANGE[0]}..1e"
        f"{DEPLOY_EPS_RANGE[1]} beta_ekf={DEPLOY_BETA}: u_max share "
        f"{share:.4f} (lanes from {(fut[0] == u_max).mean():.4f} to "
        f"{(fut[-1] == u_max).mean():.4f}); card wall {wall:.3f}s (first "
        f"call: the library's load included), CPU build {cpu_wall:.3f}s "
        f"on {threads} threads (median of 3)")
    check(0.0 < share < 1.0, "deploy sweep: degenerate (u_max share "
                             f"{share})")
    same_u = np.array_equal(got["U_OPT_SMOOTH"], cpu["U_OPT_SMOOTH"])
    errs = {k: max_rel(got[k], cpu[k]) for k in ("J0", "J1")}
    bits = all(np.array_equal(got[k], cpu[k]) for k in got)
    log(f"deploy card vs CPU build: prescriptions equal={same_u}; J0 "
        f"{errs['J0']:.3e} J1 {errs['J1']:.3e} relative; bit for bit="
        f"{bits}")
    check(same_u and all(np.isfinite(got[k]).all() for k in got)
          and max(errs.values()) <= DEPLOY_CPU_RTOL,
          f"deploy sweep: card and CPU build differ ({errs})")

    torch.cuda.synchronize()
    t1 = time.perf_counter()
    plain = {k: v.cpu().numpy()
             for k, v in pareto_sweep_plain(**case, device=device).items()}
    plain_wall = time.perf_counter() - t1
    same_plain = np.array_equal(got["U_OPT_SMOOTH"], plain["U_OPT_SMOOTH"])
    perr = {k: max_rel(got[k], plain[k]) for k in ("J0", "J1")}
    abs_err = max(float(np.max(np.abs(got[k] - plain[k]))) for k in got)
    log(f"deploy card vs plain version on the card: prescriptions equal="
        f"{same_plain}; J0 {perr['J0']:.3e} J1 {perr['J1']:.3e} relative; "
        f"plain wall {plain_wall:.3f}s")
    check(same_plain and max(perr.values()) <= DEPLOY_PLAIN_RTOL,
          f"deploy sweep: card and plain version differ ({perr})")

    single = deploy_single_checks(case,
                                  float(case["eps_values"][DEPLOY_EPS // 2]))
    log(f"deploy single-epsilon entry (card vs CPU build, bit for bit): "
        f"{single}")

    d = deploy_native.native_inputs(*(case[k] for k in (
        "u", "x", "params", "s_init", "Ps_init", "s_final", "Ps_final", "Q",
        "R_v")))
    dc = deploy_native.to_device(d, device)
    eps_t = torch.from_numpy(case["eps_values"]).to(device)
    sia_t = torch.from_numpy(case["sia_hist"]).to(device)
    ms = cuda_ms(lambda: deploy_native.newcase_ekf_sweep(
        dc, eps_t, T_hist, sia_t, DEPLOY_BETA))
    host, phases = [], []
    for _ in range(3):
        t1 = time.perf_counter()
        res = deploy_native.sweep_host_entry(
            d, case["eps_values"], T_hist, case["sia_hist"], DEPLOY_BETA)
        host.append(time.perf_counter() - t1)
        phases.append(deploy_native.host_entry_phases())
    check(all(np.array_equal(res[k], got[k]) for k in got),
          "deploy host-pointer entry: outputs differ from the device entry")
    host_phases = {k: float(np.median([ph[k] for ph in phases]))
                   for k in deploy_native.HOST_PHASES}
    log("deploy host-pointer entry's parts (ms, median of 3; the C entry's "
        "own clock): " + ", ".join(f"{k} {v:.3f}"
                                   for k, v in host_phases.items())
        + f"; the wall around the call {1e3 * float(np.median(host)):.3f}")
    b_ms, b_by, scratch_ms = newcase_bound(case)
    log(f"kernel newcase_ekf [deploy sweep] E={DEPLOY_EPS} T="
        f"{case['u'].shape[0]}: kernel_ms={ms:.3f} (median of 5 warm calls) "
        f"host entry {1e3 * float(np.median(host)):.3f} ms (copies "
        f"included, median of 3); CPU build {1e3 * cpu_wall:.1f} ms on "
        f"{threads} threads; plain {1e3 * plain_wall:.1f} ms (one call); "
        f"bound "
        f"{b_ms:.4f} ms ({b_by}; {newcase_ops(case):.4e} float64 ops needed "
        f"at {PEAK_F64_PER_S / 1e12:.0f} TFLOP/s; the kernel as written does "
        f"{newcase_ops_as_written(case):.4e}); the scratch's own traffic "
        f"{scratch_ms:.4f} ms at 3.35 TB/s")
    log(f"slice 8 (deploy): {time.perf_counter() - t0:.1f}s [{card}]")
    return dict(launches=n["newcase_ekf"], max_abs_err=abs_err, ms=ms,
                plain_ms=1e3 * plain_wall, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, path="newcase_ekf_pareto_sweep_native "
                "(one region, device=None)",
                shape=f"E={DEPLOY_EPS} T={case['u'].shape[0]} "
                      f"P={case['u'].shape[1]} float64",
                cpu_build_ms=1e3 * cpu_wall, cpu_build_threads=threads,
                host_entry_ms=1e3 * float(np.median(host)),
                scratch_traffic_ms=scratch_ms, u_max_share=share,
                host_entry_phases_ms=host_phases,
                ops=newcase_ops(case),
                ops_as_written=newcase_ops_as_written(case),
                cpu_build_max_rel_err=max(errs.values()),
                bit_for_bit=bits, ptxas=ptxas, **geometry)


def run_example(name, device, args=None, record=True, **kw):
    """One run of an example driver's main on ``device`` (with ``args``,
    else EXAMPLE_ARGS's, and EXAMPLE_CUTS's sizes) in a fresh temporary
    working directory: (its returned dict, its wall in s, the kernel
    launches, the files it wrote, its printed lines, a record of its
    calls). The record (with ``record``): "sweeps", the arguments and
    result of each core.pareto_prescribe call; on a card also "launches",
    (kernel, arguments, keywords, outputs) of each ekf3 / ekf6 wrapper
    call."""
    mod = importlib.import_module(f"epidemicmodeling_torch.examples.{name}")
    chunk = EXAMPLE_CPU_CHUNK.get(name) if device.type == "cpu" else None
    rec = dict(sweeps=[], launches=[])

    def spy(real, log_to, tag=None):
        def call(*a, **k):
            out = real(*a, **k)
            log_to.append((a, k, out) if tag is None else (tag, a, k, out))
            return out
        return call

    # the names the pipelines call them by (the package binds the
    # train_predict_prescribe module's name to its function; the lanes
    # glue looks the wrappers up in their modules at each call)
    users = (sys.modules[
        "epidemicmodeling_torch.pipelines.train_predict_prescribe"],
        prescribe_mod)
    real_sweep, real3, real6 = (core.pareto_prescribe, ekf3_kernel.ekf3,
                                ekf6_kernel.ekf6)
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp), \
            contextlib.redirect_stdout(buf):
        if record:
            for m in users:
                m.pareto_prescribe = spy(real_sweep, rec["sweeps"])
            if device.type == "cuda":
                ekf3_kernel.ekf3 = spy(real3, rec["launches"], "ekf3")
                ekf6_kernel.ekf6 = spy(real6, rec["launches"], "ekf6")
        if chunk:
            mod.PipelineConfig = lambda **c: PipelineConfig(
                **dict(c, pareto_chunk=chunk))
        try:
            reset_launches()
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            args = EXAMPLE_ARGS.get(name, ()) if args is None else args
            out = mod.main(*args, device=device,
                           **{**EXAMPLE_CUTS.get(name, {}), **kw})
            if device.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = read_launches()
        finally:
            for m in users:
                m.pareto_prescribe = real_sweep
            ekf3_kernel.ekf3, ekf6_kernel.ekf6 = real3, real6
            mod.PipelineConfig = PipelineConfig
        files = sorted(str(p.relative_to(tmp))
                       for p in Path(tmp).rglob("*") if p.is_file())
    return out, wall, n, files, buf.getvalue().splitlines(), rec


def region_scale(J):
    """Each region's largest |cost| over epsilon (1 where all are 0)."""
    s = J.double().cpu().abs().amax(dim=0)
    return torch.where(s > 0, s, torch.ones_like(s))


def front_gap(J0a, J1a, fa, J0b, J1b, fb):
    """The largest margin, over the regions and both directions, by which
    a point of one front is dominated by a point of the other, in units of
    the region's largest costs (<= 0: neither front dominates the other
    anywhere)."""
    s0, s1 = region_scale(J0b), region_scale(J1b)
    gap = -float("inf")
    for (x0, x1, fx), (y0, y1, fy) in (((J0a, J1a, fa), (J0b, J1b, fb)),
                                       ((J0b, J1b, fb), (J0a, J1a, fa))):
        x0, x1, y0, y1 = (v.double().cpu() for v in (x0, x1, y0, y1))
        fx, fy = fx.cpu(), fy.cpu()
        for r in range(x0.shape[1]):
            a0, a1 = x0[fx[:, r], r], x1[fx[:, r], r]
            b0, b1 = y0[fy[:, r], r], y1[fy[:, r], r]
            m = torch.minimum((a0[:, None] - b0[None]) / s0[r],
                              (a1[:, None] - b1[None]) / s1[r])
            gap = max(gap, float(m.max()))
    return gap


def sweep_diffs(pc, pp):
    """Two sweeps' pareto dicts, epsilon by epsilon: the share of
    prescribed cells that differ (over all epsilons and in each band of
    the grid, its log half and its linear half) and the J0 and J1
    differences over the region's largest cost (median, 90th percentile,
    largest)."""
    E = pc["J0"].shape[0]
    d = (pc["u_prescribed"][:, :, :-1].cpu()
         != pp["u_prescribed"][:, :, :-1].cpu())
    bands = ((0, E // 2), (E // 2, E)) if E > 1 else ((0, 1),)
    rel = torch.cat([(torch.abs(pc[k].double().cpu() - pp[k].double().cpu())
                      / region_scale(pp[k])).flatten() for k in ("J0", "J1")])
    return dict(flip=float(d.double().mean()),
                flips=[float(d[a:b].double().mean()) for a, b in bands],
                cost=float(rel.max()), cost_med=float(rel.median()),
                cost_p90=float(torch.quantile(rel, 0.9)))


def lane_groups(launches):
    """A run's recorded ekf3 / ekf6 launches grouped by (kernel, T,
    keywords), each group's arguments and outputs joined along the lanes
    (the last axis; no formula couples two lanes):
    [(kernel, args, keywords, outputs, launches)]."""
    groups = {}
    for kn, a, k, o in launches:
        key = (kn, a[0].shape[0], tuple(sorted(k.items())))
        groups.setdefault(key, []).append((a, o))
    cat = lambda xs: torch.cat(xs, dim=-1)
    return [(kn, [cat([a[i] for a, _ in g]) for i in range(len(g[0][0]))],
             dict(kw), [cat([o[i] for _, o in g]) for i in range(3)],
             len(g)) for (kn, _, kw), g in groups.items()]


def ekf_lane_errs(kn, got, ref, t_hist):
    """ekf3: the scaled errors of S_PLUS and S_SMOOTH (EKF3_BOUNDS). ekf6:
    over the cells finite in both, the scaled errors of S_PLUS and of the
    smoothed epidemic states (S_SMOOTH's first three rows) and the shares
    of cells finite on one side only; for the record, the smoothed
    costates' error and the share of prescribed cells (rows t_hist ..
    T-2) that differ."""
    if kn == "ekf3":
        return dict(s_plus=scaled_err(got[1], ref[1]),
                    s_smooth=scaled_err(got[0], ref[0]))
    e = {}
    for n, a, b in (("s_plus", got[2], ref[2]),
                    ("s_smooth_states", got[0][:, :3], ref[0][:, :3]),
                    ("s_smooth_costates", got[0][:, 3:], ref[0][:, 3:])):
        e[n], e[n + "_nonfinite_mismatch"] = masked_err(a, b)
    e["u_diff"] = float((got[1][t_hist:-1] != ref[1][t_hist:-1])
                        .double().mean())
    return e


def kernel_lane_holds(name, launches, t_hist, R, fails):
    """Each of a card run's ekf3 / ekf6 launch groups (lane_groups)
    against the plain version on the same inputs on the card, held at
    EXAMPLE_KERNEL_BOUNDS; each mutant must exceed a bound. For ekf6 the
    plain version also runs on the CPU: its distance from the one on the
    card (two correct float32 runs) widens the smoother's bounds
    (EXAMPLE_SPREAD_HELD). Returns the readings."""
    out = []
    for kn, args, kw, got, calls in lane_groups(launches):
        plain = KERNELS[kn]["plain"]
        ref = plain(*args, **kw)
        e = ekf_lane_errs(kn, got, ref, t_hist)
        bounds = dict(EXAMPLE_KERNEL_BOUNDS[kn])
        spread = None
        if kn == "ekf6":
            cpu_ref = plain(*(a.cpu() for a in args), **kw)
            spread = ekf_lane_errs(
                kn, ref, [r.to(ref[0].device) for r in cpu_ref], t_hist)
            for k in EXAMPLE_SPREAD_HELD:
                bounds[k] = max(bounds[k], EXAMPLE_SPREAD_FACTOR * spread[k])
        T, B = args[0].shape[0], args[0].shape[-1]
        tag = f"{kn} T={T} B={B} ({calls} launches)"
        for k, b in bounds.items():
            if not e[k] <= b:
                fails.append(f"{name}: {tag} {k} {e[k]:.3e} > {b}")
        # a launch on the wrong lanes or days: one region over, one
        # epsilon over (ekf6, lane = e * R + r), one day over (ekf3)
        shift = {"regions_rolled": lambda x: torch.roll(x, 1, dims=-1)}
        if kn == "ekf6" and B > R:
            shift["epsilon_off"] = lambda x: torch.roll(x, R, dims=-1)
        if kn == "ekf3":
            shift["day_off"] = lambda x: torch.roll(x, 1, dims=0)
        mutants = {}
        for m, f in shift.items():
            mutants[m] = {k: v for k, v in ekf_lane_errs(
                kn, got, [f(r) for r in ref], t_hist).items() if k in bounds}
            if not any(mutants[m][k] > b for k, b in bounds.items()):
                fails.append(f"{name}: {tag} mutant {m} reads "
                             f"{mutants[m]}, within the bounds {bounds}")
        g = dict(kernel=tag, errs=e, bounds=bounds, mutants=mutants)
        if spread is not None:
            g["plain_card_vs_cpu"] = spread
        out.append(g)
    return out


def pipeline_grades(name, card, cpu, rec_card, rec_cpu, fails):
    """A pipeline driver's card run against its CPU run: holds the
    training (EXAMPLE_TRAIN_BOUND) and each kernel on its own launches'
    inputs (kernel_lane_holds), checks that every mutant exceeds a bound,
    and returns the readings, the two runs' independent ones included."""
    sw_c, sw_p = rec_card["sweeps"], rec_cpu["sweeps"]
    check(len(sw_c) == 1 and len(sw_p) == 1,
          f"{name}: {len(sw_c)} / {len(sw_p)} sweeps, expected one a run")
    a_c, _, pc = sw_c[0]
    a_p, _, pp = sw_p[0]
    # pareto_prescribe(batch_full, trained, init, s_hist, eps, weights,
    # mins, maxes, T_hist, ...)
    tr_c, tr_p, sh_c, sh_p = a_c[1], a_p[1], a_c[3], a_p[3]
    train = dict(a2=scaled_err(tr_c.a2.cpu(), tr_p.a2.cpu()),
                 s_hist=scaled_err(sh_c.cpu(), sh_p.cpu()))
    train_mutants = dict(
        s_hist_day_off=dict(s_hist=scaled_err(sh_c[:, 1:].cpu(),
                                              sh_p[:, :-1].cpu())),
        a1_for_a2=dict(a2=scaled_err(tr_c.a1.cpu(), tr_p.a2.cpu())))
    for k, b in EXAMPLE_TRAIN_BOUND.items():
        if not train[k] <= b:
            fails.append(f"{name}: {k} {train[k]:.3e} > {b}")
    for m, got in train_mutants.items():
        if not any(got[k] > b for k, b in EXAMPLE_TRAIN_BOUND.items()
                   if k in got):
            fails.append(f"{name}: mutant {m} reads {got}, within the "
                         f"bounds {EXAMPLE_TRAIN_BOUND}")
    kernels = kernel_lane_holds(name, rec_card["launches"], a_c[8],
                                tr_c.a2.shape[0], fails)
    fc, fp = card["front"], cpu["front"]
    runs = sweep_diffs(pc, pp)
    runs.update(front_gap=front_gap(pc["J0"], pc["J1"], fc, pp["J0"],
                                    pp["J1"], fp),
                front_sizes=(fc.sum(0).tolist(), fp.sum(0).tolist()))
    return dict(train=train, train_mutants=train_mutants, kernels=kernels,
                runs=runs)


def pipeline_front(name, out):
    """A pipeline driver's front mask (E, R) on the CPU."""
    if name == "prescribe_from_checkpoint":
        return torch.as_tensor(out["front"])
    return out["result"].pareto_front.cpu()


def sim_pairwise_holds(p, hold):
    """The pairwise wrapper on the spatial driver's own agent positions
    (p[t], the input to step t + 1, for t in EXAMPLE_SIM_STEPS) against
    its plain version on the same inputs, row by row; ``hold`` records a
    failure. Returns {step: row_err}."""
    cfg = PopulationSimConfig(n_subjects=p.shape[1])
    _, obs_np = default_environment(cfg)
    obs = torch.tensor(obs_np, dtype=F32, device=p.device)
    rows = torch.arange(p.shape[1], device=p.device)
    out = {}
    for t in EXAMPLE_SIM_STEPS:
        pos = p[t].to(F32).contiguous()
        got = pairwise_kernel.social_forces(pos, obs, cfg)
        ref = pairwise_kernel.social_forces_plain(pos, obs, cfg)
        m = hold_pairwise(f"spatial_sims step {t + 1}", got, ref, pos, obs,
                          cfg, rows)
        hold(m["row_err"] <= PAIRWISE_ROW_BOUND,
             f"pairwise at step {t + 1}: row_err {m['row_err']:.3e} > "
             f"{PAIRWISE_ROW_BOUND}")
        for mu, v in m["mutants"].items():
            hold(v > PAIRWISE_ROW_BOUND,
                 f"pairwise at step {t + 1}: mutant {mu} reads {v:.3e} <= "
                 f"{PAIRWISE_ROW_BOUND}")
        out[t + 1] = m["row_err"]
    return out


def example_grades(name, card, cpu, fails, recs=None):
    """Hold one driver's card run against its CPU run; appends to
    ``fails``. ``recs``: the two runs' records (run_example). Returns the
    readings to print."""
    def hold(ok, what):
        if not ok:
            fails.append(f"{name}: {what}")

    if name in EXAMPLE_PIPELINES:
        g = pipeline_grades(name, dict(front=pipeline_front(name, card)),
                            dict(front=pipeline_front(name, cpu)),
                            *recs, fails)
        if name == "make_figures":
            g["i_opt"] = (card["i_opt"], cpu["i_opt"])
        if name == "realistic_data_pipeline":
            g["counts"] = (card["nan_npis"], card["neg_days"])
            hold((card["nan_frac"], card["neg_days"], card["nan_npis"])
                 == (cpu["nan_frac"], cpu["neg_days"], cpu["nan_npis"]),
                 "artefact counts differ")
        return g
    if name == "forecast_quality":
        r = close_ratio(torch.as_tensor(card["median_error_smooth"]),
                        torch.as_tensor(cpu["median_error_smooth"]),
                        EXAMPLE_BACKTEST_TOL)
        hold(r <= 1.0, f"median error curves {r:.3e} of the bound")
        return dict(curves=r)
    if name == "spatial_sims":
        same = lambda k: bit_equal(card[k].cpu(), cpu[k].cpu())
        g = dict(diffusion_bits=same("c4") and same("c8"),
                 walker_bits=same("walk_field") and same("walk_traj"))
        hold(g["diffusion_bits"] and g["walker_bits"],
             "diffusion or walker fields not bit for bit")
        sc, sp = card["sim"], cpu["sim"]
        g["pairwise"] = sim_pairwise_holds(sc.p, hold)
        dp = (sc.p.double().cpu() - sp.p.double().cpu()).abs().amax((1, 2))
        dpva = torch.stack([(getattr(sc, f).double().cpu()
                             - getattr(sp, f).double().cpu()).abs()
                            .amax((1, 2)) for f in ("p", "v", "a")]).amax(0)
        part = torch.nonzero(dp > 1e-3)
        g.update(traj_gap_at_10_20_30=[
            float(dpva[k - 1]) for k in (10, 20, 30) if k <= len(dpva)],
                 traj_parts_at=int(part[0]) if len(part)
                 else None, traj_final_dp=float(dp[-1]),
                 field_totals=(card["field_total"], cpu["field_total"]))
        hold(all(np.isfinite(card[k]) for k in ("mean_speed",
                                                "field_total")),
             "sim not finite")
        return g
    if name == "seirp_scenarios":
        a = np.array([v for s in card["scenarios"].values() for v in s]
                     + [card["saturated"], card["unlimited"]])
        b = np.array([v for s in cpu["scenarios"].values() for v in s]
                     + [cpu["saturated"], cpu["unlimited"]])
        r = close_ratio(torch.as_tensor(a), torch.as_tensor(b), SLICE6_TOL)
        hold(r <= 1.0 and card["rank"] == cpu["rank"] == 4,
             f"{r:.3e} of the bound, ranks {card['rank']}/{cpu['rank']}")
        return dict(values=r, bits=bool(np.array_equal(a, b)))
    if name == "rt_comparison":
        g = {k: close_ratio(torch.as_tensor(card[k]),
                            torch.as_tensor(cpu[k]), SLICE5_TOL)
             for k in ("gen_ratios", "log_lin", "ekf")}
        ls = torch.as_tensor(cpu["nonlin_ls"])
        g["nonlin_ls"] = close_ratio(torch.as_tensor(card["nonlin_ls"]), ls,
                                     dict(rtol=0.0, atol=LM_RTOL * float(
                                         ls.abs().max())))
        hold(max(g.values()) <= 1.0, f"{g}")
        return g
    if name in ("lstm_forecast", "direct_newcases_lstm"):
        lc, lp = card["losses"], cpu["losses"]
        g = dict(rms=rms_loss_ratio(lc[:EXAMPLE_LSTM_EPOCHS],
                                    lp[:EXAMPLE_LSTM_EPOCHS]),
                 rms_all=rms_loss_ratio(lc, lp),
                 final_loss=(lc[-1], lp[-1]))
        hold(g["rms"] <= 1.0, f"first {EXAMPLE_LSTM_EPOCHS} epochs "
                              f"{g['rms']:.3e} of the bound")
        hold(lc[-1] < lc[0] and np.isfinite(lc[-1]), "loss did not fall")
        if name == "lstm_forecast":
            g["mape"] = (card["mape"], cpu["mape"])
            hold(bool(np.isfinite(card["forecast"]).all()),
                 "forecast not finite")
        else:
            g["mae"] = (card["mae"], cpu["mae"])
            hold(np.isfinite(card["mae"]), "MAE not finite")
        return g
    if name == "ml_comparison":
        g = {}
        for m, tol in EXAMPLE_ML_TOL.items():
            g[m] = close_ratio(
                torch.tensor([r[m] for r in card["mae"].values()]),
                torch.tensor([r[m] for r in cpu["mae"].values()]), tol)
        g["lstm_rms"] = max(rms_loss_ratio(
            card["lstm_losses"][n][:EXAMPLE_LSTM_EPOCHS],
            cpu["lstm_losses"][n][:EXAMPLE_LSTM_EPOCHS])
            for n in card["lstm_losses"])
        g["lstm_mae"] = (card["mean_mae"]["lstm"], cpu["mean_mae"]["lstm"])
        g["best"] = (card["best"], cpu["best"])
        hold(max(v for k, v in g.items() if not isinstance(v, tuple))
             <= 1.0, f"{g}")
        return g
    raise KeyError(name)


def write_phase2_csvs():
    """A 235-region synthetic OxCGRT set over the XPRIZE driver's Phase-II
    window (2020-03-15 .. 2021-08-29) under EXAMPLES_DIR. Returns the
    three paths."""
    shutil.rmtree(EXAMPLES_DIR, ignore_errors=True)
    EXAMPLES_DIR.mkdir(parents=True)
    frame, pops, _ = synthetic_oxford_frame(R_REGIONS, PHASE2_DAYS,
                                            PHASE2_START, seed=0)
    files = write_oxford_csvs(EXAMPLES_DIR, frame, pops)
    return [files["data"], files["geos"], files["populations"]]


def phase2_checks(out, files, n, fails):
    """The full-width XPRIZE run's outputs: its kernels launched, 235
    regions, bang-bang prescriptions, finite costs, non-empty fronts and
    the prescriptions CSV's rows."""
    res = out["result"]
    u = res.pareto["u_prescribed"]
    hi = to_tensor(NPI_MAXES_DEFAULT, u.dtype, u.device)
    ok = dict(
        launches=n["ekf3"] > 0 and n["ekf6"] > 0,
        regions=out["n_regions"] == R_REGIONS
        and tuple(u.shape[1:]) == (R_REGIONS, PHASE2_HORIZON, 12),
        bang_bang=bool(((u == 0) | (u == hi)).all()),
        finite=bool(torch.isfinite(res.pareto["J0"]).all()
                    and torch.isfinite(res.pareto["J1"]).all()),
        fronts=int(res.pareto_front.sum(0).min()) >= 1,
        files=files == ["prescriptions.csv", "trained_params.npz"])
    fails.extend(f"xprize_prescribe (Phase II): {k}" for k, v in ok.items()
                 if not v)
    return ok


def examples_phase(device):
    """Slice 9: each example driver through its main on the card, timed,
    with its kernel launches, held against the same driver on the CPU;
    then the XPRIZE driver at full width (235 regions over its Phase-II
    window). Returns {driver: launches on the card}."""
    card = card_line()
    t0 = time.perf_counter()
    fails, launches = [], {}
    # the card machine may have no matplotlib: make_figures then runs
    # everything but the drawing, on both sides
    extra = {"make_figures": dict(
        plot=importlib.util.find_spec("matplotlib") is not None)}
    for name in EXAMPLE_NAMES:
        kw = extra.get(name, {})
        c, wall, n, files, lines, rec_c = run_example(name, device, **kw)
        p, cpu_wall, _, cpu_files, _, rec_p = run_example(
            name, torch.device("cpu"), **kw)
        launches[name] = {k: v for k, v in n.items() if v}
        for line in lines:
            log(f"example {name} | {line}")
        if files != cpu_files:
            fails.append(f"{name}: files {files} vs {cpu_files}")
        for k in EXAMPLE_KERNELS.get(name, ()):
            if n[k] <= 0:
                fails.append(f"{name}: {k} never launched")
        g = example_grades(name, c, p, fails, (rec_c, rec_p))
        del rec_c, rec_p
        cut = EXAMPLE_CUTS.get(name)
        log(f"example {name}: card wall={wall:.3f}s CPU wall={cpu_wall:.3f}s"
            f" launches={launches[name]}"
            + (f" (cut: {cut})" if cut else "") + f" files={files} "
            f"card vs CPU: {g} [{card}]")
        del c, p
    # the XPRIZE driver's file branch at full width
    files = write_phase2_csvs()
    out, wall, n, written, lines, _ = run_example(
        "xprize_prescribe", device, args=(["xprize_prescribe", *files],),
        record=False)
    tag = "xprize_prescribe (Phase II)"
    launches[tag] = {k: v for k, v in n.items() if v}
    for line in lines:
        log(f"example {tag} | {line}")
    ok = phase2_checks(out, written, n, fails)
    stages = {k: round(v, 3) for k, v in out["result"].stage_seconds.items()}
    log(f"example {tag}: {R_REGIONS} regions x "
        f"{PHASE2_DAYS - PHASE2_HORIZON}+{PHASE2_HORIZON} days, 250 eps: "
        f"card wall={wall:.3f}s stages={stages} launches={launches[tag]} "
        f"checks={ok} [{card}]")
    del out
    log(f"slice 9 (examples): {time.perf_counter() - t0:.1f}s, "
        f"{len(EXAMPLE_NAMES)} drivers, card kernel launches {launches} "
        f"[{card}]")
    check(not fails, "examples: " + "; ".join(fails))
    return launches


def kernel_entries(measured, xprize_launches, stencil_cases, sim_launches,
                   pairwise_cases, cli_launches, backtest, slice5_launches,
                   roofline, mesh_launches, deploy, example_launches, nnls,
                   f64, si_rollout):
    """One entry per kernel for the JSON line: its launches on its path's
    warm run, its largest error against the plain version, and kernel,
    plain-version, bound and library times at its largest timed shape
    (both versions timed); mesh_launches, its launches on the warm 5 x 1
    mesh XPRIZE run (MESH_SLOTS slots of the card, mesh_slots; not for
    newcase_ekf, which no mesh runs); deploy, slice 8's entry;
    example_launches, slice 9's launches per driver on the card
    (examples_launches, the drivers that launched the kernel); nnls,
    nnls_counts' measurements, with its launches on the warm main-path,
    CLI, backtest, trainer and mesh runs; f64, f64_path's entries for the
    double instances of ekf3 and ekf6 (their launches on the warm float64
    run_pipeline as f64_launches; their times, bound and largest errors
    held on that run's launches as f64; its rollout launches as
    rollout_launches); si_rollout, si_rollout_counts' measurements, with
    its launches on the warm main-path, float64 and CLI runs (and the mesh
    run's, the lead slot's). Fails if a kernel never launched
    on its path."""
    kernels = []
    for name in ("ekf3", "ekf6"):
        big = max((m for m in measured[name] if m["ms"] is not None),
                  key=lambda m: m["T"] * m["B"])
        b_ms, b_by = ekf_bound(name, big["T"], big["B"])
        kernels.append(dict(
            max_abs_err=max(m["abs_err"] for m in measured[name]),
            ms=big["ms"], plain_ms=big["plain_ms"], bound_ms=b_ms,
            bound_by=b_by, library_ms=None, launches=xprize_launches[name],
            path="run_pipeline (XPRIZE size, warm)",
            shape=f"T={big['T']} B={big['B']} ({big['tag']})"))
        kernels[-1]["cli_launches"] = cli_launches[name]
        kernels[-1]["f64_launches"] = f64[name]["launches"]
        kernels[-1]["f64"] = {k: v for k, v in f64[name].items()
                              if k != "launches"}
        if name == "ekf6":
            kernels[-1]["prescribe_launches"] = \
                slice5_launches["prescribe"][name]
            active = next(m for m in measured[name]
                          if m["tag"] == "per-capita, control active")
            kernels[-1].update(active_ms=active["ms"],
                               active_plain_ms=active["plain_ms"])
        else:
            kernels[-1]["train_launches"] = slice5_launches["train"][name]
            bt_bound, bt_by = ekf_bound(name, backtest["T"], backtest["B"])
            kernels[-1].update(
                max_abs_err=max(kernels[-1]["max_abs_err"],
                                backtest["abs_err"]),
                backtest_launches=backtest["launches"],
                backtest_ms=backtest["ms"],
                backtest_plain_ms=backtest["plain_ms"],
                backtest_bound_ms=bt_bound, backtest_bound_by=bt_by,
                backtest_max_abs_err=backtest["abs_err"],
                backtest_shape=f"T={backtest['T']} B={backtest['B']}")
    big = [m for m in stencil_cases
           if m.get("ms") is not None and m["eight"]][-1]
    kernels.append(dict(
        max_abs_err=max(m["abs_err"] for m in stencil_cases), ms=big["ms"],
        plain_ms=big["plain_ms"], bound_ms=big["bound_ms"],
        bound_by=big["bound_by"], library_ms=big["library_ms"],
        launches=sim_launches["stencil"],
        path=SIM_PATH,
        shape=f"{big['shape'][0]}x{big['shape'][1]} 8-neighbour float32"))
    timed = next(m for m in pairwise_cases if m["ms"] is not None)
    kernels.append(dict(
        max_abs_err=max(m["abs_err"] for m in pairwise_cases),
        max_row_err=max(m["row_err"] for m in pairwise_cases),
        min_mutant_row_err=min(v for m in pairwise_cases
                               for v in m["mutants"].values()),
        max_scaled_err=max(m["scaled_err"] for m in pairwise_cases),
        ms=timed["ms"], plain_ms=timed["plain_ms"],
        bound_ms=timed["bound_ms"], bound_by=timed["bound_by"],
        library_ms=None, launches=sim_launches["pairwise"],
        path=SIM_PATH,
        n100k_ms=pairwise_cases[-1]["big_ms"],
        n100k_bound_ms=pairwise_cases[-1]["big_bound_ms"],
        shape=f"N={timed['N']} O={timed['O']} float32"))
    kernels.append(roofline)
    kernels.append(deploy)
    kernels.append(dict(
        nnls, launches=xprize_launches["nnls"],
        path="run_pipeline (XPRIZE size, warm)",
        cli_launches=cli_launches["nnls"],
        backtest_launches=backtest["nnls_launches"],
        train_launches=slice5_launches["train"]["nnls"]))
    kernels.append(dict(
        si_rollout, launches=xprize_launches["rollout"],
        path="run_pipeline (XPRIZE size, warm)",
        f64_launches=f64["rollout_launches"],
        cli_launches=cli_launches["rollout"]))
    kernels = [dict(name=name, route="cuda",
                    **{f: v for f, v in KERNELS[name].items()
                       if f not in ("run", "plain")}, **k,
                    **({} if name == "newcase_ekf" else dict(
                        mesh_launches=mesh_launches[name],
                        mesh_slots=MESH_SLOTS)),
                    examples_launches={d: n[name] for d, n in
                                       example_launches.items()
                                       if n.get(name)})
               for name, k in zip(KERNELS, kernels)]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} never launched on its path")
    for name in ("ekf3", "ekf6", "nnls", "rollout"):
        check(mesh_launches[name] > 0, f"{name} never launched on the mesh")
    for path in ("cli", "backtest", "train"):
        check(kernels[-2][f"{path}_launches"] > 0,
              f"nnls never launched on the {path} path")
    check(kernels[-1]["cli_launches"] == kernels[-1]["f64_launches"]
          == SI_ROLLOUT_CALLS, f"rollout launches {kernels[-1]}")
    return kernels


def build_all():
    """Build every kernel, one nvcc per source, all started together with
    the deployment artefact's CPU build (g++), and print each kernel's
    ptxas register and spill lines."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(build.SOURCES) + 1) as pool:
        cpu_build = pool.submit(deploy_native.build_library)
        reports = list(pool.map(lambda n: build.build(n)[1], build.SOURCES))
        cpu_build.result()
    for name, report in zip(build.SOURCES, reports):
        for line in report.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill")):
                log(f"  ptxas {name}: {line.strip()}")
    log(f"build: {time.perf_counter() - t0:.1f}s")


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs one card")
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {kind} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | device_count "
        f"{torch.cuda.device_count()}")
    build_all()

    # the XPRIZE path (slice 1)
    bt, bf, actual, _ = xprize_inputs(R_REGIONS, T_HIST, HORIZON, seed=0)
    cfg = PipelineConfig(backend="pallas", smoother_gain="solve",
                         pareto_chunk=CHUNK, num_monte_carlo=N_MC)
    measured = {}
    for name, tag, args, bounds, timed in kernel_cases(bt, bf, actual, cfg,
                                                       device):
        measured.setdefault(name, []).append(
            compare_kernel(name, tag, args, device, bounds, timed))
    small_reference_check(device)
    main_res, _, xprize_launches = main_path(device, bt, bf, actual)
    f64 = f64_path(device, bt, bf, actual)
    nnls = nnls_counts(device)
    si_rollout = si_rollout_counts(device)

    # the spatial stack (slice 2)
    stencil_cases = stencil_phase(device) + multistep_phase(device)
    rollout_phase(device)
    walkers_phase(device)
    sim, sim_launches = sim_phase(device)
    pairwise_cases = pairwise_phase(device, sim.p)
    roofline = roofline_phase(device)

    # the XPRIZE product's own entry point and the backtest (slice 3)
    cli_launches, _, cli_files = cli_phase(device)
    backtest, _ = backtest_phase(device, bt)

    # the generic EKF/EKS core and the regressions (slice 4)
    vmap_phase(device, bt, bf, actual)

    # the standalone trainer and prescriptor, AR-alpha, Rt, smoothing,
    # filter health and the realistic-artefact data (slice 5)
    slice5_launches = slice5_phase(device, main_res, bt, bf, *cli_files)

    # the theory studies and the ML stack (slice 6)
    slice6_phase(device)

    # the device mesh, the multi-process runs and parallel_kalman (slice 7)
    mesh_launches = mesh_phase(device, bt, bf, actual, cli_files)

    # the native deployment artefact's card build (slice 8)
    deploy = deploy_phase(device)

    # the example drivers (slice 9)
    example_launches = examples_phase(device)

    kernels = kernel_entries(measured, xprize_launches, stencil_cases,
                             sim_launches, pairwise_cases, cli_launches,
                             backtest, slice5_launches, roofline,
                             mesh_launches, deploy, example_launches, nnls,
                             f64, si_rollout)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
