"""epidemicmodeling_torch — the PyTorch / CUDA port of epidemicmodeling_tpu.

The JAX package beside it is the reference: the tests run both on the same
inputs and hold each module of the port against its counterpart. Module
names mirror the JAX package's, so each counterpart is easy to find.

Every module of the JAX package but its JAX plumbing (utils/jax_cache.py,
utils/platform.py) is ported. The XPRIZE product runs from its own entry
points: the CLI (python -m epidemicmodeling_torch.pipelines.xprize_cli) and
pipelines.train_predict_prescribe read the OxCGRT CSVs without pandas and
run pipelines.run_pipeline, on the batch-last backends with the two EKF/EKS
kernels or on the "vmap" backend (the default) with the generic EKF/EKS
core (ops/ekf.py, tensor ops, MATLAB's pinv smoother gain) and any of the
three regressions, writing the XPRIZE prescriptions and predictions CSVs
and .npz or .mat checkpoints; pipelines.forecast_quality_assessment, the paper's
backtest, runs every (region, holdout start) filter in one ekf3 call. The
reference's offline tools run too: pipelines.train.train_npi_prescriptor
(training with the death-based mortality estimates and a checkpoint) and
pipelines.prescribe_from_checkpoint (the paper's sweep of up to 2000
epsilons from saved coefficients), with AR-alpha prescription, the
pre-generic 6-state EKS, the four Rt estimators, the smoothing filters,
the filter-health report, the realistic-artefact and OxCGRT_latest frames
and the JHU reader. The spatial stack (spatial.diffusion_rollout,
spatial.walkers.walking_sources_sim, spatial.population_motion_sim) runs
with the diffusion-stencil and pairwise-force kernels. The theory studies
(the SIR and SEIRP models, analysis/) and the ML stack (ml/: features,
ridge and ARX, epsilon-SVR, the LSTM forecasters) run as tensor ops and
cuDNN, with no kernel of their own. The pipeline, the backtest and the CLI
take a device mesh (parallel/: several slots, also across processes, split
the EKS kernels' lanes), and ops.parallel_kalman and viz/ complete the
port. The native deployment artefact (deploy/: the 6-state optimal-NPI
EKF/EKS and its epsilon sweep behind a C interface) is built for the card
and, with device="cpu", for the CPU; utils.profiling times stages and
captures profiler traces. All six kernels are written by hand in CUDA C++
for Hopper (csrc/, ops/cuda/, deploy/). The entry points run on the CUDA
card unless the caller passes CPU tensors or device="cpu"; for CPU tensors
each kernel wrapper runs its plain PyTorch version.

Subpackages
-----------
pipelines    config, batched stages, run_pipeline, the CSV entry point and
             CLI, checkpoint files, the forecast-quality backtest, the
             training-only entry point and the standalone prescriptor
spatial      diffusion CA, random-walk sources, agent sim with social forces
ops          the generic and the batch-last EKF/EKS cores, the CUDA kernels
             and their lane sharding, the associative-scan Kalman filter,
             AR fits and forecasts, smoothing filters, filter health
models       SI-alpha, costate and time-reversed systems (generic and
             batch-last), the SI, SI-alpha, SIR and SEIRP rollouts
analysis     linear systems, the SEIRP scenarios, country statistics,
             forward Hamiltonian shooting
ml           features, ridge and ARX, epsilon-SVR, the custom layers, the
             LSTM forecasters and optax's update
regression   batched NNLS with intercept refinement, LASSO, element-wise
             robust fits
rt           the four Rt estimators (generation ratios, log-linear and
             nonlinear least squares, the exponential-fit EKF/EKS)
control      NPI cost, epsilon grid, Pareto front, Monte-Carlo schedules
data         pandas-free OxCGRT and JHU loaders and XPRIZE CSV writers,
             NumPy-only preprocessing, synthetic and realistic-artefact
             frames and CSVs
utils        NaN-ordered clips, moving averages, dates, the entry points'
             default device, stage timing and profiler traces
parallel     the device mesh, the multi-process runs and their dry run
viz          the figures and the spatial animations (matplotlib)
deploy       the native deployment artefact: the card and CPU builds of
             the 6-state optimal-NPI EKF/EKS's C interface
"""

__version__ = "0.1.0"
