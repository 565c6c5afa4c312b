"""epidemicmodeling_torch — the PyTorch / CUDA port of epidemicmodeling_tpu.

The JAX package beside it is the reference: the tests run both on the same
inputs and hold each module of the port against its counterpart. Module
names mirror the JAX package's, so each counterpart is easy to find.

This first slice is the XPRIZE train -> predict -> prescribe path
(pipelines.run_pipeline) on the batch-last backends, with the two EKF/EKS
kernels written by hand in CUDA C++ for Hopper (csrc/, ops/cuda/).

Subpackages
-----------
pipelines    config, batched stages, run_pipeline, parameter carry-over
ops          the batch-last EKF/EKS core and the CUDA kernels
models       batch-last SI-alpha system equations, the rollout step
regression   batched NNLS with intercept refinement
control      NPI cost, epsilon grid, Pareto front, Monte-Carlo schedules
data         NumPy-only preprocessing and synthetic regions
utils        NaN-ordered clips
"""

__version__ = "0.1.0"
