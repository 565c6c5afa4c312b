"""Prescribe from a saved checkpoint without retraining — the
testScripts/testPrescribeXPRIZE01.m flow: load trained (a, b) coefficients,
rebuild the historic state, sweep epsilon, score against random policies.
The pipeline runs on the "lanes" backend: on the card the ekf3 and ekf6
kernels, on the CPU their plain versions.

Usage: python -m epidemicmodeling_torch.examples.prescribe_from_checkpoint [params.npz] [--device cpu]
(no argument: trains once on synthetic data, saves trained_params.npz in
the working directory, then reloads it)."""

import sys

import numpy as np
import torch

from ..control import epsilon_grid, pareto_front_mask_batched
from ..data import NPI_MAXES_DEFAULT, synthetic_oxford_frame
from ..pipelines import (PipelineConfig, load_trained_params,
                         save_trained_params, trained_params_from_numpy)
from ..pipelines.core import forecast_scenarios, train_regions
from ..pipelines.prescribe import prescribe_from_checkpoint
from ..utils.device import resolve_device
from ..utils.math import host_array
from ._common import cpu_generator, split_device, truth_batches


def main(argv, *, device=None, dtype=None, generator=None, u_random=None):
    """Run the driver on ``argv`` (``[prog]`` or ``[prog, params.npz]``).
    The Monte-Carlo schedules come from ``u_random`` (N, H, P) when given,
    else from ``generator`` (default: a CPU generator seeded with 0).
    Returns the epsilon count, the front sizes, the Monte-Carlo policy
    count and the sweep's and the baseline's outputs."""
    device = resolve_device(device)
    dtype = dtype or torch.get_default_dtype()
    T_hist, H = 180, 40
    _, _, truth = synthetic_oxford_frame(n_regions=3, n_days=T_hist, seed=6)
    _, bt, bf = truth_batches(truth, horizon=H)
    cfg = PipelineConfig(pareto_chunk=16, backend="lanes")
    run = dict(dtype=dtype, device=device)

    out = train_regions(bt, np.zeros(12), NPI_MAXES_DEFAULT, T_hist, cfg,
                        **run)
    if len(argv) > 1:
        trained = load_trained_params(argv[1])
        print(f"loaded checkpoint {argv[1]}: {len(trained.names)} regions")
    else:
        save_trained_params("trained_params", out.trained)
        trained = load_trained_params("trained_params")
        print("trained + checkpointed + reloaded")
    trained = trained_params_from_numpy(trained, dtype, device)
    init = out.init

    _, s_hist = forecast_scenarios(bf, trained, init, np.ones(12),
                                   np.zeros(12), NPI_MAXES_DEFAULT, T_hist,
                                   cfg, **run)
    # the paper-scale 2000-point epsilon sweep (testPrescribeXPRIZE01.m:160)
    eps = epsilon_grid(2000).numpy()
    par, mc = prescribe_from_checkpoint(
        trained, bf, s_hist, init, eps, np.ones(12), np.zeros(12),
        NPI_MAXES_DEFAULT, T_hist, cfg, generator=generator or
        cpu_generator(0), u_random=u_random, **run)
    front = host_array(pareto_front_mask_batched(par["J0"], par["J1"]))
    print(f"swept {len(eps)} epsilon values; front sizes: "
          f"{front.sum(axis=0)}; MC baseline {mc['J0'].shape[0]} policies")
    return dict(n_epsilon=len(eps), front_sizes=front.sum(axis=0),
                n_policies=int(mc["J0"].shape[0]), front=front,
                pareto=par, monte_carlo=mc, trained=trained)


if __name__ == "__main__":
    dev, args = split_device(sys.argv)
    main(args, device=dev)
