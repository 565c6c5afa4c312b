"""Produce the reference's headline figures from a pipeline run: state
estimates with sigma envelopes, the scenario comparison, and the Pareto
cloud (TrainPredictPrescribeNPI.m plotting sections; Figures/*.png in the
reference repo). Writes PNGs to ./figures/ (viz/, matplotlib). The
pipeline runs on the "lanes" backend: on the card the ekf3 and ekf6
kernels, on the CPU their plain versions.

Usage: python -m epidemicmodeling_torch.examples.make_figures [--device cpu]
"""

import os
import sys

import numpy as np
import torch

from ..control import epsilon_grid
from ..data import NPI_MAXES_DEFAULT, synthetic_oxford_frame
from ..pipelines import PipelineConfig
from ..pipelines.core import train_regions
from ..pipelines.train_predict_prescribe import run_pipeline
from ..utils.device import resolve_device
from ..utils.math import host_array
from ..viz import select_optimal_index
from ._common import cpu_generator, split_device, truth_batches

FIGURES = ("states.png", "scenarios.png", "pareto.png",
           "training_diagnostic.png", "npi_schedule.png")


def main(outdir="figures", *, device=None, dtype=None, generator=None,
         u_random=None, plot: bool = True):
    """Run the pipeline and draw the five figures into ``outdir``. The
    Monte-Carlo schedules come from ``u_random`` (N, H, P) when given, else
    from ``generator`` (default: a CPU generator seeded with 0). plot=False
    runs everything but the drawing (for a machine without matplotlib).
    Returns the optimal epsilon index, the arrays each figure shows and
    the pipeline's result."""
    device = resolve_device(device)
    dtype = dtype or torch.get_default_dtype()
    _, _, truth = synthetic_oxford_frame(n_regions=3, n_days=260, seed=4)
    T_hist, H = 220, 40
    names, bt, bf = truth_batches(truth, T_hist, horizon=H)

    cfg = PipelineConfig(num_monte_carlo=200, pareto_chunk=16,
                         backend="lanes")
    # train separately so the per-region diagnostic (rho monitor, round-1/2
    # smoothed fits) is available, then reuse the trained params
    tr_out = train_regions(bt, np.zeros(12), NPI_MAXES_DEFAULT, T_hist, cfg,
                           dtype=dtype, device=device)
    res = run_pipeline(bt, bf, None, T_hist, np.ones(12),
                       epsilon_grid(32).numpy(), np.zeros(12),
                       NPI_MAXES_DEFAULT, T_hist, cfg,
                       generator or cpu_generator(0), dtype,
                       trained=tr_out.trained, device=device,
                       u_random=u_random)

    r = 0
    pop = float(res.trained.population[r])
    sh = host_array(res.s_hist[r])
    scen = res.scenarios
    cases = {}
    for label in ("fixed", "zero", "max"):
        sc = scen[label]
        cases[f"{label} NPI"] = host_array(sc.s[r] * sc.i[r] * sc.alpha[r])
    J0 = host_array(res.pareto["J0"][:, r])
    J1 = host_array(res.pareto["J1"][:, r])
    i_opt = select_optimal_index(J0, J1)
    cases["optimal NPI"] = host_array(
        res.pareto["s"][i_opt, r] * res.pareto["i"][i_opt, r]
        * res.pareto["alpha"][i_opt, r])
    u_opt = host_array(res.pareto["u_prescribed"])[i_opt, r]
    shown = dict(states=sh, cases=cases, J0=J0, J1=J1,
                 mc_J0=host_array(res.monte_carlo["J0"][:, r]),
                 mc_J1=host_array(res.monte_carlo["J1"][:, r]),
                 front=host_array(res.pareto_front[:, r]),
                 s_smooth_round1=host_array(tr_out.s_smooth_round1[r]),
                 s_smooth_round2=host_array(tr_out.s_smooth_round2[r]),
                 rho_round1=host_array(tr_out.rho_round1[r]),
                 rho_round2=host_array(tr_out.rho_round2[r]),
                 u_prescribed=u_opt)
    if plot:
        _draw(outdir, names[r], pop, i_opt, shown, bt, res, r, T_hist)
        print(f"wrote {outdir}/states.png, scenarios.png, pareto.png, "
              f"training_diagnostic.png, npi_schedule.png "
              f"(optimal index {i_opt})")
    else:
        print(f"figures not drawn (plot=False); optimal index {i_opt}")
    return dict(i_opt=i_opt, outdir=outdir if plot else None, result=res,
                **shown)


def _draw(outdir, name, pop, i_opt, shown, bt, res, r, T_hist):
    """The five figures of the JAX driver, from ``shown``."""
    from ..viz import (plot_npi_schedule, plot_pareto_cloud, plot_scenarios,
                       plot_state_estimates, plot_training_diagnostic)
    os.makedirs(outdir, exist_ok=True)
    scen = res.scenarios
    plot_state_estimates(s_smooth=shown["states"],
                         title=f"{name} smoothed states",
                         path=f"{outdir}/states.png")
    plot_scenarios(shown["cases"], population=pop,
                   title=f"{name} scenario comparison",
                   path=f"{outdir}/scenarios.png")
    plot_pareto_cloud(
        shown["mc_J0"], shown["mc_J1"], shown["J0"], shown["J1"],
        front_mask=shown["front"], J0_fixed=float(scen["fixed"].J0[r]),
        J1_fixed=float(scen["fixed"].J1[r]), population=pop,
        title=f"{name} Pareto tradeoff", path=f"{outdir}/pareto.png")
    # per-region training diagnostic: new-case fits, rho monitor,
    # alpha-vs-regression-fit, NPI schedule (the reference's 4-panel
    # debug figure, TrainPredictPrescribeNPI.m:697-733)
    tr = res.trained
    plot_training_diagnostic(
        bt.new_cases_norm[r], shown["s_smooth_round1"],
        shown["s_smooth_round2"], shown["rho_round1"], shown["rho_round2"],
        bt.npis[r], a1=host_array(tr.a1[r]), b1=float(tr.b1[r]),
        a2=host_array(tr.a2[r]), b2=float(tr.b2[r]),
        npi_maxes=NPI_MAXES_DEFAULT, num_regression_days=T_hist,
        population=pop, title=f"{name} training diagnostic",
        path=f"{outdir}/training_diagnostic.png")
    # NPI-schedule overlay: history + the optimal-epsilon prescription
    plot_npi_schedule(
        bt.npis[r], u_prescribed=shown["u_prescribed"],
        npi_maxes=NPI_MAXES_DEFAULT,
        title=f"{name} NPI schedule (optimal eps index {i_opt})",
        path=f"{outdir}/npi_schedule.png")


if __name__ == "__main__":
    dev, _ = split_device(sys.argv)
    main(device=dev)
