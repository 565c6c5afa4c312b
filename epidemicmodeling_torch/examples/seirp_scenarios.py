"""SEIRP scenario study driver (testScripts/testSEIRP01-03.m): run the five
named scenarios, print peak infections/final deaths, check observability and
the analytic eigenvalues, and compare saturated vs unlimited healthcare.
Scalar sequential rollouts in float64: one Python loop of small tensor ops
a step, no kernel of its own.

Usage: python -m epidemicmodeling_torch.examples.seirp_scenarios [--device cpu]
"""

import sys

import numpy as np
import torch

from ..analysis import (SEIRP_SCENARIOS, obsv, run_seirp_scenario,
                        seirp_early_eigen, seirp_early_phase_matrix)
from ..models import seirp_saturated_rollout
from ..utils.device import resolve_device
from ..utils.math import host_array
from ._common import split_device


def main(*, device=None, dt: float = 0.5):
    """Run the study; returns per scenario the peak infections, the final
    deaths and the third early-phase eigenvalue, the observability rank
    and the saturated and unlimited final deaths."""
    device = resolve_device(device)
    print("scenario | peak i | final deaths (fraction) | eig3 (growth rate)")
    scenarios = {}
    for name in SEIRP_SCENARIOS:
        res = run_seirp_scenario(name, dt=dt, device=device)
        rates = {k: float(v[0]) for k, v in res["rates"].items()}
        lam = host_array(seirp_early_eigen(**rates, device=device))
        peak, deaths = float(res["i"].max()), float(res["p"][-1])
        scenarios[name] = (peak, deaths, float(lam[2]))
        print(f"   {name}     | {peak:.4f} | "
              f"{deaths:.5f}            | {lam[2]:+.4f}")

    A = seirp_early_phase_matrix(
        alpha_e=0.65, alpha_i=0.005, kappa=0.05, rho=0.08, beta=0.1,
        mu=0.02, gamma=0.0, device=device)
    C = torch.cat([A.new_zeros((3, 1)), torch.eye(3, dtype=A.dtype,
                                                  device=A.device)], dim=1)
    rank = int(np.linalg.matrix_rank(host_array(obsv(A, C))))
    print(f"observability rank (observing i, r, p): {rank} / 4")

    # saturated-resource breakdown (testSEIRP03)
    K = 4000
    r5 = [np.full(K, v) for v in (0.9, 0.5, 0.3, 0.0, 0.0)]
    args = (0.99, 0.005, 0.005, 0.0, 0.0, 400.0, 0.1)
    p_sat = seirp_saturated_rollout(*r5, *args, 0.1, 0.05, 0.02, 0.2, 0.01,
                                    0.05, device=device)[4]
    p_nom = seirp_saturated_rollout(*r5, *args, 0.1, 0.1, 0.02, 0.02, 0.01,
                                    0.05, device=device)[4]
    sat, nom = float(p_sat[-1]), float(p_nom[-1])
    print(f"healthcare breakdown deaths: saturated {sat:.4f} "
          f"vs unlimited {nom:.4f}")
    return dict(scenarios=scenarios, rank=rank, saturated=sat,
                unlimited=nom)


if __name__ == "__main__":
    dev, _ = split_device(sys.argv)
    main(device=dev)
