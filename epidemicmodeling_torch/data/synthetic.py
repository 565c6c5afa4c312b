"""Synthetic multi-region epidemics for tests and the chip smoke run.

NumPy-only counterpart of epidemicmodeling_tpu/data/synthetic.py:17-86
(synthetic_oxford_frame) without the DataFrame: it rolls the SI-alpha model
with region-specific parameters and piecewise-constant NPI schedules and
returns the same ``truth`` dict. It draws the same rng sequence, so for one
seed the truth is identical to the JAX package's (tests/test_torch_data.py).
"""

from __future__ import annotations

import numpy as np

from .preprocess import NPI_MAXES_DEFAULT


def _numpy_si_alpha_rollout(u, s0, i0, alpha0, u_max, alpha_min, alpha_max,
                            gamma, a, b, beta, K, dt):
    """Noise-free SI-alpha Euler rollout (Tools/SIalpha_Controlled.m
    semantics), initial condition excluded from outputs."""
    s = np.empty(K + 1); i = np.empty(K + 1); al = np.empty(K + 1)
    s[0], i[0], al[0] = s0, i0, alpha0
    for t in range(K):
        s[t + 1] = min(1.0, max(0.0, s[t] - dt * al[t] * s[t] * i[t]))
        i[t + 1] = min(1.0, max(0.0, i[t] + dt * (al[t] * s[t] * i[t]
                                                  - beta * i[t])))
        al[t + 1] = min(alpha_max, max(alpha_min, al[t] + dt * (
            -gamma * al[t] + gamma * b + gamma * a @ (u_max - u[t]))))
    return s[1:], i[1:], al[1:]


def synthetic_regions(n_regions: int = 4, n_days: int = 240, seed: int = 0,
                      npi_maxes=NPI_MAXES_DEFAULT, beta=None) -> dict:
    """Per-region generating parameters and trajectories, keyed by the
    region id ("Synthland{r} "): dict(a, b, beta, pop, u (n_days, P),
    s, i, alpha (n_days,))."""
    rng = np.random.default_rng(seed)
    P = len(npi_maxes)
    truth = {}
    for r in range(n_regions):
        pop = float(rng.integers(1_000_000, 80_000_000))
        # keep the equilibrium contact rate b + a.(umax-u) near beta so the
        # epidemic persists and NPIs matter; the default beta is the
        # pipeline's recovery rate (-ln(0.01)/21, PipelineConfig.beta_model)
        beta_r = beta if beta is not None else 0.21925347571405505
        a_true = 0.008 * rng.random(P)
        b_true = beta_r * (0.75 + 0.2 * rng.random())
        # piecewise-constant NPI schedule: levels change every ~30 days
        n_seg = -(-n_days // 30)
        seg_levels = rng.integers(0, np.asarray(npi_maxes, int) + 1,
                                  size=(n_seg, P))
        u = np.repeat(seg_levels, 30, axis=0)[:n_days].astype(float)
        alpha0 = beta_r + np.log(2.2)
        i0 = 50.0 / pop
        s, i, al = _numpy_si_alpha_rollout(
            u, 1.0 - i0, i0, alpha0, np.asarray(npi_maxes, float),
            1e-8, 100.0, 1.0 / 7.0, a_true, b_true, beta_r, n_days, 1.0)
        truth[f"Synthland{r} "] = dict(a=a_true, b=b_true, beta=beta_r,
                                       pop=pop, u=u, s=s, i=i, alpha=al)
    return truth
