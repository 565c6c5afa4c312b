"""Synthetic regions from a seed, cleaned into the pipeline's input arrays.

A frozen copy of the port's generator and cleaning, so that later changes to
the program cannot change the benchmark's inputs:
- ``_rollout`` and ``regions`` follow
  ``epidemicmodeling_torch/data/synthetic.py`` (``_numpy_si_alpha_rollout``,
  ``synthetic_regions``), its constants read from a recipe (the ``data``
  group of a configuration file): the recovery rate ``beta``, the
  contact-rate relaxation ``gamma``, the NPI influence's scale, the initial
  contact rate's growth factor, the segment length, the initial cases and
  the population range. At the generator's own constants (the
  configurations' recipe) it draws the port's regions from the same rng;
- ``_causal_ma``, ``_zero_phase_ma``, ``clean_new_cases`` and ``region_arrays``
  follow ``epidemicmodeling_torch/data/preprocess.py`` (``_causal_ma``,
  ``_filtfilt_ma``, ``clean_case_series``, ``preprocess_region``,
  ``build_region_batch``) for complete series, as the generator makes them.

Everything here is NumPy on the host, float64. The program and the
reference receive the same arrays.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import filtfilt

# Oxford codebook maxima of the 12 NPIs
# (testScripts/testPrescribeXPRIZE02.m:38)
NPI_MAXES = np.array([3, 3, 2, 4, 2, 3, 2, 4, 2, 3, 2, 4], float)
NPI_MINS = np.zeros(12)
NPI_WEIGHTS = np.ones(12)


def _rollout(u, s0, i0, alpha0, u_max, alpha_min, alpha_max, gamma, a, b,
             beta, K, dt):
    """Noise-free SI-alpha Euler rollout, the initial condition left out."""
    s = np.empty(K + 1); i = np.empty(K + 1); al = np.empty(K + 1)
    s[0], i[0], al[0] = s0, i0, alpha0
    for t in range(K):
        s[t + 1] = min(1.0, max(0.0, s[t] - dt * al[t] * s[t] * i[t]))
        i[t + 1] = min(1.0, max(0.0, i[t] + dt * (al[t] * s[t] * i[t]
                                                  - beta * i[t])))
        al[t + 1] = min(alpha_max, max(alpha_min, al[t] + dt * (
            -gamma * al[t] + gamma * b + gamma * a @ (u_max - u[t]))))
    return s[1:], i[1:], al[1:]


def regions(recipe: dict, rng: np.random.Generator) -> list:
    """Per-region generating parameters and trajectories over
    t_hist + horizon days: a list of dict(a, b, pop, u (n_days, P), s, i,
    alpha (n_days,)), drawn from ``rng``."""
    n_days = recipe["t_hist"] + recipe["horizon"]
    beta, gamma = recipe["beta"], recipe["gamma"]
    P = len(NPI_MAXES)
    seg = recipe["segment_days"]
    out = []
    for _ in range(recipe["regions"]):
        pop = float(rng.integers(*recipe["population"]))
        a = recipe["npi_influence"] * rng.random(P)
        b = beta * (recipe["b_low"] + recipe["b_span"] * rng.random())
        n_seg = -(-n_days // seg)
        levels = rng.integers(0, NPI_MAXES.astype(int) + 1, size=(n_seg, P))
        u = np.repeat(levels, seg, axis=0)[:n_days].astype(float)
        i0 = recipe["initial_cases"] / pop
        s, i, al = _rollout(u, 1.0 - i0, i0,
                            beta + np.log(recipe["initial_growth"]), NPI_MAXES,
                            1e-8, 100.0, gamma, a, b, beta, n_days,
                            recipe["dt"])
        out.append(dict(a=a, b=b, pop=pop, u=u, s=s, i=i, alpha=al))
    return out


def _causal_ma(x, win):
    """MATLAB filter(ones(1,w), w, x): causal, zero initial state."""
    return np.convolve(np.concatenate([np.zeros(win - 1), x]),
                       np.ones(win) / win, mode="valid")


def _zero_phase_ma(x, win):
    """filtfilt of the boxcar of length ``win`` (the series are longer than
    3 * win)."""
    return filtfilt(np.ones(win) / win, 1.0, x)


def clean_new_cases(confirmed):
    """Daily new cases from cumulative counts: the first day's difference
    0, negatives clipped (the series have no NaN)."""
    new = np.diff(np.concatenate([[confirmed[0]], confirmed]))
    new[new < 0] = 0
    return new


def region_arrays(truth: list, t_hist: int, horizon: int,
                  smoothing_win: int = 7, obs_noise_factor: float = 0.1
                  ) -> dict:
    """The pipeline's input arrays from the generated regions: per-capita
    smoothed new cases over the training window (NaN over the horizon), the
    observation-noise variance, the NPIs (the training window's last level
    held over the horizon), the populations and the NPIs actually applied
    over the whole window. Keys: obs, new_cases_norm, confirmed_norm,
    npis (R, T, P), obs_noise_var, population, actual (R, T, P); the
    training-window views are the first t_hist days."""
    R, T = len(truth), t_hist + horizon
    P = len(NPI_MAXES)
    obs = np.full((R, T), np.nan)
    ccn = np.full((R, T), np.nan)
    npis = np.zeros((R, T, P))
    rv = np.zeros((R, T))
    pops = np.zeros(R)
    actual = np.zeros((R, T, P))
    half = max(1, round(smoothing_win / 2))
    for r, tr in enumerate(truth):
        pop = tr["pop"]
        confirmed = np.cumsum(tr["s"] * tr["i"] * tr["alpha"] * pop)[:t_hist]
        new = clean_new_cases(confirmed)
        smooth = _causal_ma(new, smoothing_win)
        zero_lag = (_zero_phase_ma(new, half) if half > 1 else new)
        obs[r, :t_hist] = smooth / pop
        ccn[r, :t_hist] = np.cumsum(smooth) / pop
        rvr = obs_noise_factor * ((zero_lag - new) / pop) ** 2
        rv[r, :t_hist] = rvr
        rv[r, t_hist:] = rvr.mean()
        npis[r, :t_hist] = tr["u"][:t_hist]
        npis[r, t_hist:] = tr["u"][t_hist - 1]
        pops[r] = pop
        actual[r] = tr["u"]
    return dict(obs=obs, new_cases_norm=obs.copy(), confirmed_norm=ccn,
                npis=npis, obs_noise_var=rv, population=pops, actual=actual)


def input_set(recipe: dict, rng: np.random.Generator) -> dict:
    """One input set of a configuration: the arrays of ``region_arrays`` for
    the regions of ``regions(recipe, rng)``."""
    return region_arrays(regions(recipe, rng), recipe["t_hist"],
                         recipe["horizon"])


def epsilon_grid(n: int) -> np.ndarray:
    """The reference's tradeoff grid (testScripts/testPrescribeXPRIZE02.m:
    49-53), a frozen copy of the port's control.epsilon_grid: n // 2
    points logspace(-12, -eps), then linspace(eps, 1 - eps), eps the
    float64 machine epsilon."""
    import torch
    meps = float(np.finfo(np.float64).eps)
    n_log = n // 2
    kw = dict(dtype=torch.float64)
    return torch.cat([10.0 ** torch.linspace(-12.0, -meps, n_log, **kw),
                      torch.linspace(meps, 1.0 - meps, n - n_log, **kw)]
                     ).numpy()


def random_schedules(rng: np.random.Generator, n: int, H: int) -> np.ndarray:
    """The Monte-Carlo baseline's schedules (N, H, P): integer levels in
    [0, max], the first half constant over the horizon, the rest redrawn
    daily (Tools/TrainPredictPrescribeNPI.m:496-522)."""
    P = len(NPI_MAXES)
    top = NPI_MAXES.astype(np.int64) + 1
    const = rng.integers(0, top, size=(n, 1, P))
    daily = rng.integers(0, top, size=(n, H, P))
    first = (np.arange(n) < n // 2)[:, None, None]
    return np.where(first, np.broadcast_to(const, (n, H, P)),
                    daily).astype(float)


def sample_epsilons(rng: np.random.Generator, E: int, k: int) -> np.ndarray:
    """k epsilon indices of E, sorted: both ends of the grid and k - 2
    drawn from ``rng``."""
    inner = rng.choice(np.arange(1, E - 1), size=min(k, E) - 2,
                       replace=False)
    return np.sort(np.concatenate([[0, E - 1], inner])).astype(np.int64)
