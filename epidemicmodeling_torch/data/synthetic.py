"""Synthetic multi-region epidemics for tests and the chip smoke run.

NumPy-only counterpart of epidemicmodeling_tpu/data/synthetic.py:17-86
without pandas: ``synthetic_regions`` rolls the SI-alpha model with
region-specific parameters and piecewise-constant NPI schedules and returns
the same ``truth`` dict, drawing the same rng sequence, so for one seed the
truth is identical to the JAX package's (tests/test_torch_data.py);
``synthetic_oxford_frame`` lays it out as the JAX frame's OxCGRT-schema
rows (as columns), and ``write_oxford_csvs`` writes the oxford, populations
and geos CSV files the loaders and the CLI read.
"""

from __future__ import annotations

import datetime as _dt
import os

import numpy as np

from .csvio import write_csv_columns
from .preprocess import NPI_MAXES_DEFAULT, OXFORD_NPI_COLUMNS


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


def synthetic_oxford_frame(n_regions: int = 4, n_days: int = 240,
                           start_date: str = "2020-03-01", seed: int = 0,
                           npi_maxes=NPI_MAXES_DEFAULT, beta=None):
    """Returns (frame, pops, truth): the JAX package's
    synthetic_oxford_frame rows as {column: values} in its column order
    (CountryName, RegionName (None), Date (YYYYMMDD int64),
    ConfirmedCases, ConfirmedDeaths, the first P NPI columns), the
    populations table likewise (CountryName, RegionName, Code,
    Population2020), and the generating truth of synthetic_regions."""
    truth = synthetic_regions(n_regions, n_days, seed, npi_maxes, beta)
    d0 = _dt.date.fromisoformat(start_date)
    days = [d0 + _dt.timedelta(days=t) for t in range(n_days)]
    date_num = np.array([d.year * 10000 + d.month * 100 + d.day
                         for d in days], np.int64)
    names = [f"Synthland{r}" for r in range(n_regions)]
    P = len(npi_maxes)
    confirmed, deaths, u = [], [], []
    for tr in truth.values():
        new_cases = tr["s"] * tr["i"] * tr["alpha"] * tr["pop"]
        confirmed.append(np.cumsum(new_cases))
        deaths.append(np.cumsum(0.01 * new_cases))
        u.append(tr["u"])
    u = np.concatenate(u) if u else np.zeros((0, P))
    frame = {
        "CountryName": [n for n in names for _ in range(n_days)],
        "RegionName": [None] * (n_regions * n_days),
        "Date": np.tile(date_num, n_regions),
        "ConfirmedCases": np.concatenate(confirmed) if confirmed else
        np.zeros(0),
        "ConfirmedDeaths": np.concatenate(deaths) if deaths else np.zeros(0),
    }
    for j, c in enumerate(OXFORD_NPI_COLUMNS[:P]):
        frame[c] = u[:, j]
    pops = {"CountryName": names, "RegionName": [None] * n_regions,
            "Code": [f"SY{r}" for r in range(n_regions)],
            "Population2020": [truth[n + " "]["pop"] for n in names]}
    return frame, pops, truth


def write_oxford_csvs(directory, frame: dict, pops: dict) -> dict:
    """Write the oxford, populations and geos CSVs of a frame (e.g.
    synthetic_oxford_frame's) into ``directory``, as pandas' to_csv writes
    them. Returns {"data": path, "populations": path, "geos": path}."""
    paths = {k: os.path.join(str(directory), f) for k, f in
             (("data", "oxford.csv"), ("populations", "populations.csv"),
              ("geos", "geos.csv"))}
    write_csv_columns(paths["data"], frame)
    write_csv_columns(paths["populations"], pops)
    write_csv_columns(paths["geos"], {k: pops[k] for k in
                                      ("CountryName", "RegionName")})
    return paths
