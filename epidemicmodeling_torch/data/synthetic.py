"""Synthetic multi-region epidemics for tests and the chip smoke run.

NumPy-only counterpart of epidemicmodeling_tpu/data/synthetic.py:17-86
without pandas: ``synthetic_regions`` rolls the SI-alpha model with
region-specific parameters and piecewise-constant NPI schedules and returns
the same ``truth`` dict, drawing the same rng sequence, so for one seed the
truth is identical to the JAX package's (tests/test_torch_data.py);
``synthetic_oxford_frame`` lays it out as the JAX frame's OxCGRT-schema
rows (as columns); ``realistic_oxford_frame`` adds the real-data artefacts
from a second rng in the JAX package's draw order, and
``to_oxcgrt_latest_schema`` widens a frame to the live OxCGRT_latest.csv
column set, each with the JAX frame's values for a seed; and
``write_oxford_csvs`` writes the oxford, populations and geos CSV files the
loaders and the CLI read.
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


def _day_of_week(start_date: str, n_days: int) -> np.ndarray:
    """0 = Monday .. 6 = Sunday of each day from start_date (1970-01-01, day
    0 of datetime64[D], was a Thursday)."""
    days = np.datetime64(start_date, "D") + np.arange(n_days)
    return (days.astype(np.int64) + 3) % 7


def realistic_oxford_frame(n_regions: int = 4, n_days: int = 240,
                           start_date: str = "2020-03-01", seed: int = 0,
                           npi_maxes=NPI_MAXES_DEFAULT, beta=None):
    """"Real-artifact" mode of epidemicmodeling_tpu/data/synthetic.py:89:
    the pathologies of real OxCGRT/JHU case histories composed on top of
    the clean synthetic epidemic, so the fixture exercises every rule of the
    cleaning layer at once (new-case diff + negative clipping,
    TrainPredictPrescribeNPI.m:156-159; trailing-NaN backfill + NaN
    zero-fill :160-170; NPI forward-fill then zero-fill :121-128;
    short-history skip :103-106):

    - weekend under-reporting dips with a Monday catch-up (weekly totals
      conserved);
    - multi-day reporting gaps: the cumulative count freezes, then the
      missed cases come in one catch-up day;
    - negative revisions: the cumulative count drops on correction days;
    - NaN holes mid-series and a trailing NaN (region 0);
    - a late-starting region: a leading NaN run (region 1, when
      n_days > 80);
    - NaN runs and leading NaNs in the NPI columns.

    The artefacts come from np.random.default_rng(seed + 1000) in the JAX
    package's order, so for one seed every cell equals the JAX frame's (NaN
    where it is NaN). Returns (frame, pops, truth) like
    synthetic_oxford_frame; truth also records each region's clean
    cumulative series under "confirmed_clean"."""
    frame, pops, truth = synthetic_oxford_frame(
        n_regions=n_regions, n_days=n_days, start_date=start_date,
        seed=seed, npi_maxes=npi_maxes, beta=beta)
    rng = np.random.default_rng(seed + 1000)
    P = len(npi_maxes)
    npi_cols = OXFORD_NPI_COLUMNS[:P]
    dow = _day_of_week(start_date, n_days)
    cases = np.array(frame["ConfirmedCases"], float)
    deaths_all = np.array(frame["ConfirmedDeaths"], float)
    u_all = np.stack([np.array(frame[c], float) for c in npi_cols], axis=1)

    for r in range(n_regions):
        rows = slice(r * n_days, (r + 1) * n_days)   # the region's days
        confirmed = cases[rows].copy()
        truth[f"Synthland{r} "]["confirmed_clean"] = confirmed.copy()
        new_cases = np.diff(np.concatenate([[confirmed[0]], confirmed]))

        # 1) weekend dips + Monday catch-up (weekly totals conserved)
        dip = rng.uniform(0.3, 0.6)
        carried = 0.0
        nc = new_cases.copy()
        for t in range(n_days):
            if dow[t] >= 5:                        # Sat/Sun under-report
                held = nc[t] * (1.0 - dip)
                nc[t] -= held
                carried += held
            elif dow[t] == 0 and carried > 0:      # Monday catch-up
                nc[t] += carried
                carried = 0.0

        # 2) reporting gaps: cumulative freezes, then one catch-up dump
        for _ in range(3):
            g0 = int(rng.integers(20, n_days - 10))
            glen = int(rng.integers(2, 6))
            dumped = nc[g0:g0 + glen].sum()
            nc[g0:g0 + glen] = 0.0
            nc[g0 + glen] += dumped

        confirmed = np.cumsum(nc)

        # 3) negative revisions: permanent downward corrections
        for _ in range(2):
            t0 = int(rng.integers(n_days // 2, n_days - 5))
            delta = 0.05 * confirmed[t0]
            confirmed[t0:] -= delta

        # 4) NaN holes + trailing NaN (region 0 gets the trailing NaN)
        holes = rng.integers(10, n_days - 2, size=4)
        confirmed[holes] = np.nan
        if r == 0:
            confirmed[-1] = np.nan

        # 5) late-starting region: leading NaN run (region 1)
        if r == 1 and n_days > 80:
            confirmed[:40] = np.nan

        # 6) NPI NaN runs + leading NaNs
        u = u_all[rows]
        for j in range(P):
            if rng.random() < 0.5:
                h0 = int(rng.integers(5, n_days - 10))
                u[h0:h0 + int(rng.integers(3, 10)), j] = np.nan
        if r == 1:
            u[:15, :] = np.nan                      # pre-reporting era

        cases[rows] = confirmed
        deaths_all[rows] = np.where(np.isnan(confirmed), np.nan,
                                    0.01 * confirmed)

    frame = dict(frame, ConfirmedCases=cases, ConfirmedDeaths=deaths_all,
                 **{c: u_all[:, j] for j, c in enumerate(npi_cols)})
    return frame, pops, truth


def _is_missing(v) -> bool:
    return v is None or (isinstance(v, float) and v != v)


def to_oxcgrt_latest_schema(frame: dict, seed: int = 0) -> dict:
    """A frame ({column: values}, e.g. synthetic_oxford_frame's) widened to
    the full live OxCGRT_latest.csv column set (data.oxford.
    OXCGRT_LATEST_COLUMNS), as epidemicmodeling_tpu/data/synthetic.py:191
    widens its DataFrame: the CountryCode / RegionCode / Jurisdiction
    identity columns, the per-NPI Flag columns, the E/H policy columns the
    pipeline ignores, M1_Wildcard and the aggregate indices, drawn column by
    column from np.random.default_rng(seed) in the column set's order (the
    columns already present are kept and draw nothing). RegionName stays
    None where the JAX frame has NaN. Returns the columns in
    OXCGRT_LATEST_COLUMNS order."""
    from .oxford import OXCGRT_LATEST_COLUMNS

    rng = np.random.default_rng(seed)
    out = dict(frame)
    n = len(out["CountryName"])
    countries = [str(c) for c in out["CountryName"]]
    regions = out["RegionName"]
    is_state = [not _is_missing(g) and str(g) != "" for g in regions]
    out["CountryCode"] = [c.upper()[:3] for c in countries]
    out["RegionCode"] = [c.upper()[:2] + "_" + str(g).upper()[:2] if st
                         else "" for c, g, st in
                         zip(countries, regions, is_state)]
    out["Jurisdiction"] = ["STATE_TOTAL" if st else "NAT_TOTAL"
                           for st in is_state]
    for col in OXCGRT_LATEST_COLUMNS:
        if col in out:
            continue
        if col.endswith("_Flag"):
            out[col] = rng.integers(0, 2, n).astype(float)
        elif col.endswith("ForDisplay") or col.endswith("Index"):
            out[col] = rng.uniform(0, 100, n).round(2)
        elif col == "M1_Wildcard":
            out[col] = np.full(n, np.nan)
        else:  # E/H policy indicators the pipeline ignores
            out[col] = rng.integers(0, 3, n).astype(float)
    return {col: out[col] for col in OXCGRT_LATEST_COLUMNS}


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
