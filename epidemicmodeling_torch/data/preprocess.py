"""Per-region data cleaning -> fixed-shape padded arrays + validity masks.

Reference behavior (inline in the drivers, Tools/TrainPredictPrescribeNPI.m):
- new cases = day-over-day difference of confirmed cases with the first sample
  duplicated, so the first day's new cases are 0 (:156)
- negative new cases clipped to 0 (:159) — "people are not born due to covid"
- a trailing NaN (today's not-yet-reported value) is back-filled with the last
  valid sample; all remaining NaNs become 0 (:164-170)
- causal smoothing: length-7 moving average, ``filter(ones(1,w), w, .)``
  (:173); a zero-phase pass with window round(w/2) is used ONLY to estimate
  the observation-noise variance (:174, :240)
- normalization by regional population (:175)
- NPI columns: forward-fill NaNs from the previous day, then zero-fill (:121-128)
- regions shorter than 2 days are masked out rather than processed (:103-106)

The batched design replaces the reference's per-region Python/MATLAB loop with
one (R, T, ...) array pack plus masks, so one batched EKF consumes all
regions at once.

A NumPy-only copy of epidemicmodeling_tpu/data/preprocess.py: importing the
JAX package's module would run its data/__init__.py (pandas) and its utils
(jax), neither of which the port may need. tests/test_torch_data.py holds the
two copies equal.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

OXFORD_NPI_COLUMNS = [
    "C1_School closing",
    "C2_Workplace closing",
    "C3_Cancel public events",
    "C4_Restrictions on gatherings",
    "C5_Close public transport",
    "C6_Stay at home requirements",
    "C7_Restrictions on internal movement",
    "C8_International travel controls",
    "H1_Public information campaigns",
    "H2_Testing policy",
    "H3_Contact tracing",
    "H6_Facial Coverings",
]

# Oxford codebook maxima (testScripts/testPrescribeXPRIZE02.m:38)
NPI_MAXES_DEFAULT = np.array([3, 3, 2, 4, 2, 3, 2, 4, 2, 3, 2, 4], float)


def _causal_ma(x: np.ndarray, win: int) -> np.ndarray:
    """MATLAB filter(ones(1,w), w, x): causal FIR with zero initial state."""
    kernel = np.ones(win) / win
    return np.convolve(np.concatenate([np.zeros(win - 1), x]), kernel,
                       mode="valid")


def _filtfilt_ma(x: np.ndarray, win: int) -> np.ndarray:
    """Zero-phase boxcar smoothing with filtfilt-style reflective padding."""
    from scipy.signal import filtfilt
    if win <= 1:
        # a length-1 boxcar is the identity; scipy's filtfilt rejects
        # single-tap filters (companion-matrix init needs >= 2 taps)
        return np.asarray(x, float).copy()
    b = np.ones(win) / win
    if len(x) <= 3 * win:
        # too short for default padding; fall back to double-pass causal
        f = _causal_ma(x, win)
        return _causal_ma(f[::-1], win)[::-1]
    return filtfilt(b, 1.0, x)


def clean_case_series(confirmed: np.ndarray):
    """Confirmed cumulative counts -> refined daily new cases.

    Returns (new_cases_refined, had_data) following the reference's exact
    cleaning order (diff-with-duplicated-first, clip negatives, back-fill the
    trailing NaN, zero remaining NaNs).
    """
    confirmed = np.asarray(confirmed, float)
    if confirmed.size < 2:
        return np.zeros_like(confirmed), False
    new_cases = np.diff(np.concatenate([[confirmed[0]], confirmed]))
    new_cases[new_cases < 0] = 0
    refined = new_cases.copy()
    if np.isnan(refined[-1]):
        valid = np.flatnonzero(~np.isnan(new_cases))
        if valid.size:
            refined[-1] = refined[valid[-1]]
    refined[np.isnan(refined)] = 0
    return refined, True


def forward_fill_npis(npis: np.ndarray) -> np.ndarray:
    """Forward-fill NaN NPI levels from the previous day, then zero-fill
    (vectorized equivalent of the reference's double loop)."""
    npis = np.asarray(npis, float).copy()
    T = npis.shape[0]
    idx = np.where(np.isnan(npis), 0, np.arange(T)[:, None])
    idx = np.maximum.accumulate(idx, axis=0)
    filled = npis[idx, np.arange(npis.shape[1])[None, :]]
    filled[np.isnan(filled)] = 0.0
    return filled


class RegionSeries(NamedTuple):
    """Cleaned single-region series (time-major numpy arrays)."""
    new_cases_smoothed: np.ndarray        # (T,) causal-MA daily cases
    new_cases_smoothed_norm: np.ndarray   # (T,) / population
    confirmed_smoothed_norm: np.ndarray   # (T,) cumulative / population
    new_deaths_smoothed: np.ndarray       # (T,)
    confirmed_deaths: np.ndarray          # (T,) raw cumulative deaths
    npis: np.ndarray                      # (T, P) forward-filled
    obs_noise_var: np.ndarray             # (T,) R_v estimate
    population: float
    valid: bool


def preprocess_region(confirmed, deaths, npis, population,
                      smoothing_win: int = 7,
                      obs_noise_factor: float = 0.1) -> RegionSeries:
    """Full per-region cleaning pipeline
    (Tools/TrainPredictPrescribeNPI.m:130-247)."""
    if not float(population) > 0:
        raise ValueError(
            f"population={population!r} — must be a positive count "
            "(everything downstream normalizes per capita); check the "
            "Population2020 column for this region")
    confirmed = np.asarray(confirmed, float)
    T = confirmed.shape[0]
    new_cases, ok = clean_case_series(confirmed)
    if deaths is None:
        deaths = np.zeros(T)
    new_deaths, _ = clean_case_series(np.asarray(deaths, float))

    nc_smooth = _causal_ma(new_cases, smoothing_win)
    nc_zero_lag = _filtfilt_ma(new_cases, max(1, round(smoothing_win / 2)))
    nd_smooth = _causal_ma(new_deaths, smoothing_win)
    conf_smooth = np.cumsum(nc_smooth)

    pop = float(population)
    # observation noise variance estimate (:240)
    r_v = obs_noise_factor * ((nc_zero_lag - new_cases) / pop) ** 2

    return RegionSeries(
        new_cases_smoothed=nc_smooth,
        new_cases_smoothed_norm=nc_smooth / pop,
        confirmed_smoothed_norm=conf_smooth / pop,
        new_deaths_smoothed=nd_smooth,
        confirmed_deaths=np.nan_to_num(np.asarray(deaths, float)),
        npis=forward_fill_npis(npis),
        obs_noise_var=r_v,
        population=pop,
        valid=bool(ok),
    )


class RegionBatch(NamedTuple):
    """Fixed-shape (R, T, ...) pack of all regions + masks: the unit the
    batched pipelines consume. Padded days carry NaN observations (=> the EKF
    runs pure prediction there) and zero NPIs."""
    observations: np.ndarray        # (R, T) chosen obs series (per obs_type)
    new_cases_norm: np.ndarray      # (R, T)
    confirmed_norm: np.ndarray      # (R, T)
    npis: np.ndarray                # (R, T, P)
    obs_noise_var: np.ndarray       # (R, T)
    population: np.ndarray          # (R,)
    length: np.ndarray              # (R,) true series length before padding
    valid: np.ndarray               # (R,) bool
    names: tuple                    # length-R tuple of "Country Region" ids
    deaths_smoothed: np.ndarray = None     # (R, T) smoothed daily deaths
    confirmed_deaths: np.ndarray = None    # (R, T) raw cumulative deaths


def build_region_batch(series: Sequence[RegionSeries], names: Sequence[str],
                       obs_type: str = "NEWCASES",
                       pad_to: Optional[int] = None,
                       horizon: int = 0) -> RegionBatch:
    """Pad per-region series to a common T (+ forecast horizon of NaN
    observations) and stack. Padded R_v entries repeat the per-region mean,
    matching the forecast-phase fill (Tools/TrainPredictPrescribeNPI.m:360)."""
    R = len(series)
    T0 = max((s.npis.shape[0] for s in series), default=0)
    T = (pad_to or T0) + horizon
    P = series[0].npis.shape[1] if R else 0

    obs = np.full((R, T), np.nan)
    ncn = np.full((R, T), np.nan)
    ccn = np.full((R, T), np.nan)
    npis = np.zeros((R, T, P))
    rv = np.zeros((R, T))
    pops = np.zeros(R)
    length = np.zeros(R, np.int64)
    valid = np.zeros(R, bool)
    nds = np.zeros((R, T))
    cds = np.zeros((R, T))

    for r, s in enumerate(series):
        L = s.npis.shape[0]
        sel = (s.new_cases_smoothed_norm if obs_type == "NEWCASES"
               else s.confirmed_smoothed_norm)
        obs[r, :L] = sel
        ncn[r, :L] = s.new_cases_smoothed_norm
        ccn[r, :L] = s.confirmed_smoothed_norm
        npis[r, :L] = s.npis
        npis[r, L:] = s.npis[-1] if L else 0.0  # hold last NPI level
        rv[r, :L] = s.obs_noise_var
        rv[r, L:] = s.obs_noise_var.mean() if L else 0.0
        nds[r, :L] = s.new_deaths_smoothed
        cds[r, :L] = s.confirmed_deaths
        if L:
            cds[r, L:] = s.confirmed_deaths[-1]
        pops[r] = s.population
        length[r] = L
        valid[r] = s.valid
    return RegionBatch(obs, ncn, ccn, npis, rv, pops, length, valid,
                       tuple(names), nds, cds)
