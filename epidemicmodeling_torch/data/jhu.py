"""JHU CSSE time-series loader, without pandas.

Counterpart of epidemicmodeling_tpu/data/jhu.py (Tools/ReadCOVID19Data.m):
reads the three JHU CSSE global CSVs (confirmed / deaths / recovered),
sums the rows whose country field contains each requested region name, and
returns per-region matrices (TotalCases, Infected = cases - deaths -
recovered, Recovered, Deceased) plus the first-case and min-case date
indices. The files go through data/csvio.py, so quoted names ("Korea,
South") and pandas' missing cells read as pandas reads them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .csvio import parse_floats, read_csv_columns, text


def _region_sums(path, region_list):
    """(R, T) sums of the date columns (every column after the fourth) over
    the rows whose Country/Region contains each name, and the date labels.
    The match is a substring test, as pandas' str.contains(regex=False):
    "Niger" also matches "Nigeria". A missing cell reads as NaN and
    propagates through its region's sum."""
    cols = read_csv_columns(path)
    names = list(cols)
    dates = names[4:]
    values = (np.stack([parse_floats(cols[d], d) for d in dates], axis=1)
              if dates else np.zeros((len(cols[names[0]]), 0)))
    # a missing country cell is NaN in pandas, "nan" after astype(str)
    countries = ["nan" if c is None else c
                 for c in text(cols["Country/Region"])]
    sums = np.zeros((len(region_list), len(dates)))
    for k, name in enumerate(region_list):
        rows = [j for j, c in enumerate(countries) if name in c]
        sums[k] = values[rows].sum(axis=0)
    return sums, dates


def read_covid19_data(confirmed_csv, deaths_csv, recovered_csv,
                      region_list: Sequence[str], min_cases: float = 1.0):
    """Returns dict with TotalCases, Infected, Recovered, Deceased
    ((R, NumDays) arrays), FirstCaseDateIndex, MinCaseDateIndex, NumDays,
    and the date column labels (the confirmed file's)."""
    total, dates = _region_sums(confirmed_csv, region_list)
    deceased, _ = _region_sums(deaths_csv, region_list)
    recovered, _ = _region_sums(recovered_csv, region_list)
    infected = total - deceased - recovered
    R = len(region_list)
    first_idx = np.zeros(R, np.int64)
    min_idx = np.zeros(R, np.int64)
    for k in range(R):
        pos = np.flatnonzero(total[k] > 0)
        first_idx[k] = pos[0] if pos.size else 0
        posm = np.flatnonzero(total[k] >= min_cases)
        min_idx[k] = posm[0] if posm.size else 0
    return dict(TotalCases=total, Infected=infected, Recovered=recovered,
                Deceased=deceased, FirstCaseDateIndex=first_idx,
                MinCaseDateIndex=min_idx, NumDays=len(dates), dates=dates)
