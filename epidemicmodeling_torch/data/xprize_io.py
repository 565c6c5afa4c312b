"""XPRIZE prediction / prescription CSV writers and the future-plan reader.

Counterpart of epidemicmodeling_tpu/data/xprize_io.py:21-110, without
pandas. The output schemas are the XPRIZE ones
(xprize-sample-data/2020-08-01_2020-08-04_predictions_example.csv:
CountryName, RegionName, Date, PredictedDailyNewCases, IsSpecialty; and
..._prescriptions_example.csv: PrescriptionIndex, CountryName, RegionName,
Date, <12 NPI columns>). The writers use ``csvio.write_csv_rows``, the
dialect of pandas' ``to_csv``, so a prescriptions file is byte-for-byte the
JAX package's.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..utils.dates import date_range_days, num_days_between
from ..utils.math import host_array
from .csvio import (csv_cell, csv_line, parse_floats, read_csv_columns,
                    write_csv_rows)
from .oxford import date_numbers, geo_ids_of
from .preprocess import OXFORD_NPI_COLUMNS


def _split_geo(geo_id: str):
    """'Country Region' (trailing space for country-level) -> fields."""
    country, _, region = str(geo_id).rpartition(" ")
    if not country:
        country, region = region, ""
    return country, region


def write_predictions_csv(path, geo_ids: Sequence[str], start_date: str,
                          predicted_daily_new_cases, is_specialty=False):
    """predicted_daily_new_cases: (R, T) array or tensor. Writes the XPRIZE
    schema; each value as its shortest round-trip decimal (repr), a NaN as
    an empty cell (as pandas writes it)."""
    pred = np.asarray(host_array(predicted_daily_new_cases), float)
    R, T = pred.shape
    dates = date_range_days(start_date, T)
    flag = int(bool(is_specialty))
    rows = []
    for r, gid in enumerate(geo_ids):
        country, region = _split_geo(gid)
        rows.extend([country, region, d, csv_cell(pred[r, t]), flag]
                    for t, d in enumerate(dates))
    return write_csv_rows(path, ["CountryName", "RegionName", "Date",
                              "PredictedDailyNewCases", "IsSpecialty"], rows)


def write_prescriptions_csv(path, geo_ids: Sequence[str], start_date: str,
                            prescriptions, npi_columns=None):
    """prescriptions: (n_idx, R, T, P), one block per PrescriptionIndex (e.g.
    selected Pareto-front points). Writes the XPRIZE schema, each level
    rounded to an integer. The lines are assembled from pieces formatted
    once each (a geo's quoted name fields, the dates, each row of levels):
    the bytes the csv module writes row by row."""
    npi_columns = list(npi_columns or OXFORD_NPI_COLUMNS)
    u = np.asarray(host_array(prescriptions), float)
    n_idx, R, T, P = u.shape
    levels = np.rint(u).astype(np.int64).reshape(-1, P)
    if P and levels.min() >= 0 and levels.max() <= 9:
        # one digit a level: the row's text is its digits between commas
        text_ = np.full((len(levels), 2 * P - 1), ord(","), np.uint8)
        text_[:, ::2] = levels + ord("0")
        level_str = text_.view(f"S{2 * P - 1}").ravel().astype(str).tolist()
    else:
        level_str = [",".join(map(str, row)) for row in levels.tolist()]
    names = [csv_line(_split_geo(g)) for g in geo_ids]
    dates = date_range_days(start_date, T)
    lines = [csv_line(["PrescriptionIndex", "CountryName", "RegionName",
                       "Date"] + npi_columns[:P])]
    k = 0
    for idx in range(n_idx):
        for r in range(R):
            head = f"{idx},{names[r]},"
            lines.extend(f"{head}{d},{lv}"
                         for d, lv in zip(dates, level_str[k:k + T]))
            k += T
    with open(path, "w", newline="") as f:
        f.write("\n".join(lines) + "\n")
    return path


def read_future_ip(path, geo_ids: Sequence[str], start_date: str,
                   end_date: str, npi_columns=None) -> np.ndarray:
    """Read a future-intervention-plan CSV (the XPRIZE ``future_ip.csv``
    schema: CountryName, RegionName, Date, one column per NPI) into an
    (R, T, P) schedule aligned to geo_ids over [start_date, end_date]
    inclusive. Missing days are forward-filled (zero before the first
    entry); geos absent from the file get all-zero schedules. Dates as in
    load_oxford_data: ISO dates or YYYYMMDD integers; for a day listed
    twice, the later row wins."""
    npi_columns = list(npi_columns or OXFORD_NPI_COLUMNS)
    P = len(npi_columns)
    T = num_days_between(start_date, end_date) + 1
    date_idx = {int(d.replace("-", "")): t
                for t, d in enumerate(date_range_days(start_date, T))}
    cols = read_csv_columns(path)
    geo = geo_ids_of(cols)
    dates = date_numbers(cols["Date"], "future plan Date")
    levels = np.stack([parse_floats(cols[c], c) for c in npi_columns], axis=1)
    rows_of = {}
    for k, g in enumerate(geo):
        rows_of.setdefault(g, []).append(k)
    out = np.zeros((len(geo_ids), T, P))
    for r, gid in enumerate(geo_ids):
        if gid not in rows_of:
            continue
        sched = np.full((T, P), np.nan)
        for k in rows_of[gid]:
            t = date_idx.get(int(dates[k]))
            if t is not None:
                sched[t] = levels[k]
        # forward-fill, zero before the first entry
        filled = np.zeros(P)
        for t in range(T):
            sched[t] = np.where(np.isnan(sched[t]), filled, sched[t])
            filled = sched[t]
        out[r] = sched
    return out
