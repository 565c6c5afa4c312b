"""OxCGRT / XPRIZE data loaders, without pandas.

Counterpart of epidemicmodeling_tpu/data/oxford.py:24-151. The reference
scripts readtable the OxCGRT CSV (CountryName, RegionName, Date as YYYYMMDD,
ConfirmedCases, ConfirmedDeaths, NPI columns) and the populations / geo
CSVs (Tools/TrainPredictPrescribeNPI.m:62-91), keying regions by the
"CountryName RegionName" string concatenation.

The JAX package returns DataFrames; the port returns small NumPy tables
(``OxfordTable``, a dict of populations) read by ``csvio``, which
reproduces pandas' missing values and float parsing bit for bit, so the
same file gives the pipeline the same numbers in both packages. One
narrowing: the Date column must hold YYYYMMDD integers or ISO dates
(YYYY-MM-DD, optionally followed by a time); pandas' ``to_datetime``
guesses other formats, this loader raises a ValueError instead.
"""

from __future__ import annotations

import datetime as _dt
import re
from typing import NamedTuple, Optional, Sequence

import numpy as np

from .csvio import is_int_column, parse_floats, read_csv_columns, text
from .preprocess import OXFORD_NPI_COLUMNS

# Full column set of the live OxCGRT_latest.csv download (the file every
# reference script reads, e.g. Tools/TrainPredictPrescribeNPI.m:73-89):
# identity columns, the C/E/H policy indicators with their Flag columns,
# M1_Wildcard, case/death counts and the aggregate indices. Loaders key by
# name, so the extras are tolerated and ignored.
OXCGRT_LATEST_COLUMNS = [
    "CountryName", "CountryCode", "RegionName", "RegionCode", "Jurisdiction",
    "Date",
    "C1_School closing", "C1_Flag",
    "C2_Workplace closing", "C2_Flag",
    "C3_Cancel public events", "C3_Flag",
    "C4_Restrictions on gatherings", "C4_Flag",
    "C5_Close public transport", "C5_Flag",
    "C6_Stay at home requirements", "C6_Flag",
    "C7_Restrictions on internal movement", "C7_Flag",
    "C8_International travel controls",
    "E1_Income support", "E1_Flag",
    "E2_Debt/contract relief",
    "E3_Fiscal measures",
    "E4_International support",
    "H1_Public information campaigns", "H1_Flag",
    "H2_Testing policy",
    "H3_Contact tracing",
    "H4_Emergency investment in healthcare",
    "H5_Investment in vaccines",
    "H6_Facial Coverings", "H6_Flag",
    "H7_Vaccination policy", "H7_Flag",
    "H8_Protection of elderly people", "H8_Flag",
    "M1_Wildcard",
    "ConfirmedCases", "ConfirmedDeaths",
    "StringencyIndex", "StringencyIndexForDisplay",
    "StringencyLegacyIndex", "StringencyLegacyIndexForDisplay",
    "GovernmentResponseIndex", "GovernmentResponseIndexForDisplay",
    "ContainmentHealthIndex", "ContainmentHealthIndexForDisplay",
    "EconomicSupportIndex", "EconomicSupportIndexForDisplay",
]

DATE_FORMATS = "YYYYMMDD integers or ISO dates (YYYY-MM-DD)"
_ISO = re.compile(r"(\d{4})-(\d{2})-(\d{2})(?:[T ].*)?")


class OxfordTable(NamedTuple):
    """The loaded OxCGRT table, one entry per row, rows sorted stably by
    (geo_id, date_num) as the JAX loader's sort_values leaves them.
    geo_id is None where CountryName is missing (those rows sort last)."""
    geo_id: list           # "Country Region" key (str or None)
    date_num: np.ndarray   # (N,) int64 YYYYMMDD
    confirmed: np.ndarray  # (N,) float64 ConfirmedCases
    deaths: np.ndarray     # (N,) float64 ConfirmedDeaths (NaN if absent)
    npis: np.ndarray       # (N, P) float64 in npi_columns order
    npi_columns: tuple


def geo_ids_of(cols: dict) -> list:
    """Each row's 'CountryName RegionName' key (read_csv_columns' columns),
    with a trailing space for country-level rows (strcat(country, " ",
    region)); None when the country is missing."""
    country = text(cols["CountryName"])
    region = (text(cols["RegionName"]) if "RegionName" in cols
              else [None] * len(country))
    return [None if c is None else f"{c} {r or ''}"
            for c, r in zip(country, region)]


def date_numbers(values, what: str = "Date") -> np.ndarray:
    """A Date column as YYYYMMDD int64: integer cells as they are, ISO dates
    (YYYY-MM-DD, optionally with a time) converted. Anything else raises."""
    values = list(values)
    if is_int_column(values):
        return np.array([int(v) for v in values], np.int64)
    out = np.empty(len(values), np.int64)
    for k, v in enumerate(values):
        m = _ISO.fullmatch(v.strip()) if v is not None else None
        try:
            d = _dt.date(*(int(g) for g in m.groups())) if m else None
        except ValueError:
            d = None
        if d is None:
            raise ValueError(
                f"{what} value {v!r} is neither of the accepted formats, "
                f"{DATE_FORMATS}")
        out[k] = d.year * 10000 + d.month * 100 + d.day
    return out


def load_oxford_data(path, npi_columns: Optional[Sequence[str]] = None,
                     start_date: Optional[str] = None,
                     end_date: Optional[str] = None) -> OxfordTable:
    """Load the OxCGRT table, normalize the Date column to YYYYMMDD ints, add
    the GeoID key, and optionally crop the date range (inclusive)."""
    npi_columns = list(npi_columns or OXFORD_NPI_COLUMNS)
    cols = read_csv_columns(path)
    # a missing NPI or cases column would silently train on zero-filled
    # series: refuse instead (OxCGRT renamed columns across versions).
    # RegionName / ConfirmedDeaths stay lenient: country-only tables omit
    # the former, and deaths only feed the optional mortality estimate.
    hard = [c for c in ["Date", "CountryName", "ConfirmedCases"]
            + npi_columns if c not in cols]
    if hard:
        raise ValueError(
            f"{str(path)!r} is missing required columns {hard} — check the "
            "NPI column names against the file header (OxCGRT releases "
            "renamed some, e.g. 'H6_Facial Coverings' vs "
            "'H6M_Facial Coverings')")
    n = len(cols["Date"])
    geo = geo_ids_of(cols)
    date_num = date_numbers(cols["Date"])
    confirmed = parse_floats(cols["ConfirmedCases"], "ConfirmedCases")
    deaths = (parse_floats(cols["ConfirmedDeaths"], "ConfirmedDeaths")
              if "ConfirmedDeaths" in cols else np.full(n, np.nan))
    npis = (np.stack([parse_floats(cols[c], c) for c in npi_columns], axis=1)
            if npi_columns else np.zeros((n, 0)))
    keep = np.ones(n, bool)
    if start_date:
        keep &= date_num >= int(start_date.replace("-", ""))
    if end_date:
        keep &= date_num <= int(end_date.replace("-", ""))
    # a stable sort by (GeoID, DateNum), missing GeoIDs last
    rank = {g: k for k, g in enumerate(sorted({g for g in geo if g}))}
    code = np.array([rank.get(g, len(rank)) for g in geo], np.int64)
    rows = np.flatnonzero(keep)
    order = rows[np.lexsort((date_num[rows], code[rows]))]
    return OxfordTable([geo[i] for i in order], date_num[order],
                       confirmed[order], deaths[order], npis[order],
                       tuple(npi_columns))


def load_populations(path) -> dict:
    """populations.csv (CountryName, RegionName, Code, Population2020, ...)
    -> {GeoID: Population2020}; a GeoID listed twice keeps its first row."""
    cols = read_csv_columns(path)
    geo = geo_ids_of(cols)
    pop = parse_floats(cols["Population2020"], "Population2020")
    out = {}
    for g, p in zip(geo, pop):
        out.setdefault(g, float(p))
    return out


def load_geo_list(path) -> list:
    """countries_regions.csv -> list of GeoID strings to process."""
    return geo_ids_of(read_csv_columns(path))


def region_arrays(table: OxfordTable, geo_id: str,
                  npi_columns: Optional[Sequence[str]] = None):
    """(confirmed, deaths, npis (T, P)) float64 arrays for one region."""
    npi_columns = list(npi_columns or OXFORD_NPI_COLUMNS)
    rows = np.array([g == geo_id for g in table.geo_id], bool)
    j = [table.npi_columns.index(c) for c in npi_columns]
    return (table.confirmed[rows], table.deaths[rows],
            table.npis[rows][:, j])


def load_npi_costs(path, geo_ids: Sequence[str],
                   npi_columns: Optional[Sequence[str]] = None) -> np.ndarray:
    """NPI cost-weight CSV (fixed_equal_costs.csv / uniform_random_costs.csv:
    CountryName, RegionName, one column per NPI) -> (R, P) weights aligned
    to geo_ids (Tools/TrainPredictPrescribeNPI.m:109-127). Geos missing from
    the file get equal weight 1; a geo listed twice takes its first row."""
    npi_columns = list(npi_columns or OXFORD_NPI_COLUMNS)
    cols = read_csv_columns(path)
    geo = geo_ids_of(cols)
    w = np.stack([parse_floats(cols[c], c) for c in npi_columns], axis=1)
    first = {}
    for k, g in enumerate(geo):
        first.setdefault(g, k)
    out = np.ones((len(geo_ids), len(npi_columns)))
    for r, gid in enumerate(geo_ids):
        if gid in first:
            out[r] = w[first[gid]]
    return out
