"""Pandas-free CSV columns: a reader that gives the values
``pandas.read_csv`` gives, and a writer in ``DataFrame.to_csv``'s dialect.

The port's loaders read the OxCGRT, population, geo, cost and future-plan
files with the ``csv`` module and NumPy (the GPU machine has no pandas).
They must hand the pipeline the very numbers the JAX package's pandas
loaders hand it, so this module reproduces three things pandas does by
default:

- missing values: an empty cell, or one of pandas' default NA strings
  (``NA_STRINGS``), reads as missing (NaN in a numeric column, None in a
  text column);
- numbers: pandas' default float parser (``precise_xstrtod`` in its C
  tokenizer) is not correctly rounded. It accumulates at most 17 digits
  (leading zeros included) in a double, one ``n * 10 + d`` at a time, and
  then multiplies or divides by a double power of ten. ``parse_floats``
  runs the same operations in the same order, vectorized over a column, so
  every value is bit-for-bit pandas' (Python's ``float()`` differs in the
  last bit on about two values in a hundred of the repo's files,
  scripts/csv_parse_probe.py);
- rows: blank lines are skipped, a short row is padded with missing cells,
  and a byte-order mark is dropped.

``write_csv_columns`` writes columns as ``to_csv(index=False)`` does: the
csv module's minimal quoting, "\\n" line ends, a missing value as an empty
cell and a float as its shortest round-trip decimal.
"""

from __future__ import annotations

import csv
import io
import re
from typing import Sequence

import numpy as np

# pandas' default na_values (pandas._libs.parsers.STR_NA_VALUES)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})

_NA_BYTES = np.array(sorted(NA_STRINGS), dtype="S")
_MAX_DIGITS = 17
# the powers of ten of the tokenizer's table: correctly rounded doubles
_POW10 = np.array([float(f"1e{k}") for k in range(309)])
_INF = re.compile(r"[+-]?(inf|infinity)", re.IGNORECASE)
_INT = re.compile(r"[+-]?\d+")


def read_csv_columns(path) -> dict:
    """The file's columns by header name, each a tuple of raw str (a short
    row padded with empty cells), in file order; ``text`` and
    ``parse_floats`` turn one into values. A repeated header name keeps its
    first column."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        data = f.read()
    if '"' in data or "\r" in data:
        rows = [r for r in csv.reader(io.StringIO(data)) if r]
    else:
        # nothing quoted and "\n" line ends: the csv module's rows are the
        # lines split at commas
        rows = [line.split(",") for line in data.split("\n") if line]
    if not rows:
        raise ValueError(f"{str(path)!r} is empty (no header row)")
    header, body = rows[0], rows[1:]
    width = len(header)
    for i, r in enumerate(body):
        if len(r) != width:
            if len(r) > width:
                raise ValueError(f"{str(path)!r} line {i + 2}: {len(r)} "
                                 f"fields, the header has {width}")
            body[i] = r + [""] * (width - len(r))
    cols = list(zip(*body)) if body else [()] * width
    out = {}
    for name, col in zip(header, cols):
        out.setdefault(name, col)
    return out


def csv_cell(v):
    """A value as to_csv writes it: None or NaN empty, a float as repr."""
    if v is None:
        return ""
    if isinstance(v, (float, np.floating)):
        v = float(v)
        return "" if v != v else repr(v)
    return v


def csv_line(cells) -> str:
    """One row as the csv module writes it, without the line end."""
    buf = io.StringIO()
    csv.writer(buf, lineterminator="").writerow(cells)
    return buf.getvalue()


def write_csv_rows(path, header, rows):
    """Write a header and rows of str and int cells (csv_cell formats any
    other value)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows(rows)
    return path


def write_csv_columns(path, columns: dict):
    """Write {name: sequence} as a CSV file, columns in dict order, each
    value through csv_cell."""
    return write_csv_rows(path, list(columns), (
        [csv_cell(v) for v in row] for row in zip(*columns.values())))


def text(values: Sequence) -> list:
    """A text column's values: str, or None for a missing cell."""
    return [None if v in NA_STRINGS else v for v in values]


def is_int_column(values: Sequence) -> bool:
    """pandas reads a column as int64 when every cell is an integer literal
    (no missing cell)."""
    return all(_INT.fullmatch(v.strip()) for v in set(values))


def parse_floats(values: Sequence, what: str = "column") -> np.ndarray:
    """float64 values of a column of raw str (missing cells -> NaN), parsed
    as pandas' default C parser parses them. Raises ValueError on a cell
    that is not a number."""
    distinct = set(values)
    if len(distinct) <= 64:
        # a level column (the NPIs): parse each distinct cell once
        keys = list(distinct)
        parsed = dict(zip(keys, _parse_cells(keys, what)))
        return np.array([parsed[v] for v in values], float)
    return _parse_cells(values, what)


def _parse_cells(values, what):
    try:
        raw = np.array(values, dtype="S")
    except UnicodeEncodeError:
        bad = next(v for v in values if not v.isascii())
        raise ValueError(f"{what}: {bad!r} is not a number") from None
    uniq, inverse = np.unique(raw, return_inverse=True)
    uniq = np.char.strip(uniq)
    number = ~np.isin(uniq, _NA_BYTES)
    vals = np.full(len(uniq), np.nan)
    if number.any():
        vals[number] = _xstrtod(uniq[number], what)
    return vals[inverse.reshape(-1)]


def _xstrtod(raw: np.ndarray, what: str) -> np.ndarray:
    """The tokenizer's precise_xstrtod over a fixed-width bytes array, one
    character position at a time for every string at once."""
    n, width = raw.shape[0], raw.dtype.itemsize
    c = np.zeros((n, width + 1), np.uint8)
    c[:, :width] = raw.view(np.uint8).reshape(n, width)
    length = (c != 0).sum(axis=1)
    rows = np.arange(n)
    at = lambda p: c[rows, np.minimum(p, width)]
    neg = c[:, 0] == ord("-")
    pos = (neg | (c[:, 0] == ord("+"))).astype(np.int64)
    number = np.zeros(n)
    num_digits = np.zeros(n, np.int64)
    exponent = np.zeros(n, np.int64)
    num_decimals = np.zeros(n, np.int64)
    # integer digits: the first 17 accumulate, the rest raise the exponent
    while True:
        ch = at(pos)
        m = (ch >= 48) & (ch <= 57)
        if not m.any():
            break
        take = m & (num_digits < _MAX_DIGITS)
        number = np.where(take, number * 10.0 + (ch - 48.0), number)
        exponent += m & ~take
        num_digits += take
        pos += m
    # the decimal part: digits accumulate while fewer than 17 are in
    has_dot = ch == ord(".")
    pos += has_dot
    while has_dot.any():
        ch = at(pos)
        m = has_dot & (ch >= 48) & (ch <= 57)
        if not m.any():
            break
        take = m & (num_digits < _MAX_DIGITS)
        number = np.where(take, number * 10.0 + (ch - 48.0), number)
        num_digits += take
        num_decimals += take
        pos += m
    exponent -= num_decimals
    number = np.where(neg, -number, number)
    # the exponent: 'e' or 'E', an optional sign, at most 17 digits
    ch = at(pos)
    has_e = (ch == ord("e")) | (ch == ord("E"))
    epos = pos + has_e
    ch = at(epos)
    eneg = has_e & (ch == ord("-"))
    epos += has_e & ((ch == ord("-")) | (ch == ord("+")))
    en = np.zeros(n, np.int64)
    edigits = np.zeros(n, np.int64)
    while has_e.any():
        ch = at(epos)
        m = has_e & (ch >= 48) & (ch <= 57) & (edigits < _MAX_DIGITS)
        if not m.any():
            break
        en = np.where(m, en * 10 + (ch.astype(np.int64) - 48), en)
        edigits += m
        epos += m
    # no digit after the 'e': the tokenizer steps back onto it
    pos = np.where(has_e & (edigits > 0), epos, pos)
    exponent += np.where(eneg, -en, en)
    special = np.flatnonzero((num_digits == 0) | (pos != length))
    for i in special:
        if not _INF.fullmatch(raw[i].decode()):
            raise ValueError(f"{what}: {raw[i].decode()!r} is not a number")
    e = exponent
    with np.errstate(over="ignore", under="ignore"):
        scaled = np.where(
            e > 308, np.where(number < 0, -np.inf, np.inf),
            np.where(e > 0, number * _POW10[np.clip(e, 0, 308)],
                     np.where(e < -616, 0.0,
                              np.where(e < -308,
                                       number / _POW10[np.clip(-308 - e, 0,
                                                               308)]
                                       / _POW10[308],
                                       number / _POW10[np.clip(-e, 0,
                                                               308)]))))
    for i in special:
        scaled[i] = -np.inf if raw[i].startswith(b"-") else np.inf
    return scaled
