"""Date helpers mirroring the script-side date arithmetic of the reference
(Tools/TrainPredictPrescribeNPI.m:24-60): ISO date strings to day counts.

A copy of epidemicmodeling_tpu/utils/dates.py (standard library only): the
port never imports the JAX package.
"""

from __future__ import annotations

import datetime as _dt


def _parse(date_str: str) -> _dt.date:
    return _dt.date.fromisoformat(str(date_str))


def num_days_between(start_date: str, end_date: str) -> int:
    """Whole days from start to end (may be negative)."""
    return (_parse(end_date) - _parse(start_date)).days


def date_range_days(start_date: str, num_days: int) -> list:
    """List of ISO date strings: start, start+1, ..., start+num_days-1."""
    d0 = _parse(start_date)
    return [(d0 + _dt.timedelta(days=i)).isoformat() for i in range(num_days)]


def date_to_number(date_str: str) -> int:
    """YYYYMMDD integer form used by the reference for comparisons
    (Tools/TrainPredictPrescribeNPI.m:26-29)."""
    d = _parse(date_str)
    return d.year * 10000 + d.month * 100 + d.day
