"""Time-quantum views: the JAX package's core/timequantum.py, copied.

A frame with quantum e.g. "YMD" writes each timestamped bit into extra
views as well ("standard_2017", "standard_201704", "standard_20170402").
A time Range reads the fewest views that cover [start, end): it walks up
from the small units to a boundary of a larger one, then down from the
large units to the end.
"""

from __future__ import annotations

import calendar
from datetime import datetime, timedelta
from typing import List

VALID_QUANTUMS = {"Y", "YM", "YMD", "YMDH", "M", "MD", "MDH", "D", "DH", "H",
                  ""}

# Wire format of PQL time arguments ("2006-01-02T15:04").
TIME_FORMAT = "%Y-%m-%dT%H:%M"


class TimeQuantum(str):
    """A subset of the units 'YMDH', e.g. 'YMD'."""

    def has(self, unit: str) -> bool:
        return unit in self

    @property
    def valid(self) -> bool:
        return str(self) in VALID_QUANTUMS


def parse_time_quantum(v: str) -> TimeQuantum:
    q = TimeQuantum(v.upper())
    if not q.valid:
        raise ValueError("invalid time quantum")
    return q


def parse_time(s: str) -> datetime:
    """A PQL time argument ("2017-04-02T09:00")."""
    return datetime.strptime(s, TIME_FORMAT)


def view_by_time_unit(name: str, t: datetime, unit: str) -> str:
    fmt = {"Y": "%Y", "M": "%Y%m", "D": "%Y%m%d", "H": "%Y%m%d%H"}.get(unit)
    if fmt is None:
        return ""
    return f"{name}_{t.strftime(fmt)}"


def views_by_time(name: str, t: datetime, q: TimeQuantum) -> List[str]:
    """Every quantum view a bit written at time t lands in."""
    return [v for unit in q if (v := view_by_time_unit(name, t, unit))]


def _normalized_date(y: int, m: int, d: int, t: datetime) -> datetime:
    """Date arithmetic that rolls a day past the month's end into the
    next month (Jan 31 + 1 month = Mar 2 or 3), as Go's AddDate does."""
    dim = calendar.monthrange(y, m)[1]
    if d <= dim:
        return t.replace(year=y, month=m, day=d)
    return t.replace(year=y, month=m, day=dim) + timedelta(days=d - dim)


def _add_month(t: datetime) -> datetime:
    y, m = (t.year + 1, 1) if t.month == 12 else (t.year, t.month + 1)
    return _normalized_date(y, m, t.day, t)


def _add_year(t: datetime) -> datetime:
    return _normalized_date(t.year + 1, t.month, t.day, t)


def _next_gte(nxt: datetime, end: datetime, cmp_units: int) -> bool:
    """True when `nxt` reaches `end`'s bucket (compared on the first
    cmp_units of year, month, day) or passes `end`."""
    a = (nxt.year, nxt.month, nxt.day)[:cmp_units]
    b = (end.year, end.month, end.day)[:cmp_units]
    return a == b or end > nxt


def views_by_time_range(name: str, start: datetime, end: datetime,
                        q: TimeQuantum) -> List[str]:
    """The fewest views of quantum q that cover [start, end)."""
    has_y, has_m, has_d, has_h = (q.has(u) for u in "YMDH")
    t = start
    results: List[str] = []

    # Walk up, small units to large, until on a larger unit's boundary.
    if has_h or has_d or has_m:
        while t < end:
            if has_h:
                if not _next_gte(t + timedelta(days=1), end, 3):
                    break
                if t.hour != 0:
                    results.append(view_by_time_unit(name, t, "H"))
                    t += timedelta(hours=1)
                    continue
            if has_d:
                if not _next_gte(_add_month(t), end, 2):
                    break
                if t.day != 1:
                    results.append(view_by_time_unit(name, t, "D"))
                    t += timedelta(days=1)
                    continue
            if has_m:
                if not _next_gte(_add_year(t), end, 1):
                    break
                if t.month != 1:
                    results.append(view_by_time_unit(name, t, "M"))
                    t = _add_month(t)
                    continue
            break

    # Walk down, large units to small, over the rest.
    while t < end:
        if has_y and _next_gte(_add_year(t), end, 1):
            results.append(view_by_time_unit(name, t, "Y"))
            t = _add_year(t)
        elif has_m and _next_gte(_add_month(t), end, 2):
            results.append(view_by_time_unit(name, t, "M"))
            t = _add_month(t)
        elif has_d and _next_gte(t + timedelta(days=1), end, 3):
            results.append(view_by_time_unit(name, t, "D"))
            t += timedelta(days=1)
        elif has_h:
            results.append(view_by_time_unit(name, t, "H"))
            t += timedelta(hours=1)
        else:
            break

    return results
