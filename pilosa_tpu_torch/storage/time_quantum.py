"""Time quantums: Y/M/D/H granularity view naming and range expansion.

Behavioral port of the reference's time.go (viewsByTime :90-103,
viewsByTimeRange :105-176, minMaxViews :240-275, addMonth :180-190): a time
field materialises one view per enabled time unit per timestamp
("<field>_2017", "<field>_201701", ...), and a range query expands to the
minimal set of views covering [start, end) by walking small units up to
large-unit boundaries and back down.

Port copy of the JAX package's ``storage/time_quantum.py``: the PyTorch
port keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from datetime import datetime, timedelta

VALID_QUANTUMS = {"Y", "YM", "YMD", "YMDH", "M", "MD", "MDH", "D", "DH", "H", ""}

# PQL timestamp literal format (pilosa.go TimeFormat "2006-01-02T15:04").
TIME_FORMAT = "%Y-%m-%dT%H:%M"


class InvalidTimeQuantumError(ValueError):
    pass


def validate_quantum(q: str) -> str:
    if q not in VALID_QUANTUMS:
        raise InvalidTimeQuantumError(f"invalid time quantum: {q!r}")
    return q


def parse_time(value) -> datetime:
    """Parse a PQL timestamp arg: '2006-01-02T15:04' string or unix int."""
    if isinstance(value, datetime):
        return value
    if isinstance(value, str):
        try:
            return datetime.strptime(value, TIME_FORMAT)
        except ValueError:
            raise ValueError(f"cannot parse string time: {value!r}")
    if isinstance(value, int):
        return datetime.utcfromtimestamp(value)
    raise ValueError("arg must be a timestamp")


def _fmt(name: str, t: datetime, unit: str) -> str:
    if unit == "Y":
        return f"{name}_{t.strftime('%Y')}"
    if unit == "M":
        return f"{name}_{t.strftime('%Y%m')}"
    if unit == "D":
        return f"{name}_{t.strftime('%Y%m%d')}"
    if unit == "H":
        return f"{name}_{t.strftime('%Y%m%d%H')}"
    raise InvalidTimeQuantumError(unit)


def views_by_time(name: str, t: datetime, quantum: str) -> list[str]:
    """One view name per unit in the quantum (time.go:90 viewsByTime)."""
    return [_fmt(name, t, unit) for unit in quantum]


def _add_month(t: datetime) -> datetime:
    """time.go:180 addMonth: clamp to the 1st for day>28 to avoid Jan 31 +
    1mo = Mar 2 style double-advances."""
    if t.day > 28:
        t = t.replace(day=1, minute=0, second=0, microsecond=0)
    if t.month == 12:
        return t.replace(year=t.year + 1, month=1)
    return t.replace(month=t.month + 1)


def _add_year(t: datetime) -> datetime:
    return t.replace(year=t.year + 1)


def _next_year_gte(t: datetime, end: datetime) -> bool:
    nxt = _add_year(t)
    return nxt.year == end.year or end > nxt


def _next_month_gte(t: datetime, end: datetime) -> bool:
    nxt = _go_add_month(t)
    return (nxt.year, nxt.month) == (end.year, end.month) or end > nxt


def _go_add_month(t: datetime) -> datetime:
    """Go's time.AddDate(0,1,0): month+1 with day-overflow normalisation
    (Jan 31 -> Mar 2/3)."""
    year, month = t.year, t.month + 1
    if month > 12:
        year, month = year + 1, 1
    day = t.day
    # normalise overflow the way Go does: keep day, roll into next month
    while True:
        try:
            return t.replace(year=year, month=month, day=day)
        except ValueError:
            # e.g. Feb 30 -> Mar 2: count days past month end
            from calendar import monthrange
            last = monthrange(year, month)[1]
            overflow = day - last
            nm_year, nm_month = (year + 1, 1) if month == 12 else (year, month + 1)
            return t.replace(year=nm_year, month=nm_month, day=overflow)


def _next_day_gte(t: datetime, end: datetime) -> bool:
    nxt = t + timedelta(days=1)
    return (nxt.year, nxt.month, nxt.day) == (end.year, end.month, end.day) \
        or end > nxt


def views_by_time_range(name: str, start: datetime, end: datetime,
                        quantum: str) -> list[str]:
    """Minimal covering set of views for [start, end)
    (time.go:105 viewsByTimeRange)."""
    has_year = "Y" in quantum
    has_month = "M" in quantum
    has_day = "D" in quantum
    has_hour = "H" in quantum

    t = start
    results: list[str] = []

    # Walk up from smallest units to largest-unit boundaries.
    if has_hour or has_day or has_month:
        while t < end:
            if has_hour:
                if not _next_day_gte(t, end):
                    break
                if t.hour != 0:
                    results.append(_fmt(name, t, "H"))
                    t += timedelta(hours=1)
                    continue
            if has_day:
                if not _next_month_gte(t, end):
                    break
                if t.day != 1:
                    results.append(_fmt(name, t, "D"))
                    t += timedelta(days=1)
                    continue
            if has_month:
                if not _next_year_gte(t, end):
                    break
                if t.month != 1:
                    results.append(_fmt(name, t, "M"))
                    t = _add_month(t)
                    continue
            break

    # Walk back down from largest units.
    while t < end:
        if has_year and _next_year_gte(t, end):
            results.append(_fmt(name, t, "Y"))
            t = _add_year(t)
        elif has_month and _next_month_gte(t, end):
            results.append(_fmt(name, t, "M"))
            t = _add_month(t)
        elif has_day and _next_day_gte(t, end):
            results.append(_fmt(name, t, "D"))
            t += timedelta(days=1)
        elif has_hour:
            results.append(_fmt(name, t, "H"))
            t += timedelta(hours=1)
        else:
            break

    return results


def view_time_part(view: str) -> str:
    return view.rsplit("_", 1)[-1]


def min_max_views(views: list[str], quantum: str) -> tuple[str, str]:
    """Smallest/largest view at the quantum's most significant granularity
    (time.go:240 minMaxViews)."""
    views = sorted(views)
    if "Y" in quantum:
        chars = 4
    elif "M" in quantum:
        chars = 6
    elif "D" in quantum:
        chars = 8
    elif "H" in quantum:
        chars = 10
    else:
        chars = 0
    lo = next((v for v in views if len(view_time_part(v)) == chars), "")
    hi = next((v for v in reversed(views) if len(view_time_part(v)) == chars), "")
    return lo, hi


def time_of_view(view: str, adj: bool = False) -> datetime | None:
    """Parse the time part of a view name back to a datetime; when ``adj``,
    advance by one unit for exclusive upper bounds (time.go:277 timeOfView)."""
    if not view:
        return None
    part = view_time_part(view)
    n = len(part)
    if n == 4:
        t = datetime.strptime(part, "%Y")
        return _add_year(t) if adj else t
    if n == 6:
        t = datetime.strptime(part, "%Y%m")
        return _add_month(t) if adj else t
    if n == 8:
        t = datetime.strptime(part, "%Y%m%d")
        return t + timedelta(days=1) if adj else t
    if n == 10:
        t = datetime.strptime(part, "%Y%m%d%H")
        return t + timedelta(hours=1) if adj else t
    raise ValueError(f"invalid time format on view: {view}")
