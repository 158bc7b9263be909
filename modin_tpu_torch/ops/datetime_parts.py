"""Datetime and timedelta fields on the device (``.dt.year`` and the rest).

The port's counterpart of ``modin_tpu/ops/datetime_parts.py``.  Datetime and
timedelta columns live on the device as int64 ticks of their unit, with NaT
as the int64 minimum (pandas' own sentinel; see
``core/dataframe/torch/dataframe.py``).  Every field is integer arithmetic
over those ticks, as plain torch ops:

- the civil date from the day number by Howard Hinnant's public-domain
  ``civil_from_days`` (eras of 146097 days; 36524, 1460 and 365 inside
  one);
- the time of day from the remainder of the ticks in their day;
- the predicates (``is_month_start``, ...) from those pieces.

Every division floors toward -inf (``torch.div(..., rounding_mode="floor")``
and ``torch.remainder``), as ``jnp.floor_divide`` does in the JAX package:
ticks before 1970 are negative, and truncation would put them in the wrong
day.

Result dtypes follow pandas: int32 fields for a column without NaT, float64
with NaN where NaT is present (one host fetch of that flag decides), bool
predicates with NaT rows False; timedelta ``days`` is int64 (float64 with
NaT), ``total_seconds`` float64 always.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from modin_tpu_torch.utils import numpy_dtype

_NAT = np.iinfo(np.int64).min

# ticks per second by numpy datetime unit
_TPS = {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}

# cumulative days before month m (1-indexed; non-leap)
_CUMDAYS = np.array([0, 0, 31, 59, 90, 120, 151, 181, 212, 243, 273, 304, 334], np.int64)
_DAYS_IN_MONTH = np.array([0, 31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31], np.int64)

COMPONENT_NAMES = (
    "year", "month", "day", "hour", "minute", "second", "microsecond",
    "nanosecond", "dayofweek", "weekday", "day_of_week", "dayofyear",
    "day_of_year", "quarter", "daysinmonth", "days_in_month",
    "is_leap_year", "is_month_start", "is_month_end", "is_quarter_start",
    "is_quarter_end", "is_year_start", "is_year_end",
)

_BOOL_COMPONENTS = frozenset(n for n in COMPONENT_NAMES if n.startswith("is_"))

# pandas' Timedelta fields: days floors toward -inf; seconds, microseconds
# and nanoseconds are the non-negative remainders
TIMEDELTA_COMPONENT_NAMES = ("days", "seconds", "microseconds", "nanoseconds", "total_seconds")

UNITS = tuple(_TPS)


def _fdiv(x: torch.Tensor, d: int) -> torch.Tensor:
    return torch.div(x, d, rounding_mode="floor")


def _split(ticks: torch.Tensor, unit: str) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(valid, ticks with NaT as 0, whole days, ticks into the day)."""
    valid = ticks != _NAT
    t = torch.where(valid, ticks, 0)
    days = _fdiv(t, 86400 * _TPS[unit])
    return valid, t, days, t - days * (86400 * _TPS[unit])


def _sub_second(tod: torch.Tensor, unit: str) -> torch.Tensor:
    """Nanoseconds into the second."""
    tps = _TPS[unit]
    return torch.remainder(tod, tps) * (10**9 // tps)


def _finish(out: torch.Tensor, valid: torch.Tensor, has_nat: bool, int_dtype: torch.dtype) -> Tuple[torch.Tensor, np.dtype]:
    """pandas' dtype rule: float64 with NaN exactly where NaT is present."""
    if has_nat:
        return torch.where(valid, out.to(torch.float64), float("nan")), np.dtype(np.float64)
    return out.to(int_dtype), numpy_dtype(int_dtype)


def td_component(name: str, ticks: torch.Tensor, unit: str) -> Tuple[torch.Tensor, np.dtype]:
    """(result, dtype) of one timedelta field of int64 ``ticks``."""
    if name not in TIMEDELTA_COMPONENT_NAMES:
        raise ValueError(f"not a timedelta field: {name!r}")
    valid, t, days, rem = _split(ticks, unit)
    if name == "total_seconds":
        # pandas divides by the ticks per second; a CUDA division by a
        # Python scalar multiplies by its reciprocal, which rounds otherwise
        tps = torch.tensor(float(_TPS[unit]), dtype=torch.float64, device=ticks.device)
        return torch.where(valid, t.to(torch.float64) / tps, float("nan")), np.dtype(np.float64)
    if name == "days":
        out = days
    elif name == "seconds":
        out = _fdiv(rem, _TPS[unit])
    elif name == "microseconds":
        out = _fdiv(_sub_second(rem, unit), 1000)
    else:  # nanoseconds
        out = torch.remainder(_sub_second(rem, unit), 1000)
    has_nat = bool((~valid).any())
    return _finish(out, valid, has_nat, torch.int64 if name == "days" else torch.int32)


def dt_component(name: str, ticks: torch.Tensor, unit: str) -> Tuple[torch.Tensor, np.dtype]:
    """(result, dtype) of one calendar field of int64 datetime ``ticks``."""
    if name not in COMPONENT_NAMES:
        raise ValueError(f"not a datetime field: {name!r}")
    tps = _TPS[unit]
    valid, _, days, tod = _split(ticks, unit)

    # civil_from_days (proleptic Gregorian)
    z = days + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097  # [0, 146096]
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524) - _fdiv(doe, 146096), 365)
    doy_mar = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy_mar + 2, 153)
    d = doy_mar - _fdiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = yoe + era * 400 + (m <= 2).to(torch.int64)

    leap = ((torch.remainder(y, 4) == 0) & (torch.remainder(y, 100) != 0)) | (torch.remainder(y, 400) == 0)
    dim = torch.as_tensor(_DAYS_IN_MONTH, device=ticks.device)[m] + ((m == 2) & leap).to(torch.int64)
    if name == "year":
        out = y
    elif name == "month":
        out = m
    elif name == "day":
        out = d
    elif name == "hour":
        out = _fdiv(tod, 3600 * tps)
    elif name == "minute":
        out = torch.remainder(_fdiv(tod, 60 * tps), 60)
    elif name == "second":
        out = torch.remainder(_fdiv(tod, tps), 60)
    elif name == "microsecond":
        out = _fdiv(_sub_second(tod, unit), 1000)
    elif name == "nanosecond":
        out = torch.remainder(_sub_second(tod, unit), 1000)
    elif name in ("dayofweek", "weekday", "day_of_week"):
        out = torch.remainder(days + 3, 7)  # 1970-01-01 was a Thursday (Monday = 0)
    elif name in ("dayofyear", "day_of_year"):
        out = torch.as_tensor(_CUMDAYS, device=ticks.device)[m] + d + ((m > 2) & leap).to(torch.int64)
    elif name == "quarter":
        out = _fdiv(m + 2, 3)
    elif name in ("daysinmonth", "days_in_month"):
        out = dim
    elif name == "is_leap_year":
        out = leap
    elif name == "is_month_start":
        out = d == 1
    elif name == "is_month_end":
        out = d == dim
    elif name == "is_quarter_start":
        out = (d == 1) & (torch.remainder(m, 3) == 1)
    elif name == "is_quarter_end":
        out = (d == dim) & (torch.remainder(m, 3) == 0)
    elif name == "is_year_start":
        out = (m == 1) & (d == 1)
    else:  # is_year_end
        out = (m == 12) & (d == 31)

    if name in _BOOL_COMPONENTS:
        # pandas: NaT rows are False for the predicates
        return out & valid, np.dtype(bool)
    return _finish(out, valid, bool((~valid).any()), torch.int32)
