"""Time binning: epoch millis → (bin, offset) per Day/Week/Month/Year period.

Matches the reference's ``BinnedTime`` (geomesa-z3/.../curve/BinnedTime.scala):

=======  ====================  ==============  =============
period   bin                   offset          max date
=======  ====================  ==============  =============
day      days since epoch      millis in day   2059-09-18
week     weeks since epoch     seconds in wk   2598-01-04
month    months since epoch    seconds in mo   4700-08-31
year     years since epoch     minutes in yr   34737-12-31
=======  ====================  ==============  =============

Bins are int16 ("Short"), offsets int64.  Day/Week are pure integer
division; Month/Year are calendar-aware and computed with numpy datetime64
month/year arithmetic on host (the "host LUT" strategy — these run during
ingest key-gen and query planning, never inside a jitted kernel; device
kernels only ever see the resulting ``(bin, offset)`` ints).

``max_offset`` values (BinnedTime.scala maxOffset): day 86_400_000 ms,
week 604_800 s, month 31*86_400 s, year 52*7*24*60 min — note month/year
use a fixed upper bound, not per-bin actual length, so the time dimension
normalizer is period-independent.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

__all__ = [
    "TimePeriod", "BinnedTime", "max_offset", "to_binned_time",
    "from_binned_time", "time_to_bin", "max_date_ms", "bin_to_ms",
]

MS_PER_DAY = 86_400_000
MS_PER_WEEK = 7 * MS_PER_DAY
MAX_BIN = 32767  # int16 max; bins are "Short" in the reference


class TimePeriod(str, enum.Enum):
    DAY = "day"
    WEEK = "week"
    MONTH = "month"
    YEAR = "year"

    @classmethod
    def parse(cls, s: "TimePeriod | str") -> "TimePeriod":
        if isinstance(s, TimePeriod):
            return s
        return cls(s.lower())


@dataclass(frozen=True)
class BinnedTime:
    bin: int
    offset: int


def max_offset(period: TimePeriod) -> int:
    """Max offset value (inclusive upper normalization bound) per period."""
    period = TimePeriod.parse(period)
    if period is TimePeriod.DAY:
        return MS_PER_DAY          # millis in a day
    if period is TimePeriod.WEEK:
        return MS_PER_WEEK // 1000  # seconds in a week
    if period is TimePeriod.MONTH:
        return 31 * 86_400          # seconds in the longest month
    return 52 * 7 * 24 * 60         # minutes in 52 weeks


def _as_ms_array(ms) -> np.ndarray:
    return np.asarray(ms, dtype=np.int64)


def _month_index(ms: np.ndarray) -> np.ndarray:
    """Calendar months since 1970-01 (UTC)."""
    return (ms.astype("M8[ms]").astype("M8[M]") - np.datetime64(0, "M")).astype(np.int64)


def _year_index(ms: np.ndarray) -> np.ndarray:
    """Calendar years since 1970 (UTC)."""
    return (ms.astype("M8[ms]").astype("M8[Y]") - np.datetime64(0, "Y")).astype(np.int64)


def _month_start_s(month_idx: np.ndarray) -> np.ndarray:
    return (np.datetime64(0, "M") + month_idx.astype("m8[M]")).astype("M8[s]").astype(np.int64)


def _year_start_s(year_idx: np.ndarray) -> np.ndarray:
    return (np.datetime64(0, "Y") + year_idx.astype("m8[Y]")).astype("M8[s]").astype(np.int64)


def to_binned_time(ms, period: TimePeriod, validate: bool = True):
    """Vectorized epoch-millis → (bin:int16-ranged int64, offset:int64).

    Mirrors BinnedTime.timeToBinnedTime (BinnedTime.scala:73-80): bins count
    periods since the java epoch, offsets are millis (day), seconds
    (week/month) or minutes (year) into the bin.
    """
    period = TimePeriod.parse(period)
    ms = _as_ms_array(ms)
    if validate and np.any(ms < 0):
        raise ValueError("date before minimum indexable value (1970-01-01)")
    if period is TimePeriod.DAY:
        bins = ms // MS_PER_DAY
        offs = ms - bins * MS_PER_DAY
    elif period is TimePeriod.WEEK:
        bins = ms // MS_PER_WEEK
        offs = (ms - bins * MS_PER_WEEK) // 1000
    elif period is TimePeriod.MONTH:
        bins = _month_index(ms)
        offs = ms // 1000 - _month_start_s(bins)
    else:
        bins = _year_index(ms)
        offs = (ms // 1000 - _year_start_s(bins)) // 60
    if validate and np.any(bins > MAX_BIN):
        raise ValueError(f"date exceeds maximum indexable value for period {period.value}")
    return bins.astype(np.int64), offs.astype(np.int64)


def time_to_bin(ms, period: TimePeriod, validate: bool = True):
    return to_binned_time(ms, period, validate=validate)[0]


def bin_to_ms(bins, period: TimePeriod) -> np.ndarray:
    """Epoch millis of the start of each bin."""
    period = TimePeriod.parse(period)
    bins = np.asarray(bins, dtype=np.int64)
    if period is TimePeriod.DAY:
        return bins * MS_PER_DAY
    if period is TimePeriod.WEEK:
        return bins * MS_PER_WEEK
    if period is TimePeriod.MONTH:
        return _month_start_s(bins) * 1000
    return _year_start_s(bins) * 1000


def from_binned_time(bins, offsets, period: TimePeriod) -> np.ndarray:
    """Inverse: (bin, offset) → epoch millis of the represented instant."""
    period = TimePeriod.parse(period)
    bins = np.asarray(bins, dtype=np.int64)
    offsets = np.asarray(offsets, dtype=np.int64)
    start = bin_to_ms(bins, period)
    if period is TimePeriod.DAY:
        return start + offsets
    if period in (TimePeriod.WEEK, TimePeriod.MONTH):
        return start + offsets * 1000
    return start + offsets * 60_000


def max_date_ms(period: TimePeriod) -> int:
    """Exclusive max indexable epoch-millis for a period (bin fits int16)."""
    return int(bin_to_ms(np.int64(MAX_BIN + 1), period))
