"""Age-off (TTL): the scan-time half.

The port's copy of the JAX package's ``age_off.py`` scan-time pieces.
The reference ages out expired rows two ways (accumulo/iterators/
AgeOffIterator.scala, DtgAgeOffFilter): a scan-time filter hiding rows
older than the retention period, and physical removal during
compaction.  This module holds the first: a query interceptor ANDs a
retention window onto every query.  The physical delete (the JAX
package's ``age_off()``) needs deletes, which the port does not have.

Retention periods are duration strings (``"7 days"``, ``"12 hours"``,
``"30 minutes"``, ``"45 seconds"``, ``"500 millis"``) stored in schema
user data under ``geomesa.age.off``.
"""

from __future__ import annotations

import re
import time

__all__ = ["parse_duration_ms", "AgeOffInterceptor", "AGE_OFF_KEY"]

AGE_OFF_KEY = "geomesa.age.off"

_UNITS_MS = {
    "ms": 1, "milli": 1, "millis": 1, "millisecond": 1, "milliseconds": 1,
    "s": 1000, "second": 1000, "seconds": 1000,
    "min": 60_000, "minute": 60_000, "minutes": 60_000,
    "h": 3_600_000, "hour": 3_600_000, "hours": 3_600_000,
    "d": 86_400_000, "day": 86_400_000, "days": 86_400_000,
    "w": 604_800_000, "week": 604_800_000, "weeks": 604_800_000,
}


def parse_duration_ms(s) -> int:
    """``"7 days"`` → milliseconds.  Bare numbers are milliseconds."""
    if isinstance(s, (int, float)):
        return int(s)
    m = re.fullmatch(r"\s*(\d+(?:\.\d+)?)\s*([a-zA-Z]*)\s*", str(s))
    if not m:
        raise ValueError(f"cannot parse duration {s!r}")
    value, unit = float(m.group(1)), m.group(2).lower()
    if not unit:
        return int(value)
    if unit not in _UNITS_MS:
        raise ValueError(f"unknown duration unit {unit!r} in {s!r}")
    return int(value * _UNITS_MS[unit])


class AgeOffInterceptor:
    """ANDs ``dtg >= now - retention`` onto every query (the scan-time
    DtgAgeOffFilter role).  Auto-attached when the schema carries
    ``geomesa.age.off`` user data."""

    def __init__(self, retention_ms: int | None = None):
        self._retention_ms = retention_ms

    def rewrite(self, sft, query):
        from dataclasses import replace

        from .filters.ast import And, During, _Include
        retention = self._retention_ms
        if retention is None:
            raw = sft.user_data.get(AGE_OFF_KEY)
            if raw is None:
                return query
            retention = parse_duration_ms(raw)
        if not sft.dtg_field:
            return query
        cutoff = int(time.time() * 1000) - retention
        window = During(sft.dtg_field, cutoff, None)
        f = query.filter
        new = window if isinstance(f, _Include) else And((f, window))
        return replace(query, filter=new)
