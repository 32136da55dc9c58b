"""Age-off (TTL): expired rows hidden at scan time and deleted.

The port's copy of the JAX package's ``age_off.py``.  The reference
ages out expired rows two ways (accumulo/iterators/AgeOffIterator.scala,
DtgAgeOffFilter): a scan-time filter hiding rows older than the
retention period (:class:`AgeOffInterceptor`, ANDing a retention window
onto every query), and physical removal during compaction
(:func:`age_off`, built on the store's ``delete``).

Retention periods are duration strings (``"7 days"``, ``"12 hours"``,
``"30 minutes"``, ``"45 seconds"``, ``"500 millis"``) stored in schema
user data under ``geomesa.age.off``.
"""

from __future__ import annotations

import re
import time

import numpy as np

__all__ = ["parse_duration_ms", "AgeOffInterceptor", "AGE_OFF_KEY",
           "age_off"]

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


def age_off(store, type_name: str, older_than_ms: int | None = None,
            retention=None, dry_run: bool = False) -> int:
    """Physically delete rows whose dtg is before the cutoff (the
    compaction-time AgeOffIterator role): ``older_than_ms``, or now less
    ``retention`` (a duration; default the schema's ``geomesa.age.off``).
    Returns the affected count — with ``dry_run`` the expired rows, tombstoned
    ones included, without deleting them.

    A lean store's expired rows are deleted through their implicit ids
    (``row_ids``); the JAX package's ``age_off`` reads the whole id
    column there, which its lean batch refuses (AttributeError)."""
    sft = store.get_schema(type_name)
    if older_than_ms is None:
        if retention is None:
            # the scan-time filter's table config (geomesa.age.off)
            retention = sft.user_data.get(AGE_OFF_KEY)
        if retention is None:
            raise ValueError("need older_than_ms or retention (schema has "
                             f"no {AGE_OFF_KEY})")
        older_than_ms = int(time.time() * 1000) - parse_duration_ms(retention)
    if not sft.dtg_field:
        raise ValueError(f"schema {type_name!r} has no dtg field")
    schema_store = store._store(type_name)
    batch = schema_store.batch
    if batch is None or len(batch) == 0:
        return 0
    dtg = batch.column(sft.dtg_field)
    expired = np.flatnonzero(dtg < older_than_ms)
    if dry_run or not len(expired):
        return int(len(expired))
    ids = (batch.row_ids(expired) if schema_store.lean
           else batch.ids[expired])
    return store.delete(type_name, ids)
