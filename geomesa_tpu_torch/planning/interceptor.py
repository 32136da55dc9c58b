"""Query interceptors: user-pluggable query rewrites.

The port's copy of the JAX package's ``planning/interceptor.py``, after
the reference's QueryInterceptor SPI (index-api planning/
QueryInterceptor.scala): per-schema classes loaded from the SFT user-data
key ``geomesa.query.interceptors``, each given a chance to rewrite the
query before planning (enforcing a default time range, blocking
expensive predicates, ...).
"""

from __future__ import annotations

import importlib
from typing import Protocol, runtime_checkable

__all__ = ["QueryInterceptor", "load_interceptors", "apply_interceptors",
           "GuardedQueryInterceptor"]

USER_DATA_KEY = "geomesa.query.interceptors"


@runtime_checkable
class QueryInterceptor(Protocol):
    def rewrite(self, sft, query):  # pragma: no cover - protocol
        """Return the (possibly modified) query."""
        ...


class GuardedQueryInterceptor:
    """Example guard: reject full-table scans (Filter == INCLUDE) — the
    QueryProperties.BlockFullTableScans behavior
    (index/conf/QueryProperties.scala:37-44) expressed as an
    interceptor."""

    def rewrite(self, sft, query):
        from ..filters.ast import _Include

        if isinstance(query.filter, _Include):
            raise ValueError(
                f"full-table scan blocked on {sft.name!r} by interceptor")
        return query


def load_interceptors(sft) -> list:
    """Instantiate the interceptor classes named in the SFT's user data
    (comma-separated ``module:Class`` or ``module.Class`` paths).  A
    schema carrying ``geomesa.age.off`` user data auto-attaches the
    age-off interceptor (the reference attaches its age-off iterator at
    table-configuration time the same way)."""
    raw = sft.user_data.get(USER_DATA_KEY, "")
    out = []
    for name in (n.strip() for n in str(raw).split(",") if n.strip()):
        if ":" in name:
            mod, cls = name.split(":", 1)
        else:
            mod, _, cls = name.rpartition(".")
        out.append(getattr(importlib.import_module(mod), cls)())
    from ..age_off import AGE_OFF_KEY, AgeOffInterceptor
    if AGE_OFF_KEY in sft.user_data:
        out.append(AgeOffInterceptor())
    return out


def apply_interceptors(interceptors, sft, query):
    for it in interceptors:
        query = it.rewrite(sft, query)
    return query
