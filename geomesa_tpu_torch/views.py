"""Merged datastore views: read-only union over N stores.

The reference's MergedDataStoreView (geomesa-index-api/.../view/
MergedDataStoreView.scala + MergedQueryRunner): one logical store whose
queries fan out to every underlying store sharing the schema and
concatenate results (each store may optionally carry a pre-filter that
scopes which subset it contributes).  The port's copy of the JAX
package's ``views.py``: each underlying store answers on its own device,
and the union is built from their host results.
"""

from __future__ import annotations

import numpy as np

from .features.batch import FeatureBatch
from .filters.ast import And
from .planning.planner import Query

__all__ = ["MergedDataStoreView"]


class MergedDataStoreView:
    """Read-only union over stores exposing create-less query APIs."""

    def __init__(self, stores, filters=None):
        """``stores``: list of stores; ``filters``: optional per-store
        scope filters (parallel list, entries None or a Filter)."""
        if not stores:
            raise ValueError("need at least one store")
        self.stores = list(stores)
        self.filters = list(filters) if filters else [None] * len(stores)
        if len(self.filters) != len(self.stores):
            raise ValueError("filters must parallel stores")

    def get_schema(self, name: str):
        return self.stores[0].get_schema(name)

    def query(self, name: str, query="INCLUDE") -> FeatureBatch:
        q = query if isinstance(query, Query) else Query.of(query)
        parts = []
        for store, scope in zip(self.stores, self.filters):
            sq = q
            if scope is not None:
                from dataclasses import replace
                sq = replace(q, filter=And((q.filter, scope)),
                             hints=dict(q.hints))
            out = store.query(name, sq)
            if len(out):
                parts.append(out)
        if not parts:
            return FeatureBatch.empty(self.get_schema(name))
        merged = parts[0]
        for p in parts[1:]:
            merged = merged.concat(p)
        if q.sort_by:
            order = np.argsort(merged.column(q.sort_by), kind="stable")
            if q.sort_desc:
                order = order[::-1]
            merged = merged.take(order)
        if q.max_features is not None:
            merged = merged.take(np.arange(min(q.max_features, len(merged))))
        return merged

    def count(self, name: str, query="INCLUDE") -> int:
        return len(self.query(name, query))
