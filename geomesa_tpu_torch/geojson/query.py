"""Mongo-style query DSL for schemaless GeoJSON documents.

The analog of the reference's GeoJsonQuery
(geomesa-geojson/geomesa-geojson-api/.../query/GeoJsonQuery.scala) —
same syntax, translated into vectorized mask evaluation over the index's
columnar batch instead of GeoTools filters:

* ``{}``                                        — everything
* ``{"foo": "bar"}``                            — property equality
* ``{"foo": {"$lt": 10}}``                      — $lt/$lte/$gt/$gte
* ``{"geometry": {"$bbox": [x0,y0,x1,y1]}}``    — bbox
* ``{"geometry": {"$intersects": {"$geometry": {...geojson...}}}}``
* ``$within`` / ``$contains`` / ``$dwithin`` (+``$dist``)
* ``{"$or": [ ... ]}``; multiple keys AND together

Bare property names refer to ``properties.<name>`` of the stored GeoJSON
feature; ``$.``-prefixed names are json-paths from the document root
(GeoMesaIndexPropertyTransformer.scala:21-27 semantics).

The port's copy of the JAX package's ``geojson/query.py``: documents and
their masks are host numpy, as there.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

from ..filters import ast as fast

__all__ = ["GeoJsonQuery", "parse_geojson_query", "json_path_get",
           "geojson_to_geometry"]


def json_path_get(doc, path: str):
    """Fetch a value at a dot/bracket json-path.

    ``$.a.b[0].c`` walks from the document root; bare ``name`` reads
    ``properties.name`` of a GeoJSON feature document.
    """
    if path.startswith("$."):
        parts = path[2:]
    elif path.startswith("$"):
        parts = path[1:]
    else:
        parts = f"properties.{path}"
    cur = doc
    for raw in parts.split("."):
        while raw:
            idx = None
            if "[" in raw:
                name, rest = raw.split("[", 1)
                idx, raw = rest.split("]", 1)
            else:
                name, raw = raw, ""
            if name:
                if not isinstance(cur, dict) or name not in cur:
                    return None
                cur = cur[name]
            if idx is not None:
                try:
                    cur = cur[int(idx)]
                except (IndexError, ValueError, TypeError):
                    return None
    return cur


from ..geometry.geojson import geojson_to_geometry  # noqa: E402 — re-export


# -- AST ---------------------------------------------------------------------

class GeoJsonQuery:
    """Base node: evaluates to a boolean mask over the index's documents."""

    def mask(self, docs: np.ndarray, batch) -> np.ndarray:
        raise NotImplementedError

    def spatial_conjuncts(self) -> list:
        """Spatial sub-filters AND-ed at the top level (push-down seeds)."""
        return []


@dataclass
class _Include(GeoJsonQuery):
    def mask(self, docs, batch):
        return np.ones(len(docs), dtype=bool)


@dataclass
class _Equals(GeoJsonQuery):
    path: str
    value: object

    def mask(self, docs, batch):
        return np.array([json_path_get(d, self.path) == self.value
                         for d in docs], dtype=bool)


@dataclass
class _Compare(GeoJsonQuery):
    path: str
    value: object
    op: str          # lt | lte | gt | gte

    def mask(self, docs, batch):
        out = np.zeros(len(docs), dtype=bool)
        for i, d in enumerate(docs):
            v = json_path_get(d, self.path)
            if v is None:
                continue
            try:
                out[i] = ((v < self.value) if self.op == "lt" else
                          (v <= self.value) if self.op == "lte" else
                          (v > self.value) if self.op == "gt" else
                          (v >= self.value))
            except TypeError:
                pass
        return out


@dataclass
class _Spatial(GeoJsonQuery):
    """Wraps one of the framework's vectorized spatial filter-AST nodes;
    evaluated over the index's packed geometry column."""

    node: fast.Filter

    def mask(self, docs, batch):
        from ..filters.evaluate import evaluate_filter
        return evaluate_filter(self.node, batch)

    def spatial_conjuncts(self):
        return [self.node]


@dataclass
class _And(GeoJsonQuery):
    parts: tuple

    def mask(self, docs, batch):
        m = self.parts[0].mask(docs, batch)
        for p in self.parts[1:]:
            m &= p.mask(docs, batch)
        return m

    def spatial_conjuncts(self):
        return [s for p in self.parts for s in p.spatial_conjuncts()]


@dataclass
class _Or(GeoJsonQuery):
    parts: tuple

    def mask(self, docs, batch):
        m = self.parts[0].mask(docs, batch)
        for p in self.parts[1:]:
            m |= p.mask(docs, batch)
        return m


# -- parser ------------------------------------------------------------------

_GEOM_PROPS = ("geometry", "$.geometry")


def parse_geojson_query(query, geom_attr: str = "geom") -> GeoJsonQuery:
    """Parse a query string/dict into a :class:`GeoJsonQuery`."""
    if query is None:
        return _Include()
    if isinstance(query, str):
        query = json.loads(query) if query.strip() else {}
    if not isinstance(query, dict):
        raise ValueError("expected a JSON object query")
    return _parse_obj(query, geom_attr)


def _parse_obj(obj: dict, geom_attr: str) -> GeoJsonQuery:
    if not obj:
        return _Include()
    parts = []
    for prop, v in obj.items():
        if prop == "$or":
            if not isinstance(v, list):
                raise ValueError("$or expects an array")
            parts.append(_Or(tuple(_parse_obj(o, geom_attr) for o in v)))
        elif isinstance(v, dict):
            parts.append(_parse_predicate(prop, v, geom_attr))
        else:
            parts.append(_Equals(prop, v))
    return parts[0] if len(parts) == 1 else _And(tuple(parts))


def _parse_predicate(prop: str, pred: dict, geom_attr: str) -> GeoJsonQuery:
    """One predicate object; multiple operators AND together (the mongo
    range idiom ``{"$gte": 18, "$lt": 65}``)."""
    parts = [_parse_one_op(prop, op, v, geom_attr)
             for op, v in pred.items()]
    if not parts:
        raise ValueError("empty predicate object")
    return parts[0] if len(parts) == 1 else _And(tuple(parts))


def _parse_one_op(prop: str, op: str, v, geom_attr: str) -> GeoJsonQuery:
    if op == "$bbox":
        x0, y0, x1, y1 = v
        return _Spatial(fast.BBox(geom_attr, float(x0), float(y0),
                                  float(x1), float(y1)))
    if op in ("$intersects", "$within", "$contains", "$dwithin"):
        geom = geojson_to_geometry(v["$geometry"])
        if op == "$intersects":
            return _Spatial(fast.Intersects(geom_attr, geom))
        if op == "$within":
            return _Spatial(fast.Within(geom_attr, geom))
        if op == "$contains":
            return _Spatial(fast.Contains(geom_attr, geom))
        dist = float(v.get("$dist", 0.0))
        unit = str(v.get("$unit", "meters"))
        factor = {"meters": 1.0, "kilometers": 1000.0,
                  "feet": 0.3048, "statute miles": 1609.344,
                  "miles": 1609.344}.get(unit.lower())
        if factor is None:
            raise ValueError(f"unknown $unit {unit!r}")
        # framework DWithin distance is in coordinate units (degrees)
        return _Spatial(fast.DWithin(geom_attr, geom,
                                     dist * factor / 111_319.9))
    if op in ("$lt", "$lte", "$gt", "$gte"):
        return _Compare(prop, v, op[1:])
    raise ValueError(f"invalid predicate {op!r}")
