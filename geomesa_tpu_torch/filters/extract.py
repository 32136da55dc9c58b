"""Filter analysis for the planner: CNF rewrite and geometry/interval
extraction.

Mirrors the roles of the reference's FilterHelper
(geomesa-filter/.../FilterHelper.scala — ``extractGeometries`` :102,
``extractIntervals`` :151) and the CNF rewrite in
geomesa-filter/.../package.scala:52: the planner needs, per query, the
spatial envelopes and temporal intervals that an index can serve, plus the
leftover predicate to re-check.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..geometry.types import Envelope, Geometry, Point, Polygon
from .ast import (
    And, BBox, Contains, Crosses, During, DWithin, Exclude, Filter,
    GeomEquals, Overlaps, Touches,
    Include, Intersects, Not, Or, Within, _Exclude, _Include,
)

__all__ = ["FilterValues", "extract_geometries", "extract_intervals", "to_cnf",
           "split_cnf_clauses"]


@dataclass(frozen=True)
class FilterValues:
    """Extracted values: a disjunction of geometries or intervals.

    ``disjoint=True`` means the filter is provably empty (e.g. two
    non-overlapping AND'd bboxes — FilterHelper models this the same way)."""

    values: tuple = ()
    disjoint: bool = False

    def __bool__(self) -> bool:
        return bool(self.values) and not self.disjoint


def to_cnf(f: Filter) -> Filter:
    """Rewrite into conjunctive normal form (bounded distribution).

    The reference rewrites filters to CNF before splitting
    (geomesa-filter/.../package.scala:52, used by FilterSplitter); the
    same distribution laws apply here, with Not pushed to leaves.
    """
    f = _push_not(f, negate=False)
    return _distribute_or(f)


def _push_not(f: Filter, negate: bool) -> Filter:
    if isinstance(f, Not):
        return _push_not(f.filter, not negate)
    if isinstance(f, And):
        parts = tuple(_push_not(p, negate) for p in f.filters)
        return Or(parts) if negate else And(parts)
    if isinstance(f, Or):
        parts = tuple(_push_not(p, negate) for p in f.filters)
        return And(parts) if negate else Or(parts)
    if isinstance(f, _Include):
        return Exclude if negate else Include
    if isinstance(f, _Exclude):
        return Include if negate else Exclude
    return Not(f) if negate else f


def _flatten(cls, filters):
    out = []
    for f in filters:
        if isinstance(f, cls):
            out.extend(_flatten(cls, f.filters))
        else:
            out.append(f)
    return out


def _distribute_or(f: Filter) -> Filter:
    if isinstance(f, And):
        parts = [_distribute_or(p) for p in _flatten(And, f.filters)]
        clauses = []
        for p in parts:
            if isinstance(p, And):
                clauses.extend(p.filters)
            else:
                clauses.append(p)
        return And(tuple(clauses)) if len(clauses) > 1 else clauses[0]
    if isinstance(f, Or):
        parts = [_distribute_or(p) for p in _flatten(Or, f.filters)]
        # distribute OR over any AND child: (a ∧ b) ∨ c → (a ∨ c) ∧ (b ∨ c)
        for i, p in enumerate(parts):
            if isinstance(p, And):
                rest = parts[:i] + parts[i + 1:]
                new = And(tuple(
                    Or(tuple([clause, *rest])) for clause in p.filters
                ))
                return _distribute_or(new)
        return Or(tuple(parts)) if len(parts) > 1 else parts[0]
    return f


def split_cnf_clauses(f: Filter) -> list[Filter]:
    """Top-level AND clauses of the CNF form."""
    cnf = to_cnf(f)
    if isinstance(cnf, And):
        return list(cnf.filters)
    return [cnf]


def _geom_envelope_values(f: Filter, prop: str) -> "FilterValues | None":
    """Geometry values contributed by a single node (None = no constraint)."""
    if isinstance(f, BBox) and f.prop == prop:
        return FilterValues((Polygon.from_envelope(f.envelope),))
    if isinstance(f, (Intersects, Within, Contains, GeomEquals,
                      Touches, Crosses, Overlaps)) and f.prop == prop:
        return FilterValues((f.geometry,))
    if isinstance(f, DWithin) and f.prop == prop:
        env = f.geometry.envelope
        deg = f.degrees  # covering degree equivalent for metric distances
        grown = Envelope(env.xmin - deg, env.ymin - deg,
                         env.xmax + deg, env.ymax + deg)
        return FilterValues((Polygon.from_envelope(grown),))
    return None


def extract_geometries(f: Filter, prop: str) -> FilterValues:
    """Extract the union-of-geometries this filter constrains ``prop`` to.

    AND intersects envelopes (detecting disjoint → provably-empty), OR
    unions the alternatives; any branch without a spatial constraint makes
    the whole OR unconstrained — the same conservative semantics as
    FilterHelper.extractGeometries.
    """
    if isinstance(f, And):
        current: FilterValues | None = None
        for part in f.filters:
            vals = extract_geometries(part, prop)
            if vals.disjoint:
                return FilterValues(disjoint=True)
            if not vals.values:
                continue
            if current is None:
                current = vals
            else:
                # intersect at envelope granularity
                kept = []
                for g in current.values:
                    for h in vals.values:
                        inter = g.envelope.intersection(h.envelope)
                        if inter is None:
                            continue
                        # keep the original (more precise) geometry when its
                        # envelope IS the intersection, else the envelope box
                        if inter == g.envelope:
                            kept.append(g)
                        elif inter == h.envelope:
                            kept.append(h)
                        else:
                            kept.append(Polygon.from_envelope(inter))
                if not kept:
                    return FilterValues(disjoint=True)
                current = FilterValues(tuple(kept))
        return current if current is not None else FilterValues()
    if isinstance(f, Or):
        out = []
        for part in f.filters:
            vals = extract_geometries(part, prop)
            if vals.disjoint:
                continue
            if not vals.values:
                return FilterValues()  # unconstrained branch
            out.extend(vals.values)
        return FilterValues(tuple(out))
    if isinstance(f, Not):
        return FilterValues()  # negated spatial predicates are not indexable
    if isinstance(f, _Exclude):
        return FilterValues(disjoint=True)
    vals = _geom_envelope_values(f, prop)
    return vals if vals is not None else FilterValues()


def extract_intervals(f: Filter, prop: str) -> FilterValues:
    """Extract (lo_ms, hi_ms) intervals constraining ``prop``.

    Open bounds become ±``None``; AND intersects, OR unions — mirroring
    FilterHelper.extractIntervals."""
    if isinstance(f, And):
        current: FilterValues | None = None
        for part in f.filters:
            vals = extract_intervals(part, prop)
            if vals.disjoint:
                return FilterValues(disjoint=True)
            if not vals.values:
                continue
            if current is None:
                current = vals
            else:
                kept = []
                for (alo, ahi) in current.values:
                    for (blo, bhi) in vals.values:
                        lo = blo if alo is None else alo if blo is None else max(alo, blo)
                        hi = bhi if ahi is None else ahi if bhi is None else min(ahi, bhi)
                        if lo is None or hi is None or lo <= hi:
                            kept.append((lo, hi))
                if not kept:
                    return FilterValues(disjoint=True)
                current = FilterValues(tuple(kept))
        return current if current is not None else FilterValues()
    if isinstance(f, Or):
        out = []
        for part in f.filters:
            vals = extract_intervals(part, prop)
            if vals.disjoint:
                continue
            if not vals.values:
                return FilterValues()
            out.extend(vals.values)
        return FilterValues(tuple(out))
    if isinstance(f, Not):
        return FilterValues()
    if isinstance(f, _Exclude):
        return FilterValues(disjoint=True)
    if isinstance(f, During) and f.prop == prop:
        return FilterValues(((f.lo_ms, f.hi_ms),))
    return FilterValues()
