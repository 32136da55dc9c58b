"""Vectorized filter evaluation over FeatureBatches.

The columnar replacement for the reference's FastFilterFactory / CQL
row-at-a-time evaluation (geomesa-filter, used server-side by
FilterTransformIterator): a filter evaluates to one boolean mask over the
whole batch, each predicate a dense numpy op over its column.  This is
both the full-scan path (LocalQueryRunner analog,
index/planning/LocalQueryRunner.scala:44-130) and the exact re-check
applied to index candidates.
"""

from __future__ import annotations

import re

import numpy as np

from ..features.batch import FeatureBatch
from ..geometry.predicates import (
    bbox_intersects,
    geometry_distance,
    geometry_intersects,
    geometry_within,
    point_in_polygon,
    points_on_rings,
    points_to_geometry_dist,
)
from ..geometry.types import (
    LineString,
    MultiLineString,
    MultiPoint,
    MultiPolygon,
    Point,
    Polygon,
)
from .ast import (
    And, BBox, Between, Contains, Crosses, During, DWithin, Filter,
    GeomEquals, Overlaps, Touches,
    IdFilter, In, Intersects, Like, Not, Or, PropertyCompare, Within,
    _Exclude, _Include,
)

__all__ = ["evaluate_filter"]


def _use_xy_fast_path(batch: FeatureBatch, prop: str) -> bool:
    """True when the property's x/y columns are the right source: either
    it is a secondary point attribute, or the default geometry with no
    packed (non-point) storage.  The packed column only ever holds the
    DEFAULT geometry, so other props must never fall through to it."""
    if f"{prop}_x" not in batch.columns:
        return False
    return prop != batch.sft.default_geom or batch.geoms is None


def _like_regex(pattern: str, case_insensitive: bool) -> re.Pattern:
    # SQL LIKE: % = any run, _ = single char
    esc = re.escape(pattern).replace("%", ".*").replace("_", ".")
    return re.compile("^" + esc + "$", re.IGNORECASE if case_insensitive else 0)


def _geom_mask_polygonal(batch: FeatureBatch, prop: str, geom, op: str) -> np.ndarray:
    """Spatial mask for a query geometry over the batch's geometry column
    (point fast path or packed geometries), honoring the operator."""
    n = len(batch)
    if _use_xy_fast_path(batch, prop):
        x, y = batch.columns[f"{prop}_x"], batch.columns[f"{prop}_y"]
        if op in ("crosses", "overlaps"):
            # a point feature can never cross anything (its interior has
            # dimension 0) and overlaps requires equal dimensions with a
            # partial interior share a lone point cannot provide
            return np.zeros(n, dtype=bool)
        if op == "touches":
            from ..geometry.predicates import _rings_of
            if isinstance(geom, (Polygon, MultiPolygon)):
                return points_on_rings(x, y, _rings_of(geom))
            if isinstance(geom, (LineString, MultiLineString)):
                lines = ([geom] if isinstance(geom, LineString)
                         else list(geom.lines))
                out = np.zeros(n, dtype=bool)
                for l in lines:
                    for e in (l.coords[0], l.coords[-1]):
                        out |= (x == e[0]) & (y == e[1])
                return out
            return np.zeros(n, dtype=bool)
        if op == "contains":
            # a point can only contain (and only intersects-equal) a point
            if isinstance(geom, Point):
                return (x == geom.x) & (y == geom.y)
            return np.zeros(n, dtype=bool)
        if isinstance(geom, (Polygon, MultiPolygon)):
            # intersects == within for point features
            return point_in_polygon(x, y, geom)
        if isinstance(geom, Point):
            return (x == geom.x) & (y == geom.y)
        if isinstance(geom, MultiPoint):
            out = np.zeros(n, dtype=bool)
            for qx, qy in geom.coords:
                out |= (x == qx) & (y == qy)
            return out
        # linear query geometry: point must lie on a segment
        if isinstance(geom, LineString):
            rings = [geom.coords]
        elif isinstance(geom, MultiLineString):
            rings = [l.coords for l in geom.lines]
        else:
            raise NotImplementedError(f"spatial op over {geom.geom_type}")
        env = geom.envelope
        near = (x >= env.xmin) & (x <= env.xmax) & (y >= env.ymin) & (y <= env.ymax)
        out = np.zeros(n, dtype=bool)
        if near.any():
            idx = np.flatnonzero(near)
            out[idx] = points_on_rings(x[idx], y[idx], rings)
        return out
    # packed geometries: bbox prefilter + exact object test.  The packed
    # column only ever stores the DEFAULT geometry — refuse rather than
    # silently answer for a different property
    packed = batch.geoms
    if packed is None or prop != batch.sft.default_geom:
        raise KeyError(f"no geometry column for {prop!r}")
    env = geom.envelope
    cand = bbox_intersects(packed.bbox, env.as_tuple())
    out = np.zeros(n, dtype=bool)
    if op == "intersects":
        # batched exact predicate over the SoA buffers — the hot residual
        # re-check runs vectorized, not per-candidate
        from ..geometry.predicates import packed_intersects
        idx = np.flatnonzero(cand)
        out[idx] = packed_intersects(packed, geom, idx)
        return out
    for i in np.flatnonzero(cand):
        gi = packed.geometry(int(i))
        if op == "within":
            out[i] = geometry_within(gi, geom)
        elif op == "contains":
            out[i] = geometry_within(geom, gi)
        elif op == "touches":
            from ..geometry.predicates import geometry_touches
            out[i] = geometry_touches(gi, geom)
        elif op == "crosses":
            from ..geometry.predicates import geometry_crosses
            out[i] = geometry_crosses(gi, geom)
        elif op == "overlaps":
            from ..geometry.predicates import geometry_overlaps
            out[i] = geometry_overlaps(gi, geom)
        else:
            raise NotImplementedError(op)
    return out


def _canonical_ring(coords: np.ndarray) -> tuple:
    """Orientation- and start-point-invariant form of a closed ring: the
    lexicographically smallest rotation over both directions (ECQL/JTS
    EQUALS is topological, so POLYGON((0 0,2 0,2 2,0 2,0 0)) equals the
    same ring started elsewhere or wound the other way)."""
    pts = [tuple(p) for p in np.asarray(coords, dtype=np.float64)]
    if len(pts) > 1 and pts[0] == pts[-1]:
        pts = pts[:-1]
    best = None
    for seq in (pts, pts[::-1]):
        for s in range(len(seq)):
            rot = tuple(seq[s:] + seq[:s])
            if best is None or rot < best:
                best = rot
    return best or ()


def _canonical_geom(g) -> tuple:
    """Hashable topological-equality key for a geometry."""
    if isinstance(g, Point):
        return ("point", (g.x, g.y))
    if isinstance(g, MultiPoint):
        return ("multipoint",
                tuple(sorted(tuple(p) for p in np.asarray(g.coords))))
    if isinstance(g, LineString):
        pts = tuple(tuple(p) for p in np.asarray(g.coords))
        return ("line", min(pts, pts[::-1]))
    if isinstance(g, MultiLineString):
        return ("multiline",
                tuple(sorted(_canonical_geom(l)[1] for l in g.lines)))
    if isinstance(g, Polygon):
        return ("polygon", _canonical_ring(g.shell),
                tuple(sorted(_canonical_ring(h) for h in g.holes)))
    if isinstance(g, MultiPolygon):
        return ("multipolygon",
                tuple(sorted(_canonical_geom(p)[1:] for p in g.polygons)))
    return ("other", repr(g))


def _prop_column(batch: FeatureBatch, prop: str) -> np.ndarray:
    """Resolve a property reference to a column.

    ``$.attr.path`` json-path references (the reference's json
    attribute queries) are not ported and raise.
    """
    if not prop.startswith("$."):
        return batch.column(prop)
    raise NotImplementedError(
        f"json-path property {prop!r}: json attributes are not ported")


def _safe_compare(col: np.ndarray, value, op: str) -> np.ndarray:
    """Ordering comparison tolerant of None/mixed entries in object
    columns (json-path results): non-comparable rows are False."""
    if col.dtype.kind == "U" and not isinstance(value, str):
        # a fixed-width string column (lean stores) against a non-string
        # value: no row compares, as in an object column
        return np.zeros(len(col), dtype=bool)
    if col.dtype != object:
        return {"<": col < value, "<=": col <= value,
                ">": col > value, ">=": col >= value}[op]
    import operator as _op
    fn = {"<": _op.lt, "<=": _op.le, ">": _op.gt, ">=": _op.ge}[op]
    out = np.zeros(len(col), dtype=bool)
    for i, v in enumerate(col):
        if v is None:
            continue
        try:
            out[i] = fn(v, value)
        except TypeError:
            pass
    return out


def evaluate_filter(f: Filter, batch: FeatureBatch) -> np.ndarray:
    """Evaluate a filter to a boolean mask over the batch."""
    n = len(batch)
    if isinstance(f, _Include):
        return np.ones(n, dtype=bool)
    if isinstance(f, _Exclude):
        return np.zeros(n, dtype=bool)
    if isinstance(f, And):
        mask = np.ones(n, dtype=bool)
        for p in f.filters:
            mask &= evaluate_filter(p, batch)
        return mask
    if isinstance(f, Or):
        mask = np.zeros(n, dtype=bool)
        for p in f.filters:
            mask |= evaluate_filter(p, batch)
        return mask
    if isinstance(f, Not):
        return ~evaluate_filter(f.filter, batch)
    if isinstance(f, BBox):
        if _use_xy_fast_path(batch, f.prop):
            x = batch.columns[f"{f.prop}_x"]
            y = batch.columns[f"{f.prop}_y"]
            return (x >= f.xmin) & (x <= f.xmax) & (y >= f.ymin) & (y <= f.ymax)
        # non-point geometries: exact intersects against the box polygon
        # (the reference's default strict-bbox behavior; loose mode would
        # stop at the bbox prefilter)
        box_poly = Polygon.from_envelope(f.envelope)
        return _geom_mask_polygonal(batch, f.prop, box_poly, "intersects")
    if isinstance(f, Intersects):
        return _geom_mask_polygonal(batch, f.prop, f.geometry, "intersects")
    if isinstance(f, Within):
        return _geom_mask_polygonal(batch, f.prop, f.geometry, "within")
    if isinstance(f, Contains):
        return _geom_mask_polygonal(batch, f.prop, f.geometry, "contains")
    if isinstance(f, Touches):
        return _geom_mask_polygonal(batch, f.prop, f.geometry, "touches")
    if isinstance(f, Crosses):
        return _geom_mask_polygonal(batch, f.prop, f.geometry, "crosses")
    if isinstance(f, Overlaps):
        return _geom_mask_polygonal(batch, f.prop, f.geometry, "overlaps")
    if isinstance(f, DWithin):
        env = f.geometry.envelope
        deg = f.degrees
        window = (env.xmin - deg, env.ymin - deg,
                  env.xmax + deg, env.ymax + deg)
        if _use_xy_fast_path(batch, f.prop):
            x = batch.columns[f"{f.prop}_x"]
            y = batch.columns[f"{f.prop}_y"]
            if isinstance(f.geometry, Point):
                if f.meters:
                    # exact great-circle test for metric distances
                    return (haversine_m(f.geometry.x, f.geometry.y, x, y)
                            <= f.distance)
                d2 = (x - f.geometry.x) ** 2 + (y - f.geometry.y) ** 2
                return d2 <= deg ** 2
            # bbox prefilter bounds the (points × segments) distance work
            near = ((x >= window[0]) & (x <= window[2])
                    & (y >= window[1]) & (y <= window[3]))
            out = np.zeros(n, dtype=bool)
            if near.any():
                idx = np.flatnonzero(near)
                out[idx] = (points_to_geometry_dist(x[idx], y[idx],
                                                    f.geometry)
                            <= deg)
            return out
        packed = batch.geoms
        if packed is None or f.prop != batch.sft.default_geom:
            raise KeyError(f"no geometry column for {f.prop!r}")
        # bbox prefilter expanded by the distance, then exact per candidate
        cand = bbox_intersects(packed.bbox, window)
        out = np.zeros(n, dtype=bool)
        for i in np.flatnonzero(cand):
            out[i] = (geometry_distance(packed.geometry(int(i)), f.geometry)
                      <= deg)
        return out
    if isinstance(f, GeomEquals):
        from ..geometry.types import Point as _Pt
        if _use_xy_fast_path(batch, f.prop):
            x = batch.columns[f"{f.prop}_x"]
            y = batch.columns[f"{f.prop}_y"]
            if not isinstance(f.geometry, _Pt):
                return np.zeros(n, dtype=bool)
            return (x == f.geometry.x) & (y == f.geometry.y)
        packed = batch.geoms
        if packed is None or f.prop != batch.sft.default_geom:
            raise KeyError(f"no geometry column for {f.prop!r}")
        env = f.geometry.envelope
        # exact-equality prefilter: equal geometries have equal bboxes
        cand = ((packed.bbox[:, 0] == env.xmin)
                & (packed.bbox[:, 1] == env.ymin)
                & (packed.bbox[:, 2] == env.xmax)
                & (packed.bbox[:, 3] == env.ymax))
        out = np.zeros(n, dtype=bool)
        want = _canonical_geom(f.geometry)
        for i in np.flatnonzero(cand):
            out[i] = _canonical_geom(packed.geometry(int(i))) == want
        return out
    if isinstance(f, During):
        col = _prop_column(batch, f.prop)
        mask = np.ones(n, dtype=bool)
        if f.lo_ms is not None:
            mask &= _safe_compare(col, f.lo_ms, ">=")
        if f.hi_ms is not None:
            mask &= _safe_compare(col, f.hi_ms, "<=")
        return mask
    if isinstance(f, PropertyCompare):
        col = _prop_column(batch, f.prop)
        if f.op == "=":
            return np.asarray(col == f.value)
        if f.op == "<>":
            mask = np.asarray(col != f.value)
            if col.dtype == object:
                # a missing (None) value matches nothing, <> included
                mask &= np.array([v is not None for v in col])
            return mask
        return _safe_compare(col, f.value, f.op)
    if isinstance(f, Between):
        col = _prop_column(batch, f.prop)
        return _safe_compare(col, f.lo, ">=") & _safe_compare(col, f.hi, "<=")
    if isinstance(f, In):
        col = _prop_column(batch, f.prop)
        # one hashed pass instead of a scan per value (high-cardinality
        # joins feed thousands of values); np.isin promotes dtypes the
        # same way `col == v` does, so semantics match the loop below
        if len(f.values) > 4:
            if col.dtype == object:
                return np.isin(col.astype(str),
                               np.array([str(v) for v in f.values]))
            vals = np.array(list(f.values))
            # only when value dtype is compatible with the column: a mixed
            # list like [1, 'a'] promotes to '<U21', and np.isin would then
            # compare numbers to strings and silently match nothing
            if (vals.dtype != object
                    and (vals.dtype.kind == col.dtype.kind
                         or (vals.dtype.kind in "iuf"
                             and col.dtype.kind in "iuf"))):
                return np.isin(col, vals)
        mask = np.zeros(n, dtype=bool)
        for v in f.values:
            mask |= col == v
        return mask
    if isinstance(f, IdFilter):
        wanted = set(f.ids)
        return np.array([str(v) in wanted for v in batch.ids], dtype=bool)
    if isinstance(f, Like):
        col = _prop_column(batch, f.prop)
        rx = _like_regex(f.pattern, f.case_insensitive)
        return np.array([v is not None and bool(rx.match(str(v)))
                         for v in col], dtype=bool)
    raise NotImplementedError(f"cannot evaluate {type(f).__name__}")


#: mean Earth radius (meters) of the metric DWITHIN test
EARTH_RADIUS_M = 6_371_008.8


def haversine_m(lon1, lat1, lon2, lat2):
    """Vectorized great-circle distance in meters."""
    lon1, lat1, lon2, lat2 = (np.radians(np.asarray(v, dtype=np.float64))
                              for v in (lon1, lat1, lon2, lat2))
    dlon = lon2 - lon1
    dlat = lat2 - lat1
    a = np.sin(dlat / 2) ** 2 + np.cos(lat1) * np.cos(lat2) * np.sin(dlon / 2) ** 2
    return 2 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0, 1)))
