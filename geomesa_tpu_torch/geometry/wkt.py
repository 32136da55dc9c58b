"""WKT (Well-Known Text) reader/writer for the geometry object model —
replaces the reference's use of JTS WKTReader (geomesa-utils
WKTUtils)."""

from __future__ import annotations

import re

import numpy as np

from .types import (
    Geometry,
    LineString,
    MultiLineString,
    MultiPoint,
    MultiPolygon,
    Point,
    Polygon,
)

__all__ = ["geometry_from_wkt", "geometry_to_wkt"]

_TYPE_RE = re.compile(r"^\s*([A-Za-z]+)\s*(.*)$", re.DOTALL)


def _parse_coord_list(body: str) -> np.ndarray:
    pts = []
    for pair in body.split(","):
        parts = pair.split()
        if len(parts) < 2:
            raise ValueError(f"bad coordinate {pair!r}")
        pts.append((float(parts[0]), float(parts[1])))
    return np.asarray(pts, dtype=np.float64)


def _split_groups(body: str) -> list[str]:
    """Split a parenthesized group list '(...),(...),...' at depth 0."""
    groups, depth, start = [], 0, None
    for i, ch in enumerate(body):
        if ch == "(":
            if depth == 0:
                start = i + 1
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                groups.append(body[start:i])
    if depth != 0:
        raise ValueError("unbalanced parentheses in WKT")
    return groups


def geometry_from_wkt(wkt: str) -> Geometry:
    m = _TYPE_RE.match(wkt)
    if not m:
        raise ValueError(f"invalid WKT: {wkt!r}")
    gtype = m.group(1).upper()
    rest = m.group(2).strip()
    if rest.upper() == "EMPTY":
        raise ValueError(f"empty geometries not supported: {wkt!r}")
    if gtype == "POINT":
        coords = _parse_coord_list(_split_groups(rest)[0] if "(" in rest else rest)
        return Point(float(coords[0, 0]), float(coords[0, 1]))
    if gtype == "LINESTRING":
        return LineString(_parse_coord_list(_split_groups(rest)[0]))
    if gtype == "POLYGON":
        rings = [_parse_coord_list(g) for g in _split_groups(rest[1:-1])]
        return Polygon(rings[0], tuple(rings[1:]))
    if gtype == "MULTIPOINT":
        inner = rest[1:-1].strip()
        if "(" in inner:
            coords = np.vstack([_parse_coord_list(g) for g in _split_groups(inner)])
        else:
            coords = _parse_coord_list(inner)
        return MultiPoint(coords)
    if gtype == "MULTILINESTRING":
        return MultiLineString(
            tuple(LineString(_parse_coord_list(g)) for g in _split_groups(rest[1:-1]))
        )
    if gtype == "MULTIPOLYGON":
        polys = []
        for poly_body in _split_groups(rest[1:-1]):
            # poly_body is the polygon's ring list '(r1), (r2)…'
            ring_groups = _split_groups(poly_body)
            if ring_groups:
                rings = [_parse_coord_list(g) for g in ring_groups]
            else:  # bare ring without inner parens
                rings = [_parse_coord_list(poly_body)]
            polys.append(Polygon(rings[0], tuple(rings[1:])))
        return MultiPolygon(tuple(polys))
    raise ValueError(f"unsupported WKT type: {gtype}")


def _fmt(v: float) -> str:
    if v == int(v):
        return str(int(v))
    return repr(v)


def _coords_to_wkt(coords: np.ndarray) -> str:
    return ", ".join(f"{_fmt(x)} {_fmt(y)}" for x, y in coords)


def geometry_to_wkt(geom: Geometry) -> str:
    if isinstance(geom, Point):
        return f"POINT ({_fmt(geom.x)} {_fmt(geom.y)})"
    if isinstance(geom, LineString):
        return f"LINESTRING ({_coords_to_wkt(geom.coords)})"
    if isinstance(geom, Polygon):
        rings = [geom.shell, *geom.holes]
        inner = ", ".join(f"({_coords_to_wkt(r)})" for r in rings)
        return f"POLYGON ({inner})"
    if isinstance(geom, MultiPoint):
        return f"MULTIPOINT ({_coords_to_wkt(geom.coords)})"
    if isinstance(geom, MultiLineString):
        inner = ", ".join(f"({_coords_to_wkt(l.coords)})" for l in geom.lines)
        return f"MULTILINESTRING ({inner})"
    if isinstance(geom, MultiPolygon):
        parts = []
        for p in geom.polygons:
            rings = [p.shell, *p.holes]
            parts.append("(" + ", ".join(f"({_coords_to_wkt(r)})" for r in rings) + ")")
        return f"MULTIPOLYGON ({', '.join(parts)})"
    raise ValueError(f"unsupported geometry: {geom!r}")
