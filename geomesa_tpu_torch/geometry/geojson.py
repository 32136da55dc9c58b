"""GeoJSON geometry codec (shared by converters and the GeoJSON export);
the port's copy of the JAX package's ``geometry/geojson.py``."""

from __future__ import annotations

from .types import (
    Geometry, LineString, MultiLineString, MultiPoint, MultiPolygon, Point,
    Polygon,
)

__all__ = ["geojson_to_geometry", "geometry_to_geojson"]


def geojson_to_geometry(g: dict) -> Geometry:
    """GeoJSON geometry dict → framework Geometry."""
    t, c = g["type"], g.get("coordinates")
    if t == "Point":
        return Point(c[0], c[1])
    if t == "LineString":
        return LineString(c)
    if t == "Polygon":
        return Polygon(c[0], tuple(c[1:]))
    if t == "MultiPoint":
        return MultiPoint(c)
    if t == "MultiLineString":
        return MultiLineString(tuple(LineString(l) for l in c))
    if t == "MultiPolygon":
        return MultiPolygon(tuple(Polygon(p[0], tuple(p[1:])) for p in c))
    raise ValueError(f"unsupported GeoJSON geometry type {t!r}")


def geometry_to_geojson(geom: Geometry) -> dict:
    """Framework Geometry → GeoJSON geometry dict."""
    if isinstance(geom, Point):
        return {"type": "Point", "coordinates": [geom.x, geom.y]}
    if isinstance(geom, MultiPoint):
        return {"type": "MultiPoint", "coordinates": geom.coords.tolist()}
    if isinstance(geom, LineString):
        return {"type": "LineString", "coordinates": geom.coords.tolist()}
    if isinstance(geom, MultiLineString):
        return {"type": "MultiLineString",
                "coordinates": [l.coords.tolist() for l in geom.lines]}
    if isinstance(geom, Polygon):
        return {"type": "Polygon",
                "coordinates": [geom.shell.tolist()]
                + [h.tolist() for h in geom.holes]}
    if isinstance(geom, MultiPolygon):
        return {"type": "MultiPolygon",
                "coordinates": [[p.shell.tolist()]
                                + [h.tolist() for h in p.holes]
                                for p in geom.polygons]}
    raise ValueError(f"cannot encode {type(geom).__name__} as GeoJSON")
