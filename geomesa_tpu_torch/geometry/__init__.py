"""Geometry model: object-form geometries (Point/LineString/Polygon/
Multi*) for planning, WKT I/O and tests; the packed SoA form the feature
batches carry; and vectorized numpy predicates, the exact re-check after
index candidate filtering."""

from .packed import PackedGeometry, pack_geometries
from .predicates import (
    bbox_intersects,
    geometry_intersects,
    point_in_polygon,
    points_in_packed_polygon,
    points_on_rings,
    segments_intersect,
)
from .types import (
    Envelope,
    Geometry,
    LineString,
    MultiLineString,
    MultiPoint,
    MultiPolygon,
    Point,
    Polygon,
)
from .wkt import geometry_from_wkt, geometry_to_wkt
