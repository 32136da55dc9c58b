"""Schemaless GeoJSON API (geomesa-geojson analog)."""

from .index import GeoJsonIndex
from .query import parse_geojson_query
from .servlet import GeoJsonApp

__all__ = ["GeoJsonIndex", "parse_geojson_query", "GeoJsonApp"]
