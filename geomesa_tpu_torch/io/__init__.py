"""IO layer: converter-based ingest and export.

The port's copy of the JAX package's ``io/``: config-driven converters
(CSV/TSV, JSON, GeoJSON, XML, fixed-width, Avro, JDBC, shapefile, OSM)
that evaluate transform expressions over whole numpy columns into
feature batches, with enrichment caches and index validators; exports to
Arrow, Parquet, ORC, CSV, GeoJSON, GML, a Leaflet map, shapefiles and
Avro, in the JAX package's layouts so that either package reads the
other's files; and the BIN track-point encoding.  The Arrow result path
is :mod:`geomesa_tpu_torch.arrow`.
"""

from .bin_encoder import decode_bin, encode_bin
from .converters import Converter, EvaluationContext, converter_from_config
from .export import (
    from_orc,
    from_parquet,
    to_arrow,
    to_csv,
    to_geojson,
    to_orc,
    to_parquet,
)

__all__ = [
    "Converter", "EvaluationContext", "converter_from_config",
    "encode_bin", "decode_bin",
    "to_arrow", "to_csv", "to_geojson", "to_parquet", "from_parquet",
    "to_orc", "from_orc",
]
