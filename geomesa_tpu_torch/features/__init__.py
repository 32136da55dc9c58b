"""Feature model: schemas and columnar feature batches.

Replaces the reference's SimpleFeatureType/SimpleFeature object model
(geomesa-utils/.../geotools/SimpleFeatureTypes.scala,
geomesa-features/.../ScalaSimpleFeature.scala) with a TPU-first design:
schemas are lightweight descriptors, and feature data is a
structure-of-arrays batch (numpy/jax columns) rather than per-row objects
— the layout device kernels consume directly.  Row serialization codecs
(Kryo/Avro) are replaced by columnar interchange (arrow / parquet via
pyarrow) at the edges.
"""

from .batch import FeatureBatch
from .feature_type import AttributeSpec, FeatureType, parse_spec
