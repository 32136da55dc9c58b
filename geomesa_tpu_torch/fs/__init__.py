"""Filesystem datastore: partitioned parquet storage with pruning (the
reference's geomesa-fs module), in the JAX package's on-disk layout."""

from .partitions import (
    AttributeScheme,
    CompositeScheme,
    DateTimeScheme,
    PartitionScheme,
    Z2Scheme,
    scheme_from_config,
)
from .storage import FileSystemDataStore, to_device_store

__all__ = [
    "PartitionScheme", "Z2Scheme", "DateTimeScheme", "AttributeScheme",
    "CompositeScheme", "scheme_from_config", "FileSystemDataStore",
    "to_device_store",
]
