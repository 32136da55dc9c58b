"""IO layer: columnar export and import through pyarrow (Arrow tables,
Parquet and ORC files), in the JAX package's file layout so that either
package reads the other's files."""

from .export import (
    from_orc,
    from_parquet,
    to_arrow,
    to_orc,
    to_parquet,
)

__all__ = ["to_arrow", "to_parquet", "from_parquet", "to_orc", "from_orc"]
