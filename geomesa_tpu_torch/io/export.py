"""Columnar export formats: Arrow, Parquet and ORC.

The port's copy of the Arrow/Parquet/ORC half of the JAX package's
``io/export.py``, with the same file layout: the schema metadata keys
``geomesa_tpu.sft`` and ``geomesa_tpu.name``, the ``__fid__`` column, the
``<geom>_x``/``<geom>_y`` fast-path columns beside the geometry as WKT
(``POINT (x y)`` for points), dates as ``timestamp[ms]``.  A file either
package writes, the other reads.  ``pyarrow`` is imported by the calls
that need it, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..features.batch import FeatureBatch
from ..features.feature_type import FeatureType, parse_spec
from ..geometry.wkt import geometry_from_wkt, geometry_to_wkt

__all__ = ["to_arrow", "to_parquet", "from_parquet", "to_orc", "from_orc"]


def _geom_wkt_column(batch: FeatureBatch) -> np.ndarray | None:
    name = batch.sft.default_geom
    if name is None:
        return None
    if batch.geoms is not None:
        return np.asarray(
            [geometry_to_wkt(batch.geoms.geometry(i)) for i in range(len(batch))],
            dtype=object)
    x, y = batch.geom_xy()
    return np.asarray([f"POINT ({a} {b})" for a, b in zip(x, y)], dtype=object)


def to_arrow(batch: FeatureBatch):
    """FeatureBatch → pyarrow.Table (dates as timestamp[ms], geometry as
    WKT plus x/y fast-path columns for points)."""
    import pyarrow as pa

    arrays, names = [], []
    arrays.append(pa.array(batch.ids.astype(str)))
    names.append("__fid__")
    for attr in batch.sft.attributes:
        if attr.is_geometry:
            if f"{attr.name}_x" in batch.columns:
                arrays.append(pa.array(batch.columns[f"{attr.name}_x"]))
                names.append(f"{attr.name}_x")
                arrays.append(pa.array(batch.columns[f"{attr.name}_y"]))
                names.append(f"{attr.name}_y")
            if attr.name == batch.sft.default_geom:
                arrays.append(pa.array(_geom_wkt_column(batch)))
                names.append(attr.name)
            elif f"{attr.name}_bbox" in batch.columns:
                # secondary non-point geometries are carried at bbox
                # resolution (the batch packs vertices only for the
                # default geometry)
                bb = batch.columns[f"{attr.name}_bbox"]
                for j, part in enumerate(("xmin", "ymin", "xmax", "ymax")):
                    arrays.append(pa.array(bb[:, j]))
                    names.append(f"{attr.name}_bbox_{part}")
        elif attr.name in batch.columns:
            col = batch.columns[attr.name]
            if attr.type == "date":
                arrays.append(pa.array(col).cast(pa.timestamp("ms")))
            else:
                arrays.append(pa.array(col))
            names.append(attr.name)
    table = pa.table(dict(zip(names, arrays)))
    return table.replace_schema_metadata(
        {"geomesa_tpu.sft": batch.sft.spec_string(),
         "geomesa_tpu.name": batch.sft.name})


def to_parquet(batch: FeatureBatch, path: str) -> None:
    import pyarrow.parquet as pq

    pq.write_table(to_arrow(batch), path)


def from_parquet(path: str, sft: FeatureType | None = None) -> FeatureBatch:
    """A parquet file back into a FeatureBatch; without ``sft`` the schema
    comes from the file's ``geomesa_tpu.sft`` metadata."""
    import pyarrow.parquet as pq

    table = pq.read_table(path)
    meta = table.schema.metadata or {}
    if sft is None:
        spec = meta.get(b"geomesa_tpu.sft")
        name = meta.get(b"geomesa_tpu.name", b"imported")
        if spec is None:
            raise ValueError("parquet file lacks geomesa_tpu schema metadata; pass sft")
        sft = parse_spec(name.decode(), spec.decode())
    return _table_to_batch(table, sft)


def to_orc(batch: FeatureBatch, path: str) -> None:
    """ORC export (the FSDS ORC storage format).  ORC carries no arrow
    schema metadata, so reading back needs the schema."""
    import pyarrow as pa
    import pyarrow.orc as orc

    table = to_arrow(batch)
    # ORC timestamps do not round-trip epoch millis: dates go as int64
    # (the reader casts date columns to int64 anyway)
    for i, f in enumerate(table.schema):
        if pa.types.is_timestamp(f.type):
            table = table.set_column(
                i, f.name, table.column(i).cast("int64"))
    orc.write_table(table, path)


def from_orc(path: str, sft: FeatureType) -> FeatureBatch:
    import pyarrow.orc as orc

    return _table_to_batch(orc.ORCFile(path).read(), sft)


def _table_to_batch(table, sft: FeatureType) -> FeatureBatch:
    data: dict = {}
    cols = {c: table.column(c) for c in table.column_names}
    extra_bbox: dict = {}
    for attr in sft.attributes:
        if attr.is_geometry:
            if attr.type == "point" and f"{attr.name}_x" in cols:
                data[attr.name] = (
                    cols[f"{attr.name}_x"].to_numpy(),
                    cols[f"{attr.name}_y"].to_numpy(),
                )
            elif attr.name in cols:
                wkt = cols[attr.name].to_numpy(zero_copy_only=False)
                data[attr.name] = [geometry_from_wkt(w) for w in wkt]
            elif f"{attr.name}_bbox_xmin" in cols:
                extra_bbox[f"{attr.name}_bbox"] = np.stack(
                    [cols[f"{attr.name}_bbox_{p}"].to_numpy()
                     for p in ("xmin", "ymin", "xmax", "ymax")], axis=1)
        elif attr.name in cols:
            col = cols[attr.name]
            if attr.type == "date":
                data[attr.name] = col.cast("int64").to_numpy()
            else:
                data[attr.name] = col.to_numpy(zero_copy_only=False)
    ids = (cols["__fid__"].to_numpy(zero_copy_only=False)
           if "__fid__" in cols else None)
    batch = FeatureBatch.from_dict(sft, data, ids=ids)
    batch.columns.update(extra_bbox)
    return batch
