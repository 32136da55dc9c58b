"""Columnar feature batches (SoA), the unit of ingest and query results.

The TPU-first replacement for per-row SimpleFeatures + Kryo payloads
(geomesa-features/.../kryo/KryoFeatureSerializer.scala): features live as
parallel columns —

* point geometry → two float64 columns ``<geom>_x`` / ``<geom>_y``
* non-point geometry → a :class:`PackedGeometry` + a (N, 4) bbox column
* date → int64 epoch-millis
* string → numpy object array host-side (dictionary-encode on demand)
* numerics/bool → natural numpy dtypes

The reference's "lazy deserialization" trick (KryoBufferSimpleFeature
reading only touched attributes) becomes simply *column projection* —
touch only the columns a query needs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..geometry.packed import PackedGeometry, pack_geometries
from .feature_type import FeatureType

__all__ = ["FeatureBatch", "build_columns"]

_DTYPES = {
    "int": np.int32,
    "long": np.int64,
    "float": np.float32,
    "double": np.float64,
    "bool": np.bool_,
    "date": np.int64,  # epoch millis
}


@dataclass
class FeatureBatch:
    """N features of one FeatureType as columns."""

    sft: FeatureType
    columns: dict                    # name -> np.ndarray (see module doc)
    ids: np.ndarray | None = None    # feature ids (object array of str) or None
    geoms: PackedGeometry | None = None  # packed non-point default geometry
    ids_explicit: bool = True        # False when ids were auto-generated

    def __post_init__(self):
        n = len(self)
        for name, col in self.columns.items():
            if len(col) != n:
                raise ValueError(
                    f"column {name!r} has length {len(col)}, expected {n}")
        if self.ids is None:
            self.ids = np.array([str(i) for i in range(n)], dtype=object)
            self.ids_explicit = False

    def __len__(self) -> int:
        if self.columns:
            return len(next(iter(self.columns.values())))
        return 0 if self.geoms is None else len(self.geoms)

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_dict(cls, sft: FeatureType, data: dict, ids=None) -> "FeatureBatch":
        """Build from a dict of attribute name → values.

        Geometry attributes accept Geometry objects (packed automatically);
        the point default-geometry fast path accepts ``(x, y)`` tuples of
        arrays under the geometry attribute name.
        """
        columns, geoms = build_columns(sft, data)
        ids_arr = None if ids is None else np.asarray(ids, dtype=object)
        return cls(sft, columns, ids_arr, geoms, ids_explicit=ids is not None)

    @classmethod
    def empty(cls, sft: FeatureType) -> "FeatureBatch":
        """Zero-row batch with correctly-typed columns for every attribute
        (including the geometry x/y fast path) — safe to geom_xy/concat."""
        data: dict = {}
        for attr in sft.attributes:
            if attr.is_geometry:
                if attr.name == sft.default_geom:
                    data[attr.name] = ((np.empty(0), np.empty(0))
                                       if attr.type == "point" else [])
            elif attr.type == "date":
                data[attr.name] = np.empty(0, dtype=np.int64)
            elif attr.type in ("string", "bytes", "json"):
                data[attr.name] = np.empty(0, dtype=object)
            else:
                data[attr.name] = np.empty(0, dtype=_DTYPES[attr.type])
        return cls.from_dict(sft, data, ids=np.empty(0, dtype=object))

    # -- access -----------------------------------------------------------
    def column(self, name: str) -> np.ndarray:
        return self.columns[name]

    def geom_xy(self, name: str | None = None):
        name = name or self.sft.default_geom
        return self.columns[f"{name}_x"], self.columns[f"{name}_y"]

    def geom_bbox(self, name: str | None = None) -> np.ndarray:
        name = name or self.sft.default_geom
        key = f"{name}_bbox"
        if key in self.columns:
            return self.columns[key]
        x, y = self.geom_xy(name)
        return np.stack([x, y, x, y], axis=1)

    def take(self, positions: np.ndarray,
             columns=None) -> "FeatureBatch":
        """Row subset (gather) — used to materialize query results.
        ``columns`` restricts which columns are gathered (projection
        push-down; ids and packed geometries still gather)."""
        cols = {k: v[positions] for k, v in self.columns.items()
                if columns is None or k in columns}
        geoms = None
        if self.geoms is not None:
            geoms = self.geoms.take(positions)
        return FeatureBatch(self.sft, cols, self.ids[positions], geoms)

    def concat(self, other: "FeatureBatch") -> "FeatureBatch":
        if other.sft.name != self.sft.name:
            raise ValueError("cannot concat batches of different schemas")
        cols = {
            k: np.concatenate([v, other.columns[k]]) for k, v in self.columns.items()
        }
        if (self.geoms is None) != (other.geoms is None):
            raise ValueError(
                "cannot concat: one batch has packed geometries, the other none")
        geoms = None
        if self.geoms is not None and other.geoms is not None:
            geoms = self.geoms.concat(other.geoms)
        return FeatureBatch(
            self.sft, cols, np.concatenate([self.ids, other.ids]), geoms)


def build_columns(sft: FeatureType, data: dict,
                  keep_fixed_strings: bool = False):
    """Normalize a dict of attribute values into the canonical column
    layout (module doc) — the shared ingest step of FeatureBatch.from_dict
    and the lean profile's chunked writes (which skip FeatureBatch id
    materialization entirely).  ``keep_fixed_strings``: a string column
    given as a fixed-width unicode array stays one (the lean profile's
    columns at scale; an object array holds a Python string a row).
    Returns ``(columns, packed_geoms)``."""
    columns: dict = {}
    geoms = None
    for attr in sft.attributes:
        if attr.name not in data:
            continue
        vals = data[attr.name]
        if attr.is_geometry:
            if attr.type == "point":
                # canonical point layout is the x/y fast path — whether
                # given as (x, y) arrays or Point objects — so batches
                # concat regardless of construction style
                if isinstance(vals, tuple):
                    x, y = vals
                elif (isinstance(vals, list) and vals
                      and isinstance(vals[0], (tuple, list))
                      and len(vals[0]) == 2
                      and not isinstance(vals[0][0], (tuple, list))):
                    # list of (x, y) coordinate pairs
                    arr = np.asarray(vals, dtype=np.float64)
                    x, y = arr[:, 0], arr[:, 1]
                else:
                    pts = (vals if isinstance(vals, PackedGeometry)
                           else pack_geometries(vals))
                    if pts.kinds.size and not (pts.kinds == 0).all():
                        raise ValueError(
                            f"attribute {attr.name!r} is typed Point but "
                            "got non-point geometries")
                    xy = pts.coords[pts.ring_offsets[:-1]] if pts.kinds.size \
                        else np.empty((0, 2))
                    x, y = xy[:, 0], xy[:, 1]
                columns[f"{attr.name}_x"] = np.asarray(x, dtype=np.float64)
                columns[f"{attr.name}_y"] = np.asarray(y, dtype=np.float64)
            else:
                packed = vals if isinstance(vals, PackedGeometry) else pack_geometries(vals)
                if attr.name == sft.default_geom:
                    geoms = packed
                columns[f"{attr.name}_bbox"] = packed.bbox
                if packed.kinds.size and (packed.kinds == 0).all():
                    # pure point column: also expose x/y fast path
                    pts = packed.coords[packed.ring_offsets[:-1]]
                    columns[f"{attr.name}_x"] = pts[:, 0]
                    columns[f"{attr.name}_y"] = pts[:, 1]
        elif attr.type == "date":
            vals = np.asarray(vals)
            if vals.dtype.kind == "M":
                vals = vals.astype("M8[ms]").astype(np.int64)
            if vals.dtype == object and any(v is None for v in vals):
                # sparse values (live-cache partial attrs): stay object;
                # filter evaluation treats None as non-matching
                columns[attr.name] = vals
            else:
                columns[attr.name] = vals.astype(np.int64)
        elif attr.type in ("string", "bytes", "json"):
            fixed = (keep_fixed_strings and attr.type == "string"
                     and isinstance(vals, np.ndarray) and vals.dtype.kind == "U")
            columns[attr.name] = (vals if fixed
                                  else np.asarray(vals, dtype=object))
        else:
            arr = np.asarray(vals)
            if arr.dtype == object and any(v is None for v in arr):
                columns[attr.name] = arr
            else:
                columns[attr.name] = arr.astype(_DTYPES[attr.type])
    return columns, geoms
