"""LeanBatch: chunked columnar storage for the store's lean profile.

The port's copy of the JAX package's ``features/lean.py``: a schema's
columns accumulate as CHUNK LISTS of numpy arrays
(one per write, concatenated lazily per column), feature ids are
IMPLICIT (the id of row ``r`` is ``str(r)`` — minted by append order,
never reused), and query results materialize real :class:`FeatureBatch`
objects only for the HIT rows.

This keeps the per-write cost O(chunk) — a FeatureBatch.concat per write
would be O(n) each, O(n²) for a streaming build — and avoids an
object-dtype id array (~60 B/row) at 100M+ rows.  Non-point schemas
(polygons, lines) ride the lean XZ indexes: their packed geometries
accumulate as chunk lists too, concatenated lazily, and the batch keeps
the running envelope of every row.
"""

from __future__ import annotations

import numpy as np

from .batch import FeatureBatch
from .feature_type import FeatureType

__all__ = ["LeanBatch", "ChunkView"]


class ChunkView:
    """Minimal column-view 'batch' for streaming paths that never need
    feature ids (stats observe, lean index appends, the planner's
    residual re-check): ``len``, ``column``, ``columns``, ``geom_xy``,
    ``take``, and the packed non-point geometries as ``geoms``."""

    def __init__(self, sft: FeatureType, columns: dict, n: int,
                 geoms=None):
        for name, col in columns.items():
            if len(col) != n:
                # the invariant FeatureBatch.__post_init__ enforces —
                # a ragged chunk would silently misalign the store
                raise ValueError(f"column {name!r} has length "
                                 f"{len(col)}, expected {n}")
        if geoms is not None and len(geoms) != n:
            raise ValueError(f"geometry column has length {len(geoms)},"
                             f" expected {n}")
        self.sft = sft
        self.columns = columns
        self._n = n
        #: packed non-point geometries riding the chunk (None for points)
        self.geoms = geoms

    def __len__(self) -> int:
        return self._n

    def column(self, name: str) -> np.ndarray:
        return self.columns[name]

    def geom_xy(self, name: str | None = None):
        name = name or self.sft.default_geom
        return self.columns[f"{name}_x"], self.columns[f"{name}_y"]

    def take(self, positions) -> "ChunkView":
        positions = np.asarray(positions)
        return ChunkView(self.sft,
                         {k: v[positions] for k, v in self.columns.items()},
                         len(positions),
                         geoms=(self.geoms.take(positions)
                                if self.geoms is not None else None))


class LeanBatch:
    """FeatureBatch-compatible chunked column store (module doc).

    Supports the planner surface: ``len``, ``column``, ``columns``,
    ``geom_xy``, ``geom_bbox``, ``geoms`` (packed non-point geometries),
    ``envelope`` (running), ``take`` (→ real FeatureBatch of the requested
    rows), ``take_view`` (→ id-free :class:`ChunkView`).  ``ids`` raises —
    any code path touching the full id array would silently materialize
    O(n) Python strings."""

    def __init__(self, sft: FeatureType):
        self.sft = sft
        self._chunks: dict[str, list] = {}
        self._flat: dict[str, np.ndarray] = {}
        self._n = 0
        #: packed (non-point) geometry chunks, lazily concatenated — empty
        #: for point schemas (their geometry is the x/y columns)
        self._geom_chunks: list = []
        self._geoms_flat = None
        #: running dataset envelope (xmin, ymin, xmax, ymax)
        self.envelope: tuple | None = None

    @property
    def geoms(self):
        """Packed non-point geometries (lazy chunk concat, kept flat — one
        host copy); None for point schemas."""
        if not self._geom_chunks:
            return None
        if self._geoms_flat is None:
            from ..geometry.packed import PackedGeometry
            flat = PackedGeometry.concat_many(self._geom_chunks)
            self._geoms_flat = flat
            self._geom_chunks = [flat]
        return self._geoms_flat

    def __len__(self) -> int:
        return self._n

    # -- ingest -----------------------------------------------------------
    def append_batch(self, fb) -> None:
        """Append one write's columns by reference (no copy)."""
        if self._chunks and set(fb.columns) != set(self._chunks):
            raise ValueError(
                "lean writes must provide the same columns every time "
                f"(have {sorted(self._chunks)}, got {sorted(fb.columns)})")
        for k, v in fb.columns.items():
            self._chunks.setdefault(k, []).append(np.asarray(v))
            self._flat.pop(k, None)
        self._n += len(fb)
        if fb.geoms is not None:
            self._geom_chunks.append(fb.geoms)
            self._geoms_flat = None
            bb = fb.geoms.bbox
            if len(bb):
                self._fold_env(float(bb[:, 0].min()), float(bb[:, 1].min()),
                               float(bb[:, 2].max()), float(bb[:, 3].max()))
            return
        gx, gy = fb.geom_xy(self.sft.geom_field)
        if len(gx):
            self._fold_env(float(np.min(gx)), float(np.min(gy)),
                           float(np.max(gx)), float(np.max(gy)))

    def _fold_env(self, lo_x, lo_y, hi_x, hi_y):
        if self.envelope is None:
            self.envelope = (lo_x, lo_y, hi_x, hi_y)
        else:
            e = self.envelope
            self.envelope = (min(e[0], lo_x), min(e[1], lo_y),
                             max(e[2], hi_x), max(e[3], hi_y))

    # -- column access ----------------------------------------------------
    def column(self, name: str) -> np.ndarray:
        """Finalized (flat) column; concatenates chunks once and keeps
        the single flat array (chunk refs dropped → one host copy)."""
        if name not in self._flat:
            parts = self._chunks[name]
            flat = parts[0] if len(parts) == 1 else np.concatenate(parts)
            self._flat[name] = flat
            self._chunks[name] = [flat]
        return self._flat[name]

    @property
    def columns(self) -> dict:
        return {k: self.column(k) for k in self._chunks}

    def geom_xy(self, name: str | None = None):
        name = name or self.sft.default_geom
        return self.column(f"{name}_x"), self.column(f"{name}_y")

    def geom_bbox(self, name: str | None = None) -> np.ndarray:
        """Per-feature bboxes — packed envelopes for non-point schemas,
        synthesized from x/y for points."""
        if self.geoms is not None:
            return self.geoms.bbox
        x, y = self.geom_xy(name)
        return np.stack([x, y, x, y], axis=1)

    @property
    def ids(self):
        raise AttributeError(
            "LeanBatch has implicit ids (row r ⇔ str(r)); materializing "
            "the full id array is O(n) strings — use take(rows) for "
            "result ids, or row_ids(rows)")

    def row_ids(self, rows: np.ndarray) -> np.ndarray:
        """Feature ids of the given rows (hits-sized)."""
        return np.array([str(int(r)) for r in rows], dtype=object)

    def _gather(self, positions, columns) -> dict:
        names = (self._chunks if columns is None
                 else [k for k in self._chunks if k in columns])
        return {k: self.column(k)[positions] for k in names}

    def take_view(self, positions: np.ndarray) -> ChunkView:
        """Hit-row gather WITHOUT feature-id materialization (the
        planner's residual re-check)."""
        positions = np.asarray(positions, dtype=np.int64)
        geoms = self.geoms
        return ChunkView(self.sft, self._gather(positions, None),
                         len(positions),
                         geoms=(geoms.take(positions)
                                if geoms is not None else None))

    def slice_view(self, lo: int, hi: int) -> ChunkView:
        """Zero-copy row-range view (the chunked stats recompute iterates
        these; no ids materialized)."""
        cols = {k: self.column(k)[lo:hi] for k in self._chunks}
        return ChunkView(self.sft, cols, hi - lo)

    def take(self, positions: np.ndarray, columns=None) -> FeatureBatch:
        """Materialize a real FeatureBatch for the requested rows (the
        only place full feature rows come into existence); ``columns``
        restricts which physical columns materialize (projection
        push-down)."""
        positions = np.asarray(positions, dtype=np.int64)
        cols = self._gather(positions, columns)
        # fixed-width string columns materialize as the object columns
        # every other write path stores
        cols = {k: v.astype(object) if v.dtype.kind == "U" else v
                for k, v in cols.items()}
        geoms = self.geoms
        return FeatureBatch(self.sft, cols, self.row_ids(positions),
                            geoms.take(positions) if geoms is not None
                            else None)
