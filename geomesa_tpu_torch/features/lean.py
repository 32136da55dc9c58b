"""LeanBatch: chunked columnar storage for the store's lean profile.

The port's copy of the JAX package's ``features/lean.py`` for point
schemas: a schema's columns accumulate as CHUNK LISTS of numpy arrays
(one per write, concatenated lazily per column), feature ids are
IMPLICIT (the id of row ``r`` is ``str(r)`` — minted by append order,
never reused), and query results materialize real :class:`FeatureBatch`
objects only for the HIT rows.

This keeps the per-write cost O(chunk) — a FeatureBatch.concat per write
would be O(n) each, O(n²) for a streaming build — and avoids an
object-dtype id array (~60 B/row) at 100M+ rows.  Non-point lean schemas
(packed geometries) are not ported: the store refuses them before any
chunk reaches this module.
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
    ``take``."""

    #: point schemas only: no packed geometries ride a chunk
    geoms = None

    def __init__(self, sft: FeatureType, columns: dict, n: int):
        for name, col in columns.items():
            if len(col) != n:
                # the invariant FeatureBatch.__post_init__ enforces —
                # a ragged chunk would silently misalign the store
                raise ValueError(f"column {name!r} has length "
                                 f"{len(col)}, expected {n}")
        self.sft = sft
        self.columns = columns
        self._n = n

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
                         len(positions))


class LeanBatch:
    """FeatureBatch-compatible chunked column store (module doc).

    Supports the planner surface: ``len``, ``column``, ``columns``,
    ``geom_xy``, ``take`` (→ real FeatureBatch of the requested rows),
    ``take_view`` (→ id-free :class:`ChunkView`).  ``ids`` raises — any
    code path touching the full id array would silently materialize O(n)
    Python strings."""

    #: point schemas only (module doc)
    geoms = None

    def __init__(self, sft: FeatureType):
        self.sft = sft
        self._chunks: dict[str, list] = {}
        self._flat: dict[str, np.ndarray] = {}
        self._n = 0

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
        return ChunkView(self.sft, self._gather(positions, None),
                         len(positions))

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
        return FeatureBatch(self.sft, cols, self.row_ids(positions))
