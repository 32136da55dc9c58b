"""Attribute index: equality/range/prefix queries on indexed attributes.

The port's copy of the JAX package's ``index/attribute.py``, the
default-profile attribute index.  It is host numpy in both packages: the
"table" is a host-side sorted column in its natural dtype (numpy sort
order equals the lexicoder order for numerics and strings), plus the
permutation — the analog of the reference's attribute index
(geomesa-index-api/.../index/attribute/, ``AttributeIndexKey.
typeRegistry``, AttributeIndexKey.scala:38).

**Secondary tier.**  The reference appends a secondary key — the date,
or the full Z3 key — after each lexicoded attribute value, so that
``attr = X AND dtg DURING …`` seeks a sub-range instead of post-filtering
(tiered-range assembly, GeoMesaFeatureIndex.getQueryStrategy,
api/GeoMesaFeatureIndex.scala:248-338).  Here the tier is a second sort
key: rows are ordered by ``(value, dtg)`` (date tier) or ``(value, bin,
z)`` (z3 tier), and equality/IN lookups refine each value run with extra
``searchsorted`` calls.  Tiers apply only to point lookups (equality /
IN); range and prefix scans span many value runs and rely on the
planner's residual filter.
"""

from __future__ import annotations

import numpy as np

__all__ = ["AttributeIndex"]


class AttributeIndex:
    """Sorted-column index over one attribute, optionally tiered.

    * **date tier** — rows sorted by ``(value, dtg)``; equality runs
      refine by a time window.
    * **z3 tier** — rows sorted by ``(value, bin, z)``; equality runs
      refine by a Z3 scan plan's covering ``(bin, zlo, zhi)`` ranges,
      narrowing by space AND time.
    """

    def __init__(self, attr: str, values: np.ndarray, pos: np.ndarray,
                 secondary: np.ndarray | None = None,
                 sec_bins: np.ndarray | None = None,
                 sec_z: np.ndarray | None = None):
        self.attr = attr
        self.values = values        # sorted (by value, then tier keys)
        self.pos = pos
        self.secondary = secondary  # date tier: int64 dtg, sorted per run
        self.sec_bins = sec_bins    # z3 tier: int32 time bin
        self.sec_z = sec_z          # z3 tier: int64 z, sorted within bin

    @staticmethod
    def _column(column) -> np.ndarray:
        col = np.asarray(column)
        return col.astype(str) if col.dtype == object else col

    @classmethod
    def build(cls, attr: str, column: np.ndarray,
              secondary: np.ndarray | None = None) -> "AttributeIndex":
        """Date-tiered (or untiered) build."""
        col = cls._column(column)
        if secondary is None:
            order = np.argsort(col, kind="stable")
            sec = None
        else:
            sec_col = np.asarray(secondary, dtype=np.int64)
            order = np.lexsort((sec_col, col))
            sec = sec_col[order]
        return cls(attr, col[order], order.astype(np.int64), sec)

    @classmethod
    def build_z3(cls, attr: str, column: np.ndarray, bins: np.ndarray,
                 z: np.ndarray) -> "AttributeIndex":
        """Z3-tiered build: ``bins``/``z`` are the features' Z3 key parts
        (host-computed, the same curve as the primary z3 index)."""
        col = cls._column(column)
        bins = np.asarray(bins, dtype=np.int32)
        z = np.asarray(z, dtype=np.int64)
        order = np.lexsort((z, bins, col))
        return cls(attr, col[order], order.astype(np.int64),
                   sec_bins=bins[order], sec_z=z[order])

    def __len__(self) -> int:
        return len(self.values)

    def _cast(self, v):
        return str(v) if self.values.dtype.kind in ("U", "S") else v

    def _refine_z3(self, lo: int, hi: int, z3_ranges) -> np.ndarray:
        """Positions of run ``[lo, hi)`` rows inside any covering
        ``(bin, zlo, zhi)`` range: per-range seeks over the run's (bin, z)
        sorted keys."""
        rbin, rzlo, rzhi = z3_ranges
        run_bins = self.sec_bins[lo:hi]
        run_z = self.sec_z[lo:hi]
        b0 = np.searchsorted(run_bins, rbin, side="left")
        b1 = np.searchsorted(run_bins, rbin, side="right")
        parts = []
        for i in range(len(rbin)):
            s, e = int(b0[i]), int(b1[i])
            if s == e:
                continue
            zs = lo + s + np.searchsorted(run_z[s:e], rzlo[i], side="left")
            ze = lo + s + np.searchsorted(run_z[s:e], rzhi[i], side="right")
            if ze > zs:
                parts.append(self.pos[zs:ze])
        if not parts:
            return np.empty(0, dtype=np.int64)
        # plan ranges are disjoint per bin, so no dedupe is needed
        return np.concatenate(parts)

    def _refine(self, lo: int, hi: int, sec_window) -> slice:
        """Narrow a value run ``[lo, hi)`` by the secondary window."""
        if sec_window is None or self.secondary is None or lo >= hi:
            return slice(lo, hi)
        s_lo, s_hi = sec_window
        run = self.secondary[lo:hi]
        i0 = (lo if s_lo is None
              else lo + int(np.searchsorted(run, s_lo, side="left")))
        i1 = (hi if s_hi is None
              else lo + int(np.searchsorted(run, s_hi, side="right")))
        return slice(i0, i1)

    def query_equals(self, value, sec_window=None,
                     z3_ranges=None) -> np.ndarray:
        """Positions where attr == value, tier-refined by an inclusive
        ``(lo, hi)`` dtg window (date tier) or a covering
        ``(rbin, rzlo, rzhi)`` plan (z3 tier)."""
        value = self._cast(value)
        lo = np.searchsorted(self.values, value, side="left")
        hi = np.searchsorted(self.values, value, side="right")
        if z3_ranges is not None and self.sec_z is not None:
            return np.sort(self._refine_z3(int(lo), int(hi), z3_ranges))
        return np.sort(self.pos[self._refine(lo, hi, sec_window)])

    def query_in(self, values, sec_window=None,
                 z3_ranges=None) -> np.ndarray:
        if not len(values):
            return np.empty(0, dtype=np.int64)
        return np.sort(np.unique(np.concatenate(
            [self.query_equals(v, sec_window, z3_ranges) for v in values])))

    def query_range(self, lo=None, hi=None, lo_inclusive=True,
                    hi_inclusive=True) -> np.ndarray:
        i0 = 0
        i1 = len(self.values)
        if lo is not None:
            i0 = np.searchsorted(self.values, self._cast(lo),
                                 side="left" if lo_inclusive else "right")
        if hi is not None:
            i1 = np.searchsorted(self.values, self._cast(hi),
                                 side="right" if hi_inclusive else "left")
        return np.sort(self.pos[i0:i1])

    def query_prefix(self, prefix: str) -> np.ndarray:
        """String prefix scan — serves LIKE 'abc%' (the reference's
        attribute-index LIKE optimization)."""
        if self.values.dtype.kind not in ("U", "S"):
            raise TypeError("prefix queries require a string attribute")
        lo = np.searchsorted(self.values, prefix, side="left")
        hi = np.searchsorted(self.values, prefix + "￿", side="right")
        return np.sort(self.pos[lo:hi])
