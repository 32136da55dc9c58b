"""Sketch-fed cardinality estimation: the costing half of closing the
cost-based-planning loop.

The port's copy of the JAX package's ``planning/estimator.py``.  The
:class:`CardinalityEstimator` answers the ``StrategyDecider``'s
selectivity questions from per-generation sketches the lean indexes
maintain, instead of whole-store fractions: the ``StatsBasedEstimator`` /
``CostEvaluator`` split of the reference's planning stack, fed by
observed per-generation data.  Two tiers:

* **z3** — a z3 scan's candidate rows from the z3 cell-count partials;
* **attribute** — ``attr IN (values)`` rows from a count-min fold and
  ``lo <= attr <= hi`` rows from a histogram fold over the attribute
  index's keys (``LeanAttrIndex.sketch_scan``; the histogram only for
  numeric types with a ``{attr}_minmax`` stat).

``z3_cell_table(bits)`` gives an exact row count per (time-bin, z-prefix
cell) over every generation (sealed partials cached by the index, the
live run re-folded).  A query estimate runs the SAME covering-range
decomposition the scan will run (``plan_z3_query``), coarsens the range
bounds to cell granularity, and sums cell counts with two
``searchsorted`` probes per range — so the estimate is of the scan's
*candidate superset*.

The merged tables cache per **generation signature** —
``tuple((gen_id, rows) per generation)`` — so a warm repeat costs a few
numpy probes and no device work: appends grow the live run's row count
and compaction mints fresh gen_ids, each changing the signature.
"""

from __future__ import annotations

import math

import numpy as np

from ..curve.binnedtime import to_binned_time

__all__ = ["CardinalityEstimator"]

#: z-prefix bits per cell of the z3 estimation table, adaptive to the
#: data's time-bin span: as fine as the fold's cell-table budget allows
#: (``nb << bits <= _Z3_CELL_BUDGET``), never finer than the ceiling
#: (~6 bits/dim) or coarser than the floor
_Z3_CELL_BITS_MIN, _Z3_CELL_BITS_MAX = 10, 18
#: per-fold dense cell-table budget (int64 slots)
_Z3_CELL_BUDGET = 1 << 22
#: covering-range budget for the *estimation* decomposition: it must
#: out-resolve the cell table, or every range rounds up to whole cells
#: and a sliver box charges for its neighbours' mass
_EST_RANGES = 2048
#: count-min / histogram shape of the estimator's attribute folds
_ATTR_DEPTH, _ATTR_WIDTH, _ATTR_BINS = 4, 2048, 128
#: sketch-sized scan budget clamp: the floor keeps boundary-bin splits
#: meaningful, the ceiling is the lean index's per-window range cap
_MAX_RANGES_FLOOR, _MAX_RANGES_CEIL = 512, 1 << 14

_NUMERIC_HIST_TYPES = frozenset(
    {"int", "integer", "long", "float", "double"})


def _gen_signature(idx) -> tuple | None:
    """Cache key over an index's generation set: compaction mints new
    gen_ids and appends grow the live run's row count, so any change to
    the data changes the signature."""
    gens = getattr(idx, "generations", None)
    if gens is None:
        return None
    return tuple((int(g.gen_id), int(g.n)) for g in gens)


class CardinalityEstimator:
    """Per-schema-store selectivity oracle over the lean index's cached
    sketches.  Constructed lazily and cached on the schema store — one
    estimator, one merged table, shared by every query against the
    schema."""

    def __init__(self, store):
        self.store = store
        self._z3_cached = None    # (signature, keys, cumsum, idx, bits)
        self._attr_cached: dict = {}  # attr -> (sig, sketch, fold, idx)

    @staticmethod
    def _cell_bits(idx) -> int:
        """Finest cell resolution whose dense fold table fits the budget
        given the data's time-bin span.  Deterministic in the index's
        time extent, which only moves on writes — and writes change the
        generation signature, so a cached table never mixes
        resolutions."""
        t0 = np.int64(max(0, idx.t_min_ms or 0))
        t1 = np.int64(max(0, idx.t_max_ms or 0))
        b0, _ = to_binned_time(t0, idx.period)
        b1, _ = to_binned_time(t1, idx.period)
        nb = max(1, int(b1) - int(b0) + 1)
        bits = _Z3_CELL_BITS_MAX
        while bits > _Z3_CELL_BITS_MIN and (nb << bits) > _Z3_CELL_BUDGET:
            bits -= 1
        return bits

    def _z3_table(self):
        idx = self.store._indexes.get("z3")
        if idx is None or not hasattr(idx, "z3_cell_table"):
            return None
        sig = _gen_signature(idx)
        cached = self._z3_cached
        if cached is not None and cached[0] == sig:
            return cached
        bits = self._cell_bits(idx)
        # the dense table's flat index is already the sorted cell key
        # less ``b0 << bits``: the JAX package's dict → sorted keys
        # round trip, without the per-cell Python loop
        b0, table = idx.z3_cell_table(bits)
        nz = np.flatnonzero(table)
        keys = (b0 << bits) + nz
        cum = np.concatenate([np.zeros(1, np.int64),
                              np.cumsum(table[nz])])
        cached = (sig, keys, cum, idx, bits)
        self._z3_cached = cached
        return cached

    def z3_rows(self, boxes, intervals) -> int | None:
        """Estimated candidate rows of a z3 scan over ``boxes`` ×
        ``intervals`` (each ``(lo_ms, hi_ms)``, None = open end), or None
        when the sketch tier can't answer (index not built yet)."""
        table = self._z3_table()
        if table is None or not len(boxes):
            return None
        _, keys, cum, idx, bits = table
        if not len(keys):
            return 0
        from ..index.z3 import plan_z3_query
        cpb = 1 << bits
        shift = np.int64(63 - bits)
        total = 0
        for lo, hi in intervals:
            lo, hi = idx._clamp_time(lo, hi)
            if lo > hi:
                continue
            plan = plan_z3_query(boxes, int(lo), int(hi), idx.period,
                                 _EST_RANGES, sfc=idx.sfc)
            if not len(plan.rbin):
                continue
            clo = plan.rbin.astype(np.int64) * cpb + (plan.rzlo >> shift)
            chi = plan.rbin.astype(np.int64) * cpb + (plan.rzhi >> shift)
            # coarsening to cells can make adjacent ranges overlap: merge
            # before summing so no cell counts twice
            order = np.argsort(clo, kind="stable")
            clo, chi = clo[order], chi[order]
            keep_hi = np.maximum.accumulate(chi)
            starts = np.r_[True, clo[1:] > keep_hi[:-1] + 1]
            seg = np.cumsum(starts) - 1
            mlo = clo[starts]
            mhi = np.full(len(mlo), np.iinfo(np.int64).min)
            np.maximum.at(mhi, seg, chi)
            li = np.searchsorted(keys, mlo, "left")
            ri = np.searchsorted(keys, mhi, "right")
            total += int((cum[ri] - cum[li]).sum())
        return min(total, int(cum[-1]))

    # -- attribute tier -----------------------------------------------------
    def _attr_sketch(self, attr: str):
        idx = self.store._indexes.get(f"attr:{attr}")
        if idx is None or not hasattr(idx, "sketch_scan"):
            return None
        sig = _gen_signature(idx)
        cached = self._attr_cached.get(attr)
        if cached is not None and cached[0] == sig:
            return cached
        fold = self._attr_fold(attr, idx)
        sketch = idx.sketch_scan(fold)
        cached = (sig, sketch, fold, idx)
        self._attr_cached[attr] = cached
        return cached

    def _attr_fold(self, attr: str, idx):
        from ..stats.sketch import SketchFold
        bins, hlo, hhi = 0, 0.0, 1.0
        if getattr(idx, "attr_type", "string") in _NUMERIC_HIST_TYPES:
            mm = self.store.stats_map().get(f"{attr}_minmax")
            try:
                lo = float(mm.min)
                hi = float(mm.max)
            except (AttributeError, TypeError, ValueError):
                lo = hi = 0.0
            if hi > lo:
                bins, hlo, hhi = _ATTR_BINS, lo, hi
        return SketchFold(bins=bins, hlo=hlo, hhi=hhi,
                          depth=_ATTR_DEPTH, width=_ATTR_WIDTH)

    def attr_equals_rows(self, attr: str, values) -> int | None:
        """Estimated rows matching ``attr IN (values)`` from the merged
        count-min table; None when unanswerable."""
        cached = self._attr_sketch(attr)
        if cached is None:
            return None
        _, sketch, fold, idx = cached
        from ..stats.sketch import sketch_equals_count
        total = 0
        for v in values:
            est = sketch_equals_count(sketch, fold, v, idx.attr_type)
            if est is None:
                return None
            total += est
        return total

    def attr_range_rows(self, attr: str, lo, hi) -> int | None:
        """Estimated rows with ``lo <= attr <= hi`` (None bound = open)
        from the merged histogram; None when the fold carries no
        histogram (string attribute, no min/max stat yet)."""
        cached = self._attr_sketch(attr)
        if cached is None:
            return None
        _, sketch, fold, _ = cached
        from ..stats.sketch import sketch_range_count
        return sketch_range_count(sketch, fold, lo, hi)

    @staticmethod
    def size_max_ranges(est_rows: float) -> int:
        """Covering-range budget sized from estimated candidate rows:
        sparse queries keep a coarse cheap decomposition, dense ones earn
        a finer one (less gather over-scan).  Monotone, clamped and
        deterministic — a warm repeat gets the same budget."""
        sized = 16.0 * math.sqrt(max(0.0, float(est_rows)) + 1.0)
        return int(min(_MAX_RANGES_CEIL, max(_MAX_RANGES_FLOOR, sized)))
