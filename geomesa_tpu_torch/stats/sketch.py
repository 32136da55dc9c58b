"""Stat-sketch push-down planning for the lean tiered index.

The port's copy of the planning half of the JAX package's
``stats/sketch.py``.  The reference answers ``Stat`` specs server-side
(StatsScan, iterators/StatsScan.scala:125): each tablet folds its rows
into mergeable sketches and ships only the sketch.  On the lean store
the same split falls out of the key layout: the z3 index's key decodes
to coarse (bin, cell) pairs — exactly Z3Histogram's domain
(utils/stats/Z3Histogram.scala:34) — and Count over the whole extent is
the live-row total.

This module holds the spec classifier (:func:`plan_pushdown`) that
``stats_process`` gates on, the fold configuration it emits for
attribute sub-stats (:class:`SketchFold`), and the client-side fill of
attribute stats from a fold's partial (:func:`fill_stats_from_partial`).
The attribute folds themselves (the JAX package's ``RunSketch``, device
and host folds over the lean attribute indexes) are not ported: the port
has no lean attribute index, so a store hands :func:`plan_pushdown` no
indexed attributes and every attribute sub-stat declines to the
materializing path, as the JAX classifier does for such a schema.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .stat import (
    CountStat, DescriptiveStats, EnumerationStat, Frequency, Histogram,
    MinMax, SeqStat, TopK, Z3HistogramStat,
)

__all__ = ["SketchFold", "PushPlan", "plan_pushdown", "decode_attr_keys",
           "decode_attr_key", "fill_stats_from_partial", "flatten_stats",
           "EXACT_DECODE_TYPES"]

_I64_MIN = np.int64(np.iinfo(np.int64).min)
_I64_MAX = np.int64(np.iinfo(np.int64).max)

#: attribute types whose int64 lexicode decodes EXACTLY back to the value
#: (strings are prefix codes — never pushable)
EXACT_DECODE_TYPES = frozenset(
    {"int", "integer", "long", "date", "float", "double"})
_FLOAT_TYPES = frozenset({"float", "double"})


def decode_attr_keys(keys: np.ndarray, attr_type: str) -> np.ndarray:
    """Inverse of the lean attribute lexicode for the exactly-decodable
    types (int64 for ints and dates, float64 for floats)."""
    k = np.asarray(keys, np.int64)
    if attr_type.lower() in _FLOAT_TYPES:
        bits = np.where(k < 0, (np.int64(-1) - k) ^ _I64_MIN, k)
        return bits.astype(np.int64).view(np.float64)
    return k


def decode_attr_key(key, attr_type: str):
    """Scalar twin of :func:`decode_attr_keys` (python int / float)."""
    v = decode_attr_keys(np.array([key], np.int64), attr_type)[0]
    return float(v) if attr_type.lower() in _FLOAT_TYPES else int(v)


@dataclass(frozen=True)
class SketchFold:
    """Configuration of one per-run sketch fold over an attribute index —
    also the partial-cache spec key of that fold."""

    slo: int = int(_I64_MIN)    # inclusive sec (dtg-ms) window
    shi: int = int(_I64_MAX)
    bins: int = 0               # histogram bins (0 = no histogram)
    hlo: float = 0.0
    hhi: float = 1.0
    depth: int = 0              # count-min depth (0 = no sketch)
    width: int = 0
    want_values: bool = False   # exact value→count fold (TopK/Enum)


@dataclass
class PushPlan:
    """One executable push-down: per-attribute folds (with the stats they
    serve), whole-extent Z3Histograms, the Count stats, and which source
    supplies the count ('attr:<name>' rides a fold; 'rows' is the
    live-row total for whole-extent windows)."""

    attr_groups: dict = field(default_factory=dict)
    z3hists: list = field(default_factory=list)
    counts: list = field(default_factory=list)
    count_source: str = "rows"


def plan_pushdown(stats: list, attr_types: dict, lean_kind: str,
                  geom_field: str, dtg_field: str | None,
                  slo: int, shi: int, t_open: bool,
                  z3_period=None) -> PushPlan | None:
    """Classify a parsed spec list into an executable push-down plan, or
    ``None`` when ANY sub-stat needs row materialization.

    ``attr_types`` maps lean-INDEXED attribute names to their schema
    types; only exactly-decodable types push.  ``t_open`` says the window
    covers the whole time extent — required by Z3Histogram
    (cell-granular time) and by the row-count source; attribute folds
    filter ``sec`` exactly for ANY window."""
    groups: dict[str, dict] = {}
    plan = PushPlan()

    def _grp(attr):
        return groups.setdefault(attr, {
            "hist": None, "freq": None, "want_values": False,
            "stats": []})

    for s in stats:
        if isinstance(s, CountStat):
            plan.counts.append(s)
            continue
        attr = getattr(s, "attr", None)
        if isinstance(s, Z3HistogramStat):
            from ..curve.binnedtime import TimePeriod
            if (lean_kind == "z3" and t_open
                    and s.geom == geom_field and s.dtg == dtg_field
                    and z3_period is not None
                    and z3_period == TimePeriod.parse(s.period)):
                plan.z3hists.append(s)
                continue
            return None
        if attr not in attr_types \
                or attr_types[attr].lower() not in EXACT_DECODE_TYPES:
            return None
        g = _grp(attr)
        if isinstance(s, (MinMax, DescriptiveStats)):
            pass
        elif isinstance(s, Histogram):
            cfg = (s.bins, s.lo, s.hi)
            if g["hist"] is not None and g["hist"] != cfg:
                return None   # two binnings would need two folds
            g["hist"] = cfg
        elif isinstance(s, Frequency):
            cfg = (s.depth, s.width)
            if g["freq"] is not None and g["freq"] != cfg:
                return None
            g["freq"] = cfg
        elif isinstance(s, (TopK, EnumerationStat)):
            g["want_values"] = True
        else:
            return None       # GroupBy / string stats / unknown kinds
        g["stats"].append(s)

    if plan.counts and not groups:
        if not t_open:
            # a selective time window needs the exact sec filter of an
            # attribute fold — ride any indexed numeric attribute
            ride = next((a for a, t in attr_types.items()
                         if t.lower() in EXACT_DECODE_TYPES), None)
            if ride is None:
                return None
            _grp(ride)
    if not groups and not plan.z3hists and not plan.counts:
        return None
    for attr, g in groups.items():
        hist = g["hist"] or (0, 0.0, 1.0)
        freq = g["freq"] or (0, 0)
        plan.attr_groups[attr] = (SketchFold(
            slo=int(slo), shi=int(shi),
            bins=int(hist[0]), hlo=float(hist[1]), hhi=float(hist[2]),
            depth=int(freq[0]), width=int(freq[1]),
            want_values=bool(g["want_values"])), g["stats"])
    if plan.attr_groups:
        plan.count_source = f"attr:{next(iter(plan.attr_groups))}"
    return plan


def fill_stats_from_partial(stats: list, part, attr_type: str) -> None:
    """Populate the user-facing stats an attribute fold serves from its
    merged partial (the client-side Reducer step): ``part`` carries the
    JAX package's ``RunSketch`` fields (count, kmin, kmax, vsum, vsumsq,
    hist, cms, values)."""
    is_float = attr_type.lower() in _FLOAT_TYPES
    vmin = (None if part.kmin is None
            else decode_attr_key(part.kmin, attr_type))
    vmax = (None if part.kmax is None
            else decode_attr_key(part.kmax, attr_type))
    for s in stats:
        if isinstance(s, MinMax):
            s.min, s.max = vmin, vmax
        elif isinstance(s, DescriptiveStats):
            s.n = part.count
            if part.count:
                s.mean = part.vsum / part.count
                s.m2 = max(part.vsumsq - part.count * s.mean * s.mean,
                           0.0)
                s.min = float(vmin)
                s.max = float(vmax)
        elif isinstance(s, Histogram):
            if part.hist is not None:
                s.counts = np.asarray(part.hist, np.int64)
        elif isinstance(s, Frequency):
            if part.cms is not None:
                s.table = np.asarray(part.cms, np.int64)
        elif isinstance(s, EnumerationStat):
            s.counts = dict(part.values or {})
        elif isinstance(s, TopK):
            # the fold is an EXACT value→count map, so feeding it through
            # observe_counts yields a top-k at least as tight as the
            # space-saving sketch's bounded-error contract
            vals = part.values or {}
            if vals:
                uv = np.array(list(vals.keys()),
                              dtype=np.float64 if is_float else np.int64)
                s.observe_counts(uv, np.array(list(vals.values()),
                                              np.int64))


def flatten_stats(stat) -> list:
    """A spec's sub-stats as a flat list (SeqStat or single)."""
    return list(stat.stats) if isinstance(stat, SeqStat) else [stat]
