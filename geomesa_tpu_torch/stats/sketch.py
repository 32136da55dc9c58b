"""Stat-sketch push-down for the lean tiered indexes.

The port's copy of the JAX package's ``stats/sketch.py``.  The reference
answers ``Stat`` specs server-side (StatsScan, iterators/StatsScan.scala:
125): each tablet folds its rows into mergeable sketches and ships only
the sketch.  On the lean store the same split falls out of the key
layout:

* the attribute index's key IS the order-preserving int64 lexicode of
  the value (index/attr_lean.py), so for numeric and date attributes a
  run's sorted ``(key, sec)`` columns decode straight back to exact
  values and timestamps — MinMax / Histogram / DescriptiveStats /
  Frequency / TopK / Enumeration (and Count) fold per run with no row
  access;
* the z3 index's key decodes to coarse (bin, cell) pairs — exactly
  Z3Histogram's domain (utils/stats/Z3Histogram.scala:34) — and Count
  over the whole extent is the live-row total.

This module holds the per-run mergeable partial (:class:`RunSketch`),
the fold configuration that is also its cache-spec key
(:class:`SketchFold`), the device fold over one run's columns
(:func:`device_fold_body`, torch), the stacked host-tier fold with
per-run attribution (:func:`fold_attr_runs`, numpy), the estimator's
probes (:func:`sketch_equals_count`, :func:`sketch_range_count`), the
spec classifier ``stats_process`` gates on (:func:`plan_pushdown`) and
the client-side fill of the user-facing stats
(:func:`fill_stats_from_partial`).

**Exactness.**  Counts, key min/max, histograms and count-min tables are
integers and equal the JAX package's; the float64 moment sums reduce in
another order than XLA's.  String keys are 8-byte prefix codes, so every
string-valued stat falls back to materialization.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .stat import (
    CountStat, DescriptiveStats, EnumerationStat, Frequency, Histogram,
    MinMax, SeqStat, TopK, Z3HistogramStat, _hash_col,
)

__all__ = ["SketchFold", "RunSketch", "PushPlan", "plan_pushdown",
           "decode_attr_keys", "decode_attr_key", "device_fold_body",
           "fold_attr_runs", "sketch_equals_count", "sketch_range_count",
           "fill_stats_from_partial", "flatten_stats", "EXACT_DECODE_TYPES"]

_I64_MIN = np.int64(np.iinfo(np.int64).min)
_I64_MAX = np.int64(np.iinfo(np.int64).max)
#: the attribute index's sentinel padding key (index/attr_lean.py)
_SENTINEL_KEY = _I64_MAX

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
class RunSketch:
    """One run's mergeable stat partial: moments, key-space min/max
    (order-preserving keys make ``min(keys)`` equal ``encode(min(values))``,
    decoded lazily), an optional fixed-bin histogram, an optional
    count-min table and an optional exact value→count map.  A monoid,
    like every sketch in stats/stat.py."""

    count: int = 0
    kmin: int | None = None     # encoded-key min over matched rows
    kmax: int | None = None
    vsum: float = 0.0
    vsumsq: float = 0.0
    hist: np.ndarray | None = None
    cms: np.ndarray | None = None
    values: dict | None = None

    def merge(self, other: "RunSketch") -> "RunSketch":
        out = RunSketch(self.count + other.count, self.kmin, self.kmax,
                        self.vsum + other.vsum, self.vsumsq + other.vsumsq)
        if other.kmin is not None:
            out.kmin = (other.kmin if out.kmin is None
                        else min(out.kmin, other.kmin))
            out.kmax = (other.kmax if out.kmax is None
                        else max(out.kmax, other.kmax))
        if self.hist is not None or other.hist is not None:
            a, b = self.hist, other.hist
            out.hist = np.array(a if b is None else b if a is None
                                else a + b, np.int64)
        if self.cms is not None or other.cms is not None:
            a, b = self.cms, other.cms
            out.cms = np.array(a if b is None else b if a is None
                               else a + b, np.int64)
        if self.values is not None or other.values is not None:
            out.values = dict(self.values or {})
            for v, n in (other.values or {}).items():
                out.values[v] = out.values.get(v, 0) + n
        return out

    def __add__(self, other):
        return self.merge(other)

    @property
    def nbytes(self) -> int:
        """Host bytes this partial retains (the cache byte ceiling)."""
        n = 64
        if self.hist is not None:
            n += self.hist.nbytes
        if self.cms is not None:
            n += self.cms.nbytes
        if self.values is not None:
            n += 48 * len(self.values)
        return n

    def to_json(self) -> dict:
        return {"count": self.count, "kmin": self.kmin, "kmax": self.kmax,
                "vsum": self.vsum, "vsumsq": self.vsumsq,
                "hist": None if self.hist is None else self.hist.tolist(),
                "cms": None if self.cms is None else self.cms.tolist(),
                "values": (None if self.values is None
                           else [[v, n] for v, n in self.values.items()])}

    @classmethod
    def from_json(cls, obj: dict) -> "RunSketch":
        return cls(
            int(obj["count"]),
            None if obj["kmin"] is None else int(obj["kmin"]),
            None if obj["kmax"] is None else int(obj["kmax"]),
            float(obj["vsum"]), float(obj["vsumsq"]),
            None if obj["hist"] is None
            else np.asarray(obj["hist"], np.int64),
            None if obj["cms"] is None
            else np.asarray(obj["cms"], np.int64),
            None if obj["values"] is None
            else {v: int(n) for v, n in obj["values"]})


# -- the device fold over one run's columns -------------------------------

def _decode_f64_t(k):
    """torch twin of :func:`decode_attr_keys` for float lexicodes: the
    bits are reinterpreted, never converted."""
    import torch
    bits = torch.where(k < 0, (-1 - k) ^ int(_I64_MIN), k)
    return bits.view(torch.float64)


def device_fold_body(k, s, slo: int, shi: int, hlo: float, hhi: float, *,
                     bins: int, depth: int, width: int, is_float: bool,
                     hist_kernel: bool = False):
    """One run's sketch fold over its (key, sec) columns on the device:
    masked moments (int64 key min/max — exact at any magnitude), a
    histogram matching ``Histogram.observe``'s outlier-clamped binning,
    and count-min rows hashed bit-identically to the host sketch
    (``stats/stat._hash_col``'s numeric path, through the int64
    splitmix64 of ``parallel/stats.py``).  Histogram and count-min rows
    count on ``parallel/stats._histogram``: the ``hist1d`` kernel when
    ``hist_kernel`` (the caller's exactness rule), else the int64
    scatter.  Returns ``(count, kmin, kmax, vsum, vsumsq, hist, cms)`` as
    tensors; ``hist``/``cms`` are empty when not requested.  An empty run
    folds to count 0 with kmin/kmax at their identities."""
    import torch

    from ..parallel.stats import (
        _as_int64, _canonical_int64, _histogram, _splitmix64, _umod,
    )
    dev = k.device
    mask = (k != int(_SENTINEL_KEY)) & (s >= int(slo)) & (s <= int(shi))
    vf = _decode_f64_t(k) if is_float else k.to(torch.float64)
    count = mask.sum()
    i64max = torch.full((1,), int(_I64_MAX), dtype=torch.int64, device=dev)
    i64min = torch.full((1,), int(_I64_MIN), dtype=torch.int64, device=dev)
    kmin = torch.cat([torch.where(mask, k, i64max), i64max]).min()
    kmax = torch.cat([torch.where(mask, k, i64min), i64min]).max()
    zero = torch.zeros_like(vf)
    vsum = torch.where(mask, vf, zero).sum()
    vsumsq = torch.where(mask, vf * vf, zero).sum()
    if bins:
        norm = bins / (hhi - hlo)
        # XLA's float→int32 conversion saturates and the JAX fold clips
        # after it; clamping in float64 first gives the same ids, and
        # NaN rows (which drop from the histogram only) go to bin 0
        q = torch.nan_to_num((vf - hlo) * norm, nan=0.0)
        b = torch.clamp(q, 0, bins - 1).to(torch.int32)
        mh = mask & ~torch.isnan(vf) if is_float else mask
        hist = _histogram(b, mh, int(bins), hist_kernel)
    else:
        hist = torch.zeros(0, dtype=torch.int64, device=dev)
    if depth:
        # exact ints never round-trip through float64; floats truncate
        # with non-finite values canonicalized as _hash_col does
        v64 = _canonical_int64(vf) if is_float else k
        rows = []
        for d in range(depth):
            h = _splitmix64(v64 ^ _as_int64((d + 1) * 0x9E3779B97F4A7C15))
            rows.append(_histogram(_umod(h, width).to(torch.int32), mask,
                                   int(width), hist_kernel))
        cms = torch.stack(rows)
    else:
        cms = torch.zeros((0, 0), dtype=torch.int64, device=dev)
    return count, kmin, kmax, vsum, vsumsq, hist, cms


# -- the host-tier fold: one stacked pass with per-run attribution --------

def fold_attr_runs(runs: list, fold: "SketchFold",
                   attr_type: str) -> list[RunSketch]:
    """Fold host-resident ``(key, sec)`` runs into one :class:`RunSketch`
    each in one stacked vectorized pass: every run's rows concatenate
    with an owning-run id and the sec mask runs once; then the matched
    rows collapse to their distinct (run, key) pairs with a row count
    each (one pass, as an index run is sorted by key), and every partial
    folds from those pairs — the value decode, histogram bins and
    count-min hashes run once per distinct key, not once per row.  The
    integers equal a per-row fold's; the float64 moment sums add
    ``count × value`` per distinct key, so they differ from a per-row
    sum in the last bits."""
    n_runs = len(runs)
    parts = [RunSketch(
        hist=np.zeros(fold.bins, np.int64) if fold.bins else None,
        cms=(np.zeros((fold.depth, fold.width), np.int64)
             if fold.depth else None),
        values={} if fold.want_values else None)
        for _ in range(n_runs)]
    if not n_runs:
        return parts
    ks = np.concatenate([np.asarray(k, np.int64) for k, _ in runs])
    ss = np.concatenate([np.asarray(s, np.int64) for _, s in runs])
    rid = np.repeat(np.arange(n_runs),
                    [len(k) for k, _ in runs]).astype(np.int64)
    mask = ((ks != _SENTINEL_KEY) & (ss >= np.int64(fold.slo))
            & (ss <= np.int64(fold.shi)))
    km, rm = ks[mask], rid[mask]
    if len(km) > 1 and not np.all((km[1:] >= km[:-1])
                                  | (rm[1:] != rm[:-1])):
        order = np.lexsort((km, rm))     # runs not sorted by key
        km, rm = km[order], rm[order]
    edge = np.r_[True, (km[1:] != km[:-1]) | (rm[1:] != rm[:-1])] \
        if len(km) else np.zeros(0, bool)
    starts = np.flatnonzero(edge)
    lens = np.diff(np.r_[starts, len(km)])
    uk, ur = km[starts], rm[starts]
    counts = np.bincount(ur, weights=lens, minlength=n_runs)
    kmin = np.full(n_runs, _I64_MAX)
    kmax = np.full(n_runs, _I64_MIN)
    np.minimum.at(kmin, ur, uk)
    np.maximum.at(kmax, ur, uk)
    is_float = attr_type.lower() in _FLOAT_TYPES
    vals = decode_attr_keys(uk, attr_type)
    vf = vals.astype(np.float64)
    with np.errstate(invalid="ignore"):
        vsum = np.bincount(ur, weights=vf * lens, minlength=n_runs)
        vsumsq = np.bincount(ur, weights=vf * vf * lens, minlength=n_runs)
    for i, p in enumerate(parts):
        p.count = int(counts[i])
        if p.count:
            p.kmin, p.kmax = int(kmin[i]), int(kmax[i])
        p.vsum, p.vsumsq = float(vsum[i]), float(vsumsq[i])

    def per_run(cells, rows, size: int) -> np.ndarray:
        """Row counts of ``(run, cell)`` codes, ``size`` cells a run."""
        return np.bincount(cells, weights=rows,
                           minlength=n_runs * size).astype(np.int64)

    if fold.bins:
        norm = fold.bins / (fold.hhi - fold.hlo)
        keep = ~np.isnan(vf) if is_float else slice(None)
        with np.errstate(invalid="ignore"):
            b = np.clip(((vf[keep] - fold.hlo) * norm).astype(np.int64),
                        0, fold.bins - 1)
        flat = per_run(ur[keep] * fold.bins + b, lens[keep], fold.bins)
        for i, p in enumerate(parts):
            p.hist = flat[i * fold.bins:(i + 1) * fold.bins]
    if fold.depth:
        col = vf if is_float else uk
        for d in range(fold.depth):
            h = (_hash_col(col, d + 1) % np.uint64(fold.width)).astype(np.int64)
            flat = per_run(ur * fold.width + h, lens, fold.width)
            for i, p in enumerate(parts):
                p.cms[d] = flat[i * fold.width:(i + 1) * fold.width]
    if fold.want_values:
        # a run's map lists its numbers in value order, then each NaN row
        # as an entry of its own (NaN equals nothing), as the JAX
        # package's per-row fold builds it
        nan = np.isnan(vf) if is_float else np.zeros(len(uk), bool)
        vl, rl, nl = vals.tolist(), ur.tolist(), lens.tolist()
        for j in np.lexsort((nan, ur)).tolist():
            out = parts[rl[j]].values
            if nan[j]:
                for _ in range(nl[j]):
                    out[float("nan")] = 1
            else:
                out[vl[j]] = out.get(vl[j], 0) + nl[j]
    return parts


# -- the estimator's probes (planning/estimator.py) -----------------------

def sketch_equals_count(sk: RunSketch, fold: "SketchFold", value,
                        attr_type: str) -> int | None:
    """Estimated rows with ``attr == value`` from a (merged) sketch: the
    count-min table's min-over-depth probe, hashed exactly as the fold
    hashed (``_hash_col`` over the decoded float for float types, over
    the encoded int64 key otherwise).  None when the sketch can't
    answer."""
    if sk.count == 0:
        return 0
    is_float = attr_type.lower() in _FLOAT_TYPES
    if sk.cms is None or not fold.depth or not fold.width:
        return None
    from ..index.attr_lean import encode_attr_value
    try:
        if is_float:
            col = np.array([float(value)], np.float64)
        else:
            col = np.array([int(encode_attr_value(value, attr_type))],
                           np.int64)
    except (TypeError, ValueError, OverflowError):
        return None
    est = None
    for d in range(fold.depth):
        h = int(_hash_col(col, d + 1)[0] % np.uint64(fold.width))
        row = int(sk.cms[d, h])
        est = row if est is None else min(est, row)
    return est


def sketch_range_count(sk: RunSketch, fold: "SketchFold", lo,
                       hi) -> int | None:
    """Estimated rows with ``lo <= attr <= hi`` (None bound = open) from a
    (merged) sketch's fixed-bin histogram, pro-rating the two partial
    edge bins.  None when the fold carried no histogram."""
    if sk.count == 0:
        return 0
    if sk.hist is None or not fold.bins:
        return None
    width = (fold.hhi - fold.hlo) / fold.bins
    if not width > 0:
        return None
    try:
        b_lo = -np.inf if lo is None else (float(lo) - fold.hlo) / width
        b_hi = np.inf if hi is None else (float(hi) - fold.hlo) / width
    except (TypeError, ValueError):
        return None
    if b_hi < b_lo:
        return 0
    # a bound past the histogram extent covers the whole edge bin — as at
    # fold time, where outliers clamp into the edge bins
    i0 = np.arange(fold.bins, dtype=np.float64)
    cover = np.clip(np.minimum(b_hi, i0 + 1.0) - np.maximum(b_lo, i0),
                    0.0, 1.0)
    return int(round(float((cover * sk.hist).sum())))


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
    merged :class:`RunSketch` (the client-side Reducer step)."""
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
