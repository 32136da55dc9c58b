"""Mergeable summary statistics over feature columns.

Reference surface: geomesa-utils/.../stats/ — ``Stat`` trait (observe,
``+``/``+=`` merge, isEquivalent, toJson at Stat.scala:31-90), the sketch
implementations, and the ``StatParser`` DSL.  The vendored clearspring
sketches (CountMinSketch / StreamSummary) are re-expressed directly:
Frequency is a numpy count-min table, TopK a space-saving summary.

Every stat is a monoid: ``observe(column)`` folds a batch in, ``a + b``
merges two partials (shard-local → global), ``to_json``/``stat_from_json``
round-trips for the metadata catalog.
"""

from __future__ import annotations

import json
import math
import re
import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

from ..curve.binnedtime import TimePeriod, to_binned_time
from ..curve.sfc import z3_sfc

__all__ = [
    "Stat", "CountStat", "MinMax", "Histogram", "Z3HistogramStat",
    "Frequency", "TopK", "EnumerationStat", "GroupBy", "DescriptiveStats",
    "SeqStat", "parse_stat", "stat_from_json",
]


class Stat:
    """Base: a mergeable, serializable summary over one or more columns."""

    kind: str = "stat"

    def observe(self, batch) -> None:
        """Fold a FeatureBatch (or dict of columns) into this stat."""
        raise NotImplementedError

    def unobserve(self, batch) -> None:
        """Remove a batch (only supported by invertible stats)."""
        raise NotImplementedError(f"{type(self).__name__} is not invertible")

    def merge(self, other: "Stat") -> "Stat":
        raise NotImplementedError

    def __add__(self, other: "Stat") -> "Stat":
        return self.merge(other)

    @property
    def is_empty(self) -> bool:
        raise NotImplementedError

    def to_json(self) -> dict:
        raise NotImplementedError

    #: dataclass fields that configure a stat (vs accumulated state)
    _CONFIG_FIELDS = frozenset({
        "attr", "geom", "dtg", "period", "bits", "bins", "lo", "hi", "k",
        "spec", "width", "depth"})

    def fresh_copy(self) -> "Stat":
        """A new, empty stat with the same configuration — used to
        recompute sketches over row subsets (e.g. visibility-filtered)."""
        import dataclasses
        kwargs = {f.name: getattr(self, f.name)
                  for f in dataclasses.fields(self)
                  if f.name in self._CONFIG_FIELDS}
        return type(self)(**kwargs)


def _col(batch, name):
    if hasattr(batch, "column"):
        return batch.column(name)
    return np.asarray(batch[name])


@dataclass
class CountStat(Stat):
    kind = "count"
    count: int = 0

    def observe(self, batch):
        self.count += len(batch)

    def unobserve(self, batch):
        self.count -= len(batch)

    def merge(self, other):
        return CountStat(self.count + other.count)

    @property
    def is_empty(self):
        return self.count == 0

    def to_json(self):
        return {"kind": self.kind, "count": self.count}


@dataclass
class MinMax(Stat):
    kind = "minmax"
    attr: str = ""
    min: object = None
    max: object = None

    def observe(self, batch):
        col = _col(batch, self.attr)
        if len(col) == 0:
            return
        lo, hi = col.min(), col.max()
        self.min = lo if self.min is None else min(self.min, lo)
        self.max = hi if self.max is None else max(self.max, hi)

    def merge(self, other):
        out = MinMax(self.attr, self.min, self.max)
        if other.min is not None:
            out.min = other.min if out.min is None else min(out.min, other.min)
            out.max = other.max if out.max is None else max(out.max, other.max)
        return out

    @property
    def is_empty(self):
        return self.min is None

    @property
    def bounds(self):
        return (self.min, self.max)

    def to_json(self):
        as_py = lambda v: v.item() if hasattr(v, "item") else v
        return {"kind": self.kind, "attr": self.attr,
                "min": as_py(self.min), "max": as_py(self.max)}


@dataclass
class BBoxStat(Stat):
    """Data envelope of a geometry attribute — the planner's spatial
    selectivity DENOMINATOR: a query box is fractioned against the
    data's extent, not the whole world (reference: MinMax[Geometry]
    feeding StatsBasedEstimator's spatial estimates)."""

    kind = "bbox"
    attr: str = ""
    xmin: float | None = None
    ymin: float | None = None
    xmax: float | None = None
    ymax: float | None = None

    def observe(self, batch):
        try:
            x = _col(batch, f"{self.attr}_x")
            y = _col(batch, f"{self.attr}_y")
        except (KeyError, AttributeError):
            try:   # non-point schemas: per-row envelopes (n, 4)
                bb = np.asarray(_col(batch, f"{self.attr}_bbox"))
                if bb.ndim != 2 or not len(bb):
                    return
                self._fold(bb[:, 0].min(), bb[:, 1].min(),
                           bb[:, 2].max(), bb[:, 3].max())
                return
            except (KeyError, AttributeError):
                return
        if len(x) == 0:
            return
        self._fold(x.min(), y.min(), x.max(), y.max())

    def _fold(self, x0, y0, x1, y1):
        if self.xmin is None:
            self.xmin, self.ymin = float(x0), float(y0)
            self.xmax, self.ymax = float(x1), float(y1)
        else:
            self.xmin = min(self.xmin, float(x0))
            self.ymin = min(self.ymin, float(y0))
            self.xmax = max(self.xmax, float(x1))
            self.ymax = max(self.ymax, float(y1))

    def merge(self, other):
        out = BBoxStat(self.attr, self.xmin, self.ymin,
                       self.xmax, self.ymax)
        if other.xmin is not None:
            out._fold(other.xmin, other.ymin, other.xmax, other.ymax)
        return out

    @property
    def is_empty(self):
        return self.xmin is None

    @property
    def bounds(self):
        return (self.xmin, self.ymin, self.xmax, self.ymax)

    def to_json(self):
        return {"kind": self.kind, "attr": self.attr,
                "xmin": self.xmin, "ymin": self.ymin,
                "xmax": self.xmax, "ymax": self.ymax}


@dataclass
class Histogram(Stat):
    """Fixed-bin numeric histogram (the planner's selectivity source —
    reference: utils/stats/Histogram with binned Bounds)."""

    kind = "histogram"
    attr: str = ""
    bins: int = 0
    lo: float = 0.0
    hi: float = 1.0
    counts: np.ndarray | None = None

    def __post_init__(self):
        if self.counts is None:
            self.counts = np.zeros(self.bins, dtype=np.int64)

    def observe(self, batch):
        col = np.asarray(_col(batch, self.attr), dtype=np.float64)
        c, _ = np.histogram(col, bins=self.bins, range=(self.lo, self.hi))
        # clamp outliers into edge bins, as the reference does
        below = np.count_nonzero(col < self.lo)
        above = np.count_nonzero(col > self.hi)
        self.counts += c
        if self.bins:
            self.counts[0] += below
            self.counts[-1] += above

    def merge(self, other):
        if (self.bins, self.lo, self.hi) != (other.bins, other.lo, other.hi):
            raise ValueError("cannot merge histograms with different binning")
        return Histogram(self.attr, self.bins, self.lo, self.hi,
                         self.counts + other.counts)

    @property
    def is_empty(self):
        return int(self.counts.sum()) == 0

    @property
    def total(self) -> int:
        return int(self.counts.sum())

    def estimate_range(self, lo: float, hi: float) -> int:
        """Estimated count in [lo, hi] assuming uniform within bins."""
        if self.total == 0 or hi < self.lo or lo > self.hi:
            return 0
        width = (self.hi - self.lo) / self.bins
        est = 0.0
        for b in range(self.bins):
            b_lo = self.lo + b * width
            b_hi = b_lo + width
            overlap = max(0.0, min(hi, b_hi) - max(lo, b_lo))
            if overlap > 0 and width > 0:
                est += self.counts[b] * (overlap / width)
        return int(round(est))

    def to_json(self):
        return {"kind": self.kind, "attr": self.attr, "bins": self.bins,
                "lo": self.lo, "hi": self.hi, "counts": self.counts.tolist()}


@dataclass
class Z3HistogramStat(Stat):
    """Histogram over coarse Z3 cells — spatio-temporal selectivity
    (reference: utils/stats/Z3Histogram.scala:34)."""

    kind = "z3histogram"
    geom: str = "geom"
    dtg: str = "dtg"
    period: str = "week"
    bits: int = 10                     # top bits of z kept
    counts: dict = field(default_factory=dict)  # (bin, cell) -> count

    def observe(self, batch):
        x, y = batch.geom_xy(self.geom)
        t = _col(batch, self.dtg)
        period = TimePeriod.parse(self.period)
        bins, offs = to_binned_time(t, period)
        sfc = z3_sfc(period)
        z = sfc.index(torch.from_numpy(np.asarray(x, dtype=np.float64)),
                      torch.from_numpy(np.asarray(y, dtype=np.float64)),
                      torch.from_numpy(offs.astype(np.float64))).numpy()
        cells = z >> (63 - self.bits)
        keys = np.stack([bins, cells], axis=1)
        uniq, cnt = np.unique(keys, axis=0, return_counts=True)
        for (b, c), n in zip(uniq, cnt):
            k = (int(b), int(c))
            self.counts[k] = self.counts.get(k, 0) + int(n)

    def merge(self, other):
        out = Z3HistogramStat(self.geom, self.dtg, self.period, self.bits,
                              dict(self.counts))
        for k, v in other.counts.items():
            out.counts[k] = out.counts.get(k, 0) + v
        return out

    @property
    def is_empty(self):
        return not self.counts

    def to_json(self):
        return {"kind": self.kind, "geom": self.geom, "dtg": self.dtg,
                "period": self.period, "bits": self.bits,
                "counts": [[k[0], k[1], v] for k, v in sorted(self.counts.items())]}


def _string_digest(col: np.ndarray) -> np.ndarray:
    """Seed-INDEPENDENT 64-bit digest of a string column's UTF-8 bytes
    (two crc32 lanes).  Computed once per column; every per-depth sketch
    hash then derives via the seeded splitmix finalize — which is what
    lets the DEVICE count-min sketch serve string columns bit-identically:
    the digest column ships to the device as plain
    int64 and the device's numeric hash path takes over unchanged.

    The digest depends on ``str(v)`` alone, so it is computed once per
    distinct string (a column of a few categories costs one dict lookup
    a row, not two crc32 passes)."""
    memo: dict = {}

    def digest(v):
        s = str(v)
        d = memo.get(s)
        if d is None:
            b = s.encode()
            d = memo[s] = zlib.crc32(b) | (zlib.crc32(b, 0x9E3779B9) << 32)
        return d

    return np.fromiter(map(digest, col), dtype=np.uint64, count=len(col))


def _hash_col(col: np.ndarray, seed: int) -> np.ndarray:
    """Stable vectorized 64-bit hash of a column (numeric or object)."""
    if col.dtype == object:
        # digest once, then the SAME seeded path as numerics — one
        # Python-loop pass per column instead of one per sketch depth,
        # and exactly what the device sketch computes from the digest
        out = _string_digest(col)
        out ^= np.uint64(seed * 0x9E3779B97F4A7C15 & 0xFFFFFFFFFFFFFFFF)
    else:
        arr = col
        if np.issubdtype(arr.dtype, np.floating):
            # canonicalize non-finite / out-of-range floats BEFORE the
            # int64 cast: the raw C cast is platform-dependent (x86
            # gives INT64_MIN, aarch64 gives 0 / INT64_MAX) and the
            # device sketch must hash identically everywhere
            lo = float(np.iinfo(np.int64).min)
            ok = np.isfinite(arr) & (arr >= lo) & (arr < 2.0 ** 63)
            with np.errstate(invalid="ignore"):
                arr = np.where(ok, arr, lo)
        out = arr.astype(np.int64).view(np.uint64).copy()
        out ^= np.uint64(seed * 0x9E3779B97F4A7C15 & 0xFFFFFFFFFFFFFFFF)
    # splitmix64 finalize
    out = (out ^ (out >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    out = (out ^ (out >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return out ^ (out >> np.uint64(31))


@dataclass
class Frequency(Stat):
    """Count-min sketch: approximate per-value frequencies (reference:
    utils/stats/Frequency + vendored clearspring CountMinSketch)."""

    kind = "frequency"
    attr: str = ""
    depth: int = 4
    width: int = 1024
    table: np.ndarray | None = None

    def __post_init__(self):
        if self.table is None:
            self.table = np.zeros((self.depth, self.width), dtype=np.int64)

    def observe(self, batch):
        col = _col(batch, self.attr)
        for d in range(self.depth):
            h = _hash_col(col, d + 1) % np.uint64(self.width)
            np.add.at(self.table[d], h.astype(np.int64), 1)

    def count(self, value) -> int:
        col = np.asarray([value], dtype=object if isinstance(value, str) else None)
        est = None
        for d in range(self.depth):
            h = int(_hash_col(col, d + 1)[0] % np.uint64(self.width))
            c = int(self.table[d, h])
            est = c if est is None else min(est, c)
        return est

    def merge(self, other):
        if (self.depth, self.width) != (other.depth, other.width):
            raise ValueError("cannot merge frequency sketches of different shape")
        return Frequency(self.attr, self.depth, self.width,
                         self.table + other.table)

    @property
    def is_empty(self):
        return int(self.table.sum()) == 0

    def to_json(self):
        return {"kind": self.kind, "attr": self.attr, "depth": self.depth,
                "width": self.width, "table": self.table.tolist()}


@dataclass
class TopK(Stat):
    """Space-saving top-k (reference: utils/stats/TopK + StreamSummary)."""

    kind = "topk"
    attr: str = ""
    k: int = 10
    counters: dict = field(default_factory=dict)

    @property
    def _capacity(self) -> int:
        return self.k * 10

    def observe(self, batch):
        col = _col(batch, self.attr)
        uniq, cnt = np.unique(col.astype(str) if col.dtype == object else col,
                              return_counts=True)
        self.observe_counts(uniq, cnt)

    def observe_counts(self, uniq, cnt) -> None:
        """Fold pre-aggregated (values, counts) — lets the write path
        compute ONE unique per column for every sketch that needs it
        (the facade ingest profile showed duplicate unique/astype
        passes dominating host time)."""
        for v, n in zip(uniq.tolist(), cnt.tolist()):
            if v in self.counters:
                self.counters[v] += n
            elif len(self.counters) < self._capacity:
                self.counters[v] = n
            else:
                # space-saving: replace the min counter
                mv = min(self.counters, key=self.counters.get)
                self.counters[v] = self.counters.pop(mv) + n

    def topk(self, n: int | None = None):
        n = n or self.k
        return sorted(self.counters.items(), key=lambda kv: -kv[1])[:n]

    def merge(self, other):
        out = TopK(self.attr, self.k, dict(self.counters))
        for v, n in other.counters.items():
            out.counters[v] = out.counters.get(v, 0) + n
        if len(out.counters) > out._capacity:
            out.counters = dict(sorted(out.counters.items(),
                                       key=lambda kv: -kv[1])[:out._capacity])
        return out

    @property
    def is_empty(self):
        return not self.counters

    def to_json(self):
        return {"kind": self.kind, "attr": self.attr, "k": self.k,
                "counters": self.counters}


@dataclass
class EnumerationStat(Stat):
    """Exact value → count map (reference: utils/stats/EnumerationStat)."""

    kind = "enumeration"
    attr: str = ""
    counts: dict = field(default_factory=dict)

    def observe(self, batch):
        col = _col(batch, self.attr)
        uniq, cnt = np.unique(col.astype(str) if col.dtype == object else col,
                              return_counts=True)
        self.observe_counts(uniq, cnt)

    def observe_counts(self, uniq, cnt) -> None:
        """Fold pre-aggregated (values, counts) — see TopK."""
        for v, n in zip(uniq.tolist(), cnt.tolist()):
            self.counts[v] = self.counts.get(v, 0) + n

    def merge(self, other):
        out = EnumerationStat(self.attr, dict(self.counts))
        for v, n in other.counts.items():
            out.counts[v] = out.counts.get(v, 0) + n
        return out

    @property
    def is_empty(self):
        return not self.counts

    def to_json(self):
        return {"kind": self.kind, "attr": self.attr, "counts": self.counts}


@dataclass
class DescriptiveStats(Stat):
    """Streaming mean/variance/min/max (reference: utils/stats/
    DescriptiveStats, Welford-mergeable)."""

    kind = "descriptive"
    attr: str = ""
    n: int = 0
    mean: float = 0.0
    m2: float = 0.0
    min: float = math.inf
    max: float = -math.inf

    def observe(self, batch):
        col = np.asarray(_col(batch, self.attr), dtype=np.float64)
        if len(col) == 0:
            return
        other = DescriptiveStats(
            self.attr, len(col), float(col.mean()),
            float(((col - col.mean()) ** 2).sum()),
            float(col.min()), float(col.max()))
        merged = self.merge(other)
        self.__dict__.update(merged.__dict__)

    def merge(self, other):
        if other.n == 0:
            return DescriptiveStats(**dict(self.__dict__))
        if self.n == 0:
            return DescriptiveStats(**dict(other.__dict__))
        n = self.n + other.n
        delta = other.mean - self.mean
        mean = self.mean + delta * other.n / n
        m2 = self.m2 + other.m2 + delta * delta * self.n * other.n / n
        return DescriptiveStats(self.attr, n, mean, m2,
                                min(self.min, other.min),
                                max(self.max, other.max))

    @property
    def variance(self) -> float:
        return self.m2 / (self.n - 1) if self.n > 1 else 0.0

    @property
    def stddev(self) -> float:
        return math.sqrt(self.variance)

    @property
    def is_empty(self):
        return self.n == 0

    def to_json(self):
        return {"kind": self.kind, "attr": self.attr, "n": self.n,
                "mean": self.mean, "m2": self.m2, "min": self.min,
                "max": self.max}


@dataclass
class GroupBy(Stat):
    """Group a sub-stat by the values of an attribute (reference:
    utils/stats/GroupBy)."""

    kind = "groupby"
    attr: str = ""
    spec: str = ""                     # sub-stat DSL, e.g. "Count()"
    groups: dict = field(default_factory=dict)

    def observe(self, batch):
        col = _col(batch, self.attr)
        keys = col.astype(str) if col.dtype == object else col
        for v in np.unique(keys).tolist():
            sel = np.flatnonzero(keys == v)
            sub = self.groups.get(v)
            if sub is None:
                sub = parse_stat(self.spec)
                self.groups[v] = sub
            sub.observe(batch.take(sel) if hasattr(batch, "take")
                        else {k: np.asarray(c)[sel] for k, c in batch.items()})

    def merge(self, other):
        out = GroupBy(self.attr, self.spec, dict(self.groups))
        for v, sub in other.groups.items():
            out.groups[v] = sub if v not in out.groups else out.groups[v] + sub
        return out

    @property
    def is_empty(self):
        return not self.groups

    def to_json(self):
        return {"kind": self.kind, "attr": self.attr, "spec": self.spec,
                "groups": {str(k): v.to_json() for k, v in self.groups.items()}}


@dataclass
class SeqStat(Stat):
    """A sequence of stats observed together (the DSL's ';' composition)."""

    kind = "seq"
    stats: list = field(default_factory=list)

    def fresh_copy(self) -> "Stat":
        return SeqStat([s.fresh_copy() for s in self.stats])

    def observe(self, batch):
        for s in self.stats:
            s.observe(batch)

    def merge(self, other):
        return SeqStat([a + b for a, b in zip(self.stats, other.stats)])

    @property
    def is_empty(self):
        return all(s.is_empty for s in self.stats)

    def to_json(self):
        return {"kind": self.kind, "stats": [s.to_json() for s in self.stats]}


# ---------------------------------------------------------------------------
# DSL parser: "Count();MinMax(attr);Histogram(attr,20,0,100);TopK(attr)"
# (reference: utils/stats/Stat.scala apply + StatParser)
# ---------------------------------------------------------------------------

_CALL_RE = re.compile(r"^\s*(\w+)\s*\((.*)\)\s*$", re.DOTALL)


def _parse_one(spec: str) -> Stat:
    m = _CALL_RE.match(spec)
    if not m:
        raise ValueError(f"invalid stat spec: {spec!r}")
    name, arg_str = m.group(1).lower(), m.group(2)
    if name == "groupby":
        # args: attribute, then a nested stat spec (may contain parens/commas)
        attr, _, sub = arg_str.partition(",")
        return GroupBy(attr.strip(), sub.strip())
    args = [a.strip().strip("'\"") for a in arg_str.split(",")] if arg_str.strip() else []
    if name == "count":
        return CountStat()
    if name == "minmax":
        return MinMax(args[0])
    if name == "histogram":
        return Histogram(args[0], int(args[1]), float(args[2]), float(args[3]))
    if name == "z3histogram":
        return Z3HistogramStat(args[0], args[1],
                               args[2] if len(args) > 2 else "week",
                               int(args[3]) if len(args) > 3 else 10)
    if name == "frequency":
        return Frequency(args[0],
                         int(args[1]) if len(args) > 1 else 4,
                         int(args[2]) if len(args) > 2 else 1024)
    if name == "topk":
        return TopK(args[0], int(args[1]) if len(args) > 1 else 10)
    if name == "enumeration":
        return EnumerationStat(args[0])
    if name == "descriptivestats" or name == "stats":
        return DescriptiveStats(args[0])
    raise ValueError(f"unknown stat {name!r}")


def parse_stat(spec: str) -> Stat:
    """Parse the ';'-separated stat DSL into a Stat (SeqStat if several)."""
    parts = [p for p in spec.split(";") if p.strip()]
    if not parts:
        raise ValueError("empty stat spec")
    stats = [_parse_one(p) for p in parts]
    return stats[0] if len(stats) == 1 else SeqStat(stats)


_KINDS = {}


def observe_shared(stats, batch) -> None:
    """Observe every stat over one chunk with shared per-column
    intermediates: TopK and EnumerationStat over the same attribute
    fold ONE ``np.unique`` (and one object→str cast) instead of one
    each — the write-path profile showed those duplicate passes
    dominating facade ingest host time."""
    shared: dict[str, list] = {}
    rest: list = []
    for s in (stats.values() if isinstance(stats, dict) else stats):
        if isinstance(s, (TopK, EnumerationStat)):
            shared.setdefault(s.attr, []).append(s)
        else:
            rest.append(s)
    for attr, ss in shared.items():
        col = _col(batch, attr)   # missing column raises, like observe
        if col.dtype == object:
            try:
                # hash-based factorize beats sort-based np.unique ~5x
                # on object strings (0.19s vs 1.06s per 4M, measured)
                import pandas as pd
                codes, uniq = pd.factorize(col, sort=False)
                valid = codes >= 0     # factorize drops None/NaN
                cnt = np.bincount(codes[valid] if not valid.all()
                                  else codes, minlength=len(uniq))
                uniq = np.asarray(uniq, dtype=object).astype(str)
                n_na = len(codes) - int(valid.sum())
                if n_na:
                    # label NA values exactly as astype(str) would
                    # ("None" / "nan"), so the incremental path and the
                    # recompute path report identical keys
                    sub = col[~valid]
                    n_none = sum(1 for v in sub if v is None)
                    if n_none:
                        uniq = np.append(uniq, "None")
                        cnt = np.append(cnt, n_none)
                    if n_na - n_none:
                        uniq = np.append(uniq, "nan")
                        cnt = np.append(cnt, n_na - n_none)
            except ImportError:  # pragma: no cover
                uniq, cnt = np.unique(col.astype(str),
                                      return_counts=True)
        else:
            uniq, cnt = np.unique(col, return_counts=True)
        for s in ss:
            s.observe_counts(uniq, cnt)
    for s in rest:
        s.observe(batch)


def stat_from_json(obj: dict) -> Stat:
    """Inverse of to_json for every stat kind."""
    kind = obj["kind"]
    if kind == "count":
        return CountStat(obj["count"])
    if kind == "minmax":
        return MinMax(obj["attr"], obj["min"], obj["max"])
    if kind == "bbox":
        return BBoxStat(obj["attr"], obj["xmin"], obj["ymin"],
                        obj["xmax"], obj["ymax"])
    if kind == "histogram":
        return Histogram(obj["attr"], obj["bins"], obj["lo"], obj["hi"],
                         np.asarray(obj["counts"], dtype=np.int64))
    if kind == "z3histogram":
        return Z3HistogramStat(
            obj["geom"], obj["dtg"], obj["period"], obj["bits"],
            {(int(b), int(c)): int(v) for b, c, v in obj["counts"]})
    if kind == "frequency":
        return Frequency(obj["attr"], obj["depth"], obj["width"],
                         np.asarray(obj["table"], dtype=np.int64))
    if kind == "topk":
        return TopK(obj["attr"], obj["k"], dict(obj["counters"]))
    if kind == "enumeration":
        return EnumerationStat(obj["attr"], dict(obj["counts"]))
    if kind == "descriptive":
        return DescriptiveStats(obj["attr"], obj["n"], obj["mean"], obj["m2"],
                                obj["min"], obj["max"])
    if kind == "groupby":
        g = GroupBy(obj["attr"], obj["spec"])
        g.groups = {k: stat_from_json(v) for k, v in obj["groups"].items()}
        return g
    if kind == "seq":
        return SeqStat([stat_from_json(s) for s in obj["stats"]])
    raise ValueError(f"unknown stat kind {kind!r}")
