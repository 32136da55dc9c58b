"""Partition schemes: map features → partition names, and filters → the
partitions that could hold matches.

The reference's FileSystemDataStore treats partition layout as its index
(geomesa-fs/geomesa-fs-storage/geomesa-fs-storage-common/.../partitions/:
Z2Scheme, XZ2Scheme, DateTimeScheme, AttributeScheme, CompositeScheme) —
queries prune to matching partition directories before scanning files.
Here each scheme assigns partition names vectorized over a FeatureBatch
and prunes from the filter's extracted geometries/intervals.  The port's
copy of the JAX package's ``fs/partitions.py``: the names are equal
string for string, so either package prunes the other's directories.
"""

from __future__ import annotations

import itertools
from datetime import datetime, timezone

import numpy as np
import torch

from ..curve.sfc import z2_sfc
from ..filters.extract import extract_geometries, extract_intervals

__all__ = ["PartitionScheme", "Z2Scheme", "DateTimeScheme",
           "AttributeScheme", "CompositeScheme", "scheme_from_config"]


class PartitionScheme:
    """SPI: feature→partition assignment + filter→partition pruning."""

    def partitions_for_batch(self, sft, batch) -> np.ndarray:
        raise NotImplementedError

    def partitions_for_filter(self, sft, filt) -> list | None:
        """Partition names that may match, or None = cannot prune."""
        raise NotImplementedError

    def to_config(self) -> dict:
        raise NotImplementedError


class Z2Scheme(PartitionScheme):
    """Spatial partitions: the top ``bits`` of the Z2 curve (2 bits per
    quadtree level; fs Z2Scheme uses the same z-prefix naming)."""

    def __init__(self, bits: int = 4):
        if bits % 2 or bits <= 0:
            raise ValueError("z2 bits must be positive and even")
        self.bits = bits
        self._sfc = z2_sfc()

    def _name(self, prefix: np.ndarray) -> np.ndarray:
        width = (self.bits + 3) // 4
        return np.array([f"z2/{int(p):0{width}x}" for p in prefix],
                        dtype=object)

    def partitions_for_batch(self, sft, batch) -> np.ndarray:
        x, y = batch.geom_xy()
        z = self._sfc.index(
            torch.from_numpy(np.asarray(x, np.float64)),
            torch.from_numpy(np.asarray(y, np.float64))).numpy().astype(
            np.uint64)
        shift = np.uint64(2 * self._sfc.precision - self.bits)
        return self._name(z >> shift)

    def partitions_for_filter(self, sft, filt) -> list | None:
        geoms = extract_geometries(filt, sft.geom_field)
        if geoms.disjoint:
            return []
        if not geoms.values:
            return None
        shift = 2 * self._sfc.precision - self.bits
        prefixes = set()
        for g in geoms.values:
            env = g.envelope
            zr = self._sfc.ranges(
                [(env.xmin, env.ymin, env.xmax, env.ymax)],
                max_ranges=2 ** self.bits * 4)
            for lo, hi in np.asarray(zr, dtype=np.int64):
                prefixes.update(range(int(lo) >> shift, (int(hi) >> shift) + 1))
        return sorted(self._name(np.array(sorted(prefixes), dtype=np.uint64)))

    def to_config(self) -> dict:
        return {"scheme": "z2", "z2-resolution": self.bits}


class DateTimeScheme(PartitionScheme):
    """Time partitions: daily / weekly / monthly / hourly directory names
    (fs DateTimeScheme; names match its java-time patterns)."""

    FORMATS = {
        "daily": "%Y/%m/%d",
        "weekly": "%Y/W%W",
        "monthly": "%Y/%m",
        "hourly": "%Y/%m/%d/%H",
    }
    STEP_MS = {
        "daily": 86_400_000,
        "weekly": 7 * 86_400_000,
        "monthly": 28 * 86_400_000,   # stepping only; names dedupe
        "hourly": 3_600_000,
    }

    def __init__(self, step: str = "daily"):
        if step not in self.FORMATS:
            raise ValueError(f"unknown datetime step {step!r}")
        self.step = step

    def _fmt(self, ms: int) -> str:
        dt = datetime.fromtimestamp(ms / 1000.0, tz=timezone.utc)
        return dt.strftime(self.FORMATS[self.step])

    #: the name is a function of the UTC hour (hourly) or day (the rest):
    #: rows of one unit share it, so it is formatted once a unit
    UNIT_MS = {"daily": 86_400_000, "weekly": 86_400_000,
               "monthly": 86_400_000, "hourly": 3_600_000}

    def partitions_for_batch(self, sft, batch) -> np.ndarray:
        ms = np.asarray(batch.column(sft.dtg_field)).astype(np.int64)
        if not len(ms):
            return np.empty(0, dtype=object)
        # one strftime a distinct unit (not one a row), each on a real
        # row's value, so the names equal the per-row format's
        key = ms // self.UNIT_MS[self.step]
        lo = int(key.min())
        span = int(key.max()) - lo + 1
        if span <= 4 * len(ms):
            row = np.full(span, -1, dtype=np.int64)
            row[key - lo] = np.arange(len(ms))
            names = np.empty(span, dtype=object)
            for k in np.flatnonzero(row >= 0):
                names[k] = self._fmt(int(ms[row[k]]))
            return names[key - lo]
        _, idx, inv = np.unique(key, return_index=True,
                                return_inverse=True)
        names = np.array([self._fmt(int(ms[i])) for i in idx], dtype=object)
        return names[inv]

    def partitions_for_filter(self, sft, filt) -> list | None:
        iv = extract_intervals(filt, sft.dtg_field)
        if iv.disjoint:
            return []
        if not iv.values:
            return None
        out = set()
        step = self.STEP_MS[self.step]
        for lo, hi in iv.values:
            if lo is None or hi is None:
                return None
            # over-cover by one step each side; dedupe via the name format
            t = int(lo) - step
            while t <= int(hi) + step:
                out.add(self._fmt(t))
                t += step
            out.add(self._fmt(int(hi)))
        return sorted(out)

    def to_config(self) -> dict:
        return {"scheme": "datetime", "datetime-step": self.step}


class AttributeScheme(PartitionScheme):
    """Partition by an attribute's (string) value."""

    def __init__(self, attribute: str):
        self.attribute = attribute

    def partitions_for_batch(self, sft, batch) -> np.ndarray:
        col = batch.column(self.attribute)
        return np.array([f"{self.attribute}={v}" for v in col], dtype=object)

    def partitions_for_filter(self, sft, filt) -> list | None:
        from ..filters.ast import And, In, Or, PropertyCompare

        def values_of(f):
            if (isinstance(f, PropertyCompare) and f.op == "="
                    and f.prop == self.attribute):
                return {f.value}
            if isinstance(f, In) and f.prop == self.attribute:
                return set(f.values)
            if isinstance(f, And):
                vals = [values_of(p) for p in f.filters]
                vals = [v for v in vals if v is not None]
                if not vals:
                    return None
                out = vals[0]
                for v in vals[1:]:
                    out &= v
                return out
            if isinstance(f, Or):
                vals = [values_of(p) for p in f.filters]
                if any(v is None for v in vals):
                    return None
                return set().union(*vals)
            return None

        vals = values_of(filt)
        if vals is None:
            return None
        return sorted(f"{self.attribute}={v}" for v in vals)

    def to_config(self) -> dict:
        return {"scheme": "attribute", "partitioned-attribute": self.attribute}


class CompositeScheme(PartitionScheme):
    """Nested schemes: partition name = "a/b" (fs CompositeScheme)."""

    def __init__(self, schemes: list):
        if len(schemes) < 2:
            raise ValueError("composite needs >= 2 schemes")
        self.schemes = list(schemes)

    def partitions_for_batch(self, sft, batch) -> np.ndarray:
        parts = [s.partitions_for_batch(sft, batch) for s in self.schemes]
        return np.array(["/".join(p) for p in zip(*parts)], dtype=object)

    def partitions_for_filter(self, sft, filt) -> list | None:
        per = [s.partitions_for_filter(sft, filt) for s in self.schemes]
        if any(p == [] for p in per):
            return []
        if all(p is None for p in per):
            return None
        # None level = wildcard; expressed as prefix filtering by the store
        out = []
        for combo in itertools.product(*[p if p is not None else ["*"]
                                         for p in per]):
            out.append("/".join(combo))
        return out

    def to_config(self) -> dict:
        return {"scheme": "composite",
                "schemes": [s.to_config() for s in self.schemes]}


def scheme_from_config(cfg: dict) -> PartitionScheme:
    kind = cfg.get("scheme", "datetime")
    if kind == "z2":
        return Z2Scheme(int(cfg.get("z2-resolution", 4)))
    if kind == "datetime":
        return DateTimeScheme(cfg.get("datetime-step", "daily"))
    if kind == "attribute":
        return AttributeScheme(cfg["partitioned-attribute"])
    if kind == "composite":
        return CompositeScheme([scheme_from_config(c) for c in cfg["schemes"]])
    raise ValueError(f"unknown partition scheme {kind!r}")
