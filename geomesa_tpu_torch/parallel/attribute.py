"""ShardedAttributeIndex: attribute equality/range/prefix scans on a mesh.

The port's copy of the JAX package's ``parallel/attribute.py``,
single-controller form.  The reference serves attribute queries through
the same distributed scan as the spatial indexes (lexicoded value keys +
tablet seeks, .../index/attribute/AttributeIndexKey.scala:38).
Lexicoding is replaced by **rank encoding**: the host keeps the sorted
unique values (the dictionary) and each row carries its value's rank as
an int64 device key — numpy sort order equals lexicoder order for
numerics and strings, so rank order IS key order.  Per-shard state:
sorted ``(rank, secondary)`` key columns and the gid payload; queries map
value predicates to rank ranges on the host and run one seek+gather per
shard (``parallel/scan.py``'s wire read), the JAX package's collective
``shard_map`` scan as a loop over the mesh's devices.

**Tiers** mirror the single-chip index
(:class:`~geomesa_tpu_torch.index.attribute.AttributeIndex`):

* **date tier** — rows sort by ``(rank, dtg)``; equality lookups refine
  by a time window inside the value run through the two-key seek.
* **z3 tier** — rows sort by ``((rank << 16) | time_bin, z)``: the rank
  and the Z3 time bin FUSE into the first key (bins are small ints), so
  the same two-key scan serves per-``(value, bin)`` z-range seeks.

As in the reference, tiers apply only to point lookups (equality / IN);
range and prefix scans rely on the planner's residual filter.  The JAX
package's multi-controller build (``build_multihost``) is not ported and
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.attr_lean import _lexsort_keys
from ..ops.search import (
    expand_ranges, pack_wire, pad_pow2, pad_ranges, searchsorted2,
)
from .mesh import DeviceMesh, device_mesh, shard_batch
from .scan import _PerDevice, _read_wires

__all__ = ["ShardedAttributeIndex"]

_SENTINEL_RANK = int(np.iinfo(np.int64).max)
_SEC_LO = int(np.iinfo(np.int64).min)
_SEC_HI = int(np.iinfo(np.int64).max)

#: bits of the first sort key reserved for the Z3 time bin (z3 tier:
#: key1 = rank << _BIN_BITS | bin); week bins stay far below 2^16
_BIN_BITS = 16


def _tier_keys(ranks: np.ndarray, secondary, sec_bins, sec_z, n: int):
    """(key1, key2, tier) for the build: the z3 tier fuses rank+bin into
    key1 with z as key2; the date tier is (rank, dtg); untiered (rank,
    0)."""
    if sec_z is not None:
        bins = np.asarray(sec_bins, dtype=np.int64)
        if bins.size and (bins.min() < 0 or bins.max() >= 1 << _BIN_BITS):
            raise ValueError("time bin exceeds the fused-key budget")
        return ((ranks << _BIN_BITS) | bins,
                np.asarray(sec_z, dtype=np.int64), "z3")
    if secondary is not None:
        return ranks, np.asarray(secondary, dtype=np.int64), "date"
    return ranks, np.zeros(n, dtype=np.int64), "none"


def _sort_shard(rk, sec, gs, vs):
    """One shard's build: sentinel the padding rows and sort by
    ``(rank, sec)`` with the gids as payload."""
    rk = torch.where(vs, rk, torch.full_like(rk, _SENTINEL_RANK))
    gs = torch.where(vs, gs, torch.full_like(gs, -1))
    perm = _lexsort_keys(rk, sec)
    return rk[perm], sec[perm], gs[perm]


def _scan_shard(lr, ls, lg, plan: dict, capacity: int):
    """One shard's seek + gather over lexicographic ``[(rank_lo, sec_lo),
    (rank_hi, sec_hi)]`` ranges, as a wire vector of gids."""
    starts = searchsorted2(lr, ls, plan["rzlo"], plan["rtlo"], side="left")
    ends = searchsorted2(lr, ls, plan["rzhi"], plan["rthi"], side="right")
    counts = torch.clamp(ends - starts, min=0)
    idx, valid, _ = expand_ranges(starts, counts, capacity)
    gc = lg[idx]
    return pack_wire(counts.sum(), gc, valid & (gc >= 0), torch.int32)


class ShardedAttributeIndex:
    """Rank-encoded attribute index sharded over a device mesh."""

    DEFAULT_CAPACITY = 1 << 14

    def __init__(self, mesh: DeviceMesh, attr: str, uniques: np.ndarray,
                 ranks: list, sec: list, gid: list, n_total: int,
                 tier: str = "none"):
        self.mesh = mesh
        self.attr = attr
        self.uniques = uniques      # host dictionary, sorted
        self.ranks = ranks          # per-shard sorted int64 key1
        self.sec = sec              # per-shard int64 key2 (dtg / z / 0)
        self.gid = gid
        self._n_total = n_total
        self.tier = tier
        self._capacity = self.DEFAULT_CAPACITY
        #: the single-chip AttributeIndex attributes the planner probes
        self.has_secondary = tier == "date"
        self.secondary = sec if tier == "date" else None
        self.sec_z = True if tier == "z3" else None

    @classmethod
    def build(cls, attr: str, column: np.ndarray, secondary=None,
              mesh: DeviceMesh | None = None, sec_bins=None,
              sec_z=None) -> "ShardedAttributeIndex":
        """``secondary`` (dtg) selects the date tier; ``sec_bins`` +
        ``sec_z`` (host-computed Z3 key parts) select the z3 tier."""
        mesh = mesh or device_mesh()
        col = np.asarray(column)
        if col.dtype == object:
            col = col.astype(str)
        uniques, inv = np.unique(col, return_inverse=True)
        ranks = inv.astype(np.int64).ravel()
        n = len(col)
        k1, k2, tier = _tier_keys(ranks, secondary, sec_bins, sec_z, n)
        (k1s, k2s, gs), valid = shard_batch(
            mesh, k1, k2, np.arange(n, dtype=np.int32))
        cols = [_sort_shard(k1s[s], k2s[s], gs[s], valid[s])
                for s in range(mesh.size)]
        rk, sec, gid = (list(c) for c in zip(*cols))
        return cls(mesh, attr, uniques, rk, sec, gid, n, tier=tier)

    @classmethod
    def build_multihost(cls, *args, **kwargs):
        raise NotImplementedError(
            "multi-controller (multihost) builds are not ported")

    def __len__(self) -> int:
        return self._n_total

    def _cast(self, v):
        return str(v) if self.uniques.dtype.kind in ("U", "S") else v

    def _scan(self, ranges: list[tuple[int, int, int, int]]) -> np.ndarray:
        """Run lexicographic (rank, sec) ranges as one seek+gather per
        shard."""
        if not ranges or self._n_total == 0:
            return np.empty(0, dtype=np.int64)
        arr = np.asarray(ranges, dtype=np.int64)
        # padding never matches in lex order: pad_ranges fills
        # (rzlo, rtlo) = (1, 1) > (rzhi, rthi) = (0, 0)
        r = pad_ranges({"rzlo": arr[:, 0], "rtlo": arr[:, 1],
                        "rzhi": arr[:, 2], "rthi": arr[:, 3]},
                       pad_pow2(len(arr)))
        flat, self._capacity = _read_wires(
            _scan_shard, list(zip(self.ranks, self.sec, self.gid)),
            _PerDevice(**r), self._capacity)
        return np.unique(flat[flat >= 0]).astype(np.int64)

    def _sec_bounds(self, sec_window) -> tuple[int, int]:
        if sec_window is None or not self.has_secondary:
            return _SEC_LO, _SEC_HI
        lo, hi = sec_window
        return (_SEC_LO if lo is None else int(lo),
                _SEC_HI if hi is None else int(hi))

    def _k1(self, rank: int, bin_: int | None = None,
            hi: bool = False) -> int:
        """First sort key for a rank: the plain rank for date/untiered;
        the fused ``rank << 16 | bin`` for the z3 tier (bin None spans
        every bin of the rank's run — lo/hi chosen by ``hi``)."""
        if self.tier != "z3":
            return int(rank)
        if bin_ is not None:
            return (int(rank) << _BIN_BITS) | int(bin_)
        return (int(rank) << _BIN_BITS) | ((1 << _BIN_BITS) - 1 if hi else 0)

    def _value_ranges(self, rank: int, s_lo: int, s_hi: int,
                      z3_ranges) -> list[tuple[int, int, int, int]]:
        """Lex ranges for one value's run: z3-tiered point lookups seek
        per-(bin, z-range) sub-runs; otherwise one run-wide range refined
        by the date window."""
        if self.tier == "z3" and z3_ranges is not None:
            rbin, rzlo, rzhi = z3_ranges
            return [(self._k1(rank, int(b)), int(zl),
                     self._k1(rank, int(b)), int(zh))
                    for b, zl, zh in zip(rbin, rzlo, rzhi)]
        return [(self._k1(rank), s_lo, self._k1(rank, hi=True), s_hi)]

    def _rank_of(self, value) -> int | None:
        value = self._cast(value)
        i = int(np.searchsorted(self.uniques, value))
        if i >= len(self.uniques) or self.uniques[i] != value:
            return None
        return i

    def query_equals(self, value, sec_window=None,
                     z3_ranges=None) -> np.ndarray:
        """Gids where attr == value, tier-refined: by a dtg window (date
        tier) or a covering ``(rbin, rzlo, rzhi)`` plan (z3 tier)."""
        i = self._rank_of(value)
        if i is None:
            return np.empty(0, dtype=np.int64)
        s_lo, s_hi = self._sec_bounds(sec_window)
        return self._scan(self._value_ranges(i, s_lo, s_hi, z3_ranges))

    def query_in(self, values, sec_window=None,
                 z3_ranges=None) -> np.ndarray:
        """Gids where attr IN values — every value in ONE scan."""
        s_lo, s_hi = self._sec_bounds(sec_window)
        ranges = []
        for v in values:
            i = self._rank_of(v)
            if i is not None:
                ranges.extend(self._value_ranges(i, s_lo, s_hi, z3_ranges))
        return self._scan(ranges)

    def query_range(self, lo=None, hi=None, lo_inclusive=True,
                    hi_inclusive=True) -> np.ndarray:
        i0 = 0
        i1 = len(self.uniques) - 1
        if lo is not None:
            i0 = int(np.searchsorted(
                self.uniques, self._cast(lo),
                side="left" if lo_inclusive else "right"))
        if hi is not None:
            i1 = int(np.searchsorted(
                self.uniques, self._cast(hi),
                side="right" if hi_inclusive else "left")) - 1
        if i1 < i0:
            return np.empty(0, dtype=np.int64)
        return self._scan([(self._k1(i0), _SEC_LO,
                            self._k1(i1, hi=True), _SEC_HI)])

    def query_prefix(self, prefix: str) -> np.ndarray:
        """String prefix scan — serves LIKE 'abc%'."""
        if self.uniques.dtype.kind not in ("U", "S"):
            raise TypeError("prefix queries require a string attribute")
        i0 = int(np.searchsorted(self.uniques, prefix, side="left"))
        i1 = int(np.searchsorted(self.uniques, prefix + "￿",
                                 side="right")) - 1
        if i1 < i0:
            return np.empty(0, dtype=np.int64)
        return self._scan([(self._k1(i0), _SEC_LO,
                            self._k1(i1, hi=True), _SEC_HI)])
