"""Sharded XZ2/XZ3 indexes: intersects scans over non-point geometries
on a device mesh.

The port of the JAX package's ``parallel/xz.py``, single-process form.
The reference serves XZ through the same distributed scan as Z
(.../index/z2/XZ2IndexKeySpace.scala:44 feeding BatchScanPlan); here the
sorted code column plus per-feature bbox columns live sharded over the
mesh, and the candidate stage (seeks, a fixed-capacity gather, the bbox
and time mask) runs on each shard's device as plain PyTorch — the JAX
package runs it as plain XLA inside ``shard_map``, with no Pallas kernel.
The exact geometry predicate stays on the host over the candidate gids,
the reference's client-side CQL re-check.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_MAX_RANGES
from ..curve.binnedtime import TimePeriod
from ..curve.xz2 import xz2_sfc
from ..curve.xz3 import xz3_sfc
from ..geometry.packed import PackedGeometry, pack_geometries
from ..geometry.predicates import packed_intersects
from ..geometry.types import Geometry
from ..index.xz2 import _is_envelope
from ..index.xz3 import xz3_bin_code_ranges, xz3_codes
from ..index.z3 import _lexsort2
from ..ops.search import (
    expand_ranges, pack_wire, pad_pow2, pad_ranges, searchsorted2,
)
from .mesh import DeviceMesh, device_mesh, shard_batch
from .scan import _PerDevice, _read_wires

__all__ = ["ShardedXZ2Index", "ShardedXZ3Index"]

_SENTINEL_BIN = int(np.iinfo(np.int32).max)
_SENTINEL_CODE = int(np.iinfo(np.int64).max)


def _exact_recheck(cand: np.ndarray, geoms: PackedGeometry,
                   geometry: Geometry) -> np.ndarray:
    """Exact geometry predicate over candidate gids (single controller:
    ``geoms`` holds every geometry, indexed by gid)."""
    cand = np.asarray(cand, dtype=np.int64)
    return cand[packed_intersects(geoms, geometry, cand)]


def _xz_build_shard(cs, gs, cols, vs, bs=None):
    """One shard's build (the JAX ``_xz_build_program``): sentinel the
    padding rows (``INT32_MAX`` bins, ``INT64_MAX`` codes, gid −1) and
    sort every column by ``code`` — or ``(bin, code)`` — with the rest as
    payload, so the sorted layout IS the storage layout.  Equal keys keep
    their incoming order (the JAX sort leaves them unspecified; no result
    depends on it)."""
    cs = torch.where(vs, cs, torch.full_like(cs, _SENTINEL_CODE))
    gs = torch.where(vs, gs, torch.full_like(gs, -1))
    if bs is None:
        perm = torch.sort(cs, stable=True).indices
        return [cs[perm], gs[perm]] + [c[perm] for c in cols]
    bs = torch.where(vs, bs, torch.full_like(bs, _SENTINEL_BIN))
    perm = _lexsort2(bs, cs)
    return [bs[perm], cs[perm], gs[perm]] + [c[perm] for c in cols]


def _bbox_mask(idx, bx0, by0, bx1, by1, a):
    """Feature bbox vs the query envelope, inclusive edges."""
    return ((bx0[idx] <= a["ex1"]) & (bx1[idx] >= a["ex0"])
            & (by0[idx] <= a["ey1"]) & (by1[idx] >= a["ey0"]))


def _xz2_scan(lc, lg, bx0, by0, bx1, by1, a, capacity: int):
    """One shard's candidate scan (the JAX ``_xz2_scan_program``): seeks
    over the sorted code column, the fixed-capacity gather, and the bbox
    prefilter, as a :func:`pack_wire` vector of gids."""
    starts = torch.searchsorted(lc, a["rzlo"], side="left")
    ends = torch.searchsorted(lc, a["rzhi"], side="right")
    counts = torch.clamp(ends - starts, min=0)
    idx, valid, _ = expand_ranges(starts, counts, capacity)
    gc = lg[idx]
    mask = valid & (gc >= 0) & _bbox_mask(idx, bx0, by0, bx1, by1, a)
    return pack_wire(counts.sum(), gc, mask, torch.int32)


def _xz3_scan(lb, lc, lg, bx0, by0, bx1, by1, lt, a, capacity: int):
    """As :func:`_xz2_scan` over ``(bin, code)`` keys with a dtg interval
    mask (the JAX ``_xz3_scan_program``)."""
    starts = searchsorted2(lb, lc, a["rbin"], a["rzlo"], side="left")
    ends = searchsorted2(lb, lc, a["rbin"], a["rzhi"], side="right")
    counts = torch.clamp(ends - starts, min=0)
    idx, valid, _ = expand_ranges(starts, counts, capacity)
    gc = lg[idx]
    tc = lt[idx]
    mask = (valid & (gc >= 0) & _bbox_mask(idx, bx0, by0, bx1, by1, a)
            & (tc >= a["t_lo"]) & (tc <= a["t_hi"]))
    return pack_wire(counts.sum(), gc, mask, torch.int32)


def _envelope_args(env) -> dict:
    return {"ex0": np.float64(env.xmin), "ey0": np.float64(env.ymin),
            "ex1": np.float64(env.xmax), "ey1": np.float64(env.ymax)}


def _packed(geoms) -> PackedGeometry:
    return (geoms if isinstance(geoms, PackedGeometry)
            else pack_geometries(geoms))


class ShardedXZ2Index:
    """XZ2 intersects index sharded over the feature axis of a mesh.

    Device state, per shard: the sorted code column, the gid payload and
    the bbox columns; host state: the packed geometries (original order,
    indexed by gid) for the exact re-check."""

    DEFAULT_CAPACITY = 1 << 14

    def __init__(self, mesh: DeviceMesh, g: int, codes, gid, bbox_cols,
                 geoms: PackedGeometry | None, n_total: int):
        self.mesh = mesh
        self.g = g
        self.sfc = xz2_sfc(g)
        self.codes = list(codes)
        self.gid = list(gid)
        #: (bx0, by0, bx1, by1): per-shard lists of device columns
        self.bbox_cols = tuple(list(c) for c in bbox_cols)
        self.geoms = geoms
        self._n_total = n_total
        self._capacity = self.DEFAULT_CAPACITY

    @classmethod
    def build(cls, geoms, g: int = 12,
              mesh: DeviceMesh | None = None) -> "ShardedXZ2Index":
        mesh = mesh or device_mesh()
        packed = _packed(geoms)
        bb = packed.bbox
        codes = xz2_sfc(g).index(bb[:, 0], bb[:, 1], bb[:, 2],
                                 bb[:, 3]).astype(np.int64)
        n = len(codes)
        sharded, valid = shard_batch(
            mesh, codes, np.arange(n, dtype=np.int32),
            *(np.ascontiguousarray(bb[:, k]) for k in range(4)))
        cols = [_xz_build_shard(sharded[0][s], sharded[1][s],
                                [c[s] for c in sharded[2:]], valid[s])
                for s in range(mesh.size)]
        cs, gs, bx0, by0, bx1, by1 = zip(*cols)
        return cls(mesh, g, cs, gs, (bx0, by0, bx1, by1), packed, n)

    @classmethod
    def build_multihost(cls, *args, **kwargs):
        raise NotImplementedError(
            "multi-controller (multihost) builds are not ported "
            "(ROADMAP A7)")

    def __len__(self) -> int:
        return self._n_total

    def _shards(self):
        return list(zip(self.codes, self.gid, *self.bbox_cols))

    def candidates(self, geometry: Geometry,
                   max_ranges: int = DEFAULT_MAX_RANGES) -> np.ndarray:
        """Sorted unique gids whose code falls in the covering ranges of
        ``geometry``'s envelope and whose bbox meets it (the device
        stage)."""
        env = geometry.envelope
        ranges = self.sfc.ranges([env.as_tuple()], max_ranges=max_ranges)
        if not len(ranges) or self._n_total == 0:
            return np.empty(0, dtype=np.int64)
        r = pad_ranges({"rzlo": ranges[:, 0].astype(np.int64),
                        "rzhi": ranges[:, 1].astype(np.int64)},
                       pad_pow2(len(ranges)))
        args = _PerDevice(**r, **_envelope_args(env))
        flat, self._capacity = _read_wires(_xz2_scan, self._shards(), args,
                                           self._capacity)
        return np.unique(flat[flat >= 0]).astype(np.int64)

    def query(self, geometry: Geometry, max_ranges: int = DEFAULT_MAX_RANGES,
              exact: bool = True) -> np.ndarray:
        """Global gids of geometries intersecting ``geometry``: the device
        candidate scan, then the host exact predicate."""
        cand = self.candidates(geometry, max_ranges)
        if (exact and len(cand) and self.geoms is not None
                and not _is_envelope(geometry, geometry.envelope)):
            cand = _exact_recheck(cand, self.geoms, geometry)
        return np.sort(cand).astype(np.int64)


class ShardedXZ3Index:
    """XZ3 intersects+time index sharded over the feature axis of a mesh:
    per shard ``(bin, code)``-sorted keys, gids, bbox columns and dtg."""

    DEFAULT_CAPACITY = 1 << 14

    def __init__(self, mesh: DeviceMesh, period, g: int, bins, codes, gid,
                 bbox_cols, dtg, geoms: PackedGeometry | None, n_total: int):
        self.mesh = mesh
        self.period = TimePeriod.parse(period)
        self.g = g
        self.sfc = xz3_sfc(self.period, g)
        self.bins = list(bins)
        self.codes = list(codes)
        self.gid = list(gid)
        self.bbox_cols = tuple(list(c) for c in bbox_cols)
        self.dtg = list(dtg)
        self.geoms = geoms
        self._n_total = n_total
        self._capacity = self.DEFAULT_CAPACITY

    @classmethod
    def build(cls, geoms, dtg_ms, period: TimePeriod | str = TimePeriod.WEEK,
              g: int = 12, mesh: DeviceMesh | None = None
              ) -> "ShardedXZ3Index":
        mesh = mesh or device_mesh()
        packed = _packed(geoms)
        period = TimePeriod.parse(period)
        dtg_ms = np.asarray(dtg_ms, dtype=np.int64)
        bb = packed.bbox
        bins, codes = xz3_codes(xz3_sfc(period, g), bb, dtg_ms)
        n = len(codes)
        sharded, valid = shard_batch(
            mesh, bins.astype(np.int32), codes, np.arange(n, dtype=np.int32),
            *(np.ascontiguousarray(bb[:, k]) for k in range(4)), dtg_ms)
        cols = [_xz_build_shard(sharded[1][s], sharded[2][s],
                                [c[s] for c in sharded[3:]], valid[s],
                                bs=sharded[0][s])
                for s in range(mesh.size)]
        bs, cs, gs, bx0, by0, bx1, by1, td = zip(*cols)
        return cls(mesh, period, g, bs, cs, gs, (bx0, by0, bx1, by1), td,
                   packed, n)

    @classmethod
    def build_multihost(cls, *args, **kwargs):
        raise NotImplementedError(
            "multi-controller (multihost) builds are not ported "
            "(ROADMAP A7)")

    def __len__(self) -> int:
        return self._n_total

    def _shards(self):
        return list(zip(self.bins, self.codes, self.gid, *self.bbox_cols,
                        self.dtg))

    def candidates(self, geometry: Geometry, t_lo_ms: int, t_hi_ms: int,
                   max_ranges: int = DEFAULT_MAX_RANGES) -> np.ndarray:
        """Sorted unique gids of the device stage: per-bin code ranges of
        the envelope × interval, the bbox and the time mask."""
        env = geometry.envelope
        if self._n_total == 0:
            return np.empty(0, dtype=np.int64)
        triples = xz3_bin_code_ranges(self.sfc, env.as_tuple(), t_lo_ms,
                                      t_hi_ms, self.period, max_ranges)
        if not triples:
            return np.empty(0, dtype=np.int64)
        trip = np.asarray(triples, dtype=np.int64)
        r = pad_ranges({"rbin": trip[:, 0].astype(np.int32),
                        "rzlo": trip[:, 1], "rzhi": trip[:, 2]},
                       pad_pow2(len(trip)))
        args = _PerDevice(**r, **_envelope_args(env),
                          t_lo=np.int64(t_lo_ms), t_hi=np.int64(t_hi_ms))
        flat, self._capacity = _read_wires(_xz3_scan, self._shards(), args,
                                           self._capacity)
        return np.unique(flat[flat >= 0]).astype(np.int64)

    def query(self, geometry: Geometry, t_lo_ms: int, t_hi_ms: int,
              max_ranges: int = DEFAULT_MAX_RANGES,
              exact: bool = True) -> np.ndarray:
        """Global gids of geometries intersecting ``geometry`` within
        ``[t_lo_ms, t_hi_ms]``."""
        cand = self.candidates(geometry, t_lo_ms, t_hi_ms, max_ranges)
        if (exact and len(cand) and self.geoms is not None
                and not _is_envelope(geometry, geometry.envelope)):
            cand = _exact_recheck(cand, self.geoms, geometry)
        return np.sort(cand).astype(np.int64)
