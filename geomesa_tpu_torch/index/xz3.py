"""XZ3 index: intersects + time queries over geometries with extent.

The port's copy of the JAX package's host XZ3 index, the analog of the
reference's XZ3 index (geomesa-index-api/.../index/z3/
XZ3IndexKeySpace.scala — key = ``[shard][2B bin][8B code][id]``): sorted
(bin, code) pair columns + permutation, per-bin time windows planned the
same way as the Z3 point index.  Host numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..config import DEFAULT_MAX_RANGES
from ..curve.binnedtime import TimePeriod, to_binned_time
from ..curve.xz3 import XZ3SFC, xz3_sfc
from ..geometry.packed import PackedGeometry, pack_geometries
from ..geometry.predicates import bbox_intersects, packed_intersects
from ..geometry.types import Geometry
from .xz2 import _is_envelope
from .z3 import _time_windows_by_bin

__all__ = ["XZ3Index", "xz3_bin_code_ranges", "xz3_codes"]


def xz3_codes(sfc: XZ3SFC, bbox: np.ndarray, dtg_ms: np.ndarray):
    """Per-row ``(bins, codes)`` of envelopes at their time instants (the
    bbox indexed with ``zmin == zmax ==`` the row's offset in its bin)."""
    bins, offs = to_binned_time(np.asarray(dtg_ms, np.int64), sfc.period)
    offs_f = offs.astype(np.float64)
    codes = sfc.index(bbox[:, 0], bbox[:, 1], offs_f, bbox[:, 2],
                      bbox[:, 3], offs_f).astype(np.int64)
    return bins, codes


def xz3_bin_code_ranges(sfc, env: tuple, t_lo_ms: int, t_hi_ms: int,
                        period, max_ranges: int) -> list:
    """Shared XZ3 range planning — per-bin covering ``(bin, code_lo,
    code_hi)`` triples for an envelope × interval (whole-period bins
    grouped to share one decomposition; the range budget splits across
    windows).  The one definition behind the host, sharded and lean XZ3
    indexes."""
    windows = _time_windows_by_bin(t_lo_ms, t_hi_ms, period)
    if not windows:
        return []
    target = max(1, max_ranges // max(1, len(windows)))
    by_window: dict[tuple, list[int]] = {}
    for b, w in windows.items():
        by_window.setdefault(w, []).append(b)
    out = []
    xmin, ymin, xmax, ymax = env
    for (wlo, whi), bs in by_window.items():
        ranges = sfc.ranges(
            [(xmin, ymin, float(wlo), xmax, ymax, float(whi))],
            max_ranges=target)
        for b in bs:
            out.extend((int(b), int(lo), int(hi)) for lo, hi in ranges)
    return out


class XZ3Index:
    """Host spatio-temporal index over non-point geometries with an
    instant dtg."""

    def __init__(self, period, g, bins, codes, pos, bbox, dtg, geoms):
        self.period = TimePeriod.parse(period)
        self.sfc: XZ3SFC = xz3_sfc(self.period, g)
        self.bins = bins          # (N,) int32 sorted-major
        self.codes = codes        # (N,) int64 sorted within bin
        self.pos = pos
        self.bbox = bbox          # original order
        self.dtg = dtg            # (N,) int64 epoch ms, original order
        self.geoms = geoms

    @classmethod
    def build(cls, geoms, dtg_ms, period: TimePeriod | str = TimePeriod.WEEK,
              g: int = 12) -> "XZ3Index":
        packed = geoms if isinstance(geoms, PackedGeometry) else pack_geometries(geoms)
        period = TimePeriod.parse(period)
        dtg_ms = np.asarray(dtg_ms, dtype=np.int64)
        bb = packed.bbox
        bins, codes = xz3_codes(xz3_sfc(period, g), bb, dtg_ms)
        order = np.lexsort((codes, bins))
        return cls(period, g, bins[order].astype(np.int32), codes[order],
                   order.astype(np.int32), bb, dtg_ms, packed)

    def __len__(self) -> int:
        return len(self.codes)

    def query(self, geometry: Geometry, t_lo_ms, t_hi_ms,
              max_ranges: int = DEFAULT_MAX_RANGES,
              exact: bool = True) -> np.ndarray:
        """Original-order positions of geometries intersecting
        ``geometry`` within ``[t_lo_ms, t_hi_ms]``; open bounds clamp to
        the data's time extent, so a spatial-only query can ride xz3."""
        env = geometry.envelope
        if not len(self):
            return np.empty(0, dtype=np.int64)
        if t_lo_ms is None:
            t_lo_ms = int(self.dtg.min())
        if t_hi_ms is None:
            t_hi_ms = int(self.dtg.max())
        bin_ranges = xz3_bin_code_ranges(self.sfc, env.as_tuple(),
                                         t_lo_ms, t_hi_ms, self.period,
                                         max_ranges)
        cands = []
        for b, rlo, rhi in bin_ranges:
            # the bin in the column's own dtype: numpy casts the whole
            # int32 column to int64 to search it for a Python int, an O(n)
            # copy a planned range (the JAX index pays it: PERF.md §6)
            b = self.bins.dtype.type(b)
            lo_i = np.searchsorted(self.bins, b, side="left")
            hi_i = np.searchsorted(self.bins, b, side="right")
            seg = self.codes[lo_i:hi_i]
            s = np.searchsorted(seg, rlo, side="left") + lo_i
            e = np.searchsorted(seg, rhi, side="right") + lo_i
            if e > s:
                cands.append(self.pos[s:e])
        if not cands:
            return np.empty(0, dtype=np.int64)
        cand = np.concatenate(cands)
        keep = bbox_intersects(self.bbox[cand], env.as_tuple())
        keep &= (self.dtg[cand] >= t_lo_ms) & (self.dtg[cand] <= t_hi_ms)
        cand = cand[keep]
        if exact and self.geoms is not None and not _is_envelope(geometry, env):
            cand = cand[packed_intersects(self.geoms, geometry, cand)]
        return np.sort(cand).astype(np.int64)
