"""Legacy (semi-normalized) curves, kept for the v1 key layouts.

The port's copy of the JAX package's ``curve/legacy.py``.  The reference
retains deprecated curve variants whose dimension normalization uses
``ceil`` with a precision of ``2^p - 1`` values
(SemiNormalizedDimension, curve/NormalizedDimension.scala:82-97) so that
data written by old versions can still be read and deleted
(LegacyZ2SFC.scala, LegacyZ3SFC.scala).  These produce the OLD key
values — a schema pinned to ``geomesa.index.versions=z3:1,z2:1`` keys
and queries with them.

The normalization runs in float64, in the reference's order of
operations (``(x - min) / (max - min) * precision``, then ``ceil``): a
float32 path or ``floor`` lands boundary points one cell off, and the
keys stop being bit-exact.  A query's boxes must be normalized with the
same curve as its keys, or the mask kernels drop hits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .binnedtime import TimePeriod, max_offset
from .ranges import zranges
from .zorder import deinterleave2, deinterleave3, interleave2, interleave3

__all__ = ["SemiNormalizedDimension", "LegacyZ2SFC", "LegacyZ3SFC",
           "legacy_z2_sfc", "legacy_z3_sfc"]


@dataclass(frozen=True)
class SemiNormalizedDimension:
    """``normalize(x) = ceil((x - min) / (max - min) * precision)`` with
    max index = ``precision`` — the deprecated binning that does not
    correctly bin the lower bound (NormalizedDimension.scala:84-87)."""

    min: float
    max: float
    precision: int          # count of bins - 1 (e.g. 2^21 - 1)

    @property
    def max_index(self) -> int:
        return self.precision

    def normalize(self, x) -> torch.Tensor:
        """Vectorized normalize on the tensor's own device (int32)."""
        x = torch.as_tensor(x).to(torch.float64)
        f = torch.ceil((x - self.min) / (self.max - self.min)
                       * self.precision)
        # clamp the float first: a far out-of-range value would overflow
        # the int64 conversion; within [-1, max + 1] the clip below is
        # the reference's
        f = f.clamp(-1.0, float(self.max_index) + 1.0)
        return f.to(torch.int64).clamp(0, self.max_index).to(torch.int32)

    def denormalize(self, i) -> torch.Tensor:
        i = torch.as_tensor(i).to(torch.float64)
        return torch.where(
            i == 0, torch.full_like(i, self.min),
            (i - 0.5) * (self.max - self.min) / self.precision + self.min)

    def normalize_scalar(self, x: float) -> int:
        i = math.ceil((x - self.min) / (self.max - self.min) * self.precision)
        return max(0, min(self.max_index, int(i)))


@dataclass(frozen=True)
class LegacyZ2SFC:
    """Z2 with semi-normalized 31-bit dims (LegacyZ2SFC.scala)."""

    bits: int = 31

    @property
    def lon(self) -> SemiNormalizedDimension:
        return SemiNormalizedDimension(-180.0, 180.0, (1 << self.bits) - 1)

    @property
    def lat(self) -> SemiNormalizedDimension:
        return SemiNormalizedDimension(-90.0, 90.0, (1 << self.bits) - 1)

    def index(self, x, y) -> torch.Tensor:
        return interleave2(self.lon.normalize(x), self.lat.normalize(y))

    def invert(self, z):
        ix, iy = deinterleave2(z)
        return self.lon.denormalize(ix), self.lat.denormalize(iy)

    def ranges(self, xy, max_ranges=None, max_levels=None) -> np.ndarray:
        """Covering z ranges in the LEGACY normalization space — lets v1
        index layouts serve queries (the reference keeps LegacyZ2SFC
        queryable, index/index/z2/legacy/Z2IndexV1.scala)."""
        boxes = np.atleast_2d(np.asarray(xy, dtype=np.float64))
        mins = np.stack([[self.lon.normalize_scalar(b[0]),
                          self.lat.normalize_scalar(b[1])] for b in boxes])
        maxs = np.stack([[self.lon.normalize_scalar(b[2]),
                          self.lat.normalize_scalar(b[3])] for b in boxes])
        return zranges(mins, maxs, dims=2, bits=self.bits,
                       max_ranges=max_ranges, max_levels=max_levels)


@dataclass(frozen=True)
class LegacyZ3SFC:
    """Z3 with semi-normalized dims: 2^21-1 lon/lat, 2^20-1 time
    (LegacyZ3SFC.scala:16-21)."""

    period: TimePeriod = TimePeriod.WEEK

    @property
    def lon(self) -> SemiNormalizedDimension:
        return SemiNormalizedDimension(-180.0, 180.0, (1 << 21) - 1)

    @property
    def lat(self) -> SemiNormalizedDimension:
        return SemiNormalizedDimension(-90.0, 90.0, (1 << 21) - 1)

    @property
    def time(self) -> SemiNormalizedDimension:
        return SemiNormalizedDimension(
            0.0, float(max_offset(self.period)), (1 << 20) - 1)

    def index(self, x, y, t) -> torch.Tensor:
        return interleave3(self.lon.normalize(x), self.lat.normalize(y),
                           self.time.normalize(t))

    def invert(self, z):
        ix, iy, it = deinterleave3(z)
        return (self.lon.denormalize(ix), self.lat.denormalize(iy),
                self.time.denormalize(it))

    @property
    def whole_period(self) -> tuple[int, int]:
        return (0, int(self.time.max_index))

    def ranges(self, xy, t, max_ranges=None, max_levels=None) -> np.ndarray:
        """Covering z ranges in the LEGACY normalization space (21-bit
        lon/lat × 20-bit time; the time dim's high bit is simply never
        set, so the uniform-bit decomposition stays valid) — lets v1
        layouts serve queries (LegacyZ3SFC.scala / Z3IndexV1)."""
        boxes = np.atleast_2d(np.asarray(xy, dtype=np.float64))
        times = np.atleast_2d(np.asarray(t, dtype=np.int64))
        mins, maxs = [], []
        for b in boxes:
            for tlo, thi in times:
                mins.append([self.lon.normalize_scalar(b[0]),
                             self.lat.normalize_scalar(b[1]),
                             self.time.normalize_scalar(float(tlo))])
                maxs.append([self.lon.normalize_scalar(b[2]),
                             self.lat.normalize_scalar(b[3]),
                             self.time.normalize_scalar(float(thi))])
        return zranges(np.asarray(mins), np.asarray(maxs), dims=3,
                       bits=21, max_ranges=max_ranges,
                       max_levels=max_levels)


_Z2 = LegacyZ2SFC()
_Z3_CACHE: dict[TimePeriod, LegacyZ3SFC] = {}


def legacy_z2_sfc() -> LegacyZ2SFC:
    return _Z2


def legacy_z3_sfc(period: TimePeriod | str = TimePeriod.WEEK) -> LegacyZ3SFC:
    period = TimePeriod.parse(period)
    if period not in _Z3_CACHE:
        _Z3_CACHE[period] = LegacyZ3SFC(period)
    return _Z3_CACHE[period]
