"""Space-filling curves: Z2 (2-D points) and Z3 (2-D points + binned time).

The reference's curve layer (geomesa-z3/.../curve/Z2SFC.scala,
Z3SFC.scala): ``index``
is a tensor program (float64 normalize → int64 magic-bit interleave) that
runs on the tensors' own device — the card at ingest, the CPU for host
stats; ``ranges`` is the host planner path producing covering z ranges via
the level-synchronous decomposition in :mod:`geomesa_tpu_torch.curve.ranges`.

Key facts mirrored from the reference:
* Z2: 31 bits/dim over lon [-180,180], lat [-90,90] (Z2SFC.scala:15).
* Z3: 21 bits/dim over lon, lat, and time-offset [0, max_offset(period)]
  (Z3SFC.scala:21-28); one curve instance per time period, cached.
* the vectorized path clamps ("lenient", Z3SFC.scala:42-47) since device
  code cannot raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .binnedtime import TimePeriod, max_offset
from .normalize import NormalizedDimension, normalized_lat, normalized_lon, normalized_time
from .ranges import zranges
from .zorder import (
    MAX_2D_BITS, MAX_3D_BITS, deinterleave2, deinterleave3, interleave2,
    interleave3,
)

__all__ = ["Z2SFC", "Z3SFC", "z2_sfc", "z3_sfc"]


@dataclass(frozen=True)
class Z2SFC:
    """2-D morton curve over lon/lat."""

    precision: int = MAX_2D_BITS

    @property
    def lon(self) -> NormalizedDimension:
        return normalized_lon(self.precision)

    @property
    def lat(self) -> NormalizedDimension:
        return normalized_lat(self.precision)

    def index(self, x, y) -> torch.Tensor:
        """Vectorized (x, y) → z (int64); out-of-bounds values clamp."""
        return interleave2(self.lon.normalize(x), self.lat.normalize(y))

    def invert(self, z):
        ix, iy = deinterleave2(z)
        return self.lon.denormalize(ix), self.lat.denormalize(iy)

    def ranges(self, xy, max_ranges=None, max_levels=None) -> np.ndarray:
        """Covering z ranges for lon/lat boxes ``[(xmin, ymin, xmax, ymax)]``."""
        boxes = np.atleast_2d(np.asarray(xy, dtype=np.float64))
        mins = [[self.lon.normalize_scalar(b[0]),
                 self.lat.normalize_scalar(b[1])] for b in boxes]
        maxs = [[self.lon.normalize_scalar(b[2]),
                 self.lat.normalize_scalar(b[3])] for b in boxes]
        return zranges(np.asarray(mins), np.asarray(maxs), dims=2,
                       bits=self.precision, max_ranges=max_ranges,
                       max_levels=max_levels)


@dataclass(frozen=True)
class Z3SFC:
    """3-D morton curve over lon/lat and a time offset within a period bin."""

    period: TimePeriod = TimePeriod.WEEK
    precision: int = MAX_3D_BITS

    @property
    def lon(self) -> NormalizedDimension:
        return normalized_lon(self.precision)

    @property
    def lat(self) -> NormalizedDimension:
        return normalized_lat(self.precision)

    @property
    def time(self) -> NormalizedDimension:
        return normalized_time(self.precision, float(max_offset(self.period)))

    @property
    def whole_period(self) -> tuple[int, int]:
        return (0, int(self.time.max))

    def index(self, x, y, t) -> torch.Tensor:
        """Vectorized (x, y, t-offset) → z (int64); clamps out-of-bounds."""
        ix = self.lon.normalize(x)
        iy = self.lat.normalize(y)
        it = self.time.normalize(t)
        return interleave3(ix, iy, it)

    def invert(self, z):
        ix, iy, it = deinterleave3(z)
        return (
            self.lon.denormalize(ix),
            self.lat.denormalize(iy),
            self.time.denormalize(it),
        )

    def ranges(self, xy, t, max_ranges=None, max_levels=None) -> np.ndarray:
        """Covering z ranges for the cross product of lon/lat boxes and
        time-offset intervals (both inclusive), mirroring Z3SFC.ranges."""
        boxes = np.atleast_2d(np.asarray(xy, dtype=np.float64))
        times = np.atleast_2d(np.asarray(t, dtype=np.int64))
        mins, maxs = [], []
        for b in boxes:
            for tlo, thi in times:
                mins.append(
                    [
                        self.lon.normalize_scalar(b[0]),
                        self.lat.normalize_scalar(b[1]),
                        self.time.normalize_scalar(float(tlo)),
                    ]
                )
                maxs.append(
                    [
                        self.lon.normalize_scalar(b[2]),
                        self.lat.normalize_scalar(b[3]),
                        self.time.normalize_scalar(float(thi)),
                    ]
                )
        return zranges(np.asarray(mins), np.asarray(maxs), dims=3,
                       bits=self.precision, max_ranges=max_ranges,
                       max_levels=max_levels)


@lru_cache(maxsize=None)
def z2_sfc(precision: int = MAX_2D_BITS) -> Z2SFC:
    return Z2SFC(precision)


@lru_cache(maxsize=None)
def z3_sfc(period: TimePeriod | str = TimePeriod.WEEK, precision: int = MAX_3D_BITS) -> Z3SFC:
    return Z3SFC(TimePeriod.parse(period), precision)
