"""XZ3 curve: extended-Z ordering in 3-D (x, y, binned time) for
geometries with extent and time.

The port's copy of the JAX package's XZ3 curve, the octree
generalization of :mod:`geomesa_tpu_torch.curve.xz2` after the
reference's XZ3SFC (geomesa-z3/.../curve/XZ3SFC.scala): the third
dimension is the time *offset within a period bin* normalized by
``max_offset``, one curve instance per (g, period).  Sequence codes are
pre-order octree numbers — entering octant ``q`` at depth ``i`` adds
``1 + q·(8^(g-i)-1)/7`` (XZ3SFC.scala:275-301); full-subtree intervals
add ``(8^(g-l+1)-1)/7`` (Lemma 3, :315-321).  Encoding runs on the host
in numpy, as for XZ2.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from ..config import DEFAULT_MAX_RANGES
from .binnedtime import TimePeriod, max_offset
from .xz2 import _resolution, _sequence_code, xz_ranges

__all__ = ["XZ3SFC", "xz3_sfc", "DEFAULT_G"]

DEFAULT_G = 12


def _iv_table8(g: int) -> np.ndarray:
    """IV[i] = (8^(g-i) - 1) / 7 for i in [0, g]."""
    if g > 20:
        raise ValueError("g must be <= 20 to fit XZ3 sequence codes in int64")
    return np.array([(8 ** (g - i) - 1) // 7 for i in range(g + 1)],
                    dtype=np.int64)


@dataclass(frozen=True)
class XZ3SFC:
    """XZ3 curve over lon/lat × time-offset-in-bin, resolution ``g``."""

    period: TimePeriod = TimePeriod.WEEK
    g: int = DEFAULT_G
    x_lo: float = -180.0
    x_hi: float = 180.0
    y_lo: float = -90.0
    y_hi: float = 90.0

    @property
    def z_lo(self) -> float:
        return 0.0

    @property
    def z_hi(self) -> float:
        return float(max_offset(self.period))

    def _normalize(self, vals):
        (xmin, ymin, zmin, xmax, ymax, zmax) = vals
        xs = self.x_hi - self.x_lo
        ys = self.y_hi - self.y_lo
        zs = self.z_hi - self.z_lo

        def n(v, lo, size):
            return np.clip((np.asarray(v, np.float64) - lo) / size, 0.0, 1.0)
        return (n(xmin, self.x_lo, xs), n(ymin, self.y_lo, ys),
                n(zmin, self.z_lo, zs), n(xmax, self.x_lo, xs),
                n(ymax, self.y_lo, ys), n(zmax, self.z_lo, zs))

    def index(self, xmin, ymin, zmin, xmax, ymax, zmax) -> np.ndarray:
        """Vectorized (bbox, time-range-in-bin) → sequence code (int64),
        on the host."""
        nxmin, nymin, nzmin, nxmax, nymax, nzmax = self._normalize(
            (xmin, ymin, zmin, xmax, ymax, zmax))
        max_dim = np.maximum(np.maximum(nxmax - nxmin, nymax - nymin),
                             nzmax - nzmin)
        length = _resolution(max_dim, (nxmin, nymin, nzmin),
                             (nxmax, nymax, nzmax), self.g)
        return _sequence_code((nxmin, nymin, nzmin), length, self.g,
                              _iv_table8(self.g))

    def ranges(self, queries, max_ranges: int | None = None) -> np.ndarray:
        """Covering ranges for OR'd ``(xmin, ymin, zmin, xmax, ymax,
        zmax)`` windows (user space; z = time offset in bin)."""
        budget = DEFAULT_MAX_RANGES if max_ranges is None else int(max_ranges)
        w = np.atleast_2d(np.asarray(queries, dtype=np.float64))
        nxmin, nymin, nzmin, nxmax, nymax, nzmax = self._normalize(
            tuple(w[:, i] for i in range(6)))
        return xz_ranges(np.stack([nxmin, nymin, nzmin], axis=1),
                         np.stack([nxmax, nymax, nzmax], axis=1), self.g,
                         _iv_table8(self.g), budget)


@lru_cache(maxsize=None)
def xz3_sfc(period: TimePeriod | str = TimePeriod.WEEK,
            g: int = DEFAULT_G) -> XZ3SFC:
    return XZ3SFC(TimePeriod.parse(period), g)
