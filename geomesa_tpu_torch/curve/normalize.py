"""Dimension normalization: map doubles in [min, max] to ints in [0, 2^p).

Semantics match the reference's ``BitNormalizedDimension``
(geomesa-z3/.../curve/NormalizedDimension.scala:60-71) bit-for-bit so that
index hit-sets are identical:

* ``normalize(x) = maxIndex if x >= max else floor((x - min) * normalizer)``
  with ``normalizer = 2^p / (max - min)`` computed in float64.
* ``denormalize(i)`` returns the *center* of bin ``min(i, maxIndex)``.

The tensor methods pin float64 explicitly: torch defaults to float32, and
a float32 normalize would land points in neighbouring cells.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

__all__ = ["NormalizedDimension", "normalized_lon", "normalized_lat", "normalized_time"]


@dataclass(frozen=True)
class NormalizedDimension:
    """Maps doubles within [min, max] to ints in [0, 2^precision)."""

    min: float
    max: float
    precision: int

    def __post_init__(self):
        if not (0 < self.precision < 32):
            raise ValueError("precision (bits) must be in [1, 31]")

    @property
    def bins(self) -> int:
        return 1 << self.precision

    @property
    def max_index(self) -> int:
        return self.bins - 1

    @property
    def _normalizer(self) -> float:
        return self.bins / (self.max - self.min)

    @property
    def _denormalizer(self) -> float:
        return (self.max - self.min) / self.bins

    # -- vectorized (tensors on any device) ---------------------------------
    def normalize(self, x) -> torch.Tensor:
        """Vectorized normalize; values >= max clamp to max_index.

        Out-of-range low values are clamped to ``min`` (the reference's
        "lenient" mode, Z3SFC.scala:42-47); strict bounds checking is a
        host-side validation concern, not a device one.
        """
        x = torch.as_tensor(x).to(torch.float64)
        x = torch.clamp(x, min=self.min)
        # int64 intermediate: floor((max-min)*normalizer) == 2^p overflows
        # int32 before the clamp for x == max
        i = torch.floor((x - self.min) * self._normalizer).to(torch.int64)
        return torch.clamp(i, 0, self.max_index).to(torch.int32)

    def denormalize(self, i) -> torch.Tensor:
        """Vectorized bin-center denormalize (matches reference rounding)."""
        i = torch.clamp(torch.as_tensor(i).to(torch.float64),
                        max=float(self.max_index))
        return self.min + (i + 0.5) * self._denormalizer

    # -- scalar (host planning path) --------------------------------------
    def normalize_scalar(self, x: float) -> int:
        if x >= self.max:
            return self.max_index
        i = math.floor((x - self.min) * self._normalizer)
        return max(0, min(self.max_index, int(i)))

    def denormalize_scalar(self, i: int) -> float:
        i = min(i, self.max_index)
        return self.min + (i + 0.5) * self._denormalizer

    def in_bounds_scalar(self, x: float) -> bool:
        return self.min <= x <= self.max


def normalized_lon(precision: int) -> NormalizedDimension:
    return NormalizedDimension(-180.0, 180.0, precision)


def normalized_lat(precision: int) -> NormalizedDimension:
    return NormalizedDimension(-90.0, 90.0, precision)


def normalized_time(precision: int, max_offset: float) -> NormalizedDimension:
    return NormalizedDimension(0.0, float(max_offset), precision)
