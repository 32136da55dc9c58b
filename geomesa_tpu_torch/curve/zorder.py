"""Morton (z-order) bit interleaving — the bit algebra under every z index.

Magic-bit shuffles on int64 tensors, elementwise, on whatever device the
input lives on.  Bit convention (sfcurve's, as in ``geomesa_tpu``):

* 2-D: ``z = split2(x) | split2(y) << 1`` — x occupies even bits, 31 bits
  per dimension → 62-bit z.
* 3-D: ``z = split3(x) | split3(y) << 1 | split3(t) << 2`` — x occupies bits
  0, 3, 6, …; 21 bits per dimension → 63-bit z.

Everything is int64, not uint64: torch supports few uint64 operations,
and no code here needs the 64th bit — a 3-D z uses at most 63 bits and a
2-D z 62 (with dimensions of at most 31 bits), so every value stays
non-negative and the arithmetic right shift equals the logical one.
"""

from __future__ import annotations

import torch

__all__ = [
    "split2", "combine2", "interleave2", "deinterleave2",
    "split3", "combine3", "interleave3", "deinterleave3",
    "MAX_2D_BITS", "MAX_3D_BITS",
]

# 31 bits/dim for 2-D (Z2SFC default, curve/Z2SFC.scala:15);
# 21 bits/dim for 3-D (Z3SFC default, curve/Z3SFC.scala:21).
MAX_2D_BITS = 31
MAX_3D_BITS = 21


def _i64(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64)


def split2(x):
    """Spread the low 32 bits of ``x`` onto even bit positions."""
    x = _i64(x) & 0x00000000FFFFFFFF
    x = (x ^ (x << 16)) & 0x0000FFFF0000FFFF
    x = (x ^ (x << 8)) & 0x00FF00FF00FF00FF
    x = (x ^ (x << 4)) & 0x0F0F0F0F0F0F0F0F
    x = (x ^ (x << 2)) & 0x3333333333333333
    x = (x ^ (x << 1)) & 0x5555555555555555
    return x


def combine2(z):
    """Gather even bits of ``z`` back into a contiguous low-32-bit value."""
    x = _i64(z) & 0x5555555555555555
    x = (x ^ (x >> 1)) & 0x3333333333333333
    x = (x ^ (x >> 2)) & 0x0F0F0F0F0F0F0F0F
    x = (x ^ (x >> 4)) & 0x00FF00FF00FF00FF
    x = (x ^ (x >> 8)) & 0x0000FFFF0000FFFF
    x = (x ^ (x >> 16)) & 0x00000000FFFFFFFF
    return x


def interleave2(x, y):
    """Morton-interleave two dimension indices: x → even bits, y → odd."""
    return split2(x) | (split2(y) << 1)


def deinterleave2(z):
    """Inverse of :func:`interleave2`; returns ``(x, y)`` as int64."""
    z = _i64(z)
    return combine2(z), combine2(z >> 1)


def split3(x):
    """Spread the low 21 bits of ``x`` to every third bit position."""
    x = _i64(x) & 0x1FFFFF
    x = (x | (x << 32)) & 0x1F00000000FFFF
    x = (x | (x << 16)) & 0x1F0000FF0000FF
    x = (x | (x << 8)) & 0x100F00F00F00F00F
    x = (x | (x << 4)) & 0x10C30C30C30C30C3
    x = (x | (x << 2)) & 0x1249249249249249
    return x


def combine3(z):
    """Gather every third bit of ``z`` into a contiguous low-21-bit value."""
    x = _i64(z) & 0x1249249249249249
    x = (x ^ (x >> 2)) & 0x10C30C30C30C30C3
    x = (x ^ (x >> 4)) & 0x100F00F00F00F00F
    x = (x ^ (x >> 8)) & 0x1F0000FF0000FF
    x = (x ^ (x >> 16)) & 0x1F00000000FFFF
    x = (x ^ (x >> 32)) & 0x1FFFFF
    return x


def interleave3(x, y, t):
    """Morton-interleave three dims: x → bits 0,3,…; y → 1,4,…; t → 2,5,…"""
    return split3(x) | (split3(y) << 1) | (split3(t) << 2)


def deinterleave3(z):
    """Inverse of :func:`interleave3`; returns ``(x, y, t)`` as int64."""
    z = _i64(z)
    return combine3(z), combine3(z >> 1), combine3(z >> 2)
