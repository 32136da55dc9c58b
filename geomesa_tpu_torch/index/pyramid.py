"""Slippy-map tile geometry for density tiles.

The port's copy of ``tile_env`` from the JAX package's
``index/pyramid.py``; the density pyramids themselves belong to the lean
profile, which is not ported.
"""

from __future__ import annotations

__all__ = ["tile_env"]


def tile_env(z: int, x: int, y: int) -> tuple:
    """The (xmin, ymin, xmax, ymax) world envelope of slippy tile
    (z, x, y) on the plate-carrée grid this store serves (world split
    into 2^z × 2^z equal-degree tiles; y=0 is the NORTH row, matching
    the slippy-map convention, while grid row 0 is south)."""
    n = 1 << int(z)
    dx = 360.0 / n
    dy = 180.0 / n
    return (-180.0 + x * dx, -90.0 + (n - 1 - y) * dy,
            -180.0 + (x + 1) * dx, -90.0 + (n - y) * dy)
