"""Slippy-map tiles over the lean index's density push-down.

The port's copy of ``tile_env``, ``tile_grid_res`` and ``density_tile``
from the JAX package's ``index/pyramid.py``.  The per-generation density
pyramids themselves (``DensityPyramid``, ``build_pyramids``) are not
ported: a tile at or below the pyramid base is always served by the
whole-world sweep, the path the JAX package also takes for a generation
that has no pyramid built, so the grids are the same.
"""

from __future__ import annotations

import numpy as np

from ..config import DEFAULT_MAX_RANGES, DensityProperties

__all__ = ["density_tile", "tile_env", "tile_grid_res"]

#: world extent the tile grid is aligned to (the lean sweep's envelope)
_WORLD = (-180.0, -90.0, 180.0, 90.0)


def tile_grid_res(z: int, tile: int) -> int:
    """World grid resolution (cells per axis) a ``/tiles/{z}/..`` request
    needs: ``tile · 2^z``."""
    return int(tile) << int(z)


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


def density_tile(index, z: int, x: int, y: int, tile: int = 256,
                 max_ranges: int = DEFAULT_MAX_RANGES) -> np.ndarray:
    """One (tile, tile) density grid for slippy tile (z, x, y), served off
    a lean z3 index's ``density(boxes, lo, hi, env, w, h)`` push-down.

    While the needed world resolution ``tile·2^z`` stays at or below
    ``geomesa.density.pyramid.base`` (and the tile is a power of two),
    the tile is a SLICE of the whole-world whole-time density at that
    resolution; finer zooms run the bbox density scan over just the
    tile's envelope, under the cell-granularity contract of
    docs/density.md."""
    n = 1 << int(z)
    res = tile_grid_res(z, tile)
    base = DensityProperties.PYRAMID_BASE.to_int()
    if res <= base and tile & (tile - 1) == 0:
        grid = index.density([_WORLD], None, None, _WORLD, res, res,
                             max_ranges=max_ranges)
        return np.asarray(grid, np.float64)[
            (n - 1 - y) * tile:(n - y) * tile,
            x * tile:(x + 1) * tile]
    env = tile_env(z, x, y)
    return np.asarray(
        index.density([env], None, None, env, tile, tile,
                      max_ranges=max_ranges), np.float64)
