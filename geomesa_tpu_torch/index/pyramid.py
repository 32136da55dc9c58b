"""Per-generation multi-resolution density pyramids and slippy-map tiles
over the lean index's density push-down.

The port's copy of the JAX package's ``index/pyramid.py``.  Sealed
generations are immutable, so the whole-extent aggregation work for the
sealed part of a tiered store can be done ONCE and reused by every later
heatmap or zoomed-out tile: a :class:`DensityPyramid` is a stack of
power-of-two world-aligned density grids (``base × base`` halving down
to ``1 × 1``), one per generation, built from the generation's keys by
the whole-extent sweep plus the 2×2 reduction ladder
(``ops/density.pyramid_reduce``).

Exactness: the base grid IS the generation's ``("sweep", world, base,
base)`` density partial (integer counts carried in float64), and each
ladder level is an exact 2×2 block sum — the ``(ix * width) >>
precision`` world binning halves exactly — so a pyramid-served grid is
bit-identical to what the direct sweep produces at the same resolution.
Requests finer than the pyramid base fall back to the direct scan.
Compaction-merged generations inherit by SUMMING their parents'
pyramids.
"""

from __future__ import annotations

import numpy as np

from ..config import DEFAULT_MAX_RANGES, DensityProperties
from ..ops.density import pyramid_reduce_np

__all__ = ["DensityPyramid", "PYRAMID_SPEC", "density_tile",
           "pyramid_spec", "tile_env", "tile_grid_res"]

#: world extent every pyramid and tile grid is aligned to (the lean
#: sweep's envelope)
_WORLD = (-180.0, -90.0, 180.0, 90.0)

#: PartialCache spec-key tag for pyramid entries — the full spec is
#: ``(PYRAMID_SPEC, base)`` so pyramids built at different bases coexist
PYRAMID_SPEC = "pyramid"


def pyramid_spec(base: int) -> tuple:
    return (PYRAMID_SPEC, int(base))


class DensityPyramid:
    """One sealed generation's density pyramid: a dict of square float64
    world grids keyed by width (``base`` down the 2×2 ladder).  Exposes
    ``nbytes`` (the PartialCache byte-ceiling contract) and elementwise
    :meth:`sum` for compaction inheritance."""

    __slots__ = ("levels",)

    def __init__(self, levels: dict[int, np.ndarray]):
        self.levels = levels

    @classmethod
    def from_base(cls, base_grid: np.ndarray, levels: int = 0
                  ) -> "DensityPyramid":
        """The full pyramid of a square pow2 base grid through the numpy
        ladder (the device path passes its already-reduced levels to
        ``__init__``).  ``levels`` 0 = the full ladder down to 1×1."""
        base_grid = np.asarray(base_grid, np.float64)
        w = base_grid.shape[0]
        out = {w: base_grid}
        for g in pyramid_reduce_np(base_grid, _ladder_depth(w, levels)):
            out[g.shape[0]] = np.asarray(g, np.float64)
        return cls(out)

    @property
    def nbytes(self) -> int:
        return sum(g.nbytes for g in self.levels.values())

    @property
    def base(self) -> int:
        return max(self.levels)

    def level(self, width: int):
        """The (width, width) grid, or None when the ladder doesn't carry
        that resolution."""
        return self.levels.get(int(width))

    @staticmethod
    def sum(pyramids: list["DensityPyramid"]) -> "DensityPyramid | None":
        """Elementwise sum for compaction inheritance — defined only when
        every parent carries the same level set (None otherwise; the
        merged run then waits for the next build)."""
        if not pyramids:
            return None
        widths = set(pyramids[0].levels)
        if any(set(p.levels) != widths for p in pyramids[1:]):
            return None
        return DensityPyramid({
            w: np.sum([p.levels[w] for p in pyramids], axis=0)
            for w in widths})


def _ladder_depth(base: int, levels: int) -> int:
    """Reduction steps below the base: ``levels`` when positive, else the
    full ladder down to 1×1 (log2 of the base)."""
    full = max(0, int(base).bit_length() - 1)
    return min(full, int(levels)) if int(levels) > 0 else full


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
    resolution — the path the sealed generations' pyramids serve
    without scanning (the live run and any pyramid-less generation still
    sweep; results never change).  Finer zooms run the bbox density scan
    over just the tile's envelope, under the cell-granularity contract
    of docs/density.md."""
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
