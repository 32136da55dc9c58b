"""Density (heatmap) grids: weighted 2-D histograms on the tensors' device.

The aggregation the reference pushes to tablet servers as DensityScan /
DensityIterator (geomesa-index-api/.../iterators/DensityScan.scala:31-109:
snap each feature to a W×H grid over the query envelope via GridSnap,
accumulate weights per cell, merge partial grids client-side).  Here the
grid is a dense tensor.  ``density_grid_auto`` runs the hand-written
density kernel (``ops/density_kernel.py``) on CUDA tensors and the plain
float64 scatter-add, :func:`density_grid`, on the CPU, as the JAX
package runs its XLA scatter off the TPU.
"""

from __future__ import annotations

import torch

from .density_kernel import density_grid_kernel, grid_snap

__all__ = ["density_grid", "density_grid_auto", "density_grid_sorted",
           "grid_snap", "pyramid_reduce", "pyramid_reduce_np"]


def density_grid(x, y, weights, mask, env, width: int, height: int):
    """Masked weighted histogram: (N,) coords → (height, width) float64
    grid, by one scatter-add.

    ``mask`` selects the features that passed the query filter;
    ``weights`` is the DENSITY_WEIGHT expression column (ones for plain
    counts).
    """
    ix, iy = grid_snap(x, y, env, width, height)
    w = torch.where(mask, weights, torch.zeros_like(weights))
    grid = torch.zeros(width * height, dtype=torch.float64, device=x.device)
    grid.index_add_(0, iy * width + ix, w.to(torch.float64))
    return grid.reshape(height, width)


def density_grid_sorted(x, y, weights, mask, env, width: int, height: int):
    """Sort-by-cell histogram: sort (cell, weight) pairs, then per-cell
    segment sums via cumsum differences at searchsorted cell boundaries.
    The float32-cast weights accumulate in float64, with the per-cell sums
    rounded to the float32 output grid; masked rows sort to a sentinel
    cell past the grid."""
    ix, iy = grid_snap(x, y, env, width, height)
    g = width * height
    flat = torch.where(mask, iy * width + ix, torch.full_like(ix, g))
    w = torch.where(mask, weights, torch.zeros_like(weights)).to(torch.float32)
    flat_s, order = torch.sort(flat, stable=True)
    cw = torch.cat([torch.zeros(1, dtype=torch.float64, device=x.device),
                    torch.cumsum(w[order].to(torch.float64), 0)])
    bounds = torch.searchsorted(
        flat_s, torch.arange(g + 1, dtype=flat_s.dtype, device=x.device),
        side="left")
    grid = (cw[bounds[1:]] - cw[bounds[:-1]]).to(torch.float32)
    return grid.reshape(height, width)


def pyramid_reduce(grid: torch.Tensor, levels: int) -> tuple:
    """2×2 reduction ladder for density pyramids, on the grid's device:
    fold a square power-of-two (w, w) float64 cell-count grid into
    ``levels`` successively-halved sum grids ``(w/2, ..., w/2^levels)``.

    Each level is an EXACT 2×2 block sum of its parent — counts are
    integers carried in float64 (exact below 2^53), so any level equals
    binning the raw points at that resolution, bit for bit.  The JAX
    package runs this as plain XLA (no Pallas kernel), so plain torch is
    its counterpart here."""
    out = []
    g = grid
    for _ in range(levels):
        h, w = g.shape
        g = g.reshape(h // 2, 2, w // 2, 2).sum(dim=(1, 3))
        out.append(g)
    return tuple(out)


def pyramid_reduce_np(grid, levels: int) -> tuple:
    """Numpy twin of :func:`pyramid_reduce` for host-tier (spilled) run
    grids — the same exact 2×2 integer-in-float64 block sums."""
    out = []
    g = grid
    for _ in range(levels):
        h, w = g.shape
        g = g.reshape(h // 2, 2, w // 2, 2).sum(axis=(1, 3))
        out.append(g)
    return tuple(out)


def density_grid_auto(x, y, weights, mask, env, width: int, height: int):
    """Dispatch: the density kernel for CUDA tensors (float32 grid, for
    every N), the float64 scatter-add on the CPU.

    The JAX package picks among three TPU programs by size
    (``_SORTED_MIN_N = 2_000_000`` and an ``n·G >= 6e10`` cut), a
    crossover measured on a TPU v5e for its O(n·G) one-hot matrix
    product.  Those numbers say nothing about this card and are not
    carried over: the CUDA kernel's work is O(n) at any grid size."""
    if x.device.type == "cuda":
        return density_grid_kernel(x, y, weights, mask, env, width, height)
    return density_grid(x, y, weights, mask, env, width, height)
