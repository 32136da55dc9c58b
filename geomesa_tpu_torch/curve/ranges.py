"""Z-range decomposition: query boxes → covering morton-code ranges.

The reference outsources this to ``sfcurve``'s ``Z2.zranges`` / ``Z3.zranges``
(external dependency, geomesa-z3/pom.xml:16-17; called from
curve/Z2SFC.scala:52 and curve/Z3SFC.scala:61) and implements the analogous
BFS itself only for XZ curves (curve/XZ2SFC.scala:146-252).  This module
implements the decomposition once, generically over dimensionality, as a
**vectorized level-synchronous quad/octree sweep** in numpy: at each level
the whole frontier of candidate cells is classified (contained / overlapping
/ disjoint) with dense array comparisons — no per-node recursion or work
queue — which keeps planner latency low and translates directly to a
device formulation later if range decomposition ever needs to move on-chip.

Ranges are *covering* (a superset of the exact query cells) whenever the
``max_ranges`` budget truncates the descent — exactly the contract the
reference planner relies on (QueryProperties.ScanRangesTarget = 2000,
index/conf/QueryProperties.scala:22), with precise filtering re-applied to
candidates afterwards (filters/Z3Filter.scala semantics).  With no budget
pressure the result is exact and merged, matching sfcurve's output (e.g.
box (2,2)-(3,6) at any precision → 3 ranges, see Z2Test.scala
"calculate ranges").

The native C++ copy of the same sweep (:mod:`geomesa_tpu_torch.native`)
serves the call when its library is available; the numpy sweep below
serves it otherwise (and is the CPU tests' differential oracle).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_MAX_RANGES
from .zorder import deinterleave2, deinterleave3

__all__ = ["zranges", "merge_ranges"]


def _deinterleave(z: np.ndarray, dims: int):
    """Frontier cell corners → per-dimension ints, through the curve's
    own tensor bit algebra on the CPU (z < 2^63, so the int64 view is
    exact)."""
    zt = torch.from_numpy(np.ascontiguousarray(z).view(np.int64))
    parts = deinterleave2(zt) if dims == 2 else deinterleave3(zt)
    return torch.stack(parts).numpy().astype(np.uint64)


def merge_ranges(los: np.ndarray, his: np.ndarray) -> np.ndarray:
    """Sort + merge overlapping/adjacent inclusive [lo, hi] ranges → (R, 2)."""
    if los.size == 0:
        return np.empty((0, 2), dtype=np.int64)
    order = np.argsort(los, kind="stable")
    los, his = los[order], np.maximum.accumulate(his[order])
    # a range starts a new group when its lo is beyond the running hi + 1
    new_group = np.ones(los.shape, dtype=bool)
    new_group[1:] = los[1:] > his[:-1] + 1
    n_groups = int(np.count_nonzero(new_group))
    out = np.empty((n_groups, 2), dtype=np.int64)
    out[:, 0] = los[new_group]
    # his is a running max in sorted order, so the last element of each group
    # carries that group's max hi
    last_of_group = np.ones(los.shape, dtype=bool)
    last_of_group[:-1] = new_group[1:]
    out[:, 1] = his[last_of_group]
    return out


def zranges(
    mins: np.ndarray,
    maxs: np.ndarray,
    dims: int,
    bits: int,
    max_ranges: int | None = None,
    max_levels: int | None = None,
) -> np.ndarray:
    """Decompose normalized-int query boxes into covering z ranges.

    Args:
      mins, maxs: ``(B, dims)`` inclusive per-dimension normalized bounds.
      dims: 2 (quadtree) or 3 (octree).
      bits: bits per dimension (31 for Z2, 21 for Z3).
      max_ranges: budget on emitted ranges before merging; descent stops and
        remaining frontier cells are emitted as covering ranges once
        exceeded.  Defaults to 2000 (the reference planner's scan-ranges
        target).
      max_levels: optional cap on tree depth (coarser, fewer ranges) —
        the analog of sfcurve's ``precision`` argument.

    Returns:
      ``(R, 2)`` int64 array of inclusive, sorted, disjoint, merged
      ``[lo, hi]`` z ranges whose union covers (and with an unexhausted
      budget, exactly equals) the query cells.
    """
    mins = np.atleast_2d(np.asarray(mins, dtype=np.int64))
    maxs = np.atleast_2d(np.asarray(maxs, dtype=np.int64))
    if mins.shape != maxs.shape or mins.shape[1] != dims:
        raise ValueError(f"expected (B, {dims}) box bounds, got {mins.shape}/{maxs.shape}")
    budget = DEFAULT_MAX_RANGES if max_ranges is None else int(max_ranges)
    depth_cap = bits if max_levels is None else min(bits, int(max_levels))

    from .. import native

    res = native.zranges_native(mins, maxs, dims, bits, budget, depth_cap)
    if res is not None:
        return res

    mins = mins.astype(np.uint64)
    maxs = maxs.astype(np.uint64)
    fanout = 1 << dims

    # boxes as (B, d) for broadcasting against the (n, d) frontier
    bmin, bmax = mins, maxs

    frontier = np.zeros(1, dtype=np.uint64)  # z of each cell's min corner
    out_lo: list[np.ndarray] = []
    out_hi: list[np.ndarray] = []
    emitted = 0

    for level in range(depth_cap + 1):
        if frontier.size == 0:
            break
        side = np.uint64(1) << np.uint64(bits - level)        # cells per dim
        zsize = np.uint64(1) << np.uint64(dims * (bits - level))  # z extent
        cmin = _deinterleave(frontier, dims).T                 # (n, d)
        cmax = cmin + (side - np.uint64(1))
        # classify against every box: (n, B, d) -> (n,)
        contained = np.logical_and(
            cmin[:, None, :] >= bmin[None, :, :],
            cmax[:, None, :] <= bmax[None, :, :],
        ).all(axis=2).any(axis=1)
        overlaps = np.logical_and(
            cmin[:, None, :] <= bmax[None, :, :],
            cmax[:, None, :] >= bmin[None, :, :],
        ).all(axis=2).any(axis=1)

        if level == depth_cap:
            # bottom: emit every overlapping cell whole
            contained = overlaps
        emit = frontier[contained]
        if emit.size:
            out_lo.append(emit)
            out_hi.append(emit + (zsize - np.uint64(1)))
            emitted += emit.size
        rest = frontier[overlaps & ~contained]
        if rest.size == 0:
            break
        if emitted + rest.size * fanout > budget:
            # budget exhausted: emit the remaining frontier as covering ranges
            out_lo.append(rest)
            out_hi.append(rest + (zsize - np.uint64(1)))
            break
        child_zsize = np.uint64(1) << np.uint64(dims * (bits - level - 1))
        offsets = (np.arange(fanout, dtype=np.uint64) * child_zsize)[None, :]
        frontier = (rest[:, None] + offsets).reshape(-1)

    if not out_lo:
        return np.empty((0, 2), dtype=np.int64)
    los = np.concatenate(out_lo).astype(np.int64)
    his = np.concatenate(out_hi).astype(np.int64)
    return merge_ranges(los, his)
