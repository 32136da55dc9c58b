"""XZ2 index: intersects queries over geometries with extent (polygons,
lines).

The port's copy of the JAX package's host XZ2 index, the analog of the
reference's XZ2 index (geomesa-index-api/.../index/z2/
XZ2IndexKeySpace.scala — key = ``[shard][8B sequence code][id]``): one
sorted int64 code column + permutation, with bbox columns for the
candidate prefilter and packed geometries for the exact predicate.

Scan = searchsorted over covering code ranges (host numpy, as in the JAX
package: the column is small relative to point tables and the exact
geometry re-check dominates) → bbox mask → exact ``packed_intersects``.
The bbox prefilter plays the role the reference's server-side filters
play; the exact stage mirrors its client/iterator CQL re-check.
"""

from __future__ import annotations

import numpy as np

from ..config import DEFAULT_MAX_RANGES
from ..curve.xz2 import XZ2SFC, xz2_sfc
from ..geometry.packed import PackedGeometry, pack_geometries
from ..geometry.predicates import bbox_intersects, packed_intersects
from ..geometry.types import Geometry, Polygon

__all__ = ["XZ2Index"]


class XZ2Index:
    """Host XZ2 index over non-point geometries."""

    def __init__(self, g: int, codes, pos, bbox, geoms: PackedGeometry | None):
        self.sfc: XZ2SFC = xz2_sfc(g)
        self.codes = codes        # (N,) int64 sorted
        self.pos = pos            # (N,) int32 permutation
        self.bbox = bbox          # (N, 4) float64, original order
        self.geoms = geoms        # packed geometries, original order

    @classmethod
    def build(cls, geoms, g: int = 12) -> "XZ2Index":
        packed = geoms if isinstance(geoms, PackedGeometry) else pack_geometries(geoms)
        bb = packed.bbox
        codes = xz2_sfc(g).index(bb[:, 0], bb[:, 1], bb[:, 2], bb[:, 3])
        order = np.argsort(codes, kind="stable")
        return cls(g, codes[order].astype(np.int64), order.astype(np.int32),
                   bb, packed)

    def __len__(self) -> int:
        return len(self.codes)

    def query(self, geometry: Geometry,
              max_ranges: int = DEFAULT_MAX_RANGES,
              exact: bool = True) -> np.ndarray:
        """Original-order positions of geometries intersecting ``geometry``
        (candidates, envelope-exact, when ``exact`` is False)."""
        env = geometry.envelope
        ranges = self.sfc.ranges([env.as_tuple()], max_ranges=max_ranges)
        if not len(ranges) or not len(self):
            return np.empty(0, dtype=np.int64)
        starts = np.searchsorted(self.codes, ranges[:, 0], side="left")
        ends = np.searchsorted(self.codes, ranges[:, 1], side="right")
        cand = np.concatenate([self.pos[s:e] for s, e in zip(starts, ends)])
        if cand.size == 0:
            return np.empty(0, dtype=np.int64)
        cand = cand[bbox_intersects(self.bbox[cand], env.as_tuple())]
        if exact and self.geoms is not None and not _is_envelope(geometry, env):
            cand = cand[packed_intersects(self.geoms, geometry, cand)]
        return np.sort(cand).astype(np.int64)


def _is_envelope(geometry: Geometry, env) -> bool:
    """True when the query geometry IS its envelope (a bbox query) — the
    bbox prefilter is then already exact at envelope granularity."""
    if not isinstance(geometry, Polygon) or geometry.holes:
        return False
    shell = geometry.shell
    if len(shell) != 5:
        return False
    xs = set(shell[:, 0].tolist())
    ys = set(shell[:, 1].tolist())
    return xs == {env.xmin, env.xmax} and ys == {env.ymin, env.ymax}
