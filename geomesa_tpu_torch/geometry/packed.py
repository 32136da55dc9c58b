"""Packed SoA geometry columns: flat buffers for batches of geometries.

The reference serializes geometries per-row with WKB/TWKB codecs
(geomesa-features/.../serialization/TwkbSerialization.scala) because its
storage is row-oriented KV.  Device-resident columnar storage wants the
opposite: one flat coordinate buffer plus offset arrays (arrow-style
nesting), so vertex data can live in HBM and predicates can run as dense
array ops.

Nesting model (three levels, covering all seven WKT families):

``geometry → part → ring → coords``

* Point/LineString: 1 part, 1 ring.
* MultiPoint: 1 part, 1 ring (the point list).
* Polygon: 1 part, ring 0 = shell, rings 1.. = holes.
* MultiLineString: one part per line.
* MultiPolygon: one part per polygon.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .types import (
    Geometry,
    LineString,
    MultiLineString,
    MultiPoint,
    MultiPolygon,
    Point,
    Polygon,
)

__all__ = ["PackedGeometry", "pack_geometries", "packed_from_boxes",
           "GEOM_KIND"]

GEOM_KIND = {
    "Point": 0, "MultiPoint": 1, "LineString": 2,
    "MultiLineString": 3, "Polygon": 4, "MultiPolygon": 5,
}
_KIND_NAMES = {v: k for k, v in GEOM_KIND.items()}


def _expand_ranges_np(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenate ``arange(starts[k], starts[k]+counts[k])`` for all k
    (vectorized; the classic cumsum-of-deltas trick)."""
    starts = np.asarray(starts, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.int64)
    nz = counts > 0
    starts, counts = starts[nz], counts[nz]
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    out = np.ones(total, dtype=np.int64)
    ends = np.cumsum(counts)
    out[0] = starts[0]
    out[ends[:-1]] = starts[1:] - (starts[:-1] + counts[:-1] - 1)
    return np.cumsum(out)


@dataclass
class PackedGeometry:
    """A column of N geometries in flat SoA buffers."""

    kinds: np.ndarray             # (N,) int8
    coords: np.ndarray            # (C, 2) float64
    ring_offsets: np.ndarray      # (R+1,) int64 → coords
    part_ring_offsets: np.ndarray # (P+1,) int64 → rings
    geom_part_offsets: np.ndarray # (N+1,) int64 → parts
    bbox: np.ndarray              # (N, 4) float64: xmin, ymin, xmax, ymax

    def __len__(self) -> int:
        return len(self.kinds)

    def geometry(self, i: int) -> Geometry:
        """Reconstruct the i-th geometry object (host-side)."""
        kind = _KIND_NAMES[int(self.kinds[i])]
        p0, p1 = self.geom_part_offsets[i], self.geom_part_offsets[i + 1]
        parts = []
        for p in range(p0, p1):
            r0, r1 = self.part_ring_offsets[p], self.part_ring_offsets[p + 1]
            rings = [
                self.coords[self.ring_offsets[r]:self.ring_offsets[r + 1]]
                for r in range(r0, r1)
            ]
            parts.append(rings)
        if kind == "Point":
            c = parts[0][0][0]
            return Point(float(c[0]), float(c[1]))
        if kind == "MultiPoint":
            return MultiPoint(parts[0][0])
        if kind == "LineString":
            return LineString(parts[0][0])
        if kind == "MultiLineString":
            return MultiLineString(tuple(LineString(p[0]) for p in parts))
        if kind == "Polygon":
            return Polygon(parts[0][0], tuple(parts[0][1:]))
        return MultiPolygon(tuple(Polygon(p[0], tuple(p[1:])) for p in parts))

    def take(self, positions) -> "PackedGeometry":
        """Row gather as pure offset arithmetic (CSR row selection) — no
        per-row geometry object rebuilds; the hot path for materializing
        non-point query results."""
        positions = np.asarray(positions)
        if positions.dtype == bool:
            positions = np.flatnonzero(positions)
        positions = positions.astype(np.int64)
        kinds = self.kinds[positions]
        bbox = self.bbox[positions]
        gp = self.geom_part_offsets
        part_counts = gp[positions + 1] - gp[positions]
        new_gp = np.concatenate([[0], np.cumsum(part_counts)])
        part_idx = _expand_ranges_np(gp[positions], part_counts)
        pr = self.part_ring_offsets
        ring_counts = pr[part_idx + 1] - pr[part_idx]
        new_pr = np.concatenate([[0], np.cumsum(ring_counts)])
        ring_idx = _expand_ranges_np(pr[part_idx], ring_counts)
        ro = self.ring_offsets
        coord_counts = ro[ring_idx + 1] - ro[ring_idx]
        new_ro = np.concatenate([[0], np.cumsum(coord_counts)])
        coord_idx = _expand_ranges_np(ro[ring_idx], coord_counts)
        return PackedGeometry(
            kinds=kinds, coords=self.coords[coord_idx],
            ring_offsets=new_ro, part_ring_offsets=new_pr,
            geom_part_offsets=new_gp, bbox=bbox)

    def concat(self, other: "PackedGeometry") -> "PackedGeometry":
        """Buffer concatenation with offset shifts (no object rebuilds)."""
        return PackedGeometry(
            kinds=np.concatenate([self.kinds, other.kinds]),
            coords=np.concatenate([self.coords, other.coords]),
            ring_offsets=np.concatenate(
                [self.ring_offsets,
                 other.ring_offsets[1:] + self.ring_offsets[-1]]),
            part_ring_offsets=np.concatenate(
                [self.part_ring_offsets,
                 other.part_ring_offsets[1:] + self.part_ring_offsets[-1]]),
            geom_part_offsets=np.concatenate(
                [self.geom_part_offsets,
                 other.geom_part_offsets[1:] + self.geom_part_offsets[-1]]),
            bbox=np.concatenate([self.bbox, other.bbox]))

    @staticmethod
    def concat_many(parts: list["PackedGeometry"]) -> "PackedGeometry":
        """One-pass concatenation of many packed columns (offset shifts
        computed per field) — pairwise ``concat`` over k chunks copies
        the accumulated buffers k times (O(total x k)); this copies
        each buffer exactly once."""
        if len(parts) == 1:
            return parts[0]

        def offsets(field: str) -> np.ndarray:
            arrs = [getattr(parts[0], field)]
            base = arrs[0][-1]
            for p in parts[1:]:
                o = getattr(p, field)
                arrs.append(o[1:] + base)
                base = base + o[-1]
            return np.concatenate(arrs)

        return PackedGeometry(
            kinds=np.concatenate([p.kinds for p in parts]),
            coords=np.concatenate([p.coords for p in parts]),
            ring_offsets=offsets("ring_offsets"),
            part_ring_offsets=offsets("part_ring_offsets"),
            geom_part_offsets=offsets("geom_part_offsets"),
            bbox=np.concatenate([p.bbox for p in parts]))

    def rings_of(self, i: int) -> list[np.ndarray]:
        """All rings of geometry i as coordinate arrays."""
        p0, p1 = self.geom_part_offsets[i], self.geom_part_offsets[i + 1]
        r0, r1 = self.part_ring_offsets[p0], self.part_ring_offsets[p1]
        return [
            self.coords[self.ring_offsets[r]:self.ring_offsets[r + 1]]
            for r in range(r0, r1)
        ]


def _rings_for(geom: Geometry) -> tuple[int, list[list[np.ndarray]]]:
    if isinstance(geom, Point):
        return GEOM_KIND["Point"], [[np.array([[geom.x, geom.y]])]]
    if isinstance(geom, MultiPoint):
        return GEOM_KIND["MultiPoint"], [[geom.coords]]
    if isinstance(geom, LineString):
        return GEOM_KIND["LineString"], [[geom.coords]]
    if isinstance(geom, MultiLineString):
        return GEOM_KIND["MultiLineString"], [[l.coords] for l in geom.lines]
    if isinstance(geom, Polygon):
        return GEOM_KIND["Polygon"], [[geom.shell, *geom.holes]]
    if isinstance(geom, MultiPolygon):
        return GEOM_KIND["MultiPolygon"], [
            [p.shell, *p.holes] for p in geom.polygons
        ]
    raise ValueError(f"cannot pack {geom!r}")


def pack_geometries(geoms) -> PackedGeometry:
    kinds = np.empty(len(geoms), dtype=np.int8)
    coords_parts: list[np.ndarray] = []
    ring_lens: list[int] = []
    part_ring_counts: list[int] = []
    geom_part_counts: list[int] = []
    bbox = np.empty((len(geoms), 4), dtype=np.float64)

    for i, g in enumerate(geoms):
        kind, parts = _rings_for(g)
        kinds[i] = kind
        geom_part_counts.append(len(parts))
        for rings in parts:
            part_ring_counts.append(len(rings))
            for ring in rings:
                coords_parts.append(np.asarray(ring, dtype=np.float64))
                ring_lens.append(len(ring))
        env = g.envelope
        bbox[i] = env.as_tuple()

    coords = (
        np.vstack(coords_parts) if coords_parts else np.empty((0, 2), np.float64)
    )
    ring_offsets = np.concatenate([[0], np.cumsum(ring_lens)]).astype(np.int64)
    part_ring_offsets = np.concatenate(
        [[0], np.cumsum(part_ring_counts)]).astype(np.int64)
    geom_part_offsets = np.concatenate(
        [[0], np.cumsum(geom_part_counts)]).astype(np.int64)
    return PackedGeometry(
        kinds=kinds, coords=coords, ring_offsets=ring_offsets,
        part_ring_offsets=part_ring_offsets,
        geom_part_offsets=geom_part_offsets, bbox=bbox,
    )


def packed_from_boxes(bbox: np.ndarray) -> "PackedGeometry":
    """Vectorized axis-aligned rectangles ``(n, 4)`` → packed polygons:
    the OBJECT-FREE bulk-ingest path (constructing 200M Python Polygon
    objects would dominate a scale build; real bulk feeds — building
    footprints, tiles, coverage cells — arrive as envelope arrays
    anyway).  Shells follow the packer's convention (closed ring, CCW
    corner order)."""
    bb = np.ascontiguousarray(np.asarray(bbox, np.float64)
                              .reshape((-1, 4)))
    n = len(bb)
    coords = np.empty((n * 5, 2), np.float64)
    coords[0::5] = bb[:, [0, 1]]
    coords[1::5] = bb[:, [2, 1]]
    coords[2::5] = bb[:, [2, 3]]
    coords[3::5] = bb[:, [0, 3]]
    coords[4::5] = bb[:, [0, 1]]
    idx = np.arange(n + 1, dtype=np.int64)
    return PackedGeometry(
        kinds=np.full(n, GEOM_KIND["Polygon"], np.int8),
        coords=coords,
        ring_offsets=idx * 5,
        part_ring_offsets=idx.copy(),
        geom_part_offsets=idx.copy(),
        bbox=bb.copy())
