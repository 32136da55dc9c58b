"""Vectorized geometry predicates.

The exact re-check stage of query evaluation: after index ranges produce
candidates (a superset), these predicates compute the final hit set — the
role the reference delegates to CQL geometry evaluation inside
FilterTransformIterator / FastFilterFactory (geomesa-filter).

All core tests are numpy-vectorized over points × segments.  Boundary
semantics follow JTS ``intersects``: points on a polygon boundary are
inside; touching segments intersect.
"""

from __future__ import annotations

import numpy as np

from .types import Envelope, Geometry, LineString, MultiLineString, MultiPoint, MultiPolygon, Point, Polygon

__all__ = [
    "bbox_intersects",
    "point_in_polygon",
    "points_in_packed_polygon",
    "points_on_rings",
    "segments_intersect",
    "geometry_intersects",
    "packed_intersects",
]

_EDGE_CHUNK = 4096  # bound the (points × edges) broadcast memory


def bbox_intersects(bbox: np.ndarray, window) -> np.ndarray:
    """(N, 4) bbox column vs one (xmin, ymin, xmax, ymax) window → mask."""
    bbox = np.asarray(bbox)
    return (
        (bbox[:, 0] <= window[2]) & (bbox[:, 2] >= window[0])
        & (bbox[:, 1] <= window[3]) & (bbox[:, 3] >= window[1])
    )


def _rings_of(geom: Geometry) -> list[np.ndarray]:
    if isinstance(geom, Polygon):
        return [geom.shell, *geom.holes]
    if isinstance(geom, MultiPolygon):
        out = []
        for p in geom.polygons:
            out.extend([p.shell, *p.holes])
        return out
    raise ValueError(f"expected polygonal geometry, got {geom.geom_type}")


def _crossing_parity(px: np.ndarray, py: np.ndarray, rings) -> np.ndarray:
    """Even-odd ray casting: odd number of upward/downward edge crossings to
    the right of the point ⇒ inside.  Holes flip parity naturally."""
    inside = np.zeros(px.shape, dtype=bool)
    for ring in rings:
        x1, y1 = ring[:-1, 0], ring[:-1, 1]
        x2, y2 = ring[1:, 0], ring[1:, 1]
        for s in range(0, len(x1), _EDGE_CHUNK):
            ex1, ey1 = x1[s:s + _EDGE_CHUNK], y1[s:s + _EDGE_CHUNK]
            ex2, ey2 = x2[s:s + _EDGE_CHUNK], y2[s:s + _EDGE_CHUNK]
            straddle = (ey1[None, :] > py[:, None]) != (ey2[None, :] > py[:, None])
            with np.errstate(divide="ignore", invalid="ignore"):
                xint = ex1[None, :] + (py[:, None] - ey1[None, :]) / (
                    ey2[None, :] - ey1[None, :]
                ) * (ex2[None, :] - ex1[None, :])
            hits = straddle & (px[:, None] < xint)
            inside ^= (np.sum(hits, axis=1) % 2).astype(bool)
    return inside


def points_on_rings(px: np.ndarray, py: np.ndarray, rings, eps: float = 0.0) -> np.ndarray:
    """True where a point lies exactly on any ring segment (boundary)."""
    on = np.zeros(px.shape, dtype=bool)
    for ring in rings:
        x1, y1 = ring[:-1, 0], ring[:-1, 1]
        x2, y2 = ring[1:, 0], ring[1:, 1]
        for s in range(0, len(x1), _EDGE_CHUNK):
            ex1, ey1 = x1[s:s + _EDGE_CHUNK], y1[s:s + _EDGE_CHUNK]
            ex2, ey2 = x2[s:s + _EDGE_CHUNK], y2[s:s + _EDGE_CHUNK]
            dx, dy = ex2 - ex1, ey2 - ey1
            vx = px[:, None] - ex1[None, :]
            vy = py[:, None] - ey1[None, :]
            cross = np.abs(vx * dy[None, :] - vy * dx[None, :])
            dot = vx * dx[None, :] + vy * dy[None, :]
            sq = (dx * dx + dy * dy)[None, :]
            on |= ((cross <= eps * np.sqrt(np.maximum(sq, 1e-300)))
                   & (dot >= 0) & (dot <= sq)).any(axis=1) if eps else (
                (cross == 0) & (dot >= 0) & (dot <= sq)).any(axis=1)
    return on


def point_in_polygon(px, py, geom: Geometry, include_boundary: bool = True) -> np.ndarray:
    """Vectorized point-in-(Multi)Polygon with even-odd hole handling."""
    px = np.asarray(px, dtype=np.float64)
    py = np.asarray(py, dtype=np.float64)
    rings = _rings_of(geom)
    inside = _crossing_parity(px, py, rings)
    if include_boundary and inside.ndim and not inside.all():
        # boundary test only for parity-outside points (x|y == x|(y&~x))
        # — the on-segment broadcast is the costlier half
        out = np.flatnonzero(~inside)
        inside[out] = points_on_rings(px[out], py[out], rings)
    elif include_boundary and not inside.ndim:
        inside = inside | points_on_rings(px, py, rings)
    return inside


def points_in_packed_polygon(px, py, packed, i: int) -> np.ndarray:
    """Point-in-polygon against geometry ``i`` of a PackedGeometry column."""
    rings = packed.rings_of(i)
    px = np.asarray(px, dtype=np.float64)
    py = np.asarray(py, dtype=np.float64)
    return _crossing_parity(px, py, rings) | points_on_rings(px, py, rings)


def _segment_orientations(p1, p2, q1, q2):
    """Broadcast (A,2)×(B,2) endpoints to the four orientation terms the
    crossing tests share; returns (p1, p2, q1, q2, d1, d2, d3, d4) with
    operands reshaped to (A, 1, 2)/(1, B, 2)."""
    p1 = np.asarray(p1, np.float64)[:, None, :]
    p2 = np.asarray(p2, np.float64)[:, None, :]
    q1 = np.asarray(q1, np.float64)[None, :, :]
    q2 = np.asarray(q2, np.float64)[None, :, :]

    def cross(o, a, b):
        return (a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1]) - (
            a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0])

    d1 = cross(q1, q2, p1)
    d2 = cross(q1, q2, p2)
    d3 = cross(p1, p2, q1)
    d4 = cross(p1, p2, q2)
    return p1, p2, q1, q2, d1, d2, d3, d4


def _proper_mask(d1, d2, d3, d4) -> np.ndarray:
    return ((((d1 > 0) & (d2 < 0)) | ((d1 < 0) & (d2 > 0)))
            & (((d3 > 0) & (d4 < 0)) | ((d3 < 0) & (d4 > 0))))


def segments_intersect(p1, p2, q1, q2) -> np.ndarray:
    """Vectorized proper-or-touching segment intersection.

    ``p1, p2``: (A, 2) segment endpoints; ``q1, q2``: (B, 2).  Returns
    (A, B) boolean matrix.  Uses orientation sign tests with collinear
    overlap handled by bbox checks.
    """
    p1, p2, q1, q2, d1, d2, d3, d4 = _segment_orientations(p1, p2, q1, q2)
    proper = _proper_mask(d1, d2, d3, d4)

    def on_bbox(a1, a2, b):
        return (
            (b[..., 0] >= np.minimum(a1[..., 0], a2[..., 0]))
            & (b[..., 0] <= np.maximum(a1[..., 0], a2[..., 0]))
            & (b[..., 1] >= np.minimum(a1[..., 1], a2[..., 1]))
            & (b[..., 1] <= np.maximum(a1[..., 1], a2[..., 1]))
        )

    touch = (
        ((d1 == 0) & on_bbox(q1, q2, p1))
        | ((d2 == 0) & on_bbox(q1, q2, p2))
        | ((d3 == 0) & on_bbox(p1, p2, q1))
        | ((d4 == 0) & on_bbox(p1, p2, q2))
    )
    return proper | touch


def _segments(geom: Geometry) -> tuple[np.ndarray, np.ndarray]:
    rings: list[np.ndarray] = []
    if isinstance(geom, LineString):
        rings = [geom.coords]
    elif isinstance(geom, MultiLineString):
        rings = [l.coords for l in geom.lines]
    elif isinstance(geom, (Polygon, MultiPolygon)):
        rings = _rings_of(geom)
    else:
        return np.empty((0, 2)), np.empty((0, 2))
    a = np.vstack([r[:-1] for r in rings]) if rings else np.empty((0, 2))
    b = np.vstack([r[1:] for r in rings]) if rings else np.empty((0, 2))
    return a, b


def _points_of(geom: Geometry) -> np.ndarray:
    if isinstance(geom, Point):
        return np.array([[geom.x, geom.y]])
    if isinstance(geom, MultiPoint):
        return geom.coords
    if isinstance(geom, LineString):
        return geom.coords
    if isinstance(geom, MultiLineString):
        return np.vstack([l.coords for l in geom.lines])
    if isinstance(geom, Polygon):
        return geom.shell
    if isinstance(geom, MultiPolygon):
        return np.vstack([p.shell for p in geom.polygons])
    raise ValueError(geom)


def all_vertices(geom: Geometry) -> np.ndarray:
    """Every vertex of a geometry, INCLUDING polygon hole rings (unlike
    ``_points_of``, whose shell-only view suffices for intersection
    seeding but not for distance)."""
    if isinstance(geom, (Polygon, MultiPolygon)):
        return np.vstack(_rings_of(geom))
    return _points_of(geom)


def points_to_geometry_dist(px, py, geom: Geometry) -> np.ndarray:
    """Vectorized planar distance (coordinate units) from points to a
    geometry: 0 inside polygons / on lines, else distance to the nearest
    vertex/segment.  Segment work is chunked to bound the (N × S)
    broadcast (same discipline as the edge-chunked predicates)."""
    px = np.asarray(px, dtype=np.float64)
    py = np.asarray(py, dtype=np.float64)
    out = np.full(px.shape, np.inf)
    if isinstance(geom, (Point, MultiPoint)):
        pts = _points_of(geom)
        for qx, qy in pts:
            out = np.minimum(out, np.hypot(px - qx, py - qy))
        return out
    a, b = _segments(geom)
    for s0 in range(0, len(a), _EDGE_CHUNK):
        aa = a[s0:s0 + _EDGE_CHUNK]
        bb = b[s0:s0 + _EDGE_CHUNK]
        ax, ay = aa[:, 0], aa[:, 1]
        bx, by = bb[:, 0], bb[:, 1]
        dx, dy = bx - ax, by - ay
        ln2 = dx * dx + dy * dy
        ln2 = np.where(ln2 == 0, 1.0, ln2)
        t = ((px[:, None] - ax[None, :]) * dx[None, :]
             + (py[:, None] - ay[None, :]) * dy[None, :]) / ln2[None, :]
        t = np.clip(t, 0.0, 1.0)
        cx = ax[None, :] + t * dx[None, :]
        cy = ay[None, :] + t * dy[None, :]
        d = np.hypot(px[:, None] - cx, py[:, None] - cy)
        out = np.minimum(out, d.min(axis=1))
    if isinstance(geom, (Polygon, MultiPolygon)):
        inside = point_in_polygon(px, py, geom)
        out = np.where(inside, 0.0, out)
    return out


def geometry_to_point_dist(geom: Geometry, qx: float, qy: float) -> float:
    """Planar distance from a geometry to a point (0 when the point is
    inside/on the geometry)."""
    if isinstance(geom, Point):
        return float(np.hypot(geom.x - qx, geom.y - qy))
    return float(points_to_geometry_dist(
        np.array([qx]), np.array([qy]), geom)[0])


def segments_cross_properly(p1, p2, q1, q2) -> np.ndarray:
    """Strict interior crossings only (touching/collinear excluded) —
    the test that distinguishes "within with boundary contact" from a
    genuine boundary violation."""
    _, _, _, _, d1, d2, d3, d4 = _segment_orientations(p1, p2, q1, q2)
    return _proper_mask(d1, d2, d3, d4)


def geometry_within(a: Geometry, b: Geometry) -> bool:
    """``a`` within ``b`` (boundary contact allowed): every vertex of
    ``a`` (hole rings included) lies in the closure of ``b`` and no
    segment of ``a`` properly crosses ``b``'s boundary.  Exact for the
    supported lattice up to degenerate collinear-overlap edge cases."""
    if not b.envelope.contains(a.envelope):
        return False
    if isinstance(b, (Polygon, MultiPolygon)):
        va = all_vertices(a)
        if not point_in_polygon(va[:, 0], va[:, 1], b).all():
            return False
        a1, a2 = _segments(a)
        b1, b2 = _segments(b)
        if len(a1) and len(b1) and bool(
                segments_cross_properly(a1, a2, b1, b2).any()):
            return False
        if len(a1):
            # a segment can leave b between two boundary vertices with
            # only touching (no proper) crossings — e.g. a chord across a
            # notch; its midpoint betrays it
            mx = (a1[:, 0] + a2[:, 0]) / 2
            my = (a1[:, 1] + a2[:, 1]) / 2
            if not point_in_polygon(mx, my, b).all():
                return False
        if isinstance(a, (Polygon, MultiPolygon)):
            # a hole of b lying strictly inside a's interior escapes both
            # tests above; any b-ring vertex strictly inside a betrays it
            vb = all_vertices(b)
            inside = point_in_polygon(vb[:, 0], vb[:, 1], a)
            if inside.any():
                idx = np.flatnonzero(inside)
                a_rings = _rings_of(a)
                on_edge = points_on_rings(vb[idx, 0], vb[idx, 1], a_rings)
                if bool((~on_edge).any()):
                    return False
        return True
    if isinstance(b, (LineString, MultiLineString)):
        # only puntal/lineal a can be within a line; vertices AND segment
        # midpoints must sit on it (vertices alone miss a diagonal whose
        # endpoints touch the line but whose body leaves it)
        if isinstance(a, (Polygon, MultiPolygon)):
            return False
        va = all_vertices(a)
        rings = ([b.coords] if isinstance(b, LineString)
                 else [l.coords for l in b.lines])
        if not bool(points_on_rings(va[:, 0], va[:, 1], rings).all()):
            return False
        a1, a2 = _segments(a)
        if len(a1):
            mx = (a1[:, 0] + a2[:, 0]) / 2
            my = (a1[:, 1] + a2[:, 1]) / 2
            if not bool(points_on_rings(mx, my, rings).all()):
                return False
        return True
    # b is (multi)point: a must be a coincident (multi)point
    if isinstance(a, (Point, MultiPoint)):
        bp = {tuple(p) for p in _points_of(b)}
        return all(tuple(p) in bp for p in _points_of(a))
    return False


def geometry_distance(a: Geometry, b: Geometry) -> float:
    """Planar min distance between two geometries (0 when intersecting).

    For non-crossing segment sets the minimum is attained at a vertex of
    one operand, so min(vertices(a)→b, vertices(b)→a) is exact once
    crossings are handled by the intersects check."""
    if geometry_intersects(a, b):
        return 0.0
    va = all_vertices(a)
    vb = all_vertices(b)
    d1 = points_to_geometry_dist(va[:, 0], va[:, 1], b).min()
    d2 = points_to_geometry_dist(vb[:, 0], vb[:, 1], a).min()
    return float(min(d1, d2))


def geometry_intersects(a: Geometry, b: Geometry) -> bool:
    """JTS-style ``intersects`` dispatch over the supported type lattice."""
    if not a.envelope.intersects(b.envelope):
        return False
    a_poly = isinstance(a, (Polygon, MultiPolygon))
    b_poly = isinstance(b, (Polygon, MultiPolygon))
    a_pts = _points_of(a)
    b_pts = _points_of(b)
    # vertex containment either direction
    if b_poly and point_in_polygon(a_pts[:, 0], a_pts[:, 1], b).any():
        return True
    if a_poly and point_in_polygon(b_pts[:, 0], b_pts[:, 1], a).any():
        return True
    # point-only operands are settled by containment / coincidence
    if isinstance(a, (Point, MultiPoint)) or isinstance(b, (Point, MultiPoint)):
        if isinstance(a, (Point, MultiPoint)) and isinstance(b, (Point, MultiPoint)):
            return bool(
                (np.abs(a_pts[:, None, :] - b_pts[None, :, :]).sum(axis=2) == 0).any()
            )
        pts, other = (a_pts, b) if isinstance(a, (Point, MultiPoint)) else (b_pts, a)
        if isinstance(other, (LineString, MultiLineString)):
            s1, s2 = _segments(other)
            rings = [np.vstack([p1, p2]) for p1, p2 in zip(s1, s2)]
            return bool(points_on_rings(pts[:, 0], pts[:, 1], rings).any())
        return False  # polygon cases already handled above
    # segment crossings
    a1, a2 = _segments(a)
    b1, b2 = _segments(b)
    if a1.size and b1.size:
        # chunk to bound memory
        for s in range(0, len(a1), _EDGE_CHUNK):
            if segments_intersect(a1[s:s + _EDGE_CHUNK], a2[s:s + _EDGE_CHUNK], b1, b2).any():
                return True
    return False


#: candidates per block for the packed re-check's broadcast stages
_CAND_CHUNK = 1 << 16


def _packed_edges(sub, pt_kind_of_coord: np.ndarray):
    """Edge endpoint indices of a PackedGeometry: consecutive coord pairs
    within each ring, excluding point-kind geometries (their 'rings' are
    point lists, not polylines)."""
    ro = sub.ring_offsets
    C = len(sub.coords)
    emask = np.ones(C, dtype=bool)
    emask[np.maximum(ro[1:] - 1, 0)] = False  # last coord of each ring
    emask &= ~pt_kind_of_coord
    return np.flatnonzero(emask)


def packed_intersects(packed, query: Geometry,
                      positions=None) -> np.ndarray:
    """Vectorized JTS-style ``intersects`` of EVERY candidate geometry in
    a PackedGeometry column against ONE query geometry.

    The batched form of :func:`geometry_intersects` — identical test
    structure (envelope → vertex containment both ways → point-kind
    coincidence/on-line → segment crossings) evaluated as dense array
    ops over the SoA buffers, replacing the per-candidate Python loop of
    the exact re-check (the server-side filter role,
    accumulo/data/AccumuloIndexAdapter.scala:181-195).  Returns a bool
    mask aligned with ``positions`` (or the whole column)."""
    sub = (packed if positions is None
           else packed.take(np.asarray(positions, dtype=np.int64)))
    n = len(sub)
    if n == 0:
        return np.zeros(0, dtype=bool)
    env = query.envelope
    alive = bbox_intersects(sub.bbox, env.as_tuple())
    hit = np.zeros(n, dtype=bool)
    if not alive.any():
        return hit

    gp, pr, ro = (sub.geom_part_offsets, sub.part_ring_offsets,
                  sub.ring_offsets)
    coords = sub.coords
    kinds = sub.kinds
    poly_kind = (kinds == 4) | (kinds == 5)
    line_kind = (kinds == 2) | (kinds == 3)
    pt_kind = (kinds == 0) | (kinds == 1)
    ring_geom = np.repeat(np.arange(n), pr[gp[1:]] - pr[gp[:-1]])
    coord_ring = np.repeat(np.arange(len(ro) - 1), np.diff(ro))
    coord_geom = ring_geom[coord_ring]
    part_of_ring = np.repeat(np.arange(len(pr) - 1), np.diff(pr))
    ring_rank = np.arange(len(ro) - 1) - pr[part_of_ring]

    b_poly = isinstance(query, (Polygon, MultiPolygon))
    b_line = isinstance(query, (LineString, MultiLineString))
    b_pt = isinstance(query, (Point, MultiPoint))
    b_pts = _points_of(query)

    # --- any A vertex in B (B polygonal); shell-only for polygon
    # candidates, all coords otherwise (_points_of semantics) ---
    if b_poly:
        a_pts_sel = ((~poly_kind[coord_geom])
                     | (ring_rank[coord_ring] == 0)) & alive[coord_geom]
        idx = np.flatnonzero(a_pts_sel)
        if len(idx):
            inb = point_in_polygon(coords[idx, 0], coords[idx, 1], query)
            np.logical_or.at(hit, coord_geom[idx], inb)

    # --- edges of line/poly candidates (owner per edge) ---
    eidx = _packed_edges(sub, pt_kind[coord_geom])
    e_owner = coord_geom[eidx]

    # --- any B vertex in A (A polygonal): per-candidate crossing parity
    # + boundary, chunked over candidate blocks ---
    poly_alive = np.flatnonzero(poly_kind & alive & ~hit)
    if len(poly_alive) and len(b_pts):
        pxq, pyq = b_pts[:, 0], b_pts[:, 1]
        # restrict to edges owned by live polygon candidates
        want = np.zeros(n, dtype=bool)
        want[poly_alive] = True
        esel = np.flatnonzero(want[e_owner])
        ea, eb = coords[eidx[esel]], coords[eidx[esel] + 1]
        eg = e_owner[esel]
        # chunk boundaries MUST align to candidate edge groups: a
        # candidate's crossing parity is over ALL its edges (splitting
        # a group across chunks would break the mod-2)
        group_starts = np.flatnonzero(np.r_[True, eg[1:] != eg[:-1]]) \
            if len(eg) else np.empty(0, np.int64)
        group_ends = np.r_[group_starts[1:], len(eg)] \
            if len(eg) else np.empty(0, np.int64)
        budget = max(int(_EDGE_CHUNK * 8 // max(len(pxq), 1)), 1)
        gi = 0
        while gi < len(group_starts):
            gj = gi  # extend while the NEXT group still fits the budget
            while (gj + 1 < len(group_starts)
                   and group_ends[gj + 1] - group_starts[gi] <= budget):
                gj += 1
            sl = slice(int(group_starts[gi]), int(group_ends[gj]))
            x1, y1 = ea[sl, 0], ea[sl, 1]
            x2, y2 = eb[sl, 0], eb[sl, 1]
            g = eg[sl]
            straddle = ((y1[None, :] > pyq[:, None])
                        != (y2[None, :] > pyq[:, None]))
            with np.errstate(divide="ignore", invalid="ignore"):
                xint = x1[None, :] + (pyq[:, None] - y1[None, :]) / (
                    y2[None, :] - y1[None, :]) * (x2[None, :] - x1[None, :])
            cross = straddle & (pxq[:, None] < xint)
            # boundary: B vertex exactly on the edge
            dx, dy = x2 - x1, y2 - y1
            vx = pxq[:, None] - x1[None, :]
            vy = pyq[:, None] - y1[None, :]
            crs = vx * dy[None, :] - vy * dx[None, :]
            dot = vx * dx[None, :] + vy * dy[None, :]
            sq = (dx * dx + dy * dy)[None, :]
            on = (crs == 0) & (dot >= 0) & (dot <= sq)
            # parity per (vertex, candidate): segment-sum crossings into
            # per-candidate bins (edges are candidate-contiguous)
            cuts = np.flatnonzero(np.r_[True, g[1:] != g[:-1]])
            owners = g[cuts]
            counts = np.add.reduceat(cross.astype(np.int32), cuts, axis=1)
            inside = (counts % 2).astype(bool)
            on_any = np.maximum.reduceat(on, cuts, axis=1)
            np.logical_or.at(hit, owners, (inside | on_any).any(axis=0))
            gi = gj + 1

    # --- point-kind candidates vs point/line queries ---
    if (b_pt or b_line):
        pt_alive = pt_kind & alive & ~hit
        idx = np.flatnonzero(pt_alive[coord_geom])
        if len(idx):
            px, py = coords[idx, 0], coords[idx, 1]
            if b_pt:
                same = ((px[:, None] == b_pts[None, :, 0])
                        & (py[:, None] == b_pts[None, :, 1])).any(axis=1)
            else:
                s1, s2 = _segments(query)
                rings = [np.vstack([p1, p2]) for p1, p2 in zip(s1, s2)]
                same = points_on_rings(px, py, rings)
            np.logical_or.at(hit, coord_geom[idx], same)

    # --- B point-kind vs line candidates: B points on A edges ---
    if b_pt:
        line_alive = np.zeros(n, dtype=bool)
        line_alive[np.flatnonzero(line_kind & alive & ~hit)] = True
        esel = np.flatnonzero(line_alive[e_owner])
        if len(esel):
            ea, eb = coords[eidx[esel]], coords[eidx[esel] + 1]
            eg = e_owner[esel]
            dx = eb[:, 0] - ea[:, 0]
            dy = eb[:, 1] - ea[:, 1]
            vx = b_pts[:, None, 0] - ea[None, :, 0]
            vy = b_pts[:, None, 1] - ea[None, :, 1]
            crs = vx * dy[None, :] - vy * dx[None, :]
            dot = vx * dx[None, :] + vy * dy[None, :]
            sq = (dx * dx + dy * dy)[None, :]
            on = ((crs == 0) & (dot >= 0) & (dot <= sq)).any(axis=0)
            np.logical_or.at(hit, eg, on)

    # --- segment crossings: A edges × B segments ---
    if not b_pt:
        q1, q2 = _segments(query)
        if len(q1):
            seg_alive = np.zeros(n, dtype=bool)
            seg_alive[np.flatnonzero((line_kind | poly_kind)
                                     & alive & ~hit)] = True
            esel = np.flatnonzero(seg_alive[e_owner])
            ea, eb = coords[eidx[esel]], coords[eidx[esel] + 1]
            eg = e_owner[esel]
            for s in range(0, len(ea), _EDGE_CHUNK):
                sl = slice(s, s + _EDGE_CHUNK)
                crossing = segments_intersect(ea[sl], eb[sl], q1, q2)
                np.logical_or.at(hit, eg[sl], crossing.any(axis=1))

    return hit & alive


def _strict_inside(pts: np.ndarray, poly: Geometry) -> np.ndarray:
    """Points strictly interior to a polygonal geometry (boundary
    excluded)."""
    if not len(pts):
        return np.zeros(0, dtype=bool)
    inside = point_in_polygon(pts[:, 0], pts[:, 1], poly,
                              include_boundary=True)
    on = points_on_rings(pts[:, 0], pts[:, 1], _rings_of(poly))
    return inside & ~on


def _interiors_intersect(a: Geometry, b: Geometry) -> bool:
    """Do the interiors of a and b intersect? (approximate DE-9IM
    interior-interior test: proper segment crossings + strict vertex /
    midpoint containment — exact for the supported lattice up to
    collinear-overlap degeneracies)."""
    a_poly = isinstance(a, (Polygon, MultiPolygon))
    b_poly = isinstance(b, (Polygon, MultiPolygon))
    a1, a2 = _segments(a)
    b1, b2 = _segments(b)
    if a1.size and b1.size and bool(
            segments_cross_properly(a1, a2, b1, b2).any()):
        return True
    if b_poly:
        va = all_vertices(a)
        if bool(_strict_inside(va, b).any()):
            return True
        if a1.size:
            mid = np.stack([(a1[:, 0] + a2[:, 0]) / 2,
                            (a1[:, 1] + a2[:, 1]) / 2], axis=1)
            if bool(_strict_inside(mid, b).any()):
                return True
    if a_poly:
        vb = all_vertices(b)
        if bool(_strict_inside(vb, a).any()):
            return True
        if b1.size:
            mid = np.stack([(b1[:, 0] + b2[:, 0]) / 2,
                            (b1[:, 1] + b2[:, 1]) / 2], axis=1)
            if bool(_strict_inside(mid, a).any()):
                return True
    if not a_poly and not b_poly and a1.size and b1.size:
        # line/line: shared collinear stretch — a segment midpoint of one
        # lying ON the other marks a 1-D shared interior
        mids_a = np.stack([(a1[:, 0] + a2[:, 0]) / 2,
                           (a1[:, 1] + a2[:, 1]) / 2], axis=1)
        rings_b = [np.vstack([p1, p2]) for p1, p2 in zip(b1, b2)]
        if bool(points_on_rings(mids_a[:, 0], mids_a[:, 1],
                                rings_b).any()):
            return True
    return False


def geometry_touches(a: Geometry, b: Geometry) -> bool:
    """JTS-style ``touches``: geometries intersect but their interiors do
    not (boundary-only contact)."""
    if not geometry_intersects(a, b):
        return False
    if isinstance(a, (Point, MultiPoint)):
        pts = _points_of(a)
        if isinstance(b, (Polygon, MultiPolygon)):
            return bool(points_on_rings(pts[:, 0], pts[:, 1],
                                        _rings_of(b)).any()
                        and not _strict_inside(pts, b).any())
        if isinstance(b, (LineString, MultiLineString)):
            lines = [b] if isinstance(b, LineString) else list(b.lines)
            ends = np.vstack([np.vstack([l.coords[0], l.coords[-1]])
                              for l in lines])
            return bool((np.abs(pts[:, None, :] - ends[None, :, :])
                         .sum(axis=2) == 0).any())
        return False  # point/point contact is equality, not touches
    if isinstance(b, (Point, MultiPoint)):
        return geometry_touches(b, a)
    return not _interiors_intersect(a, b)


def geometry_crosses(a: Geometry, b: Geometry) -> bool:
    """JTS-style ``crosses``: interiors intersect and the intersection's
    dimension is lower than the operands' max (line/line meeting at
    points; a line passing through a polygon)."""
    a_line = isinstance(a, (LineString, MultiLineString))
    b_line = isinstance(b, (LineString, MultiLineString))
    a_poly = isinstance(a, (Polygon, MultiPolygon))
    b_poly = isinstance(b, (Polygon, MultiPolygon))
    if a_line and b_line:
        a1, a2 = _segments(a)
        b1, b2 = _segments(b)
        return bool(a1.size and b1.size
                    and segments_cross_properly(a1, a2, b1, b2).any())
    if (a_line and b_poly) or (a_poly and b_line):
        line, poly = (a, b) if a_line else (b, a)
        v = all_vertices(line)
        s1, s2 = _segments(line)
        mids = np.vstack([v, np.stack(
            [(s1[:, 0] + s2[:, 0]) / 2, (s1[:, 1] + s2[:, 1]) / 2],
            axis=1)]) if s1.size else v
        inside = _strict_inside(mids, poly)
        outside = ~point_in_polygon(mids[:, 0], mids[:, 1], poly,
                                    include_boundary=True)
        return bool(inside.any() and outside.any())
    return False


def geometry_overlaps(a: Geometry, b: Geometry) -> bool:
    """JTS-style ``overlaps``: same dimension, interiors intersect,
    neither contains the other."""
    a_pt = isinstance(a, (Point, MultiPoint))
    b_pt = isinstance(b, (Point, MultiPoint))
    a_line = isinstance(a, (LineString, MultiLineString))
    b_line = isinstance(b, (LineString, MultiLineString))
    if a_pt != b_pt or a_line != b_line:
        return False  # different dimensions
    if a_pt:
        pa = {tuple(p) for p in _points_of(a)}
        pb = {tuple(p) for p in _points_of(b)}
        return bool(pa & pb) and bool(pa - pb) and bool(pb - pa)
    if not _interiors_intersect(a, b):
        return False
    return not geometry_within(a, b) and not geometry_within(b, a)
