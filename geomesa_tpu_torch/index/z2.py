"""Z2 point index: spatial-only bbox queries over (lon, lat) points.

The reference's Z2 index (geomesa-index-api/.../index/z2/
Z2IndexKeySpace.scala; key layout ``[shard][8B z][id]``, :42) as
device-resident torch columns: one sorted int64 z column plus ``pos``,
the permutation into the original feature columns.  It serves point
schemas with or without a dtg attribute, and multi-box (OR of bboxes)
queries.

* **Write path.** ``build`` = SFC encode on the device → stable sort by
  z.  Appends write into sentinel padding and re-sort.
* **Query path.** Host planning decomposes the boxes into covering
  z-ranges (Z2IndexKeySpace.getRanges); the device scan is two
  ``torch.searchsorted`` seeks on the sorted z column (one key, so no
  lexicographic seek is needed), one fixed-capacity gather, the z2 mask
  kernel (filters/Z2Filter.scala semantics) and the exact
  double-precision predicate.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..config import DEFAULT_MAX_RANGES
from ..curve.legacy import legacy_z2_sfc
from ..curve.sfc import z2_sfc
from ..curve.zorder import deinterleave2, interleave2
from ..device import resolve_device
from ..ops.search import (
    coded_pos_bits, expand_ranges, gather_capacity, pack_coded, pack_wire,
    pad_boxes, pad_pow2, pad_ranges, run_packed_query, split_coded,
)
from ..ops.z2_mask import z2_mask

__all__ = ["Z2PointIndex", "Z2QueryPlan", "plan_z2_query"]


@dataclass
class Z2QueryPlan:
    rzlo: np.ndarray   # (R,) int64
    rzhi: np.ndarray
    ixy: np.ndarray    # (B, 4) int32 normalized bounds
    boxes: np.ndarray  # (B, 4) float64 exact bounds

    @property
    def num_ranges(self) -> int:
        return len(self.rzlo)


#: current z2 key-layout version (v1 = legacy semi-normalized curve)
Z2_INDEX_VERSION = 2


def z2_sfc_for_version(version: int):
    """Curve for a persisted index-layout version (the reference's
    Z2IndexV1..Vn read-path dispatch, index/index/z2/legacy/): v1 is the
    legacy semi-normalized curve (curve/legacy.py)."""
    if version >= 2:
        return z2_sfc()
    return legacy_z2_sfc()


def plan_z2_query(boxes, max_ranges: int = DEFAULT_MAX_RANGES,
                  sfc=None) -> Z2QueryPlan:
    sfc = sfc if sfc is not None else z2_sfc()
    boxes = np.atleast_2d(np.asarray(boxes, dtype=np.float64))
    zr = sfc.ranges(boxes, max_ranges=max_ranges)
    ixy = np.array([[sfc.lon.normalize_scalar(b[0]),
                     sfc.lat.normalize_scalar(b[1]),
                     sfc.lon.normalize_scalar(b[2]),
                     sfc.lat.normalize_scalar(b[3])] for b in boxes],
                   dtype=np.int32)
    return Z2QueryPlan(rzlo=zr[:, 0], rzhi=zr[:, 1], ixy=ixy, boxes=boxes)


def _in_boxes(ix, iy, b):
    """(N, B) inclusive box tests of ``(ix, iy)`` against ``b`` (B, 4)."""
    return ((ix[:, None] >= b[None, :, 0]) & (iy[:, None] >= b[None, :, 1])
            & (ix[:, None] <= b[None, :, 2]) & (iy[:, None] <= b[None, :, 3]))


def _gather(z, pos, rzlo, rzhi, capacity: int):
    """Seeks + fixed-capacity gather: ``(zc, posc, valid, rid, total)``."""
    starts = torch.searchsorted(z, rzlo, side="left")
    ends = torch.searchsorted(z, rzhi, side="right")
    counts = torch.clamp(ends - starts, min=0)
    idx, valid, rid = expand_ranges(starts, counts, capacity)
    return z[idx], pos[idx], valid, rid, counts.sum()


def _query_many_packed(z, pos, x, y, rzlo, rzhi, rqid, ixy, boxes, bqid,
                       capacity: int, pos_bits: int = 40):
    """Batched multi-box-set scan: Q independent queries in one pass (see
    z3._query_many_packed for the packed ``qid << pos_bits | pos``
    protocol).  The ``same_q`` pairing has no kernel in the JAX package
    either, so this path stays plain torch."""
    zc, posc, valid, rid, total = _gather(z, pos, rzlo, rzhi, capacity)
    cqid = rqid[rid]
    ix, iy = deinterleave2(zc)
    pl = posc.to(torch.int64)
    same_q = cqid[:, None] == bqid[None, :]
    in_box_int = (same_q & _in_boxes(ix, iy, ixy.to(torch.int64))).any(dim=1)
    in_box_exact = (same_q & _in_boxes(x[pl], y[pl], boxes)).any(dim=1)
    mask = valid & in_box_int & in_box_exact
    return pack_coded(total, cqid, posc, mask, pos_bits)


def _query_packed(z, pos, x, y, rzlo, rzhi, ixy, boxes, capacity: int):
    """One-pass scan (seeks + gather + the z2 mask kernel + the exact
    float re-check) returning the packed ``[total, pos|-1, …]`` vector —
    one device→host copy per query (see z3._query_packed).  The exact
    re-check stays plain torch, as it stays XLA in the JAX package."""
    zc, posc, valid, _, total = _gather(z, pos, rzlo, rzhi, capacity)
    in_box_int = z2_mask(zc, ixy)
    pl = posc.to(torch.int64)
    in_box_exact = _in_boxes(x[pl], y[pl], boxes).any(dim=1)
    return pack_wire(total, posc, valid & in_box_int & in_box_exact,
                     torch.int32)


@lru_cache(maxsize=8)
def _world_cell_boundaries(s: int, device: torch.device):
    """Sorted z-prefix starts of the 2^s × 2^s world grid plus the flat
    permutation mapping z-order cells to (row, col), cached per device."""
    side = torch.arange(1 << s, dtype=torch.int64)
    iy, ix = torch.meshgrid(side, side, indexing="ij")
    shift = 31 - s
    starts = interleave2(ix.reshape(-1) << shift, iy.reshape(-1) << shift)
    sorted_starts = torch.sort(starts).values
    sx, sy = deinterleave2(sorted_starts)
    perm = (sy >> shift) * (1 << s) + (sx >> shift)
    return sorted_starts.to(device), perm.to(device)


def _density_world_program(z, starts, perm, n: int, s: int, height: int,
                           width: int):
    """World histogram on the device: boundary seeks + differences +
    scatter by the static permutation + pooling; only the output grid
    crosses to the host."""
    bounds = torch.searchsorted(z, starts, side="left")
    tail = torch.tensor([n], dtype=bounds.dtype, device=bounds.device)
    counts = torch.diff(torch.cat([bounds, tail])).to(torch.float64)
    sq = torch.zeros((1 << s) * (1 << s), dtype=torch.float64,
                     device=z.device)
    sq[perm] = counts
    return sq.reshape(height, (1 << s) // height,
                      width, (1 << s) // width).sum(dim=(1, 3))


def _encode_sort_z2(sfc, xs, ys):
    """Key encode + sort by z, the permutation as payload.  The sort is
    stable: ties on equal z keep their incoming order (the JAX sort leaves
    them unspecified; positions are sorted again per query)."""
    zv = sfc.index(xs, ys)
    z_s, perm = torch.sort(zv, stable=True)
    return z_s, perm.to(torch.int32)


#: sentinel key for append padding: sorts last, matches no query range
_SENTINEL_Z2 = int(np.iinfo(np.int64).max)


def _z2_append_step(sfc, idx: "Z2PointIndex", r: int, xs, ys,
                    m_valid: int) -> None:
    """Write a new batch's coords at ``[r, r + m_pad)`` of the value
    columns, its z keys into the sentinel slots starting at sorted
    position ``r``, and re-sort keys+pos.  JAX's version returned new
    columns (``dynamic_update_slice``); the port writes into the resident
    columns in place, so an append allocates no second copy of x/y."""
    m_pad = int(xs.shape[0])
    device = idx.z.device
    valid = torch.arange(m_pad, device=device) < m_valid
    z_new = torch.where(valid, sfc.index(xs, ys),
                        torch.full((m_pad,), _SENTINEL_Z2, dtype=torch.int64,
                                   device=device))
    pos_new = torch.where(
        valid, r + torch.arange(m_pad, dtype=torch.int32, device=device),
        torch.full((m_pad,), -1, dtype=torch.int32, device=device))
    w = slice(r, r + m_pad)
    idx.x[w] = xs
    idx.y[w] = ys
    idx.z[w] = z_new
    idx.pos[w] = pos_new
    idx.z, perm = torch.sort(idx.z, stable=True)
    idx.pos = idx.pos[perm]


class Z2PointIndex:
    """Device-resident Z2 index over point features."""

    DEFAULT_CAPACITY = 1 << 15

    def __init__(self, z, pos, x, y, version: int = Z2_INDEX_VERSION,
                 n_rows: int | None = None):
        self.version = version
        self.sfc = z2_sfc_for_version(version)
        self.z = z
        self.pos = pos
        self.x = x
        self.y = y
        #: valid rows (the z/pos tail beyond this holds append-padding
        #: sentinels)
        self._n_rows = int(z.shape[0]) if n_rows is None else n_rows
        self._capacity = self.DEFAULT_CAPACITY

    @property
    def device(self) -> torch.device:
        return self.z.device

    @classmethod
    def build(cls, x, y, version: int = Z2_INDEX_VERSION,
              device=None) -> "Z2PointIndex":
        """Encode keys and sort on ``device`` (the card unless the caller
        names the CPU).  The index owns its x/y columns (copies), since
        appends write into them in place."""
        dev = resolve_device(device)
        sfc = z2_sfc_for_version(version)
        xd = torch.tensor(np.asarray(x, dtype=np.float64), device=dev)
        yd = torch.tensor(np.asarray(y, dtype=np.float64), device=dev)
        z_s, pos = _encode_sort_z2(sfc, xd, yd)
        return cls(z=z_s, pos=pos, x=xd, y=yd, version=version,
                   n_rows=int(xd.shape[0]))

    def __len__(self) -> int:
        return self._n_rows

    def _grow_capacity(self, cap: int) -> None:
        """Extend the resident columns to ``cap`` slots with sentinel keys
        (sort last, match nothing)."""
        pad = cap - int(self.z.shape[0])
        if pad <= 0:
            return

        def ext(t, fill):
            return torch.cat([t, torch.full((pad,), fill, dtype=t.dtype,
                                            device=t.device)])

        self.z = ext(self.z, _SENTINEL_Z2)
        self.pos = ext(self.pos, -1)
        self.x = ext(self.x, 0)
        self.y = ext(self.y, 0)

    def append(self, x, y) -> "Z2PointIndex":
        """Incremental ingest: new rows land in the sentinel padding and
        the capacity-padded columns re-sort in place; shapes bucket by
        (capacity, pow2(m)).  Returns self (mutated)."""
        x = np.asarray(x, dtype=np.float64)
        m = len(x)
        if m == 0:
            return self
        y = np.asarray(y, dtype=np.float64)
        m_pad = gather_capacity(m, minimum=8)
        r = self._n_rows
        if r + m_pad > int(self.z.shape[0]):
            self._grow_capacity(gather_capacity(r + m_pad))
        pad = m_pad - m

        def up(a):
            return torch.from_numpy(np.pad(a, (0, pad))).to(self.device)

        _z2_append_step(self.sfc, self, r, up(x), up(y), m)
        self._n_rows = r + m
        return self

    def _dev(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def query(self, boxes, max_ranges: int = DEFAULT_MAX_RANGES) -> np.ndarray:
        """Original-order positions matching any of the bboxes, exactly."""
        plan = plan_z2_query(boxes, max_ranges, sfc=self.sfc)
        if plan.num_ranges == 0 or len(self) == 0:
            return np.empty(0, dtype=np.int64)
        r = pad_ranges({"rzlo": plan.rzlo, "rzhi": plan.rzhi},
                       pad_pow2(plan.num_ranges))
        ixy, bxs = pad_boxes(plan.ixy, plan.boxes,
                             pad_pow2(len(plan.boxes), minimum=1))
        args = (self.z, self.pos, self.x, self.y,
                self._dev(r["rzlo"]), self._dev(r["rzhi"]),
                self._dev(ixy), self._dev(bxs))
        hits, self._capacity = run_packed_query(
            lambda capacity: _query_packed(*args, capacity=capacity),
            self._capacity)
        return hits

    def density_world(self, width: int, height: int) -> np.ndarray:
        """Whole-world count grid straight from the SORTED z column: each
        cell of a power-of-two grid is one contiguous z-prefix range, so
        the histogram is G binary-search boundaries + adjacent
        differences — no pass over the data.  Semantics match
        ``density_grid`` over the world envelope (clamping included) for
        unweighted counts."""
        a = int(math.log2(width))
        b = int(math.log2(height))
        if (1 << a) != width or (1 << b) != height or a > 15 or b > 15:
            raise ValueError("density_world needs power-of-two dims "
                             "(≤ 32768 per axis)")
        # with unequal per-axis bit counts a cell is NOT one contiguous z
        # range, so compute the SQUARE grid at s = max(a, b) — whose cells
        # are exact z prefixes — and pool the extra resolution down
        s = max(a, b)
        starts, perm = _world_cell_boundaries(s, self.device)
        grid = _density_world_program(self.z, starts, perm, len(self), s,
                                      height, width)
        return grid.cpu().numpy()

    def query_many(self, boxes_list,
                   max_ranges: int = DEFAULT_MAX_RANGES) -> list[np.ndarray]:
        """Batched spatial-only queries: one device pass for ALL the box
        sets; returns a sorted position array per entry."""
        n_q = len(boxes_list)
        if n_q == 0 or len(self) == 0:
            return [np.empty(0, dtype=np.int64) for _ in range(n_q)]
        rzlo, rzhi, rqid, ixy, bxs, bqid = [], [], [], [], [], []
        for q, boxes in enumerate(boxes_list):
            # per-window scan-ranges budget (see z3.query_many)
            plan = plan_z2_query(boxes, max_ranges, sfc=self.sfc)
            if plan.num_ranges == 0:
                continue
            rzlo.append(plan.rzlo)
            rzhi.append(plan.rzhi)
            rqid.append(np.full(plan.num_ranges, q, dtype=np.int32))
            ixy.append(plan.ixy)
            bxs.append(plan.boxes)
            bqid.append(np.full(len(plan.boxes), q, dtype=np.int32))
        if not rzlo:
            return [np.empty(0, dtype=np.int64) for _ in range(n_q)]
        r = pad_ranges({"rzlo": np.concatenate(rzlo),
                        "rzhi": np.concatenate(rzhi),
                        "rqid": np.concatenate(rqid)},
                       pad_pow2(sum(len(a) for a in rzlo)))
        ixy_c, boxes_c, bqid_c = pad_boxes(
            np.concatenate(ixy), np.concatenate(bxs),
            pad_pow2(sum(len(b) for b in bxs), minimum=1),
            np.concatenate(bqid))
        args = (self.z, self.pos, self.x, self.y,
                self._dev(r["rzlo"]), self._dev(r["rzhi"]),
                self._dev(r["rqid"]), self._dev(ixy_c), self._dev(boxes_c),
                self._dev(bqid_c))
        pos_bits = coded_pos_bits(len(self), n_q)
        coded, self._capacity = run_packed_query(
            lambda capacity: _query_many_packed(
                *args, capacity=capacity, pos_bits=pos_bits),
            self._capacity)
        return split_coded(coded, pos_bits, n_q)
