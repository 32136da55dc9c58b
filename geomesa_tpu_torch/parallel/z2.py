"""ShardedZ2Index: spatial-only bbox scans over a device mesh.

The mesh analog of the reference's Z2 index served through the same
distributed scan machinery as Z3 (AccumuloQueryPlan.BatchScanPlan serves
every index's ranges alike, .../data/AccumuloQueryPlan.scala:87-157).
Structure mirrors :class:`~geomesa_tpu_torch.parallel.scan.ShardedZ3Index`:
one sorted int64 z column per shard with the global-id payload, per-shard
packed scans (the z2 mask kernel on the card), appends into sentinel
padding.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_MAX_RANGES
from ..curve.zorder import deinterleave2
from ..index.z2 import (
    Z2_INDEX_VERSION, _in_boxes, plan_z2_query, z2_sfc_for_version,
)
from ..ops.search import (
    coded_pos_bits, expand_ranges, gather_capacity, pack_coded, pack_wire,
    pad_boxes, pad_pow2, pad_ranges, split_coded,
)
from ..ops.z2_mask import z2_mask
from .mesh import DeviceMesh, device_mesh, shard_batch
from .scan import (
    _block_segments, _PerDevice, _read_wires, segments_shard_of,
)

__all__ = ["ShardedZ2Index"]

_SENTINEL_Z = int(np.iinfo(np.int64).max)


def _gather(lz, lg, a, capacity: int):
    """Seeks + fixed-capacity gather: ``(idx, gids, valid, rid, total)``."""
    starts = torch.searchsorted(lz, a["rzlo"], side="left")
    ends = torch.searchsorted(lz, a["rzhi"], side="right")
    counts = torch.clamp(ends - starts, min=0)
    idx, valid, rid = expand_ranges(starts, counts, capacity)
    return idx, lg[idx], valid, rid, counts.sum()


class ShardedZ2Index:
    """Z2 point index sharded over the feature axis of a device mesh.
    Per-shard lists of device tensors: ``z`` (sorted, sentinel-padded),
    ``gid`` (-1 for padding), ``x``/``y`` in sorted order."""

    DEFAULT_CAPACITY = 1 << 15

    def __init__(self, mesh: DeviceMesh, z, gid, x, y, n_total: int,
                 shard_counts: np.ndarray, version: int | None = None):
        self.mesh = mesh
        self.version = Z2_INDEX_VERSION if version is None else version
        self.sfc = z2_sfc_for_version(self.version)
        self.z, self.gid, self.x, self.y = list(z), list(gid), list(x), list(y)
        self._n_total = n_total
        self._shard_counts = np.asarray(shard_counts, dtype=np.int64)
        self._capacity = self.DEFAULT_CAPACITY
        #: gid-residency segments (see ShardedZ3Index)
        self._segments: list[tuple[int, int, int]] = []

    def shard_of_gids(self, gids: np.ndarray) -> np.ndarray:
        """Device shard holding each gid (see ShardedZ3Index)."""
        return segments_shard_of(self._segments, gids)

    @classmethod
    def build(cls, x, y, mesh: DeviceMesh | None = None,
              version: int | None = None) -> "ShardedZ2Index":
        mesh = mesh or device_mesh()
        version = Z2_INDEX_VERSION if version is None else version
        sfc = z2_sfc_for_version(version)
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        n = len(x)
        (xd, yd, gidd), valid = shard_batch(mesh, x, y,
                                            np.arange(n, dtype=np.int32))
        cols = []
        for s in range(mesh.size):
            z = torch.where(valid[s], sfc.index(xd[s], yd[s]),
                            torch.full_like(valid[s], _SENTINEL_Z,
                                            dtype=torch.int64))
            gs = torch.where(valid[s], gidd[s], torch.full_like(gidd[s], -1))
            z, perm = torch.sort(z, stable=True)
            cols.append((z, gs[perm], xd[s][perm], yd[s][perm]))
        per = int(cols[0][0].shape[0])
        shard_counts = np.clip(n - np.arange(mesh.size) * per, 0, per)
        idx = cls(mesh, *zip(*cols), n_total=n, shard_counts=shard_counts,
                  version=version)
        idx._segments = _block_segments(n, per, mesh.size)
        return idx

    @classmethod
    def build_multihost(cls, *args, **kwargs):
        raise NotImplementedError(
            "multi-controller (multihost) builds are not ported")

    def total(self) -> int:
        return self._n_total

    def __len__(self) -> int:
        return self._n_total

    @property
    def capacity(self) -> int:
        """Slots per shard, padding included."""
        return int(self.z[0].shape[0])

    def append(self, x, y) -> "ShardedZ2Index":
        """Append (see ShardedZ3Index.append): each shard writes its slice
        into its sentinel padding in place and re-sorts."""
        x = np.asarray(x, dtype=np.float64)
        m = len(x)
        if m == 0:
            return self
        y = np.asarray(y, dtype=np.float64)
        n_shards = self.mesh.size
        m_per = gather_capacity(-(-m // n_shards), minimum=8)
        pad = m_per * n_shards - m
        gids = np.concatenate([
            np.arange(self._n_total, self._n_total + m, dtype=np.int32),
            np.full(pad, -1, np.int32)])
        need = int(self._shard_counts.max()) + m_per
        if need > self.capacity:
            grow = gather_capacity(need) - self.capacity

            def ext(cols, fill):
                return [torch.cat([t, torch.full((grow,), fill,
                                                 dtype=t.dtype,
                                                 device=t.device)])
                        for t in cols]
            self.z = ext(self.z, _SENTINEL_Z)
            self.gid = ext(self.gid, -1)
            self.x, self.y = ext(self.x, 0), ext(self.y, 0)
        new = (np.pad(x, (0, pad)), np.pad(y, (0, pad)), gids)
        for s, dev in enumerate(self.mesh):
            xs, ys, gs = (torch.from_numpy(a[s * m_per:(s + 1) * m_per]).to(dev)
                          for a in new)
            z_new = torch.where(gs < 0, torch.full_like(gs, _SENTINEL_Z,
                                                        dtype=torch.int64),
                                self.sfc.index(xs, ys))
            r0 = int(self._shard_counts[s])
            w = slice(r0, r0 + m_per)
            self.z[s][w] = z_new
            self.gid[s][w] = gs
            self.x[s][w] = xs
            self.y[s][w] = ys
            self.z[s], perm = torch.sort(self.z[s], stable=True)
            self.gid[s] = self.gid[s][perm]
            self.x[s] = self.x[s][perm]
            self.y[s] = self.y[s][perm]
        self._shard_counts = self._shard_counts + np.clip(
            m - np.arange(n_shards) * m_per, 0, m_per)
        self._segments.extend(
            _block_segments(m, m_per, n_shards, gid_base=self._n_total))
        self._n_total += m
        return self

    def _columns(self):
        return list(zip(self.z, self.gid, self.x, self.y))

    def query(self, boxes, max_ranges: int = DEFAULT_MAX_RANGES,
              capacity: int | None = None) -> np.ndarray:
        """Exact global hit gids matching any of the bboxes, sorted: per
        shard, seeks + gather + the z2 mask kernel (Z2Filter) AND the
        exact double-precision re-check, read with the shard's candidate
        total in one copy."""
        plan = plan_z2_query(boxes, max_ranges, sfc=self.sfc)
        if plan.num_ranges == 0 or self._n_total == 0:
            return np.empty(0, dtype=np.int64)
        r = pad_ranges({"rzlo": plan.rzlo, "rzhi": plan.rzhi},
                       pad_pow2(plan.num_ranges))
        ixy, bxs = pad_boxes(plan.ixy, plan.boxes,
                             pad_pow2(len(plan.boxes), minimum=1))
        args = _PerDevice(ixy=ixy, boxes=bxs, **r)

        def scan(lz, lg, xs, ys, a, capacity):
            idx, gc, valid, _, total = _gather(lz, lg, a, capacity)
            mask = (valid & (gc >= 0) & z2_mask(lz[idx], a["ixy"])
                    & _in_boxes(xs[idx], ys[idx], a["boxes"]).any(dim=1))
            return pack_wire(total, gc, mask, torch.int32)

        flat, self._capacity = _read_wires(scan, self._columns(), args,
                                           capacity or self._capacity)
        return np.sort(flat[flat >= 0]).astype(np.int64)

    def query_many(self, boxes_list,
                   max_ranges: int = DEFAULT_MAX_RANGES) -> list[np.ndarray]:
        """Batched spatial queries: one pass per shard for ALL the box
        sets; returns a sorted gid array per entry.  The ``same_q``
        pairing has no kernel in the JAX package either, so this path
        stays plain torch."""
        n_q = len(boxes_list)
        if n_q == 0 or self._n_total == 0:
            return [np.empty(0, dtype=np.int64) for _ in range(n_q)]
        rzlo, rzhi, rqid, ixy, bxs, bqid = [], [], [], [], [], []
        for q, boxes in enumerate(boxes_list):
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
        args = _PerDevice(ixy=ixy_c, boxes=boxes_c, bqid=bqid_c, **r)
        pos_bits = coded_pos_bits(self._n_total, n_q)

        def scan(lz, lg, xs, ys, a, capacity):
            idx, gc, valid, rid, total = _gather(lz, lg, a, capacity)
            cqid = a["rqid"][rid]
            same_q = cqid[:, None] == a["bqid"][None, :]
            ix, iy = deinterleave2(lz[idx])
            in_int = (same_q & _in_boxes(ix, iy, a["ixy"].to(torch.int64))
                      ).any(dim=1)
            in_exact = (same_q & _in_boxes(xs[idx], ys[idx], a["boxes"])
                        ).any(dim=1)
            mask = valid & (gc >= 0) & in_int & in_exact
            return pack_coded(total, cqid, gc, mask, pos_bits)

        flat, self._capacity = _read_wires(scan, self._columns(), args,
                                           self._capacity)
        return split_coded(np.sort(flat[flat >= 0]).astype(np.int64),
                           pos_bits, n_q)
