"""ShardedZ2Index: spatial-only bbox scans over a device mesh.

The mesh analog of the reference's Z2 index served through the same
distributed scan machinery as Z3 (AccumuloQueryPlan.BatchScanPlan serves
every index's ranges alike, .../data/AccumuloQueryPlan.scala:87-157).
Structure mirrors :class:`~geomesa_tpu_torch.parallel.scan.ShardedZ3Index`:
one sorted int64 z column per shard with the global-id payload, per-shard
packed scans (the z2 mask kernel on the card), appends into sentinel
padding.  Under multihost (``build_multihost``) each process's shards hold
its own rows, hits allgather, and slot decisions derive from the agreed
global per-shard counts (see ``parallel/scan.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_MAX_RANGES
from ..index.z2 import (
    Z2_INDEX_VERSION, _in_boxes, plan_z2_query, z2_mask_union,
    z2_sfc_for_version,
)
from ..ops.search import (
    coded_pos_bits, expand_ranges, gather_capacity, pack_coded, pack_wire,
    pad_boxes, pad_pow2, pad_ranges, split_coded,
)
from ..ops.gate import agree_kernel
from ..ops.z2_mask import z2_mask
from .mesh import DeviceMesh, device_mesh, shard_batch
from .multihost import (
    agree_append_layout, agreed_int, global_device_mesh, global_shard_counts,
    process_index, process_local_shard,
)
from .scan import (
    _block_segments, _global_hits, _multihost_segments, _PerDevice,
    _read_wires, _wire_dtype, encode_gids, multihost_gid_span,
    segments_shard_of,
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


def _sort_shard(sfc, xs, ys, gs, vs):
    """One shard's build: encode, sentinel the padding rows and sort by
    z with the gids and coordinates as payload."""
    z = torch.where(vs, sfc.index(xs, ys),
                    torch.full_like(vs, _SENTINEL_Z, dtype=torch.int64))
    gs = torch.where(vs, gs, torch.full_like(gs, -1))
    z, perm = torch.sort(z, stable=True)
    return z, gs[perm], xs[perm], ys[perm]


class ShardedZ2Index:
    """Z2 point index sharded over the feature axis of a device mesh.
    Per-shard lists of device tensors: ``z`` (sorted, sentinel-padded),
    ``gid`` (-1 for padding), ``x``/``y`` in sorted order."""

    DEFAULT_CAPACITY = 1 << 15

    def __init__(self, mesh: DeviceMesh, z, gid, x, y, n_total: int,
                 shard_counts: np.ndarray, version: int | None = None,
                 multihost: bool = False, n_local: int | None = None):
        self.mesh = mesh
        self._multihost = multihost
        #: rows THIS process has fed (the multihost gid cursor)
        self._n_local = n_total if n_local is None else n_local
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
        cols = [_sort_shard(sfc, xd[s], yd[s], gidd[s], valid[s])
                for s in range(mesh.size)]
        per = int(cols[0][0].shape[0])
        shard_counts = np.clip(n - np.arange(mesh.size) * per, 0, per)
        idx = cls(mesh, *zip(*cols), n_total=n, shard_counts=shard_counts,
                  version=version)
        idx._segments = _block_segments(n, per, mesh.size)
        return idx

    @classmethod
    def build_multihost(cls, x, y, mesh: DeviceMesh | None = None,
                        version: int | None = None) -> "ShardedZ2Index":
        """Multi-controller build from per-process LOCAL rows (see
        ShardedZ3Index.build_multihost)."""
        mesh = mesh or global_device_mesh()
        version = Z2_INDEX_VERSION if version is None else version
        sfc = z2_sfc_for_version(version)
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        n_local = len(x)
        (xd, yd, gidd), valid = process_local_shard(
            mesh, x, y, encode_gids(np.arange(n_local, dtype=np.int64)))
        cols = [_sort_shard(sfc, xd[s], yd[s], gidd[s], valid[s])
                for s in range(mesh.size)]
        idx = cls(mesh, *zip(*cols), n_total=agreed_int(n_local, "sum"),
                  shard_counts=global_shard_counts(n_local, mesh),
                  version=version, multihost=True, n_local=n_local)
        idx._segments = _multihost_segments(mesh, n_local, gid_start=0)
        return idx

    def _local_counts(self) -> np.ndarray:
        """Valid rows of THIS process's shards."""
        if not self._multihost:
            return self._shard_counts
        lo = process_index() * self.mesh.size
        return self._shard_counts[lo:lo + self.mesh.size]

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
        into its sentinel padding in place and re-sorts.  Under multihost
        every process passes its LOCAL new rows (a collective)."""
        x = np.asarray(x, dtype=np.float64)
        m = len(x)
        m_global = agreed_int(m, "sum") if self._multihost else m
        if m_global == 0:
            return self
        y = np.asarray(y, dtype=np.float64)
        n_shards = self.mesh.size
        if self._multihost:
            m_per, slots, _ = agree_append_layout(self.mesh, m)
            gids = np.full(slots, -1, dtype=np.int64)
            gids[:m] = encode_gids(
                self._n_local + np.arange(m, dtype=np.int64))
        else:
            m_per = gather_capacity(-(-m // n_shards), minimum=8)
            slots = m_per * n_shards
            gids = np.concatenate([
                np.arange(self._n_total, self._n_total + m, dtype=np.int32),
                np.full(slots - m, -1, np.int32)])
        pad = slots - m
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
        counts = self._local_counts()
        for s, dev in enumerate(self.mesh):
            xs, ys, gs = (torch.from_numpy(a[s * m_per:(s + 1) * m_per]).to(dev)
                          for a in new)
            z_new = torch.where(gs < 0, torch.full_like(gs, _SENTINEL_Z,
                                                        dtype=torch.int64),
                                self.sfc.index(xs, ys))
            r0 = int(counts[s])
            w = slice(r0, r0 + m_per)
            self.z[s][w] = z_new
            self.gid[s][w] = gs
            self.x[s][w] = xs
            self.y[s][w] = ys
            self.z[s], perm = torch.sort(self.z[s], stable=True)
            self.gid[s] = self.gid[s][perm]
            self.x[s] = self.x[s][perm]
            self.y[s] = self.y[s][perm]
        if self._multihost:
            self._shard_counts = self._shard_counts + global_shard_counts(
                m, self.mesh, m_per=m_per)
            self._segments.extend(_multihost_segments(
                self.mesh, m, gid_start=self._n_local, m_per=m_per))
        else:
            self._shard_counts = self._shard_counts + np.clip(
                m - np.arange(n_shards) * m_per, 0, m_per)
            self._segments.extend(
                _block_segments(m, m_per, n_shards, gid_base=self._n_total))
        self._n_total += m_global
        self._n_local += m
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
        if self._multihost:
            agree_kernel("z2_scan", self.mesh[0])

        def scan(lz, lg, xs, ys, a, capacity):
            idx, gc, valid, _, total = _gather(lz, lg, a, capacity)
            mask = (valid & (gc >= 0) & z2_mask(lz[idx], a["ixy"])
                    & _in_boxes(xs[idx], ys[idx], a["boxes"]).any(dim=1))
            return pack_wire(total, gc, mask, _wire_dtype(gc))

        flat, self._capacity = _read_wires(scan, self._columns(), args,
                                           capacity or self._capacity)
        return _global_hits(flat[flat >= 0], self._multihost)

    def query_many(self, boxes_list,
                   max_ranges: int = DEFAULT_MAX_RANGES) -> list[np.ndarray]:
        """Batched spatial queries: one pass per shard for ALL the box
        sets; returns a sorted gid array per entry.  The int-space test
        runs the z2 mask kernel over the union of every query's boxes,
        made exact by the per-query exact re-check (see
        index/z2._query_many_packed)."""
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
        if self._multihost:
            agree_kernel("z2_scan", self.mesh[0])
        pos_bits = coded_pos_bits(
            multihost_gid_span() if self._multihost else self._n_total, n_q)

        def scan(lz, lg, xs, ys, a, capacity):
            idx, gc, valid, rid, total = _gather(lz, lg, a, capacity)
            cqid = a["rqid"][rid]
            same_q = cqid[:, None] == a["bqid"][None, :]
            in_exact = (same_q & _in_boxes(xs[idx], ys[idx], a["boxes"])
                        ).any(dim=1)
            mask = (valid & (gc >= 0) & z2_mask_union(lz[idx], a["ixy"])
                    & in_exact)
            return pack_coded(total, cqid, gc, mask, pos_bits)

        flat, self._capacity = _read_wires(scan, self._columns(), args,
                                           self._capacity)
        return split_coded(_global_hits(flat[flat >= 0], self._multihost),
                           pos_bits, n_q)
