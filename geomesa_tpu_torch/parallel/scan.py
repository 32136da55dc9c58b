"""Sharded index build, scan, append and density over a device mesh.

Per-shard sorted key segments + reductions over the shards — the mesh
analog of the reference's range-partitioned parallel scans with a
client-side reduce (AccumuloQueryPlan.BatchScanPlan threads,
QueryPlan.Reducer; SURVEY.md §2.7).  The JAX package runs each step as
one ``shard_map`` program; here each is a loop over the mesh's devices
that runs the port's single-chip pieces per shard (``ops/search.py``
seeks and gather, the z3 mask kernel), and a ``psum`` is the sum of the
per-shard partials.

* ``ShardedZ3Index.build``: each shard encodes and locally sorts its
  feature slice (per-tablet sorted layout), values as sort payload.
* ``ShardedZ3Index.query`` / ``query_many``: per-shard binary-search
  seeks + fixed-capacity gather + candidate mask, hits read back per
  shard (the scatter-gather + client-merge pattern).
* ``ShardedZ3Index.append``: each shard writes its slice of the new
  batch into its sentinel padding and re-sorts (the BatchWriter
  continuous-write role, index/api/IndexAdapter.scala:95-106).
* ``sharded_range_count`` / ``sharded_density``: sums of per-shard
  partials (DensityScan + client merge).

**Row identity.** Every shard carries a global-id column as sort payload
beside its keys: scans emit gids directly, so query results never
depend on block-layout arithmetic (shards hold unequal row counts after
appends).  Gids are the input row order (int32), process 0 of the JAX
package's ``process << GID_PROC_SHIFT | row`` coding.

One process drives the whole mesh.  The JAX package's multi-controller
builds and appends and its ring-parallel scans are not ported and raise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_MAX_RANGES
from ..curve.binnedtime import TimePeriod, to_binned_time
from ..index.z3 import (
    Z3_INDEX_VERSION, _exact_pairs, _lexsort2, candidate_mask,
    plan_z3_query, z3_sfc_for_version,
)
from ..ops.density import density_grid_auto
from ..ops.search import (
    coded_pos_bits, expand_ranges, gather_capacity, pack_coded, pack_wire,
    pad_boxes, pad_pow2, pad_ranges, searchsorted2, split_coded,
)
from ..ops.z3_mask import z3_mask
from .mesh import DeviceMesh, device_mesh, shard_batch

__all__ = ["ShardedZ3Index", "sharded_range_count", "sharded_density",
           "GID_PROC_SHIFT", "encode_gids", "decode_gids",
           "segments_shard_of", "gid_weight_lookup",
           "SHARDED_TWO_PHASE_MIN_CAPACITY"]

#: multihost gid coding of the JAX package: ``gid = process <<
#: GID_PROC_SHIFT | local_row`` (the port has one process, number 0)
GID_PROC_SHIFT = 40

#: sentinel keys for padding slots: sort after every real key and can
#: never match a query range (real bins are small, z uses ≤63 bits)
_SENTINEL_BIN = int(np.iinfo(np.int32).max)
_SENTINEL_Z = int(np.iinfo(np.int64).max)

#: capacity at which the two-phase read (per-shard compaction, then a
#: hits-sized head) takes over from reading the full per-shard buffers
SHARDED_TWO_PHASE_MIN_CAPACITY = 1 << 17


def encode_gids(rows: np.ndarray, proc: int = 0) -> np.ndarray:
    """Code local rows as gids: ``proc << GID_PROC_SHIFT | row`` (the
    port's one process is process 0)."""
    return ((np.int64(proc) << GID_PROC_SHIFT)
            | np.asarray(rows, dtype=np.int64))


def decode_gids(gids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split gids into ``(process, local_row)`` arrays, the inverse of
    :func:`encode_gids`."""
    g = np.asarray(gids, dtype=np.int64)
    return g >> GID_PROC_SHIFT, g & ((np.int64(1) << GID_PROC_SHIFT) - 1)


def _block_segments(n: int, per: int, n_shards: int, gid_base: int = 0,
                    shard_base: int = 0) -> list[tuple[int, int, int]]:
    """Residency segments for one contiguous block placement: row i of a
    length-n feed lands on shard ``i // per``."""
    segs = []
    for s in range(n_shards):
        lo, hi = s * per, min(n, (s + 1) * per)
        if hi > lo:
            segs.append((gid_base + lo, gid_base + hi, shard_base + s))
    return segs


def segments_shard_of(segments: list, gids: np.ndarray) -> np.ndarray:
    """Map gids to their holding shard through residency segments (-1 for
    gids outside every segment, including the no-segments case — unknown
    residency must never masquerade as shard 0)."""
    gids = np.asarray(gids, dtype=np.int64)
    if not segments or not len(gids):
        return np.full(len(gids), -1, dtype=np.int64)
    segs = sorted(segments)
    starts = np.array([s[0] for s in segs], dtype=np.int64)
    ends = np.array([s[1] for s in segs], dtype=np.int64)
    shards = np.array([s[2] for s in segs], dtype=np.int64)
    i = np.clip(np.searchsorted(starts, gids, side="right") - 1,
                0, len(segs) - 1)
    out = shards[i]
    out[(gids < starts[i]) | (gids >= ends[i])] = -1
    return out


def gid_weight_lookup(gs, table, bases):
    """Per-row weight/value gather from a table by gid: ``bases[process]
    + local_row`` (``bases == [0]`` for single-controller gids, whose
    process field is always 0).  Padding slots (gid -1) read row 0; every
    caller masks them out."""
    g = torch.clamp(gs, min=0).to(torch.int64)
    proc = torch.clamp(g >> GID_PROC_SHIFT, max=bases.shape[0] - 1)
    row = g & ((1 << GID_PROC_SHIFT) - 1)
    return table[bases[proc] + row]


class _PerDevice:
    """Host arrays uploaded once per distinct device of a mesh (a plan's
    ranges and boxes reach every shard; on a CPU mesh every shard shares
    one copy)."""

    def __init__(self, **arrays):
        self._arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
        self._on: dict = {}

    def on(self, device: torch.device) -> dict:
        if device not in self._on:
            self._on[device] = {k: torch.from_numpy(v).to(device)
                                for k, v in self._arrays.items()}
        return self._on[device]


def _to_host(tensors) -> list[np.ndarray]:
    return [t.cpu().numpy() for t in tensors]


def _unwire(wire: np.ndarray) -> tuple[int, np.ndarray]:
    """Split one :func:`pack_wire` vector into ``(total, values)``."""
    return (int(wire[0]) << 30) | int(wire[1]), wire[2:]


def _read_wires(scan, shards, args: "_PerDevice", capacity: int):
    """The mesh form of :func:`~geomesa_tpu_torch.ops.search.
    run_packed_query`: run ``scan(*shard_columns, plan, capacity)`` on
    every shard, read each shard's wire vector in one copy, and regrow
    the capacity until every shard's candidates fit.  Returns ``(the
    values of every shard, capacity)``."""
    while True:
        parts = [_unwire(w) for w in _to_host(
            scan(*cols, args.on(cols[0].device), capacity)
            for cols in shards)]
        top = max(t for t, _ in parts)
        if top <= capacity:
            return np.concatenate([v for _, v in parts]), capacity
        capacity = gather_capacity(top)


def _encode_sort_shard(sfc, xs, ys, ts, bs, os_, gs, vs):
    """One shard's build: encode, sentinel the padding rows, and sort the
    six columns by ``(bins, z)``, values travelling as payload so the
    sorted layout IS the storage layout."""
    z = sfc.index(xs, ys, os_)
    bs = torch.where(vs, bs, torch.full_like(bs, _SENTINEL_BIN))
    z = torch.where(vs, z, torch.full_like(z, _SENTINEL_Z))
    gs = torch.where(vs, gs, torch.full_like(gs, -1))
    perm = _lexsort2(bs, z)
    return bs[perm], z[perm], gs[perm], xs[perm], ys[perm], ts[perm]


def _scan_shard(lb, lz, lg, xs, ys, ts, plan: dict, t_lo: int, t_hi: int,
                capacity: int):
    """One shard's scan: seeks + fixed-capacity gather + the z3 mask
    kernel (Z3Filter.inBounds) AND the exact double-precision re-check.
    Returns ``(gids, mask, total_candidates)`` as device tensors."""
    starts = searchsorted2(lb, lz, plan["rbin"], plan["rzlo"], side="left")
    ends = searchsorted2(lb, lz, plan["rbin"], plan["rzhi"], side="right")
    counts = torch.clamp(ends - starts, min=0)
    idx, valid, rid = expand_ranges(starts, counts, capacity)
    gc = lg[idx]
    tc = ts[idx]
    mask = (valid & (gc >= 0)
            & z3_mask(lz[idx], plan["ixy"], plan["rtlo"][rid],
                      plan["rthi"][rid])
            & _exact_pairs(xs[idx], ys[idx], plan["boxes"]).any(dim=1)
            & (tc >= t_lo) & (tc <= t_hi))
    return gc, mask, counts.sum()


class ShardedZ3Index:
    """Z3 point index sharded over the feature axis of a device mesh.

    Per-shard state (lists with one device tensor per shard, each sorted
    by ``(bins, z)`` and capacity-padded with sentinel keys, all shards
    of one length):

    * ``bins``/``z`` — the sort keys (the reference's ``[2B bin][8B z]``
      row-key order, Z3IndexKeySpace.scala:60)
    * ``gid`` — global row id payload (-1 for padding)
    * ``x``/``y``/``dtg`` — feature values in sorted order (no permutation
      indirection on the scan path)
    """

    DEFAULT_CAPACITY = 1 << 15
    #: plans with more ranges than this per device go to the JAX
    #: package's ring scan, which is not ported
    RING_MIN_RANGES_PER_DEVICE = 4096

    def __init__(self, mesh: DeviceMesh, period: TimePeriod,
                 bins, z, gid, x, y, dtg, n_total: int,
                 shard_counts: np.ndarray,
                 t_min_ms: int | None = None, t_max_ms: int | None = None,
                 version: int | None = None):
        self.mesh = mesh
        self.period = TimePeriod.parse(period)
        self.version = Z3_INDEX_VERSION if version is None else version
        self.sfc = z3_sfc_for_version(self.period, self.version)
        self.bins, self.z, self.gid = list(bins), list(z), list(gid)
        self.x, self.y, self.dtg = list(x), list(y), list(dtg)
        self._n_total = n_total
        #: per-shard valid row counts
        self._shard_counts = np.asarray(shard_counts, dtype=np.int64)
        self.t_min_ms = t_min_ms
        self.t_max_ms = t_max_ms
        self._capacity = self.DEFAULT_CAPACITY
        #: gid-residency segments [(gid_lo, gid_hi_excl, shard), ...]:
        #: which shard HOLDS each contiguous gid block (builds and appends
        #: place contiguous blocks); the per-shard reducers group result
        #: rows by true residency through shard_of_gids
        self._segments: list[tuple[int, int, int]] = []

    def _columns(self):
        return list(zip(self.bins, self.z, self.gid, self.x, self.y,
                        self.dtg))

    # -- builds -----------------------------------------------------------
    @classmethod
    def build(cls, x, y, dtg_ms, period: TimePeriod | str = TimePeriod.WEEK,
              mesh: DeviceMesh | None = None,
              version: int | None = None) -> "ShardedZ3Index":
        """Single-controller build: the full columns live on this host and
        scatter over the mesh (:func:`shard_batch`); gids are input row
        order."""
        mesh = mesh or device_mesh()
        period = TimePeriod.parse(period)
        version = Z3_INDEX_VERSION if version is None else version
        sfc = z3_sfc_for_version(period, version)
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        dtg_ms = np.asarray(dtg_ms, dtype=np.int64)
        host_bins, host_offs = to_binned_time(dtg_ms, period)
        n = len(x)
        gids = np.arange(n, dtype=np.int32)
        (xd, yd, td, bind, offd, gidd), valid = shard_batch(
            mesh, x, y, dtg_ms, host_bins.astype(np.int32),
            host_offs.astype(np.float64), gids)
        cols = list(zip(*(
            _encode_sort_shard(sfc, xd[s], yd[s], td[s], bind[s], offd[s],
                               gidd[s], valid[s])
            for s in range(mesh.size))))
        per = int(cols[0][0].shape[0])
        shard_counts = np.clip(n - np.arange(mesh.size) * per, 0, per)
        idx = cls(mesh, period, *cols, n_total=n, shard_counts=shard_counts,
                  version=version)
        idx._segments = _block_segments(n, per, mesh.size)
        if n:
            idx.t_min_ms = int(dtg_ms.min())
            idx.t_max_ms = int(dtg_ms.max())
        return idx

    @classmethod
    def build_multihost(cls, *args, **kwargs):
        raise NotImplementedError(
            "multi-controller (multihost) builds are not ported")

    # -- bookkeeping ------------------------------------------------------
    def total(self) -> int:
        return self._n_total

    def __len__(self) -> int:
        return self._n_total

    @property
    def capacity(self) -> int:
        """Slots per shard, padding included."""
        return int(self.z[0].shape[0])

    def shard_of_gids(self, gids: np.ndarray) -> np.ndarray:
        """Device shard HOLDING each gid (true residency, from the
        placement segments that builds and appends record)."""
        return segments_shard_of(self._segments, gids)

    def _clamp_time(self, t_lo_ms, t_hi_ms) -> tuple[int, int]:
        """Clamp to the data's time extent; ``None`` bounds are open and
        resolve to the extent itself (matching Z3PointIndex)."""
        t_lo_ms = self.t_min_ms if t_lo_ms is None else int(t_lo_ms)
        t_hi_ms = self.t_max_ms if t_hi_ms is None else int(t_hi_ms)
        if self.t_min_ms is not None:
            t_lo_ms = max(t_lo_ms, self.t_min_ms)
        if self.t_max_ms is not None:
            t_hi_ms = min(t_hi_ms, self.t_max_ms)
        return t_lo_ms, t_hi_ms

    # -- incremental ingest -----------------------------------------------
    def _grow(self, pad: int) -> None:
        """Extend every shard's columns by ``pad`` sentinel slots (the
        sorted invariant holds: sentinels are the largest key)."""
        def ext(cols, fill):
            return [torch.cat([t, torch.full((pad,), fill, dtype=t.dtype,
                                             device=t.device)])
                    for t in cols]
        self.bins = ext(self.bins, _SENTINEL_BIN)
        self.z = ext(self.z, _SENTINEL_Z)
        self.gid = ext(self.gid, -1)
        self.x, self.y, self.dtg = (ext(c, 0) for c in
                                    (self.x, self.y, self.dtg))

    def append(self, x, y, dtg_ms) -> "ShardedZ3Index":
        """Append: the new batch splits into per-shard slices, each of
        which its shard writes into its sentinel padding and re-sorts.
        The JAX package's arrays are immutable and its append returns new
        columns; here the window is written in place and the sort's
        gather replaces each column.  Returns self (mutated)."""
        x = np.asarray(x, dtype=np.float64)
        m = len(x)
        if m == 0:
            return self
        y = np.asarray(y, dtype=np.float64)
        dtg_ms = np.asarray(dtg_ms, dtype=np.int64)
        n_shards = self.mesh.size
        m_per = gather_capacity(-(-m // n_shards), minimum=8)
        pad = m_per * n_shards - m
        host_bins, host_offs = to_binned_time(dtg_ms, self.period)
        gids = np.concatenate([
            np.arange(self._n_total, self._n_total + m, dtype=np.int32),
            np.full(pad, -1, np.int32)])
        # grow per-shard capacity when any shard's padding would overflow
        need = int(self._shard_counts.max()) + m_per
        if need > self.capacity:
            self._grow(gather_capacity(need) - self.capacity)
        new = [np.pad(a, (0, pad)) for a in
               (x, y, host_offs.astype(np.float64),
                host_bins.astype(np.int32), dtg_ms)] + [gids]
        for s, dev in enumerate(self.mesh):
            xs, ys, os_, bs, ts, gs = (
                torch.from_numpy(a[s * m_per:(s + 1) * m_per]).to(dev)
                for a in new)
            z_new = self.sfc.index(xs, ys, os_)
            invalid = gs < 0
            bs = torch.where(invalid, torch.full_like(bs, _SENTINEL_BIN), bs)
            z_new = torch.where(invalid, torch.full_like(z_new, _SENTINEL_Z),
                                z_new)
            r0 = int(self._shard_counts[s])
            w = slice(r0, r0 + m_per)
            for cols, vals in ((self.bins, bs), (self.z, z_new),
                               (self.gid, gs), (self.x, xs), (self.y, ys),
                               (self.dtg, ts)):
                cols[s][w] = vals
            perm = _lexsort2(self.bins[s], self.z[s])
            for cols in (self.bins, self.z, self.gid, self.x, self.y,
                         self.dtg):
                cols[s] = cols[s][perm]
        self._shard_counts = self._shard_counts + np.clip(
            m - np.arange(n_shards) * m_per, 0, m_per)
        self._segments.extend(
            _block_segments(m, m_per, n_shards, gid_base=self._n_total))
        self._n_total += m
        t_min, t_max = int(dtg_ms.min()), int(dtg_ms.max())
        self.t_min_ms = (t_min if self.t_min_ms is None
                         else min(self.t_min_ms, t_min))
        self.t_max_ms = (t_max if self.t_max_ms is None
                         else max(self.t_max_ms, t_max))
        return self

    # -- queries ------------------------------------------------------------
    def _plan(self, boxes, t_lo_ms, t_hi_ms, max_ranges: int):
        t_lo_ms, t_hi_ms = self._clamp_time(t_lo_ms, t_hi_ms)
        return plan_z3_query(boxes, t_lo_ms, t_hi_ms, self.period,
                             max_ranges, sfc=self.sfc)

    def range_count(self, boxes, t_lo_ms: int, t_hi_ms: int,
                    max_ranges: int = DEFAULT_MAX_RANGES) -> int:
        """Candidate count across all shards (index-key resolution)."""
        plan = self._plan(boxes, t_lo_ms, t_hi_ms, max_ranges)
        if plan.num_ranges == 0:
            return 0
        return sharded_range_count(self.bins, self.z, plan.rbin, plan.rzlo,
                                   plan.rzhi)

    def range_counts_ring(self, *args, **kwargs):
        raise NotImplementedError("the ring-parallel scan is not ported")

    def query_ring(self, *args, **kwargs):
        raise NotImplementedError("the ring-parallel scan is not ported")

    def query(self, boxes, t_lo_ms: int, t_hi_ms: int,
              max_ranges: int = DEFAULT_MAX_RANGES,
              capacity: int | None = None) -> np.ndarray:
        """Exact global hit gids across all shards, sorted.

        Each shard scans its local sorted segment (:func:`_scan_shard`)
        and emits its hits' gids.  Below
        :data:`SHARDED_TWO_PHASE_MIN_CAPACITY` each shard's whole packed
        buffer is read with its candidate total in one copy; at or above
        it the totals are read first and then a hits-sized head of each
        shard's compacted buffer, and the capacity decays toward the
        observed candidate volume."""
        plan = self._plan(boxes, t_lo_ms, t_hi_ms, max_ranges)
        if plan.num_ranges == 0 or self._n_total == 0:
            return np.empty(0, dtype=np.int64)
        if plan.num_ranges > self.RING_MIN_RANGES_PER_DEVICE * self.mesh.size:
            raise NotImplementedError(
                f"a plan of {plan.num_ranges} ranges needs the ring-parallel "
                "scan, which is not ported")
        capacity = capacity or self._capacity
        r = pad_ranges({"rbin": plan.rbin, "rzlo": plan.rzlo,
                        "rzhi": plan.rzhi, "rtlo": plan.rtlo,
                        "rthi": plan.rthi}, pad_pow2(plan.num_ranges))
        ixy, bxs = pad_boxes(plan.ixy, plan.boxes,
                             pad_pow2(len(plan.boxes), minimum=1))
        args = _PerDevice(ixy=ixy, boxes=bxs, **r)
        t_lo, t_hi = plan.t_lo_ms, plan.t_hi_ms
        while True:
            scans = [_scan_shard(*cols, args.on(cols[0].device), t_lo, t_hi,
                                 capacity)
                     for cols in self._columns()]
            if capacity >= SHARDED_TWO_PHASE_MIN_CAPACITY:
                # two-phase: tiny totals first, then a hits-sized head per
                # shard instead of the full capacity buffer
                tot = np.stack(_to_host(torch.stack([t, m.sum()])
                                        for _, m, t in scans))
                if int(tot[:, 0].max(initial=0)) > capacity:
                    capacity = gather_capacity(int(tot[:, 0].max()))
                    continue
                self._capacity = max(self.DEFAULT_CAPACITY,
                                     gather_capacity(int(tot[:, 0].max())))
                k = gather_capacity(max(int(tot[:, 1].max(initial=0)), 1),
                                    minimum=8)
                heads = []
                for gc, mask, _ in scans:
                    packed = torch.where(mask, gc, torch.full_like(gc, -1))
                    if k < capacity:
                        packed = torch.sort(packed, descending=True).values[:k]
                    heads.append(packed)
                flat = np.concatenate(_to_host(heads))
                return np.sort(flat[flat >= 0]).astype(np.int64)
            wires = _to_host(pack_wire(t, gc, mask, torch.int32)
                             for gc, mask, t in scans)
            parts = [_unwire(w) for w in wires]
            top = max(t for t, _ in parts)
            if top <= capacity:
                self._capacity = capacity
                flat = np.concatenate([v for _, v in parts])
                return np.sort(flat[flat >= 0]).astype(np.int64)
            capacity = gather_capacity(top)

    def query_many(self, windows,
                   max_ranges: int = DEFAULT_MAX_RANGES) -> list[np.ndarray]:
        """Batched queries: ``windows`` is a list of ``(boxes, t_lo_ms,
        t_hi_ms)``; every window scans in one pass per shard; returns one
        sorted gid array per window."""
        n_q = len(windows)
        if n_q == 0 or self._n_total == 0:
            return [np.empty(0, dtype=np.int64) for _ in range(n_q)]
        rbin, rzlo, rzhi, rtlo, rthi, rqid = [], [], [], [], [], []
        ixy, boxes, bqid = [], [], []
        qtlo = np.empty(n_q, dtype=np.int64)
        qthi = np.empty(n_q, dtype=np.int64)
        for q, (bxs, lo, hi) in enumerate(windows):
            plan = self._plan(bxs, lo, hi, max_ranges)
            qtlo[q] = plan.t_lo_ms
            qthi[q] = plan.t_hi_ms
            if plan.num_ranges == 0:
                continue
            rbin.append(plan.rbin)
            rzlo.append(plan.rzlo)
            rzhi.append(plan.rzhi)
            rtlo.append(plan.rtlo)
            rthi.append(plan.rthi)
            rqid.append(np.full(plan.num_ranges, q, dtype=np.int32))
            ixy.append(plan.ixy)
            boxes.append(plan.boxes)
            bqid.append(np.full(len(plan.boxes), q, dtype=np.int32))
        if not rbin:
            return [np.empty(0, dtype=np.int64) for _ in range(n_q)]
        ra = {"rbin": np.concatenate(rbin), "rzlo": np.concatenate(rzlo),
              "rzhi": np.concatenate(rzhi), "rtlo": np.concatenate(rtlo),
              "rthi": np.concatenate(rthi), "rqid": np.concatenate(rqid)}
        ra = pad_ranges(ra, pad_pow2(len(ra["rbin"])))
        ixy_c, boxes_c, bqid_c = pad_boxes(
            np.concatenate(ixy), np.concatenate(boxes),
            pad_pow2(sum(len(b) for b in boxes), minimum=1),
            np.concatenate(bqid))
        args = _PerDevice(ixy=ixy_c, boxes=boxes_c, bqid=bqid_c, qtlo=qtlo,
                          qthi=qthi, **ra)
        pos_bits = coded_pos_bits(self._n_total, n_q)

        def scan(lb, lz, lg, xs, ys, ts, a, capacity):
            starts = searchsorted2(lb, lz, a["rbin"], a["rzlo"], side="left")
            ends = searchsorted2(lb, lz, a["rbin"], a["rzhi"], side="right")
            counts = torch.clamp(ends - starts, min=0)
            idx, valid, rid = expand_ranges(starts, counts, capacity)
            gc = lg[idx]
            cqid = a["rqid"][rid]
            mask = valid & (gc >= 0) & candidate_mask(
                lz[idx], a["rtlo"][rid], a["rthi"][rid], a["ixy"],
                a["boxes"], xs[idx], ys[idx], ts[idx], cqid, a["bqid"],
                a["qtlo"], a["qthi"])
            return pack_coded(counts.sum(), cqid, gc, mask, pos_bits)

        flat, self._capacity = _read_wires(scan, self._columns(), args,
                                           self._capacity)
        coded = np.sort(flat[flat >= 0]).astype(np.int64)
        # a feature can land in several of a query's covering ranges
        return split_coded(coded, pos_bits, n_q)

    # -- aggregation --------------------------------------------------------
    def _weight_table(self, weights, dtype=np.float64):
        """``(table, bases)`` for weight/value lookups by gid, on the host:
        the table is indexed by gid directly (base 0, one process).
        ``dtype`` keeps integer columns exact where float64 would lose
        bits past 2^53 (the frequency sketch hashes exact int64)."""
        return (np.ascontiguousarray(weights, dtype=dtype),
                np.zeros(1, dtype=np.int64))

    def density(self, boxes, t_lo_ms: int, t_hi_ms: int, env,
                width: int = 256, height: int = 256,
                weights=None) -> np.ndarray:
        """Global density grid for bbox(es) + interval: a masked
        histogram per shard, summed.  ``weights`` (optional) is a host
        array of per-row weights indexed by gid."""
        t_lo_ms, t_hi_ms = self._clamp_time(t_lo_ms, t_hi_ms)
        boxes = np.atleast_2d(np.asarray(boxes, dtype=np.float64))
        w_tab = bases = None
        if weights is not None:
            w_tab, bases = self._weight_table(weights)
        return sharded_density(
            self.x, self.y, self.dtg, self.gid, w_tab, boxes,
            int(t_lo_ms), int(t_hi_ms), tuple(float(v) for v in env),
            width, height, bases=bases)


def sharded_range_count(bins, z, rbin, rzlo, rzhi) -> int:
    """Candidate count of the covering ranges over every shard's sorted
    keys (per-shard lists of device tensors): per-shard seeks, summed."""
    args = _PerDevice(rbin=rbin, rzlo=rzlo, rzhi=rzhi)
    total = 0
    for lb, lz in zip(bins, z):
        a = args.on(lb.device)
        starts = searchsorted2(lb, lz, a["rbin"], a["rzlo"], side="left")
        ends = searchsorted2(lb, lz, a["rbin"], a["rzhi"], side="right")
        total += int(torch.clamp(ends - starts, min=0).sum())
    return total


def sharded_density(x, y, dtg, gid, weights, boxes,
                    t_lo_ms: int, t_hi_ms: int, env,
                    width: int, height: int, bases=None) -> np.ndarray:
    """Density grid over the shards (per-shard lists of device tensors):
    per shard, the rows inside any box and the interval go through
    :func:`density_grid_auto` (the density kernel on the card), and the
    partial grids are summed.  ``gid``
    doubles as the validity mask (>= 0 marks real rows); ``weights`` is
    an optional host table of per-row weights indexed by gid."""
    if weights is not None and bases is None:
        bases = np.zeros(1, dtype=np.int64)
    args = _PerDevice(boxes=np.atleast_2d(np.asarray(boxes, np.float64)),
                      **({} if weights is None else
                         {"w": np.asarray(weights, np.float64),
                          "bases": bases}))
    total = None
    for xs, ys, ts, gs in zip(x, y, dtg, gid):
        a = args.on(xs.device)
        mask = ((gs >= 0) & _exact_pairs(xs, ys, a["boxes"]).any(dim=1)
                & (ts >= t_lo_ms) & (ts <= t_hi_ms))
        ws = (gid_weight_lookup(gs, a["w"], a["bases"]) if weights is not None
              else torch.ones_like(xs))
        grid = density_grid_auto(xs, ys, ws, mask, env, width, height)
        total = grid if total is None else total + grid.to(total.device)
    return total.cpu().numpy()
