"""Distributed stats over the mesh.

The reference runs StatsScan on every data node and merges partial
sketches client-side (index/iterators/StatsScan.scala:125 + the
QueryPlan.Reducer, api/QueryPlan.scala:16-39).  Two mesh analogs:

* :func:`sharded_stats_scan` / :func:`sharded_frequency_scan` — numeric
  moments, a fixed-bin histogram and a count-min sketch computed per
  shard on the device and summed (the JAX package's ``psum``); only the
  partials reach the host.  The histograms run the hand-written
  ``hist1d`` kernel on the card.
* :func:`merged_stats` — the host-merge reduce: per-shard partial
  results fold through the Stat monoid.

Under multihost each process reduces its own shards' partials and the
sums, extrema and tables all-reduce over the processes on the device
(:func:`~geomesa_tpu_torch.parallel.multihost.allreduce_tensor`); value
tables stay with their process (its shards hold only its rows).
Host-side partials — spilled runs' sketches and count tables — merge
through :func:`allreduce_run_sketch` and :func:`allreduce_counts`, and
each process's metrics registry through
:func:`allreduce_metrics_snapshot`.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..metrics import merge_snapshots
from ..metrics import registry as _registry
from ..ops.gate import agree_kernel
from ..ops.hist1d_kernel import hist1d
from ..stats.stat import Frequency, Stat, _string_digest, parse_stat
from .multihost import (
    allgather_concat, allgather_strings, allreduce_tensor, process_count,
)
from .scan import _PerDevice, gid_weight_lookup

__all__ = ["sharded_stats_scan", "sharded_frequency_scan", "merged_stats",
           "allreduce_run_sketch", "allreduce_counts",
           "allreduce_metrics_snapshot", "HIST_KERNEL_MAX_SLOTS"]

#: per-shard slot count from which a histogram leaves the float32 kernel
#: for the int64 scatter: a bin counts at most every slot of its shard,
#: and float32 holds integers exactly only below 2^24
HIST_KERNEL_MAX_SLOTS = 1 << 24

_INT64_MIN = int(np.iinfo(np.int64).min)


def allreduce_metrics_snapshot(reg=None) -> dict:
    """One metrics snapshot for every process: each process's registry
    snapshot (the bucket-bearing form) allgathers as JSON over the host
    group and folds through :func:`~geomesa_tpu_torch.metrics.
    merge_snapshots` — counters sum, histogram moments and log-bucket
    tables merge, and p50/p95/p99 recompute over the union.  The identity
    (modulo the quantile recompute) under one process.  A COLLECTIVE
    under multihost: every process calls it together."""
    local = (reg if reg is not None else _registry).snapshot(buckets=True)
    if process_count() == 1:
        return merge_snapshots([local])
    blobs = allgather_strings(np.array([json.dumps(local)], dtype=object))
    return merge_snapshots([json.loads(b) for b in blobs])


def allreduce_run_sketch(part):
    """Merge one per-process :class:`~geomesa_tpu_torch.stats.sketch.
    RunSketch` over every process through the monoid (spilled runs live
    on their owning process, so their partials fold locally and meet
    here as JSON); the identity with one process."""
    if process_count() == 1:
        return part
    import json

    from ..stats.sketch import RunSketch
    merged = None
    for blob in allgather_strings(
            np.array([json.dumps(part.to_json())], dtype=object)):
        p = RunSketch.from_json(json.loads(blob))
        merged = p if merged is None else merged + p
    return merged


def allreduce_counts(counts: np.ndarray) -> np.ndarray:
    """Element-wise sum of one per-process int64 count table over every
    process (the Z3Histogram cell-table merge of spilled runs); the
    identity with one process."""
    if process_count() == 1:
        return counts
    return allgather_concat(
        np.asarray(counts, np.int64)[None, :]).sum(axis=0)


def _bbox_time_mask(xs, ys, ts, gs, bx, t_lo, t_hi):
    """Shared per-shard row mask: gid validity + any-box membership
    (inclusive edges) + inclusive time interval — the one definition the
    moments, frequency and density bodies agree on."""
    in_box = ((xs[:, None] >= bx[None, :, 0])
              & (ys[:, None] >= bx[None, :, 1])
              & (xs[:, None] <= bx[None, :, 2])
              & (ys[:, None] <= bx[None, :, 3])).any(dim=1)
    return (gs >= 0) & in_box & (ts >= t_lo) & (ts <= t_hi)


def _hist_kernel_ok(idx) -> bool:
    """Whether the float32 ``hist1d`` kernel is EXACT for this index: a
    shard's slots (padding included) bound any bin count, which must stay
    inside float32's integer range; at or above it the int64 scatter
    serves the histogram, as the JAX package's XLA branch does.  Under
    multihost the capacity grows from the agreed global per-shard counts,
    so every process takes the same route."""
    rows_per_shard = idx.capacity
    return rows_per_shard < HIST_KERNEL_MAX_SLOTS


def _histogram(bins, mask, n_bins: int, kernel: bool) -> torch.Tensor:
    """One shard's unit-weight histogram of ``bins`` over the masked rows,
    int64: the ``hist1d`` kernel (float32, exact below 2^24 per bin) or
    the int64 scatter."""
    if kernel:
        return hist1d(bins, torch.ones(bins.shape, dtype=torch.float32,
                                       device=bins.device),
                      mask, n_bins).to(torch.int64)
    hist = torch.zeros(n_bins, dtype=torch.int64, device=bins.device)
    return hist.index_add_(0, bins.to(torch.int64), mask.to(torch.int64))


def _bin_ids(vals, h_lo: float, h_hi: float, n_bins: int) -> torch.Tensor:
    """Fixed-width bin ids of float64 ``vals``, clipped to the edge bins.
    XLA's float→int32 conversion saturates and the JAX program clips after
    it; torch's conversion of NaN or of values out of int32's range is
    undefined, so the clip is taken in float64 first (which gives the same
    ids for every number) and NaN goes to bin 0, as it does on the JAX
    CPU backend."""
    q = (vals - h_lo) / ((h_hi - h_lo) / n_bins)
    q = torch.nan_to_num(q, nan=0.0)
    return torch.clamp(q, 0, n_bins - 1).to(torch.int32)


def _lsr(h, k: int):
    """Logical right shift of int64 ``h`` by ``k`` (torch shifts int64
    arithmetically)."""
    return (h >> k) & ((1 << (64 - k)) - 1)


def _as_int64(c: int) -> int:
    """A 64-bit constant as the int64 of the same bits."""
    c &= (1 << 64) - 1
    return c - (1 << 64) if c >= 1 << 63 else c


def _splitmix64(h):
    """splitmix64's finalizer in int64: multiplication wraps as uint64's
    does, and every right shift is logical."""
    h = (h ^ _lsr(h, 30)) * _as_int64(0xBF58476D1CE4E5B9)
    h = (h ^ _lsr(h, 27)) * _as_int64(0x94D049BB133111EB)
    return h ^ _lsr(h, 31)


def _umod(h, width: int):
    """``h mod width`` of int64 ``h`` read as uint64: ``h = 2 * lsr(h, 1)
    + (h & 1)``, both parts non-negative."""
    return ((_lsr(h, 1) % width) * 2 + (h & 1)) % width


def _canonical_int64(vals):
    """A value column as the int64 the host sketch hashes: float columns
    truncate, and NaN, ±inf and values outside int64 become INT64_MIN
    first (numpy's result on x86; torch's conversion of them is
    undefined).  Integer columns pass through."""
    if not vals.dtype.is_floating_point:
        return vals.to(torch.int64)
    lo = float(_INT64_MIN)
    ok = torch.isfinite(vals) & (vals >= lo) & (vals < 2.0 ** 63)
    return torch.where(ok, vals, torch.full_like(vals, lo)).to(torch.int64)


def sharded_stats_scan(idx, boxes, t_lo_ms, t_hi_ms, values=None,
                       hist_bins: int = 0, hist_range=None) -> dict:
    """Stats over a :class:`ShardedZ3Index` for a bbox+time window: count
    / sum / sumsq / min / max (+ a fixed-bin histogram when ``hist_bins``
    > 0) of ``values`` — a host table indexed by gid — or of the x
    coordinate when no values are given.  Per-shard partials on the
    device; only the scalars and the histogram reach the host."""
    t_lo_ms, t_hi_ms = idx._clamp_time(t_lo_ms, t_hi_ms)
    boxes = np.atleast_2d(np.asarray(boxes, dtype=np.float64))
    h_lo, h_hi = ((float(hist_range[0]), float(hist_range[1]))
                  if hist_range else (0.0, 1.0))
    kernel = bool(hist_bins) and _hist_kernel_ok(idx)
    if kernel and idx._multihost:
        agree_kernel("hist1d", idx.mesh[0])
    tables = {"boxes": boxes}
    if values is not None:
        tables["table"], tables["bases"] = idx._weight_table(values)
    args = _PerDevice(**tables)
    moments, counts, hists = [], [], []
    for xs, ys, ts, gs in zip(idx.x, idx.y, idx.dtg, idx.gid):
        a = args.on(xs.device)
        mask = _bbox_time_mask(xs, ys, ts, gs, a["boxes"], t_lo_ms, t_hi_ms)
        vals = (gid_weight_lookup(gs, a["table"], a["bases"])
                if values is not None else xs)
        zero = torch.zeros_like(vals)
        inf = torch.full_like(vals, float("inf"))
        counts.append(mask.sum())
        moments.append(torch.stack([
            torch.where(mask, vals, zero).sum(),
            torch.where(mask, vals * vals, zero).sum(),
            torch.where(mask, vals, inf).min(),
            torch.where(mask, vals, -inf).max()]))
        if hist_bins:
            hists.append(_histogram(_bin_ids(vals, h_lo, h_hi, hist_bins),
                                    mask, int(hist_bins), kernel))
    # reduce the per-shard partials on the first shard's device, then
    # over the processes under multihost
    dev = idx.mesh[0]
    mom = torch.stack([m.to(dev) for m in moments])
    sums = mom[:, :2].sum(dim=0)
    vmin, vmax = mom[:, 2].min().reshape(1), mom[:, 3].max().reshape(1)
    cnt = torch.stack([c.to(dev) for c in counts]).sum().reshape(1)
    hist = (torch.stack([h.to(dev) for h in hists]).sum(dim=0)
            if hist_bins else None)
    if idx._multihost:
        for t in (sums, cnt) + ((hist,) if hist_bins else ()):
            allreduce_tensor(t)
        allreduce_tensor(vmin, "min")
        allreduce_tensor(vmax, "max")
    s, s2 = sums.cpu().numpy()
    res = {"count": int(cnt[0]), "sum": float(s), "sumsq": float(s2),
           "min": float(vmin[0]), "max": float(vmax[0])}
    if hist_bins:
        res["histogram"] = hist.cpu().numpy().astype(np.int64)
    return res


def sharded_frequency_scan(idx, boxes, t_lo_ms, t_hi_ms, values,
                           depth: int = 4, width: int = 1024) -> Frequency:
    """Device count-min sketch over a bbox+time window of a
    ShardedZ3Index: per shard, each value hashes with the same seeded
    splitmix64 family as the host sketch (``stats/stat._hash_col``) and
    each hash row is histogrammed; the per-shard tables are summed.
    Returns a ``Frequency`` whose counts equal a host ``observe()`` over
    the matching rows."""
    t_lo_ms, t_hi_ms = idx._clamp_time(t_lo_ms, t_hi_ms)
    boxes = np.atleast_2d(np.asarray(boxes, dtype=np.float64))
    col = np.asarray(values)
    if col.dtype == object:
        # string columns: the seed-independent host digest of the UTF-8
        # bytes, after which the numeric seeded-splitmix path is
        # bit-identical to the host sketch
        col = _string_digest(col).view(np.int64)
    table, bases = idx._weight_table(
        col, dtype=np.int64 if col.dtype.kind in "iu" else np.float64)
    args = _PerDevice(boxes=boxes, table=table, bases=bases)
    kernel = _hist_kernel_ok(idx)
    if kernel and idx._multihost:
        agree_kernel("hist1d", idx.mesh[0])
    parts = []
    for xs, ys, ts, gs in zip(idx.x, idx.y, idx.dtg, idx.gid):
        a = args.on(xs.device)
        mask = _bbox_time_mask(xs, ys, ts, gs, a["boxes"], t_lo_ms, t_hi_ms)
        v64 = _canonical_int64(gid_weight_lookup(gs, a["table"], a["bases"]))
        rows = []
        for d in range(depth):
            h = _splitmix64(v64 ^ _as_int64((d + 1) * 0x9E3779B97F4A7C15))
            rows.append(_histogram(_umod(h, width).to(torch.int32), mask,
                                   width, kernel))
        parts.append(torch.stack(rows))
    table = torch.stack([p.to(idx.mesh[0]) for p in parts]).sum(dim=0)
    if idx._multihost:
        allreduce_tensor(table)
    return Frequency("", int(depth), int(width),
                     table.cpu().numpy().astype(np.int64))


def _shard_groups(n: int, shards) -> list[np.ndarray]:
    """Per-shard row groups for the host-merge reducers.

    ``shards`` is either an int (contiguous block split — exactly the
    residency a fresh build would create, used when no sharded index
    exists yet) or a precomputed per-row shard-id array from
    ``shard_of_gids`` (true residency, including append placements)."""
    if isinstance(shards, (int, np.integer)):
        per = -(-n // int(shards)) if n else 0
        return [np.arange(s, min(s + per, n))
                for s in range(0, n, per)] if per else []
    shards = np.asarray(shards)
    # unknown-residency rows (-1) form their own group: dropping them
    # would silently lose rows from the reduce
    return [np.flatnonzero(shards == s) for s in np.unique(shards)]


def merged_stats(batch, stat_spec: str, shards) -> Stat:
    """Per-shard observe + monoid merge (the client-side Reducer): each
    shard's resident rows fold into a fresh stat, and the partials merge
    pairwise.  Exact stats (count, minmax, histogram, enumeration,
    descriptive) equal the single-pass result; sketches (TopK, Frequency)
    merge within their approximation guarantees, as the reference's
    Stat.+ does (Stat.scala:31-90).  ``shards``: a shard-id-per-row array
    (true residency) or an int block split (see _shard_groups)."""
    proto = parse_stat(stat_spec)
    partials = []
    for rows in _shard_groups(len(batch), shards):
        part = proto.fresh_copy()
        part.observe(batch.take(rows))
        partials.append(part)
    if not partials:
        return proto
    merged = partials[0]
    for p in partials[1:]:
        merged = merged + p
    return merged
