"""Z3 point index: bbox + time queries over (lon, lat, dtg) point features.

The reference's Z3 index (geomesa-index-api/.../index/z3/
Z3IndexKeySpace.scala) as device-resident torch columns:

* **Key layout.** The reference writes ``[1B shard][2B bin][8B z][id]``
  rows (Z3IndexKeySpace.scala:60).  Here the same order lives as two
  sorted device columns — ``bins`` (int32) and ``z`` (int64) sorted
  lexicographically — plus ``pos``, the permutation into the original
  feature columns.
* **Write path.** ``build`` = host time-binning (calendar-aware,
  BinnedTime semantics) → SFC encode on the device → device lexsort (the
  KV store's implicit sort made explicit).  Appends write into sentinel
  padding and re-sort.
* **Query path.** Host planning mirrors Z3IndexKeySpace.getIndexValues/
  getRanges (:98-189): bin the time interval, decompose bbox × per-bin
  time windows into covering z-ranges with the scan-ranges budget split
  across bins (:166-168).  Device scan = vectorized binary-search seeks +
  one fixed-capacity gather + the z3 mask kernel (filters/Z3Filter.scala:
  19-55 semantics) + the exact double-precision predicate (the
  reference's FilterTransformIterator CQL re-check).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import DEFAULT_MAX_RANGES
from ..curve.binnedtime import TimePeriod, max_date_ms, max_offset, to_binned_time
from ..curve.legacy import legacy_z3_sfc
from ..curve.sfc import z3_sfc
from ..device import resolve_device
from ..obs.trace import device_span
from ..ops.search import (
    coded_pos_bits, expand_ranges, gather_capacity, pack_coded,
    pack_wire, pad_boxes, pad_pow2, pad_ranges, run_packed_query,
    searchsorted2, split_coded,
)
from ..ops.z3_mask import MAX_BOXES, z3_mask
from ..resilience.deadline import check_cancel

__all__ = ["Z3PointIndex", "Z3QueryPlan", "plan_z3_query"]


@dataclass
class Z3QueryPlan:
    """Host-side scan plan: covering ranges + filter bounds (all numpy)."""

    # per-range arrays (R,)
    rbin: np.ndarray      # int32 time bin
    rzlo: np.ndarray      # int64 inclusive z lo
    rzhi: np.ndarray      # int64 inclusive z hi
    rtlo: np.ndarray      # int32 normalized time lo for the range's bin
    rthi: np.ndarray      # int32 normalized time hi
    # normalized-int spatial bounds (Z3Filter semantics), per box (B, 4)
    ixy: np.ndarray
    # exact double-precision bounds
    boxes: np.ndarray     # (B, 4) xmin, ymin, xmax, ymax
    t_lo_ms: int
    t_hi_ms: int

    @property
    def num_ranges(self) -> int:
        return len(self.rbin)


def _time_windows_by_bin(t_lo_ms: int, t_hi_ms: int, period: TimePeriod):
    """Split [lo, hi] ms into per-bin offset windows; mirror of the
    reference's ``timesByBin`` construction (Z3IndexKeySpace.scala:120-158):
    interior bins get the whole period, boundary bins get partial windows."""
    lo_ms = max(0, int(t_lo_ms))
    hi_ms = min(int(t_hi_ms), max_date_ms(period) - 1)
    if lo_ms > hi_ms:
        return {}
    blo_a, olo_a = to_binned_time(lo_ms, period)
    bhi_a, ohi_a = to_binned_time(hi_ms, period)
    blo, olo, bhi, ohi = int(blo_a), int(olo_a), int(bhi_a), int(ohi_a)
    whole = (0, max_offset(period))
    if blo == bhi:
        return {blo: (olo, ohi)}
    windows = {blo: (olo, whole[1]), bhi: (0, ohi)}
    for b in range(blo + 1, bhi):
        windows[b] = whole
    return windows


def plan_z3_query(
    boxes,
    t_lo_ms: int,
    t_hi_ms: int,
    period: TimePeriod | str = TimePeriod.WEEK,
    max_ranges: int = DEFAULT_MAX_RANGES,
    sfc=None,
) -> Z3QueryPlan:
    """Decompose bbox(es) + time interval into a covering-range scan plan.

    The scan-ranges budget is split across time bins as in
    Z3IndexKeySpace.getRanges (:166-168); whole-period bins share one
    decomposition, partial (boundary) bins get their own."""
    period = TimePeriod.parse(period)
    sfc = sfc if sfc is not None else z3_sfc(period)
    boxes = np.atleast_2d(np.asarray(boxes, dtype=np.float64))
    windows = _time_windows_by_bin(t_lo_ms, t_hi_ms, period)
    empty = np.empty(0, dtype=np.int64)
    if not windows:
        return Z3QueryPlan(
            rbin=empty.astype(np.int32), rzlo=empty, rzhi=empty,
            rtlo=empty.astype(np.int32), rthi=empty.astype(np.int32),
            ixy=np.empty((0, 4), np.int32), boxes=boxes,
            t_lo_ms=int(t_lo_ms), t_hi_ms=int(t_hi_ms),
        )
    target = max(1, max_ranges // max(1, len(windows)))

    # group bins by identical time window so whole-period bins share one
    # range decomposition
    by_window: dict[tuple[int, int], list[int]] = {}
    for b, w in windows.items():
        by_window.setdefault(w, []).append(b)

    rbin, rzlo, rzhi, rtlo, rthi = [], [], [], [], []
    for (wlo, whi), bs in by_window.items():
        zr = sfc.ranges(boxes, [(wlo, whi)], max_ranges=target)
        itlo = sfc.time.normalize_scalar(float(wlo))
        ithi = sfc.time.normalize_scalar(float(whi))
        for b in sorted(bs):
            rbin.append(np.full(len(zr), b, dtype=np.int32))
            rzlo.append(zr[:, 0])
            rzhi.append(zr[:, 1])
            rtlo.append(np.full(len(zr), itlo, dtype=np.int32))
            rthi.append(np.full(len(zr), ithi, dtype=np.int32))

    ixy = np.stack(
        [
            [
                sfc.lon.normalize_scalar(b[0]),
                sfc.lat.normalize_scalar(b[1]),
                sfc.lon.normalize_scalar(b[2]),
                sfc.lat.normalize_scalar(b[3]),
            ]
            for b in boxes
        ]
    ).astype(np.int32)

    return Z3QueryPlan(
        rbin=np.concatenate(rbin),
        rzlo=np.concatenate(rzlo),
        rzhi=np.concatenate(rzhi),
        rtlo=np.concatenate(rtlo),
        rthi=np.concatenate(rthi),
        ixy=ixy,
        boxes=boxes,
        t_lo_ms=int(t_lo_ms),
        t_hi_ms=int(t_hi_ms),
    )


def _exact_pairs(xc, yc, boxes):
    """(N, B) exact double-precision box tests (FilterTransformIterator)."""
    return ((xc[:, None] >= boxes[None, :, 0])
            & (yc[:, None] >= boxes[None, :, 1])
            & (xc[:, None] <= boxes[None, :, 2])
            & (yc[:, None] <= boxes[None, :, 3]))


def z3_mask_union(zc, ixy, tlo, thi):
    """:func:`~geomesa_tpu_torch.ops.z3_mask.z3_mask` over any number of
    boxes: one launch per ``MAX_BOXES`` boxes, OR-ed."""
    out = None
    for i in range(0, ixy.shape[0], MAX_BOXES):
        m = z3_mask(zc, ixy[i:i + MAX_BOXES], tlo, thi)
        out = m if out is None else out | m
    return out


def candidate_mask(zc, rtlo_c, rthi_c, ixy, boxes, xc, yc, tc,
                   cqid, bqid, qtlo, qthi):
    """Candidate filter of the batched multi-window scan: the z-decode
    int-space bounds test (Z3Filter.inBounds, filters/Z3Filter.scala:
    19-55) AND the exact double-precision re-check.

    ``rtlo_c``/``rthi_c`` are per-CANDIDATE normalized time bounds
    (already gathered by owning range).  Exact boxes only apply to
    candidates of the same query (``cqid`` against ``bqid``); exact time
    bounds come from ``qtlo``/``qthi`` per query.  The int-space test
    runs the z3 mask kernel over the union of every window's boxes: a
    superset of the per-window test, and the same mask once ANDed with
    the exact per-window re-check, which implies the per-window int test
    (box and point normalize through one monotone floor).  The JAX
    package pairs the int test per window in XLA here; its Pallas kernel
    runs only on the single-query scan.
    """
    exact_pairs = _exact_pairs(xc, yc, boxes) & (cqid[:, None]
                                                 == bqid[None, :])
    q = cqid.to(torch.int64)
    in_time_exact = (tc >= qtlo[q]) & (tc <= qthi[q])
    return (z3_mask_union(zc, ixy, rtlo_c, rthi_c)
            & exact_pairs.any(dim=1) & in_time_exact)


def _scan_core(
    bins, z, pos, x, y, dtg,
    rbin, rzlo, rzhi, rtlo, rthi,
    ixy, boxes, t_lo_ms, t_hi_ms,
    capacity: int,
):
    """The scan body shared by every single-query path: binary-search
    seeks + fixed-capacity gather + the z3 mask kernel (the z-decode
    int-space bounds test, Z3Iterator/Z3Filter) AND the exact
    double-precision re-check (FilterTransformIterator).  Returns
    ``(posc, mask, total_candidates)`` as device tensors."""
    starts = searchsorted2(bins, z, rbin, rzlo, side="left")
    ends = searchsorted2(bins, z, rbin, rzhi, side="right")
    counts = torch.clamp(ends - starts, min=0)
    total = counts.sum()
    idx, valid, rid = expand_ranges(starts, counts, capacity)
    zc = z[idx]
    posc = pos[idx]
    pl = posc.to(torch.int64)
    xc = x[pl]
    yc = y[pl]
    tc = dtg[pl]
    mask_int = z3_mask(zc, ixy, rtlo[rid], rthi[rid])
    in_box_exact = _exact_pairs(xc, yc, boxes).any(dim=1)
    mask = mask_int & in_box_exact & (tc >= t_lo_ms) & (tc <= t_hi_ms)
    return posc, valid & mask, total


def _query_packed(*args, capacity: int):
    """The WHOLE scan returning one packed int32 vector
    ``[total_hi, total_lo, pos_0|-1, pos_1|-1, …]`` — one device→host
    copy per query.  ``total`` lets the host detect capacity overflow and
    retry bigger (rare; capacity is adaptive)."""
    posc, mask, total = _scan_core(*args, capacity=capacity)
    return pack_wire(total, posc, mask, torch.int32)


def _scan_keep_device(*args, capacity: int):
    """Two-phase variant of :func:`_query_packed`: the packed vector
    stays ON DEVICE and only ``[total_candidates, total_hits]`` crosses
    to the host, which then runs :func:`_compact_hits` for a hits-sized
    copy — the better trade once capacity is large and selectivity low."""
    posc, mask, total = _scan_core(*args, capacity=capacity)
    packed = torch.where(mask, posc.to(torch.int32),
                         torch.full_like(posc, -1, dtype=torch.int32))
    totals = torch.stack([total.to(torch.int64),
                          mask.sum().to(torch.int64)])
    return packed, totals


def _compact_hits(packed, k: int):
    """Descending sort floats the valid (>= 0) positions to the front;
    the first ``k`` slots cover all hits (k = pow2 >= total_hits)."""
    return torch.sort(packed, descending=True).values[:k]


#: capacity at which the two-phase (device-compact) read takes over from
#: the single full-buffer copy
TWO_PHASE_MIN_CAPACITY = 1 << 19


def _query_many_packed(
    bins, z, pos, x, y, dtg,
    rbin, rzlo, rzhi, rtlo, rthi, rqid,
    ixy, boxes, bqid, qtlo, qthi,
    capacity: int, pos_bits: int = 40,
):
    """Batched multi-window scan: Q independent bbox+time queries in ONE
    pass (the reference's BatchScanner over many range sets, accumulated
    per query).  Each covering range and each box carries its owning
    query id; a candidate only matches boxes/time bounds of its own
    query.  Returns ``[total, (qid << pos_bits | pos)|-1, …]`` — one copy
    decodes into per-query hit lists; int32 when qid and pos together fit
    31 bits, else int64."""
    starts = searchsorted2(bins, z, rbin, rzlo, side="left")
    ends = searchsorted2(bins, z, rbin, rzhi, side="right")
    counts = torch.clamp(ends - starts, min=0)
    total = counts.sum()
    idx, valid, rid = expand_ranges(starts, counts, capacity)
    zc = z[idx]
    posc = pos[idx]
    pl = posc.to(torch.int64)
    cqid = rqid[rid]
    mask = valid & candidate_mask(
        zc, rtlo[rid], rthi[rid], ixy, boxes,
        x[pl], y[pl], dtg[pl], cqid, bqid, qtlo, qthi)
    return pack_coded(total, cqid, posc, mask, pos_bits)


#: sentinel keys for capacity-padding slots: sort after every real key
#: and can never match a query range (real bins are small)
_SENTINEL_BIN = int(np.iinfo(np.int32).max)
_SENTINEL_Z = int(np.iinfo(np.int64).max)


def _lexsort2(bins, z):
    """Permutation sorting ``(bins, z)`` lexicographically, bin-major.
    Two stable sorts — by z, then by bin — because bin and z together are
    79 bits and fit no single key.  Ties on equal ``(bin, z)`` keep their
    incoming order (the JAX sort leaves them unspecified; positions are
    sorted again per query, so hit sets do not depend on it)."""
    perm = torch.sort(z, stable=True).indices
    return perm[torch.sort(bins[perm], stable=True).indices]


def _encode_sort_z3(sfc, xs, ys, os_, bs):
    """Key encode + 2-key sort (bin-major), the permutation as payload."""
    zv = sfc.index(xs, ys, os_)
    perm = _lexsort2(bs, zv)
    return bs[perm], zv[perm], perm.to(torch.int32)


def _append_step(sfc, idx: "Z3PointIndex", r: int, xs, ys, offs, bs, ts,
                 m_valid: int) -> None:
    """One incremental append: encode the (padded) new batch, write its
    keys over the sentinel slots at the sorted tail, and re-sort the
    capacity-padded key columns.  JAX's arrays were immutable and its
    version returned new columns (``dynamic_update_slice``); the port
    updates the resident columns in place with slice assignment, so an
    append allocates no second copy of the value columns.  The new
    feature values land at ``[r, r + m_pad)`` of the value columns (slots
    past m_valid belong to invalid rows that are never gathered)."""
    m_pad = int(xs.shape[0])
    device = idx.z.device
    z_b = sfc.index(xs, ys, offs)
    valid_b = torch.arange(m_pad, device=device) < m_valid
    bs = torch.where(valid_b, bs, torch.full_like(bs, _SENTINEL_BIN))
    z_b = torch.where(valid_b, z_b, torch.full_like(z_b, _SENTINEL_Z))
    payload = torch.where(
        valid_b, r + torch.arange(m_pad, dtype=torch.int32, device=device),
        torch.full((m_pad,), -1, dtype=torch.int32, device=device))
    # sentinels occupy the sorted tail, so the write window starts at r
    w = slice(r, r + m_pad)
    idx.bins[w] = bs
    idx.z[w] = z_b
    idx.pos[w] = payload
    idx.x[w] = xs
    idx.y[w] = ys
    idx.dtg[w] = ts
    perm = _lexsort2(idx.bins, idx.z)
    idx.bins = idx.bins[perm]
    idx.z = idx.z[perm]
    idx.pos = idx.pos[perm]


#: current z3 key-layout version (v1 = legacy semi-normalized curve —
#: the reference's Z3IndexV1 era)
Z3_INDEX_VERSION = 2


def z3_sfc_for_version(period: TimePeriod, version: int):
    """Curve for a persisted index-layout version (the read-path
    dispatch of the reference's versioned indices,
    index/index/z3/legacy/Z3IndexV1.scala): v1 is the legacy
    semi-normalized curve (curve/legacy.py)."""
    if version >= 2:
        return z3_sfc(period)
    return legacy_z3_sfc(period)


class Z3PointIndex:
    """Device-resident Z3 index over point features with timestamps."""

    #: initial fixed gather capacity; grows adaptively on overflow so the
    #: common case is exactly ONE scan + ONE copy per query
    DEFAULT_CAPACITY = 1 << 15

    def __init__(self, period, bins, z, pos, x, y, dtg,
                 version: int = Z3_INDEX_VERSION):
        self.period = TimePeriod.parse(period)
        self.version = version
        self.sfc = z3_sfc_for_version(self.period, version)
        self.bins = bins
        self.z = z
        self.pos = pos
        self.x = x
        self.y = y
        self.dtg = dtg
        #: valid rows; append() capacity-pads the arrays with sentinel
        #: keys past this count
        self._n_rows = int(z.shape[0])
        self._capacity = self.DEFAULT_CAPACITY
        #: data time extent; queries clamp to it so an unbounded interval
        #: plans over the data's bins, not every bin since the epoch
        self.t_min_ms: int | None = None
        self.t_max_ms: int | None = None

    @property
    def device(self) -> torch.device:
        return self.z.device

    @classmethod
    def build(cls, x, y, dtg_ms, period: TimePeriod | str = TimePeriod.WEEK,
              version: int = Z3_INDEX_VERSION,
              device=None) -> "Z3PointIndex":
        """Encode keys and sort (device lexsort, bin-major) on ``device``
        (the card unless the caller names the CPU)."""
        dev = resolve_device(device)
        period = TimePeriod.parse(period)
        sfc = z3_sfc_for_version(period, version)
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        dtg_ms = np.asarray(dtg_ms, dtype=np.int64)
        host_bins, host_offs = to_binned_time(dtg_ms, period)
        t_min = int(dtg_ms.min()) if len(dtg_ms) else 0
        t_max = int(dtg_ms.max()) if len(dtg_ms) else 0

        # torch.tensor copies: the index owns its columns (appends write
        # into them in place), never aliasing the caller's arrays
        xd = torch.tensor(x, device=dev)
        yd = torch.tensor(y, device=dev)
        td = torch.tensor(dtg_ms, device=dev)
        bind = torch.tensor(host_bins.astype(np.int32), device=dev)
        offd = torch.tensor(host_offs.astype(np.float64), device=dev)

        bins_s, z_s, pos = _encode_sort_z3(sfc, xd, yd, offd, bind)
        idx = cls(period, bins=bins_s, z=z_s, pos=pos, x=xd, y=yd, dtg=td,
                  version=version)
        idx.t_min_ms, idx.t_max_ms = t_min, t_max
        return idx

    def __len__(self) -> int:
        return self._n_rows

    def _grow_capacity(self, cap: int) -> None:
        """Extend the resident columns to ``cap`` slots with sentinel
        keys (sort last, match nothing) — one reallocation per
        power-of-two growth step."""
        pad = cap - int(self.z.shape[0])
        if pad <= 0:
            return

        def ext(t, fill):
            return torch.cat([t, torch.full((pad,), fill, dtype=t.dtype,
                                            device=t.device)])

        self.bins = ext(self.bins, _SENTINEL_BIN)
        self.z = ext(self.z, _SENTINEL_Z)
        self.pos = ext(self.pos, -1)
        self.x = ext(self.x, 0)
        self.y = ext(self.y, 0)
        self.dtg = ext(self.dtg, 0)

    def append(self, x, y, dtg_ms) -> "Z3PointIndex":
        """Incremental ingest: encode the NEW batch, write its keys into
        the sentinel padding, and re-sort the capacity-padded columns in
        place, entirely device-resident — the win over a rebuild is
        skipping the host→device re-upload of the whole dataset.  Shapes
        bucket by (capacity, pow2(m)).  Returns self (mutated)."""
        x = np.asarray(x, dtype=np.float64)
        m = len(x)
        if m == 0:
            return self
        y = np.asarray(y, dtype=np.float64)
        dtg_ms = np.asarray(dtg_ms, dtype=np.int64)
        m_pad = gather_capacity(m, minimum=8)
        r = self._n_rows
        if r + m_pad > int(self.z.shape[0]):
            self._grow_capacity(gather_capacity(r + m_pad))
        host_bins, host_offs = to_binned_time(dtg_ms, self.period)
        pad = m_pad - m
        dev = self.device

        def up(a):
            return torch.from_numpy(np.pad(a, (0, pad))).to(dev)

        _append_step(self.sfc, self, r, up(x), up(y),
                     up(host_offs.astype(np.float64)),
                     up(host_bins.astype(np.int32)), up(dtg_ms), m)
        self._n_rows = r + m
        t_min = int(dtg_ms.min())
        t_max = int(dtg_ms.max())
        self.t_min_ms = t_min if self.t_min_ms is None else min(self.t_min_ms, t_min)
        self.t_max_ms = t_max if self.t_max_ms is None else max(self.t_max_ms, t_max)
        return self

    def _clamp_time(self, t_lo_ms, t_hi_ms) -> tuple[int, int]:
        """Clamp to the data's time extent; ``None`` bounds are open (no
        time constraint) and resolve to the extent itself."""
        t_lo_ms = self.t_min_ms if t_lo_ms is None else int(t_lo_ms)
        t_hi_ms = self.t_max_ms if t_hi_ms is None else int(t_hi_ms)
        if self.t_min_ms is not None:
            t_lo_ms = max(t_lo_ms, self.t_min_ms)
        if self.t_max_ms is not None:
            t_hi_ms = min(t_hi_ms, self.t_max_ms)
        return t_lo_ms, t_hi_ms

    def _dev(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def query(self, boxes, t_lo_ms: int, t_hi_ms: int,
              max_ranges: int = DEFAULT_MAX_RANGES) -> np.ndarray:
        """Return original-order positions of features matching
        bbox(es) ∧ time interval, exactly (oracle-equal hit sets)."""
        t_lo_ms, t_hi_ms = self._clamp_time(t_lo_ms, t_hi_ms)
        plan = plan_z3_query(boxes, t_lo_ms, t_hi_ms, self.period, max_ranges,
                             sfc=self.sfc)
        if plan.num_ranges == 0 or len(self) == 0:
            return np.empty(0, dtype=np.int64)
        # bucket the plan shapes (one shape per power-of-two range/box
        # count)
        r = pad_ranges({"rbin": plan.rbin, "rzlo": plan.rzlo,
                        "rzhi": plan.rzhi, "rtlo": plan.rtlo,
                        "rthi": plan.rthi}, pad_pow2(plan.num_ranges))
        ixy, bxs = pad_boxes(plan.ixy, plan.boxes,
                             pad_pow2(len(plan.boxes), minimum=1))
        args = (
            self.bins, self.z, self.pos, self.x, self.y, self.dtg,
            self._dev(r["rbin"]), self._dev(r["rzlo"]), self._dev(r["rzhi"]),
            self._dev(r["rtlo"]), self._dev(r["rthi"]),
            self._dev(ixy), self._dev(bxs),
            plan.t_lo_ms, plan.t_hi_ms,
        )
        if self._capacity >= TWO_PHASE_MIN_CAPACITY:
            return self._query_two_phase(args)

        def dispatch(capacity):
            # the copy ends inside the span: it is the device round trip
            with device_span("query.scan.device", stage="packed",
                             capacity=capacity):
                return _query_packed(*args, capacity=capacity).cpu()

        hits, self._capacity = run_packed_query(dispatch, self._capacity)
        return hits

    def _query_two_phase(self, args) -> np.ndarray:
        """Large-capacity scan: keep the packed vector on device, read
        the tiny totals, then copy a device-compacted hits-sized slice
        (see _scan_keep_device).  When the hits nearly fill the capacity
        the compaction buys nothing, so the packed buffer is read
        directly."""
        capacity = self._capacity
        while True:
            with device_span("query.scan.device", stage="two_phase",
                             capacity=capacity):
                packed, totals = _scan_keep_device(*args, capacity=capacity)
                total, nhits = (int(v) for v in totals.cpu().tolist())
                if total > capacity:
                    capacity = gather_capacity(total)
                    continue
                # decay toward the observed candidate volume so one huge
                # query doesn't tax every later small one (re-growth
                # costs a single retry)
                self._capacity = max(self.DEFAULT_CAPACITY,
                                     gather_capacity(total))
                k = gather_capacity(max(nhits, 1), minimum=8)
                if k >= capacity:  # dense result: compact can't shrink
                    out = packed.cpu().numpy()
                else:
                    out = _compact_hits(packed, k=k).cpu().numpy()
            return np.sort(out[out >= 0]).astype(np.int64)

    def query_many(self, windows,
                   max_ranges: int = DEFAULT_MAX_RANGES) -> list[np.ndarray]:
        """Batched queries: ``windows`` is a list of
        ``(boxes, t_lo_ms, t_hi_ms)``; returns one sorted position array
        per window — all windows scanned in ONE pass (see
        _query_many_packed)."""
        n_q = len(windows)
        if n_q == 0 or len(self) == 0:
            return [np.empty(0, dtype=np.int64) for _ in range(n_q)]
        rbin, rzlo, rzhi, rtlo, rthi, rqid = [], [], [], [], [], []
        ixy, boxes, bqid = [], [], []
        qtlo = np.empty(n_q, dtype=np.int64)
        qthi = np.empty(n_q, dtype=np.int64)
        for q, (bxs, lo, hi) in enumerate(windows):
            # deadline yield point between range decompositions: a
            # partial break leaves the remaining windows with no ranges,
            # so they return empty hit lists
            if check_cancel("query.decompose"):
                break
            lo, hi = self._clamp_time(lo, hi)
            # the scan-ranges target applies PER window, as in the
            # reference (each window is an independent scan)
            plan = plan_z3_query(bxs, lo, hi, self.period, max_ranges,
                                 sfc=self.sfc)
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
        args = (
            self.bins, self.z, self.pos, self.x, self.y, self.dtg,
            self._dev(ra["rbin"]), self._dev(ra["rzlo"]),
            self._dev(ra["rzhi"]), self._dev(ra["rtlo"]),
            self._dev(ra["rthi"]), self._dev(ra["rqid"]),
            self._dev(ixy_c), self._dev(boxes_c), self._dev(bqid_c),
            self._dev(qtlo), self._dev(qthi),
        )
        pos_bits = coded_pos_bits(len(self), n_q)

        def dispatch(capacity):
            with device_span("query.scan.device", stage="packed_many",
                             capacity=capacity):
                return _query_many_packed(*args, capacity=capacity,
                                          pos_bits=pos_bits).cpu()

        coded, self._capacity = run_packed_query(dispatch, self._capacity)
        # a feature can land in several of a query's covering ranges
        return split_coded(coded, pos_bits, n_q)
