"""LeanZ3Index: tiered generational Z3 index — the store's lean (scale)
profile.

The port of the JAX package's ``index/z3_lean.py``.  The full-fat
:class:`~geomesa_tpu_torch.index.z3.Z3PointIndex` keeps x/y/dtg resident
next to its keys (40 B/point) so the exact re-check fuses into the scan.
Past a few hundred million points device memory is the wall, so this
index keeps the searchable keys — ``(bins int32, z int64, pos int32)`` =
16 B/point, the role of the tablet server's key space — in sorted
GENERATIONS of bounded capacity (LSM-flavoured: appends fill the current
generation and roll to a new one when full, so the append sort's working
set is one generation), while the payload columns stay in host RAM (the
"value" fetch; clients re-check exactly, AccumuloIndexAdapter.scala:
181-195).

**Tiers.**  Each generation has a residency tier, demoted oldest-first as
the store outgrows ``hbm_budget_bytes``:

* ``full`` — keys AND an (x, y, t) payload copy on the device (40 B/pt):
  the exact bbox+time mask runs on the device and only survivors cross
  to the host.
* ``keys`` — keys only on the device (16 B/pt): device seeks + candidate
  gather; the exact mask runs vectorized on the host payload.
* ``host`` — the sorted key run spilled to host RAM (0 B of device
  memory): numpy segmented searchsorted seeks.

The tier decisions are the JAX package's, slot for slot: the accounting
is per-slot arithmetic (:data:`KEYS_BYTES`, :data:`FULL_BYTES`) against
the same budget, including the sentinel padding buffers the JAX index
allocates for its compile buckets.  The port runs eager PyTorch, so it
pads nothing and allocates no sentinel generation (padding changes no
result); its budget still charges them so that every tier decision
equals the reference's for the same inputs.

**Programs.**  The JAX package runs each multi-generation program (count
probe, candidate scan, exact scan, density) as one jitted dispatch over
all generations.  Here each is a loop over the generations of plain
PyTorch operations on the generations' device, the seek being
:func:`~geomesa_tpu_torch.ops.search.searchsorted2`.  No Pallas kernel
sits on this path in the JAX package, so none does here; the probe's
per-generation seeks are reused by the scan that follows it.
``dispatch_count`` counts the port's own per-generation programs and is
not held equal to the JAX package's.

**LSM lifecycle.**  :meth:`LeanZ3Index.compact` is a budgeted, resumable
size-tiered K-way merge (device sort for keys-tier runs, numpy lexsort
for spilled host runs); sealed generations' density partials, z3
cell-count partials and density pyramids cache per spec
(:class:`~geomesa_tpu_torch.index.partial_cache.PartialCache`) and are
invalidated when their generation merges away — a merged run inherits
the SUM of its parents' pyramids.  Seals and merges fire the
``generation_listeners`` (the store's build-behind pyramid trigger).

**Aggregates next to the keys.**  :meth:`LeanZ3Index.build_pyramids`
builds each sealed generation's density pyramid
(:mod:`~geomesa_tpu_torch.index.pyramid`), which the whole-world sweep
then serves in place of sweeping that generation;
:meth:`LeanZ3Index.z3_cell_counts` folds every generation's keys into
(time-bin, z-cell) counts (the Z3Histogram push-down and the planner's
cardinality estimator).

**Replanning.**  :meth:`LeanZ3Index.query_many` reports its candidate
counts to an ambient replan scope (planning/adaptive.py) after the
device probe and after the host-tier seek, before any gather or exact
mask, so a mispredicted plan aborts having collected nothing.

Not ported from the JAX index (each is absent): degraded execution on
device failure (a device error propagates), heat tracking, spans and
metrics.

Reference mapping: Z3IndexKeySpace.scala:60 (key layout),
IndexAdapter.scala:95-106 (writers), AccumuloQueryPlan.scala:87-157
(scan plans over sorted runs).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_MAX_RANGES, DensityProperties
from ..curve.binnedtime import TimePeriod, to_binned_time
from ..curve.zorder import deinterleave3
from ..device import resolve_device
from ..ops.density import pyramid_reduce
from ..ops.search import (
    coded_pos_bits, expand_ranges, gather_capacity, pad_pow2, pad_ranges,
    searchsorted2, split_coded, wire_dtype,
)
from .lsm import (
    compact_incremental, merged_capacity, notify_generation_event,
    plan_size_tiered, replace_group,
)
from ..planning.adaptive import check_replan
from .partial_cache import PartialCache
from .pyramid import DensityPyramid, _ladder_depth, pyramid_spec
from .z3 import (
    _SENTINEL_BIN, _SENTINEL_Z, Z3_INDEX_VERSION, _lexsort2, plan_z3_query,
    z3_sfc_for_version,
)

__all__ = ["LeanZ3Index", "HostRun", "HostStack", "merge_host_runs",
           "KEYS_BYTES", "FULL_BYTES"]

#: per-slot byte widths, derived once from the column dtypes (bins int32
#: + z int64 + pos int32 — positions are int32 here — and the full tier
#: adds x/y float64 + t int64).  Every budget computation uses these.
KEYS_BYTES = 4 + 8 + 4
PAYLOAD_BYTES = 8 + 8 + 8
FULL_BYTES = KEYS_BYTES + PAYLOAD_BYTES

#: combined candidate-slot count at which the full tier's two-phase read
#: (device compaction + survivors-sized copy) replaces copying every
#: gathered slot
_TWO_PHASE_MIN_SLOTS = 1 << 18

#: hard per-window range cap after per-bin scaling (plan assembly and
#: upload are host work)
_MAX_RANGES_PER_WINDOW = 1 << 14

_WORLD_ENV = (-180.0, -90.0, 180.0, 90.0)


def _bins_spanned(t_lo_ms: int, t_hi_ms: int, period) -> int:
    """Time bins a clamped interval covers (per-window range budgets
    scale by it: a tiny box over 27 open-bounds bins would otherwise get
    2000/27 ranges per bin)."""
    b_lo, _ = to_binned_time(np.int64(max(0, t_lo_ms)), period)
    b_hi, _ = to_binned_time(np.int64(max(0, t_hi_ms)), period)
    return max(1, int(b_hi) - int(b_lo) + 1)


def _np_decode(sfc, z: np.ndarray):
    """Host twin of the device decode: ``(ix, iy, it)`` int64 numpy cell
    coordinates of z keys (through the port's torch decode on CPU
    tensors, zero-copy)."""
    ix, iy, it = deinterleave3(torch.from_numpy(np.ascontiguousarray(z)))
    return ix.numpy(), iy.numpy(), it.numpy()


def _np_denormalize(dim, i: np.ndarray) -> np.ndarray:
    """Host twin of ``dim.denormalize`` (cell centre, float64)."""
    return dim.denormalize(torch.from_numpy(i)).numpy()


def _grid_cells(xd, yd, env, width: int, height: int):
    """Floor-and-clip grid cells of float64 coordinates over ``env``, in
    the JAX package's order of operations (``(x - x0) / max(x1 - x0,
    1e-12) * width``, truncated, then clipped).  The float is clamped to
    ``[-1, width]`` before the integer conversion, which equals the
    clip after it for every finite input and keeps far-away points from
    overflowing the conversion."""
    fx = (xd - env[0]) / max(env[2] - env[0], 1e-12) * width
    fy = (yd - env[1]) / max(env[3] - env[1], 1e-12) * height
    gx = fx.clamp(-1.0, float(width)).to(torch.int64).clamp(0, width - 1)
    gy = fy.clamp(-1.0, float(height)).to(torch.int64).clamp(0, height - 1)
    return gx, gy


def _grid_count(gx, gy, ok, width: int, height: int) -> torch.Tensor:
    """Exact integer counts of the ``ok`` cells as a flat float64 grid.

    The JAX package counts by sort + boundary differences
    (``_grid_accum``: searchsorted bounds of the sorted cells) because the
    TPU's float64 scatter-add is emulated; an integer ``torch.bincount``
    gives the same counts exactly.  This is a library call standing in
    for XLA code, not for a Pallas kernel (none sits on the lean density
    path).  Masked rows count into a sentinel cell past the grid; ``ok``
    None counts every row."""
    g = width * height
    flat = gy * width + gx
    if ok is not None:
        flat = torch.where(ok, flat, torch.full_like(gx, g))
    return torch.bincount(flat, minlength=g + 1)[:g].to(torch.float64)


def _z3_cells(bins, z, b0: int, nb: int, bits: int) -> torch.Tensor:
    """Z3Histogram fold of one device generation: every slot's coarse
    cell is the TOP BITS of its z key (``z >> (63 - bits)`` — exactly
    Z3HistogramStat's cell function), counted per (time-bin, cell) over
    the bin span ``[b0, b0 + nb)``.  Sentinel keys and out-of-span bins
    fold into a discarded overflow slot, as in the JAX package's
    ``_z3_cells_multi`` (plain XLA there, so plain torch here)."""
    size = nb << bits
    cell = z >> (63 - bits)
    flat = (bins.to(torch.int64) - b0) * (1 << bits) + cell
    ok = (z != _SENTINEL_Z) & (flat >= 0) & (flat < size)
    flat = torch.where(ok, flat, torch.full_like(flat, size))
    return torch.bincount(flat, minlength=size + 1)[:size]


class HostRun:
    """One sorted key run spilled to host RAM (the ``host`` residency
    tier): numpy segmented searchsorted seeks — per distinct query bin,
    two vectorized z-searchsorted calls within the bin's segment."""

    __slots__ = ("bins", "z", "pos", "_bin_vals", "_bin_starts")

    def __init__(self, bins: np.ndarray, z: np.ndarray, pos: np.ndarray):
        self.bins, self.z, self.pos = bins, z, pos
        self._bin_vals, starts = np.unique(bins, return_index=True)
        self._bin_starts = np.append(starts, len(bins))

    def __len__(self) -> int:
        return len(self.z)

    def bins_column(self) -> np.ndarray:
        """The run's bins, rebuilt from the segment table (a stacked
        run hands its ``bins`` ownership to the :class:`HostStack`)."""
        return np.repeat(self._bin_vals, np.diff(self._bin_starts))

    def cell_counts(self, b0: int, nb: int, bits: int) -> np.ndarray:
        """Z3Histogram partial over THIS spilled run: flat
        ``(bin - b0) << bits | cell`` counts — the numpy twin of
        :func:`_z3_cells` (bins rebuild from the segment table)."""
        bins = self.bins_column().astype(np.int64)
        cell = np.asarray(self.z).astype(np.int64) >> (63 - bits)
        size = nb << bits
        flat = (bins - b0) * (1 << bits) + cell
        ok = (flat >= 0) & (flat < size)
        return np.bincount(flat[ok], minlength=size)[:size] \
            .astype(np.int64)

    def sweep_partial(self, sfc, env, width: int, height: int,
                      world: bool) -> np.ndarray:
        """Whole-extent grid partial over THIS run (no seeks — every row
        decodes its cell from the z key; the numpy twin of one
        generation's device sweep)."""
        ix, iy, _ = _np_decode(sfc, np.asarray(self.z))
        p = sfc.lon.precision
        if world:
            gx = (ix * width) >> p
            gy = (iy * height) >> p
        else:
            xd = _np_denormalize(sfc.lon, ix)
            yd = _np_denormalize(sfc.lat, iy)
            gx = np.clip(((xd - env[0])
                          / max(env[2] - env[0], 1e-12)
                          * width).astype(np.int64), 0, width - 1)
            gy = np.clip(((yd - env[1])
                          / max(env[3] - env[1], 1e-12)
                          * height).astype(np.int64), 0, height - 1)
        return np.bincount(
            (gy * width + gx).astype(np.int64),
            minlength=width * height
        )[:width * height].reshape((height, width)).astype(np.float64)


def merge_host_runs(runs: list[HostRun]) -> HostRun:
    """COMPACTION merge for spilled runs: K sorted host runs fold into
    one sorted :class:`HostRun` via a composite (bin, z) lexsort."""
    bins = np.concatenate([r.bins_column() for r in runs])
    z = np.concatenate([np.asarray(r.z) for r in runs])
    pos = np.concatenate([np.asarray(r.pos) for r in runs])
    order = np.lexsort((z, bins))
    return HostRun(np.ascontiguousarray(bins[order]),
                   np.ascontiguousarray(z[order]),
                   np.ascontiguousarray(pos[order]))


def _bisect_segments(z: np.ndarray, vals: np.ndarray, lo: np.ndarray,
                     hi: np.ndarray, side: str) -> np.ndarray:
    """Vectorized binary search of ``vals[i]`` within the sorted segments
    ``z[lo[i]:hi[i]]`` — one numpy bisection loop serves every (range ×
    run-segment) pair at once, so host-tier seek cost is flat in the
    number of spilled runs."""
    lo = lo.astype(np.int64).copy()
    hi = hi.astype(np.int64).copy()
    while True:
        active = lo < hi
        if not active.any():
            return lo
        mid = (lo + hi) >> 1
        zm = z[np.where(active, mid, 0)]
        below = zm < vals if side == "left" else zm <= vals
        go = active & below
        lo = np.where(go, mid + 1, lo)
        hi = np.where(active & ~below, mid, hi)


def _expand_counts(counts: np.ndarray):
    """(flat slot → owning range, offset within the range) for a batch of
    per-range counts; None when the total is zero."""
    cum = np.cumsum(counts)
    total = int(cum[-1]) if len(cum) else 0
    if total == 0:
        return None
    j = np.arange(total)
    rid = np.searchsorted(cum, j, side="right")
    prev = np.where(rid > 0, cum[rid - 1], 0)
    return rid, j - prev


class HostStack:
    """EVERY spilled run stacked into one contiguous key store with a
    global (bin → segment) table: a query batch seeks ALL host
    generations with two vectorized bisections total, instead of a
    Python loop per run per bin.

    The stack OWNS the concatenated arrays; each constituent
    :class:`HostRun`'s columns are re-pointed at views into them, so host
    RAM holds ONE copy of the spilled keys."""

    __slots__ = ("z", "pos", "seg_bin", "seg_lo", "seg_hi", "seg_run",
                 "n_runs")

    def __init__(self, runs: list[HostRun]):
        zs, ps, sb, sl, sh, sr = [], [], [], [], [], []
        off = 0
        for i, run in enumerate(runs):
            zs.append(run.z)
            ps.append(run.pos)
            sb.append(run._bin_vals)
            sl.append(off + run._bin_starts[:-1])
            sh.append(off + run._bin_starts[1:])
            sr.append(np.full(len(run._bin_vals), i, np.int32))
            off += len(run.z)
        self.n_runs = len(runs)
        self.z = np.concatenate(zs) if zs else np.empty(0, np.int64)
        self.pos = np.concatenate(ps) if ps else np.empty(0, np.int32)
        seg_bin = np.concatenate(sb) if sb else np.empty(0, np.int32)
        seg_lo = np.concatenate(sl) if sl else np.empty(0, np.int64)
        seg_hi = np.concatenate(sh) if sh else np.empty(0, np.int64)
        seg_run = np.concatenate(sr) if sr else np.empty(0, np.int32)
        order = np.argsort(seg_bin, kind="stable")
        self.seg_bin = seg_bin[order]
        self.seg_lo = seg_lo[order].astype(np.int64)
        self.seg_hi = seg_hi[order].astype(np.int64)
        self.seg_run = seg_run[order]
        # re-point the runs' columns at views of the stacked buffers so
        # the per-run copies free (the stack is now the owner)
        off = 0
        for run in runs:
            n = len(run.z)
            run.z = self.z[off:off + n]
            run.pos = self.pos[off:off + n]
            run.bins = None   # recoverable from the segment table
            off += n

    def _expand(self, rb, rlo, rhi):
        """(flat z indices, owning segment, owning range) for a range
        batch.  Each range matches the span of same-bin segments (one
        segment per run containing the bin); two composite bisections
        serve every pair."""
        if not len(self.z) or not len(rb):
            return None, None, None
        a = np.searchsorted(self.seg_bin, rb, side="left")
        b = np.searchsorted(self.seg_bin, rb, side="right")
        ex = _expand_counts(np.maximum(b - a, 0))
        if ex is None:
            return None, None, None
        rid, k = ex
        seg = a[rid] + k
        starts = _bisect_segments(self.z, rlo[rid], self.seg_lo[seg],
                                  self.seg_hi[seg], side="left")
        ends = _bisect_segments(self.z, rhi[rid], self.seg_lo[seg],
                                self.seg_hi[seg], side="right")
        ex2 = _expand_counts(np.maximum(ends - starts, 0))
        if ex2 is None:
            return None, None, None
        pid, k2 = ex2
        return starts[pid] + k2, seg[pid], rid[pid]

    def candidates(self, rb, rlo, rhi, rqid, pos_bits: int) -> np.ndarray:
        """Coded candidate positions ``qid << pos_bits | pos`` across every
        stacked run for a padded range batch."""
        idx, _seg, rid = self._expand(rb, rlo, rhi)
        if idx is None:
            return np.empty(0, np.int64)
        return ((rqid[rid].astype(np.int64) << pos_bits)
                | self.pos[idx].astype(np.int64))

    def density_partials(self, rb, rlo, rhi, sfc, ixy, tb, env,
                         width: int, height: int) -> np.ndarray:
        """PER-RUN DensityScan partials ``(n_runs, height, width)`` in one
        vectorized pass: each hit attributes to its owning run via the
        segment table (the z-decoded CELL contract of the keys tier)."""
        grids = np.zeros((self.n_runs, height, width), np.float64)
        idx, seg, _rid = self._expand(rb, rlo, rhi)
        if idx is None:
            return grids
        zc = self.z[idx]
        bc = self.seg_bin[seg].astype(np.int64)
        ix, iy, it = _np_decode(sfc, zc)
        in_box = np.zeros(len(zc), bool)
        for b in np.atleast_2d(ixy):
            in_box |= ((ix >= b[0]) & (iy >= b[1])
                       & (ix <= b[2]) & (iy <= b[3]))
        ok = (in_box
              & ((bc > tb[0]) | ((bc == tb[0]) & (it >= tb[1])))
              & ((bc < tb[2]) | ((bc == tb[2]) & (it <= tb[3]))))
        if not ok.any():
            return grids
        xd = _np_denormalize(sfc.lon, ix[ok])
        yd = _np_denormalize(sfc.lat, iy[ok])
        gx = np.clip(((xd - env[0])
                      / max(env[2] - env[0], 1e-12) * width)
                     .astype(np.int64), 0, width - 1)
        gy = np.clip(((yd - env[1])
                      / max(env[3] - env[1], 1e-12) * height)
                     .astype(np.int64), 0, height - 1)
        np.add.at(grids, (self.seg_run[seg[ok]], gy, gx), 1.0)
        return grids


class _Generation:
    """One sorted key run.  ``tier`` ∈ {"full", "keys", "host"} (module
    doc); ``base`` is the global row id of its first row — generations
    cover contiguous global row ranges, so a ``full`` generation's payload
    is indexed by ``pos - base`` (append order).  ``gen_id`` is a
    store-lifetime-unique identity assigned by the owning index —
    compaction mints a FRESH id for each merged run, which is what keys
    (and therefore invalidates) the density partial cache."""

    __slots__ = ("bins", "z", "pos", "x", "y", "t", "n", "base", "tier",
                 "run", "gen_id", "_capacity")

    def __init__(self, capacity: int, base: int, tier: str, device):
        self.bins = torch.full((capacity,), _SENTINEL_BIN, dtype=torch.int32,
                               device=device)
        self.z = torch.full((capacity,), _SENTINEL_Z, dtype=torch.int64,
                            device=device)
        self.pos = torch.full((capacity,), -1, dtype=torch.int32,
                              device=device)
        if tier == "full":
            self.x = torch.zeros(capacity, dtype=torch.float64, device=device)
            self.y = torch.zeros(capacity, dtype=torch.float64, device=device)
            self.t = torch.zeros(capacity, dtype=torch.int64, device=device)
        else:
            self.x = self.y = self.t = None
        self.n = 0
        self.base = int(base)
        self.tier = tier
        self.run: HostRun | None = None
        self.gen_id = -1   # assigned by the owning index
        self._capacity = int(capacity)

    @classmethod
    def from_columns(cls, tier: str, bins, z, pos, n: int, base: int,
                     payload=None) -> "_Generation":
        """A device-tier run from existing columns (a compaction's merged
        keys, or a carried-over state): ``payload`` is the full tier's
        ``(x, y, t)``."""
        gen = cls.__new__(cls)
        gen.bins, gen.z, gen.pos = bins, z, pos
        gen.x, gen.y, gen.t = payload if tier == "full" else (None,) * 3
        gen.n = int(n)
        gen.base = int(base)
        gen.tier = tier
        gen.run = None
        gen.gen_id = -1
        gen._capacity = int(z.shape[0])
        return gen

    @classmethod
    def merged_host(cls, run: HostRun, base: int) -> "_Generation":
        """A compacted (or converted) ``host``-tier run."""
        gen = cls.__new__(cls)
        gen.bins = gen.z = gen.pos = None
        gen.x = gen.y = gen.t = None
        gen.n = len(run)
        gen.base = int(base)
        gen.tier = "host"
        gen.run = run
        gen.gen_id = -1
        gen._capacity = len(run)
        return gen

    @property
    def capacity(self) -> int:
        return self._capacity

    def device_bytes(self) -> int:
        if self.tier == "host":
            return 0
        per = FULL_BYTES if self.tier == "full" else KEYS_BYTES
        return self.capacity * per

    def drop_payload(self) -> None:
        """full → keys: free the device payload copy (the host payload
        remains the source of truth for the exact mask)."""
        if self.tier == "full":
            self.x = self.y = self.t = None
            self.tier = "keys"

    def spill_to_host(self) -> None:
        """keys → host: copy the sorted key run into host RAM as a
        :class:`HostRun`, freeing the device memory."""
        self.drop_payload()
        if self.tier != "keys":
            return
        # valid rows only: the sentinel padding sorts to the tail
        n = self.n
        self.run = HostRun(self.bins[:n].cpu().numpy(),
                           self.z[:n].cpu().numpy(),
                           self.pos[:n].cpu().numpy())
        self.bins = self.z = self.pos = None
        self.tier = "host"


def _seek(gen: _Generation, rb, rlo, rhi):
    """Per-range ``(starts, counts)`` of one device generation (over its
    ``n`` valid rows: the sentinel tail matches no real range)."""
    b, z = gen.bins[:gen.n], gen.z[:gen.n]
    starts = searchsorted2(b, z, rb, rlo, side="left")
    ends = searchsorted2(b, z, rb, rhi, side="right")
    return starts, torch.clamp(ends - starts, min=0)


def _in_boxes(xc, yc, boxes):
    """(N, B) box tests, inclusive on every edge."""
    return ((xc[:, None] >= boxes[None, :, 0])
            & (yc[:, None] >= boxes[None, :, 1])
            & (xc[:, None] <= boxes[None, :, 2])
            & (yc[:, None] <= boxes[None, :, 3]))


class LeanZ3Index:
    """Tiered generational keys-on-device Z3 index (see module doc)."""

    #: slots per generation.  Each append re-sorts its generation, so
    #: generation size trades sort cost per slice against run count per
    #: query.
    GENERATION_SLOTS = 1 << 24
    DEFAULT_CAPACITY = 1 << 15
    #: default device-memory budget for the key/payload residency: the
    #: JAX package's default (a TPU v5e's usable HBM minus scan slack),
    #: kept so that tier decisions equal the reference's for the same
    #: inputs — not a measurement on the card.  Stores set it with
    #: ``geomesa.lean.hbm.budget``.
    HBM_BUDGET_BYTES = int(13.5 * 2**30)
    #: size-tiered compaction trigger for explicit compact() calls; pass
    #: ``compaction_factor=F`` to also run it opportunistically after
    #: appends (one merge group per append)
    COMPACTION_FACTOR = 4
    #: distinct density specs whose per-generation partials are retained
    #: (LRU), and the host-RAM ceiling across them
    DENSITY_CACHE_SPECS = 4
    DENSITY_CACHE_MAX_BYTES = 512 * 2**20
    #: z3 cell-count partial cache bounds (time-bins × 2^bits int64 per
    #: sealed generation).  The estimator's table reaches 2^22 cells
    #: (32 MiB a generation), so the JAX package's 64 MiB ceiling holds
    #: two sealed partials and every generation change re-folds the rest
    #: (4.3 s for the first query after a compaction of a 128M-row store,
    #: PERF.md, on an H100 80GB HBM3 machine); the ceiling here is the
    #: density cache's
    SKETCH_CACHE_SPECS = 8
    SKETCH_CACHE_MAX_BYTES = 512 * 2**20
    #: density-pyramid cache spec bound: one spec per base resolution —
    #: two let a base retune keep serving off the old stack while the
    #: new one builds.  The byte ceiling is
    #: ``geomesa.density.pyramid.cache.bytes``.
    PYRAMID_CACHE_SPECS = 2

    def __init__(self, period: TimePeriod | str = TimePeriod.WEEK,
                 version: int = Z3_INDEX_VERSION,
                 generation_slots: int | None = None,
                 hbm_budget_bytes: int | None = None,
                 payload_on_device: bool = True,
                 compaction_factor: int | None = None,
                 device=None):
        """``device``: where the device tiers live — the CUDA card unless
        the caller names the CPU (with no card and no ``"cpu"`` this
        raises)."""
        self.device = resolve_device(device)
        self.period = TimePeriod.parse(period)
        self.version = version
        self.sfc = z3_sfc_for_version(self.period, version)
        self.generation_slots = generation_slots or self.GENERATION_SLOTS
        self.hbm_budget_bytes = hbm_budget_bytes or self.HBM_BUDGET_BYTES
        #: whether NEW generations carry a device payload for the exact
        #: mask (they demote automatically under budget pressure)
        self.payload_on_device = payload_on_device
        self.generations: list[_Generation] = []
        #: host payload slices (x, y, dtg) in append order, finalized
        #: lazily; a store embedding this index supplies
        #: ``payload_provider`` instead (one host copy, owned by the store)
        self._payload: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._flat: tuple | None = None
        self.payload_provider = None
        self._n_rows = 0
        self.t_min_ms: int | None = None
        self.t_max_ms: int | None = None
        #: per-generation scan programs run (see module doc)
        self.dispatch_count = 0
        #: stacked host-tier runs (built lazily on the first query after
        #: a spill)
        self._host_stack: HostStack | None = None
        #: opportunistic compaction factor (0 = off)
        self.compaction_factor = int(compaction_factor or 0)
        #: merge groups folded so far
        self.compactions = 0
        #: sealed generations whose whole-world sweep a pyramid level
        #: served in place of their keys
        self.pyramid_serve_hits = 0
        #: sealed-generation density partials: spec → {gen_id: grid}
        self._density_cache = PartialCache(self.DENSITY_CACHE_SPECS,
                                           self.DENSITY_CACHE_MAX_BYTES)
        #: sealed-generation z3 cell-count partials: (bits, bin span) →
        #: {gen_id: counts}
        self._sketch_cache = PartialCache(self.SKETCH_CACHE_SPECS,
                                          self.SKETCH_CACHE_MAX_BYTES)
        #: sealed-generation density pyramids: ("pyramid", base) →
        #: {gen_id: DensityPyramid}
        self._pyramid_cache = PartialCache(
            self.PYRAMID_CACHE_SPECS,
            DensityProperties.PYRAMID_CACHE_BYTES.to_int())
        #: generation-lifecycle listeners (lsm.notify_generation_event):
        #: ``listener(kind, gen_ids)`` fired on seal/merge — the hook the
        #: store's build-behind pyramid trigger rides
        self.generation_listeners: list = []
        self._gen_counter = 0

    def __len__(self) -> int:
        return self._n_rows

    def block(self) -> None:
        """Wait for the card's queued work (appends are asynchronous)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- accounting -------------------------------------------------------
    def device_bytes(self) -> int:
        """Device residency of the key/payload columns, by the per-slot
        accounting the budget uses."""
        return sum(g.device_bytes() for g in self.generations)

    def host_key_bytes(self) -> int:
        """Host RAM held by spilled (``host``-tier) key runs."""
        return sum(g.n * KEYS_BYTES for g in self.generations
                   if g.tier == "host")

    def tier_counts(self) -> dict:
        out = {"full": 0, "keys": 0, "host": 0}
        for g in self.generations:
            out[g.tier] += 1
        return out

    def sentinel_bytes(self) -> int:
        """Device bytes held by sentinel padding generations: none, since
        the port pads nothing (the budget still charges the JAX
        package's, see :meth:`_budget_after_sentinels`)."""
        return 0

    def storage_stats(self) -> dict:
        """Where this index's bytes sit, per generation, from the same
        per-slot constants the budget uses."""
        gens = [{"gen_id": g.gen_id, "tier": g.tier, "rows": int(g.n),
                 "capacity": 0 if g.tier == "host" else g.capacity,
                 "device_bytes": g.device_bytes(),
                 "host_bytes": (g.n * KEYS_BYTES
                                if g.tier == "host" else 0)}
                for g in self.generations]
        return {"kind": type(self).__name__, "rows": len(self),
                "tiers": self.tier_counts(),
                "device_bytes": self.device_bytes(),
                "host_bytes": self.host_key_bytes(),
                "sentinel_bytes": self.sentinel_bytes(),
                "hbm_budget_bytes": self.hbm_budget_bytes,
                "generations": gens,
                "caches": {"density": self._density_cache.stats(),
                           "sketch": self._sketch_cache.stats(),
                           "pyramid": self._pyramid_cache.stats()},
                "dispatches": self.dispatch_count}

    # -- write path -------------------------------------------------------
    def _new_generation(self, base: int) -> _Generation:
        tier = "full" if self.payload_on_device else "keys"
        if tier == "full":
            # the live generation's payload is reserved by the demotion
            # policy, so it is doomed only if the live full generation
            # alone (plus the sentinel charges) busts the budget — don't
            # allocate a payload that _rebalance frees moments later
            floor = self.generation_slots * (FULL_BYTES
                                             + KEYS_BYTES + FULL_BYTES)
            if floor > self.hbm_budget_bytes:
                tier = "keys"
        gen = _Generation(self.generation_slots, base=base, tier=tier,
                          device=self.device)
        gen.gen_id = self._next_gen_id()
        self.generations.append(gen)
        self._rebalance()
        return self.generations[-1]

    def _next_gen_id(self) -> int:
        self._gen_counter += 1
        return self._gen_counter

    def _budget_after_sentinels(self) -> int:
        """Effective budget: hbm_budget_bytes minus the JAX package's
        full-size sentinel padding buffers — a keys one always, a full one
        while full-tier generations exist (module doc)."""
        per = self.generation_slots * KEYS_BYTES
        if any(g.tier == "full" for g in self.generations):
            per += self.generation_slots * FULL_BYTES
        return self.hbm_budget_bytes - per

    def _fits(self) -> bool:
        return self.device_bytes() <= self._budget_after_sentinels()

    def _spill(self, gen: _Generation) -> None:
        gen.spill_to_host()
        self._host_stack = None   # restacked lazily on the next query

    def _rebalance(self) -> None:
        """Demote oldest-first until the device residency fits the budget:
        payload drops first (full → keys), then key runs spill to host RAM
        (keys → host).  The ACTIVE generation's keys never spill — appends
        sort there — and its payload is reserved: older key runs spill to
        make room; it drops only as the last step before the budget is
        simply too small for one live generation."""
        if self._fits():
            return
        for gen in self.generations[:-1]:
            if gen.tier == "full":
                gen.drop_payload()
                if self._fits():
                    return
        for gen in self.generations[:-1]:
            if gen.tier == "keys":
                self._spill(gen)
                if self._fits():
                    return
        live = self.generations[-1] if self.generations else None
        if live is not None and live.tier == "full":
            live.drop_payload()
            if self._fits():
                return
        raise MemoryError(
            f"active generation ({self.generation_slots} slots) "
            f"exceeds hbm_budget_bytes={self.hbm_budget_bytes} "
            "minus the sentinel-padding overhead")

    def _append_step(self, gen: _Generation, x, y, offs, bins, t,
                     take: int) -> None:
        """Encode ``take`` rows' keys into the generation's sentinel
        padding at sorted offset ``gen.n`` and re-sort the occupied
        prefix (the sentinel tail stays sorted past it).  Positions are
        global (``base + r + i``); a full generation's payload lands at
        ``[r, r + m_pad)`` in append order."""
        dev = self.device
        r = gen.n
        m_pad = int(x.shape[0])

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        xs, ys = up(x), up(y)
        z_new = self.sfc.index(xs, ys, up(offs))
        valid = torch.arange(m_pad, device=dev) < take
        w = slice(r, r + m_pad)
        gen.bins[w] = torch.where(valid, up(bins),
                                  torch.full((m_pad,), _SENTINEL_BIN,
                                             dtype=torch.int32, device=dev))
        gen.z[w] = torch.where(valid, z_new,
                               torch.full_like(z_new, _SENTINEL_Z))
        gen.pos[w] = torch.where(
            valid,
            gen.base + r + torch.arange(m_pad, dtype=torch.int32,
                                        device=dev),
            torch.full((m_pad,), -1, dtype=torch.int32, device=dev))
        if gen.tier == "full":
            gen.x[w] = xs
            gen.y[w] = ys
            gen.t[w] = up(t)
        end = r + m_pad
        perm = _lexsort2(gen.bins[:end], gen.z[:end])
        gen.bins[:end] = gen.bins[:end][perm]
        gen.z[:end] = gen.z[:end][perm]
        gen.pos[:end] = gen.pos[:end][perm]

    def append(self, x, y, dtg_ms) -> "LeanZ3Index":
        """Stream one slice in: host payload retained by reference, keys
        encoded and sorted into the current generation on the device
        (rolling to a fresh generation when full)."""
        if self._n_rows + len(x) > np.iinfo(np.int32).max:
            raise ValueError("LeanZ3Index positions are int32: "
                             "2,147M rows max per index")
        x = np.ascontiguousarray(x, dtype=np.float64)
        y = np.ascontiguousarray(y, dtype=np.float64)
        dtg_ms = np.ascontiguousarray(dtg_ms, dtype=np.int64)
        m_total = len(x)
        if m_total == 0:
            return self
        if self.payload_provider is None:
            self._payload.append((x, y, dtg_ms))
            self._flat = None
        host_bins, host_offs = to_binned_time(dtg_ms, self.period)
        host_bins = host_bins.astype(np.int32)
        host_offs = host_offs.astype(np.float64)
        done = 0
        while done < m_total:
            gen = self.generations[-1] if self.generations else None
            if gen is None or gen.tier == "host" or gen.n >= gen.capacity:
                sealed = (gen.gen_id if gen is not None
                          and gen.tier != "host" else None)
                # base = global row id of the generation's first row
                gen = self._new_generation(self._n_rows + done)
                if sealed is not None:
                    notify_generation_event(self, "seal", [sealed])
            room = gen.capacity - gen.n
            take = min(room, m_total - done)
            m_pad = min(gather_capacity(take, minimum=8), room)
            pad = m_pad - take
            sl = slice(done, done + take)
            self.dispatch_count += 1
            self._append_step(
                gen, np.pad(x[sl], (0, pad)), np.pad(y[sl], (0, pad)),
                np.pad(host_offs[sl], (0, pad)),
                np.pad(host_bins[sl], (0, pad)),
                np.pad(dtg_ms[sl], (0, pad)), take)
            gen.n += take
            done += take
        self._n_rows += m_total
        t_min, t_max = int(dtg_ms.min()), int(dtg_ms.max())
        self.t_min_ms = (t_min if self.t_min_ms is None
                         else min(self.t_min_ms, t_min))
        self.t_max_ms = (t_max if self.t_max_ms is None
                         else max(self.t_max_ms, t_max))
        if self.compaction_factor:
            # opportunistic trigger after append/demotion: bounded to ONE
            # merge group so ingest latency stays O(generation)
            self.compact(factor=self.compaction_factor, max_groups=1)
        return self

    # -- compaction (LSM maintenance) -------------------------------------
    def _sealed(self) -> list[_Generation]:
        """Generations appends can no longer touch — all but the live
        (last) one."""
        return self.generations[:-1]

    def _compaction_groups(self, factor: int) -> list[list[_Generation]]:
        return plan_size_tiered(self._sealed(), ("keys", "host"),
                                lambda g: g.n, factor)

    def _merge_group(self, group: list[_Generation]) -> None:
        """Fold one same-tier group into a single sorted run placed at the
        group's oldest position.  The merged run gets a FRESH gen_id; the
        source runs' device slots / host buffers free with their
        references and their cached density partials drop."""
        base = min(g.base for g in group)
        total = int(sum(g.n for g in group))
        if group[0].tier == "keys":
            out_cap = merged_capacity(
                total, sum(g.capacity for g in group), gather_capacity)
            # every sentinel slot sorts past the valid rows, so the
            # leading out_cap slots of the sorted union are the merged run
            bins = torch.cat([g.bins for g in group])
            z = torch.cat([g.z for g in group])
            pos = torch.cat([g.pos for g in group])
            perm = _lexsort2(bins, z)[:out_cap]
            self.dispatch_count += 1
            merged = _Generation.from_columns("keys", bins[perm], z[perm],
                                              pos[perm], n=total, base=base)
        else:
            merged = _Generation.merged_host(
                merge_host_runs([g.run for g in group]), base=base)
            self._host_stack = None   # restacked lazily
        merged.gen_id = self._next_gen_id()
        dead_ids = [g.gen_id for g in group]
        # the merged run's pyramid is the SUM of its parents', taken
        # before the parents' entries drop
        self._inherit_pyramids(dead_ids, merged.gen_id)
        self.generations = replace_group(self.generations, group, merged)
        self._drop_cached_partials(dead_ids)
        self.compactions += 1
        notify_generation_event(self, "merge", [merged.gen_id])

    def compact(self, budget_ms: float | None = None,
                factor: int | None = None,
                max_groups: int | None = None) -> dict:
        """Incremental size-tiered K-way merge compaction (the role the
        reference delegates to its key-value backend's major compaction).

        Merges one group at a time and re-plans, so a ``budget_ms``
        deadline or ``max_groups`` cap interrupts cleanly BETWEEN merges
        and the next call resumes; each call makes progress (≥ 1 group
        when any is eligible) even at ``budget_ms=0``.  Query results are
        identical at every intermediate state.

        Returns ``{"merged_groups", "generations", "tiers"}``."""
        f = int(factor or self.compaction_factor or self.COMPACTION_FACTOR)
        merged = compact_incremental(
            lambda: self._compaction_groups(f), self._merge_group,
            budget_ms=budget_ms, max_groups=max_groups)
        if merged:
            # merged runs never out-size their sources — residency only
            # shrinks, but re-check so the budget invariant is explicit
            self._rebalance()
        return {"merged_groups": merged,
                "generations": len(self.generations),
                "tiers": self.tier_counts()}

    def _drop_cached_partials(self, gen_ids: list) -> None:
        self._density_cache.drop_generations(gen_ids)
        self._sketch_cache.drop_generations(gen_ids)
        self._pyramid_cache.drop_generations(gen_ids)

    def _inherit_pyramids(self, dead_ids: list, new_gen_id: int) -> None:
        """Compaction inheritance: when EVERY merged-away parent has a
        pyramid under a spec (same level set), the merged run gets their
        elementwise sum — exact, because each parent level is the
        parent's count grid and the merged run is exactly the union of
        the parents' rows.  Any missing parent leaves the merged run
        pyramid-less (the next build fills it)."""
        for _spec, cache in self._pyramid_cache.items():
            parents = [cache.get(gid) for gid in dead_ids]
            if all(p is not None for p in parents):
                merged = DensityPyramid.sum(parents)
                if merged is not None:
                    self._pyramid_cache.add(cache, new_gen_id, merged)

    def _pyramid_level(self, gen_id: int, width: int):
        """The cached (width, width) pyramid grid of one sealed
        generation, or None — serving never waits on a build."""
        for _spec, cache in self._pyramid_cache.items():
            pyr = cache.get(gen_id)
            if pyr is not None:
                lvl = pyr.level(width)
                if lvl is not None:
                    return lvl
        return None

    # -- payload ----------------------------------------------------------
    def _payload_flat(self):
        if self.payload_provider is not None:
            return self.payload_provider()
        if self._flat is None:
            xs, ys, ts = zip(*self._payload) if self._payload else ((), (), ())
            self._flat = (np.concatenate(xs) if xs else np.empty(0),
                          np.concatenate(ys) if ys else np.empty(0),
                          np.concatenate(ts) if ts else np.empty(0, np.int64))
            # drop the per-slice references: one host copy of the payload
            self._payload = [tuple(self._flat)]
        return self._flat

    def _clamp_time(self, t_lo_ms, t_hi_ms) -> tuple[int, int]:
        t_lo_ms = self.t_min_ms if t_lo_ms is None else int(t_lo_ms)
        t_hi_ms = self.t_max_ms if t_hi_ms is None else int(t_hi_ms)
        if self.t_min_ms is not None:
            t_lo_ms = max(t_lo_ms, self.t_min_ms)
        if self.t_max_ms is not None:
            t_hi_ms = min(t_hi_ms, self.t_max_ms)
        return t_lo_ms, t_hi_ms

    def _dev(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _probe(self, gens, rb, rlo, rhi):
        """Seek every device generation once: the per-generation
        ``(starts, counts)`` (kept on the device for the scan that
        follows) and the totals, read with one device→host copy."""
        if not gens:
            return [], np.empty(0, np.int64)
        seeks = [_seek(g, rb, rlo, rhi) for g in gens]
        self.dispatch_count += 1
        totals = torch.stack([c.sum() for _, c in seeks]).cpu().numpy()
        return seeks, totals

    # -- query path -------------------------------------------------------
    def query(self, boxes, t_lo_ms, t_hi_ms,
              max_ranges: int = DEFAULT_MAX_RANGES) -> np.ndarray:
        """Exact original-order positions for one bbox(es)+time window."""
        return self.query_many([(boxes, t_lo_ms, t_hi_ms)],
                               max_ranges=max_ranges)[0]

    def query_many(self, windows,
                   max_ranges: int = DEFAULT_MAX_RANGES) -> list[np.ndarray]:
        """Batched multi-window scan: every window × every generation, the
        BatchScanner-over-many-range-sets pattern.  Returns one sorted
        exact-position array per window."""
        n_q = len(windows)
        if n_q == 0 or self._n_rows == 0:
            return [np.empty(0, dtype=np.int64) for _ in range(n_q)]
        rbin, rzlo, rzhi, rqid = [], [], [], []
        w_boxes: list = []
        qtlo = np.empty(n_q, dtype=np.int64)
        qthi = np.empty(n_q, dtype=np.int64)
        for q, (bxs, lo, hi) in enumerate(windows):
            lo, hi = self._clamp_time(lo, hi)
            qtlo[q], qthi[q] = lo, hi
            bxs = np.atleast_2d(np.asarray(bxs, dtype=np.float64))
            w_boxes.append(bxs)
            # per-BIN range budget: plan_z3_query splits its target across
            # the interval's bins, so open/long intervals would starve
            # each bin into hugely overcovering ranges
            budget = min(max_ranges * _bins_spanned(lo, hi, self.period),
                         _MAX_RANGES_PER_WINDOW)
            plan = plan_z3_query(bxs, lo, hi, self.period, budget,
                                 sfc=self.sfc)
            if plan.num_ranges == 0:
                continue
            rbin.append(plan.rbin)
            rzlo.append(plan.rzlo)
            rzhi.append(plan.rzhi)
            rqid.append(np.full(plan.num_ranges, q, dtype=np.int32))
        if not rbin:
            return [np.empty(0, dtype=np.int64) for _ in range(n_q)]
        ra = pad_ranges(
            {"rbin": np.concatenate(rbin), "rzlo": np.concatenate(rzlo),
             "rzhi": np.concatenate(rzhi), "rqid": np.concatenate(rqid)},
            pad_pow2(sum(len(r) for r in rbin)))
        rb, rlo, rhi = (self._dev(ra[k]) for k in ("rbin", "rzlo", "rzhi"))
        rq = self._dev(ra["rqid"]).to(torch.int64)
        pos_bits = coded_pos_bits(self._n_rows, n_q)

        full_gens = [g for g in self.generations if g.tier == "full"]
        keys_gens = [g for g in self.generations if g.tier == "keys"]
        host_gens = [g for g in self.generations if g.tier == "host"]
        seeks, totals = self._probe(full_gens + keys_gens, rb, rlo, rhi)
        # replan probe point: the device totals are known BEFORE any
        # gather, so an abort here (ReplanSignal) discards only the seeks
        dev_total = int(totals.sum())
        check_replan("query.scan.probe", dev_total)
        nf = len(full_gens)
        exact_hits = np.empty(0, np.int64)
        cand: list = []
        if full_gens and int(totals[:nf].sum()):
            boxes_c = np.concatenate(w_boxes)
            bqid_c = np.concatenate([np.full(len(b), q, dtype=np.int64)
                                     for q, b in enumerate(w_boxes)])
            exact_hits = self._scan_full(
                full_gens, seeks[:nf], totals[:nf], rq, pos_bits,
                self._dev(boxes_c), self._dev(bqid_c), self._dev(qtlo),
                self._dev(qthi))
        if keys_gens and int(totals[nf:].sum()):
            got = self._scan_keys(keys_gens, seeks[nf:], totals[nf:], rq,
                                  pos_bits)
            if len(got):
                cand.append(got)
        if host_gens:
            # host tier: stacked numpy seeks, flat in run count
            if self._host_stack is None:
                self._host_stack = HostStack([g.run for g in host_gens])
            got = self._host_stack.candidates(
                ra["rbin"], ra["rzlo"], ra["rzhi"], ra["rqid"], pos_bits)
            if len(got):
                # second probe point: host-tier candidates are counted
                # before the payload re-check, the expensive host step
                check_replan("query.scan.probe", dev_total + len(got))
                cand.append(got)
        mask_bits = (np.int64(1) << pos_bits) - 1
        cand_hits = np.concatenate(cand) if cand else np.empty(0, np.int64)
        if len(cand_hits):
            # host exact mask on the payload (the client-side re-check of
            # keys/host-tier candidates)
            x, y, t = self._payload_flat()
            qids = cand_hits >> pos_bits
            rows = cand_hits & mask_bits
            cx, cy, ct = x[rows], y[rows], t[rows]
            keep = np.zeros(len(rows), dtype=bool)
            for q in range(n_q):
                sel = qids == q
                if not sel.any():
                    continue
                in_box = np.zeros(int(sel.sum()), dtype=bool)
                for b in w_boxes[q]:
                    in_box |= ((cx[sel] >= b[0]) & (cy[sel] >= b[1])
                               & (cx[sel] <= b[2]) & (cy[sel] <= b[3]))
                keep[sel] = (in_box & (ct[sel] >= qtlo[q])
                             & (ct[sel] <= qthi[q]))
            cand_hits = cand_hits[keep]
        # sorted codes hold each window's hits as one run; overlapping
        # covering ranges can repeat a row, which split_coded drops
        merged = np.sort(np.concatenate([exact_hits, cand_hits]))
        return split_coded(merged, pos_bits, n_q)

    def _scan_keys(self, gens, seeks, totals, rq, pos_bits) -> np.ndarray:
        """CANDIDATE gather over ``keys``-tier generations: per generation
        with candidates, expand + gather global positions coded as
        ``qid << pos_bits | pos``; one device→host copy.  The exact mask
        runs on the host payload."""
        dt = wire_dtype(pos_bits)
        parts = []
        for gen, (starts, counts), tot in zip(gens, seeks, totals):
            if not int(tot):
                continue
            cap = gather_capacity(int(tot), minimum=self.DEFAULT_CAPACITY)
            idx, valid, rid = expand_ranges(starts, counts, cap)
            coded = (rq[rid].to(dt) << pos_bits) | gen.pos[idx].to(dt)
            parts.append(torch.where(valid, coded,
                                     torch.full_like(coded, -1)))
            self.dispatch_count += 1
        flat = torch.cat(parts).cpu().numpy()
        return flat[flat >= 0].astype(np.int64)

    def _scan_full(self, gens, seeks, totals, rq, pos_bits, boxes, bqid,
                   qtlo, qthi) -> np.ndarray:
        """EXACT scan over ``full``-tier generations: seek + gather + the
        float64 bbox+time mask over the generation's device payload.  A
        candidate only matches boxes/time bounds of its own window.
        Every non-negative code is a true hit; past
        ``_TWO_PHASE_MIN_SLOTS`` gathered slots the coded buffer stays on
        the device and only a survivors-sized prefix is copied."""
        dt = wire_dtype(pos_bits)
        parts = []
        for gen, (starts, counts), tot in zip(gens, seeks, totals):
            if not int(tot):
                continue
            cap = gather_capacity(int(tot), minimum=self.DEFAULT_CAPACITY)
            idx, valid, rid = expand_ranges(starts, counts, cap)
            posc = gen.pos[idx]
            local = torch.clamp(posc.to(torch.int64) - gen.base, min=0)
            xc, yc, tc = gen.x[local], gen.y[local], gen.t[local]
            cqid = rq[rid]
            in_box = (_in_boxes(xc, yc, boxes)
                      & (cqid[:, None] == bqid[None, :])).any(dim=1)
            ok = valid & in_box & (tc >= qtlo[cqid]) & (tc <= qthi[cqid])
            coded = (cqid.to(dt) << pos_bits) | posc.to(dt)
            parts.append(torch.where(ok, coded, torch.full_like(coded, -1)))
            self.dispatch_count += 1
        packed = torch.cat(parts)
        if packed.shape[0] >= _TWO_PHASE_MIN_SLOTS:
            nhits = int((packed >= 0).sum())
            k = gather_capacity(max(nhits, 1), minimum=8)
            self.dispatch_count += 1
            flat = torch.sort(packed, descending=True).values[:k]
        else:
            flat = packed
        flat = flat.cpu().numpy()
        return flat[flat >= 0].astype(np.int64)

    # -- result materialization -------------------------------------------
    def gather_payload(self, positions: np.ndarray):
        """(x, y, t) columns for the given global row positions.  Rows in
        a ``full``-tier generation gather on the device (one take per
        generation over its payload columns); the rest gather from the
        host payload.  Values are identical either way (the device copy
        was written from the same arrays)."""
        positions = np.asarray(positions, dtype=np.int64)
        n = len(positions)
        if n == 0:
            return (np.empty(0, np.float64), np.empty(0, np.float64),
                    np.empty(0, np.int64))
        order = None
        sorted_pos = positions
        if n > 1 and not bool(np.all(positions[1:] >= positions[:-1])):
            order = np.argsort(positions, kind="stable")
            sorted_pos = positions[order]
        x = np.empty(n, np.float64)
        y = np.empty(n, np.float64)
        t = np.empty(n, np.int64)
        covered = np.zeros(n, dtype=bool)
        for gen in self.generations:
            if gen.tier != "full" or gen.n == 0:
                continue
            lo = int(np.searchsorted(sorted_pos, gen.base, side="left"))
            hi = int(np.searchsorted(sorted_pos, gen.base + gen.n,
                                     side="left"))
            if hi <= lo:
                continue
            idx = self._dev(sorted_pos[lo:hi] - gen.base)
            self.dispatch_count += 1
            x[lo:hi] = gen.x[idx].cpu().numpy()
            y[lo:hi] = gen.y[idx].cpu().numpy()
            t[lo:hi] = gen.t[idx].cpu().numpy()
            covered[lo:hi] = True
        if not covered.all():
            hx, hy, ht = self._payload_flat()
            rest = sorted_pos[~covered]
            x[~covered] = hx[rest]
            y[~covered] = hy[rest]
            t[~covered] = ht[rest]
        if order is not None:
            inv = np.empty(n, np.int64)
            inv[order] = np.arange(n)
            x, y, t = x[inv], y[inv], t[inv]
        return x, y, t

    # -- aggregation push-down --------------------------------------------
    def _plan_one(self, boxes, t_lo_ms, t_hi_ms, max_ranges: int):
        """Padded covering-range arrays for ONE window (the density /
        count scan shape)."""
        lo, hi = self._clamp_time(t_lo_ms, t_hi_ms)
        bxs = np.atleast_2d(np.asarray(boxes, dtype=np.float64))
        budget = min(max_ranges * _bins_spanned(lo, hi, self.period),
                     _MAX_RANGES_PER_WINDOW)
        plan = plan_z3_query(bxs, lo, hi, self.period, budget, sfc=self.sfc)
        if plan.num_ranges == 0:
            return None
        ra = pad_ranges(
            {"rbin": plan.rbin, "rzlo": plan.rzlo, "rzhi": plan.rzhi},
            pad_pow2(plan.num_ranges))
        return ra, bxs, lo, hi

    def density(self, boxes, t_lo_ms, t_hi_ms, env,
                width: int = 256, height: int = 256,
                max_ranges: int = DEFAULT_MAX_RANGES) -> np.ndarray:
        """DensityScan push-down: the (height, width) float64 heatmap of
        bbox+time hits accumulated NEXT TO THE KEYS — full-tier
        generations mask exactly on their device payload, keys-tier
        generations decode cell-accurate coordinates from the z key,
        host-tier runs contribute numpy partials; the grids sum.  Only
        grids cross to the host (DensityScan.scala:31-59 +
        AggregatingScan.scala:80-102).

        Contract (docs/density.md): value-exact on full-tier generations;
        on keys- and host-tier generations the masks compare at z-cell
        granularity, exact for whole-extent scans and cell-inclusive
        (never excluding a true hit) at a partial window's edges; every
        hit bins at its z-cell midpoint."""
        grid = np.zeros((height, width), np.float64)
        if self._n_rows == 0:
            return grid
        # whole-extent fast path: a covering box + the full time extent
        # needs no seeks at all — sweep every generation's z column
        lo_c, hi_c = self._clamp_time(t_lo_ms, t_hi_ms)
        bxs0 = np.atleast_2d(np.asarray(boxes, dtype=np.float64))
        covers = any(b[0] <= -180.0 and b[1] <= -90.0
                     and b[2] >= 180.0 and b[3] >= 90.0 for b in bxs0)
        if covers and lo_c == self.t_min_ms and hi_c == self.t_max_ms:
            return self._density_sweep(env, width, height)
        planned = self._plan_one(boxes, t_lo_ms, t_hi_ms, max_ranges)
        if planned is None:
            return grid
        ra, bxs, lo, hi = planned
        rb, rlo, rhi = (self._dev(ra[k]) for k in ("rbin", "rzlo", "rzhi"))
        env_t = tuple(float(v) for v in env)
        # normalized-cell bounds for the decoded (keys/host) tiers
        b_lo, o_lo = to_binned_time(np.int64(max(0, lo)), self.period)
        b_hi, o_hi = to_binned_time(np.int64(max(0, hi)), self.period)
        tb = np.array([int(b_lo),
                       self.sfc.time.normalize_scalar(float(o_lo)),
                       int(b_hi),
                       self.sfc.time.normalize_scalar(float(o_hi))],
                      np.int64)
        ixy = np.stack([np.array(
            [self.sfc.lon.normalize_scalar(b[0]),
             self.sfc.lat.normalize_scalar(b[1]),
             self.sfc.lon.normalize_scalar(b[2]),
             self.sfc.lat.normalize_scalar(b[3])], np.int64)
            for b in bxs])
        live = self.generations[-1] if self.generations else None
        full_gens = [g for g in self.generations if g.tier == "full"]
        keys_gens = [g for g in self.generations if g.tier == "keys"]
        host_gens = [g for g in self.generations if g.tier == "host"]
        # sealed-generation partial cache: a demoted (keys/host)
        # generation's contribution to this exact spec is IMMUTABLE — sum
        # its cached grid and scan only the rest.  Full-tier generations
        # always re-scan: their payload mask is value-exact at window
        # edges and the cache must not replace that with anything looser.
        spec = ("scan", tuple(map(tuple, bxs.tolist())), int(lo), int(hi),
                env_t, width, height, int(max_ranges))
        cache = self._density_cache.spec_cache(spec)
        keys_scan: list = []
        for g in keys_gens:
            part = cache.get(g.gen_id) if g is not live else None
            if part is None:
                keys_scan.append(g)
            else:
                grid += part
        seeks, totals = self._probe(full_gens + keys_scan, rb, rlo, rhi)
        nf = len(full_gens)
        if full_gens and int(totals[:nf].sum()):
            grid += self._density_full(
                full_gens, seeks[:nf], totals[:nf], self._dev(bxs), lo, hi,
                env_t, width, height)
        if keys_scan:
            parts = self._density_keys(
                keys_scan, seeks[nf:], totals[nf:], self._dev(ixy), tb,
                env_t, width, height)
            for g, part in zip(keys_scan, parts):
                grid += part
                if g is not live:
                    self._density_cache.add(cache, g.gen_id, part)
        # host tier: ONE stacked vectorized pass attributes hits to their
        # owning runs, a cacheable partial each
        if host_gens:
            if any(g.gen_id not in cache for g in host_gens):
                if self._host_stack is None:
                    self._host_stack = HostStack([g.run for g in host_gens])
                parts = self._host_stack.density_partials(
                    ra["rbin"], ra["rzlo"], ra["rzhi"], self.sfc, ixy, tb,
                    env_t, width, height)
                for g, part in zip(host_gens, parts):
                    if g.gen_id not in cache:
                        self._density_cache.add(cache, g.gen_id, part)
                    grid += part
            else:
                for g in host_gens:
                    grid += cache[g.gen_id]
        return grid

    def _density_full(self, gens, seeks, totals, boxes, lo, hi, env,
                      width: int, height: int) -> np.ndarray:
        """DensityScan over ``full``-tier generations: seek + gather + the
        EXACT payload mask (raw float64) + a grid count, binned through
        the z-cell midpoint (normalize → denormalize) so cell assignment
        is integer-deterministic."""
        lon, lat = self.sfc.lon, self.sfc.lat
        acc = torch.zeros(width * height, dtype=torch.float64,
                          device=self.device)
        for gen, (starts, counts), tot in zip(gens, seeks, totals):
            if not int(tot):
                continue
            cap = gather_capacity(int(tot), minimum=self.DEFAULT_CAPACITY)
            idx, valid, _rid = expand_ranges(starts, counts, cap)
            local = torch.clamp(gen.pos[idx].to(torch.int64) - gen.base,
                                min=0)
            xc, yc, tc = gen.x[local], gen.y[local], gen.t[local]
            ok = (valid & _in_boxes(xc, yc, boxes).any(dim=1)
                  & (tc >= lo) & (tc <= hi))
            gx, gy = _grid_cells(lon.denormalize(lon.normalize(xc)),
                                 lat.denormalize(lat.normalize(yc)),
                                 env, width, height)
            acc += _grid_count(gx, gy, ok, width, height)
            self.dispatch_count += 1
        return acc.reshape(height, width).cpu().numpy()

    def _density_keys(self, gens, seeks, totals, ixy, tb, env,
                      width: int, height: int) -> list[np.ndarray]:
        """DensityScan over ``keys``-tier generations: the z KEY decodes
        to CELL coordinates on the device (21 bits/dim ≈ 1.7e-4°), so the
        grid accumulates with no payload and no host transfer.  Masks
        compare at cell granularity in normalized space — ``ixy`` holds
        per-box normalized (ix0, iy0, ix1, iy1) and ``tb`` = (bin_lo,
        cell_lo, bin_hi, cell_hi).  Returns one partial per generation
        (zero for a generation without candidates) so sealed ones can
        cache."""
        lon, lat = self.sfc.lon, self.sfc.lat
        b_lo, c_lo, b_hi, c_hi = (int(v) for v in tb)
        zero = torch.zeros(width * height, dtype=torch.float64,
                           device=self.device)
        grids = []
        for gen, (starts, counts), tot in zip(gens, seeks, totals):
            if not int(tot):
                grids.append(zero)
                continue
            cap = gather_capacity(int(tot), minimum=self.DEFAULT_CAPACITY)
            idx, valid, _rid = expand_ranges(starts, counts, cap)
            bc = gen.bins[idx].to(torch.int64)
            ix, iy, it = deinterleave3(gen.z[idx])
            in_box = _in_boxes(ix, iy, ixy).any(dim=1)
            after = (bc > b_lo) | ((bc == b_lo) & (it >= c_lo))
            before = (bc < b_hi) | ((bc == b_hi) & (it <= c_hi))
            ok = valid & in_box & after & before
            gx, gy = _grid_cells(lon.denormalize(ix), lat.denormalize(iy),
                                 env, width, height)
            grids.append(_grid_count(gx, gy, ok, width, height))
            self.dispatch_count += 1
        stacked = torch.stack(grids).cpu().numpy()
        return [stacked[i].reshape(height, width)
                for i in range(len(gens))]

    def _sweep_device(self, gen: _Generation, env, width: int, height: int,
                      world: bool) -> torch.Tensor:
        """WHOLE-EXTENT DensityScan of one device generation: no seek, no
        expand — every valid row decodes its grid cell from the z key.
        With a world envelope and power-of-two grid dims the binning is
        pure integer arithmetic (``(cell * width) >> precision``, exactly
        the midpoint binning when width divides 2^precision); any other
        envelope/width takes the float64 midpoint path."""
        ix, iy, _it = deinterleave3(gen.z[:gen.n])
        if world:
            p = self.sfc.lon.precision
            gx = (ix * width) >> p
            gy = (iy * height) >> p
        else:
            gx, gy = _grid_cells(self.sfc.lon.denormalize(ix),
                                 self.sfc.lat.denormalize(iy),
                                 env, width, height)
        self.dispatch_count += 1
        return _grid_count(gx, gy, None, width, height)

    def _density_sweep(self, env, width: int, height: int) -> np.ndarray:
        """Whole-extent grid: one sweep per UNCACHED device generation +
        one numpy pass per uncached host run.  Every SEALED generation's
        sweep partial caches under the grid spec — a whole-extent sweep
        is z-only and time-independent, so the partial survives the
        generation's own later demotions; the live generation's partial
        caches per row count (append-only rows never change).

        Pyramid serving: on a world-extent, square, power-of-two grid, a
        sealed generation whose built pyramid carries this resolution
        contributes its level grid — bit-identical to sweeping it, no
        keys touched.  Generations without a pyramid sweep as before."""
        env_t = tuple(float(v) for v in env)
        world = (env_t == _WORLD_ENV
                 and width & (width - 1) == 0
                 and height & (height - 1) == 0)
        pyr_ok = world and width == height
        grid = np.zeros((height, width), np.float64)
        live = self.generations[-1] if self.generations else None
        cache = self._density_cache.spec_cache(("sweep", env_t, width,
                                                height))
        scan: list = []
        for g in self.generations:
            if g.tier == "host":
                continue
            if g is not live:
                part = self._pyramid_level(g.gen_id, width) if pyr_ok \
                    else None
                if part is not None:
                    self.pyramid_serve_hits += 1
                    grid += part
                    continue
                part = cache.get(g.gen_id)
            else:
                part = cache.get(("live", g.gen_id, int(g.n)))
            if part is None:
                scan.append(g)
            else:
                grid += part
        if scan:
            stacked = torch.stack([
                self._sweep_device(g, env_t, width, height, world)
                for g in scan]).cpu().numpy()
            for i, g in enumerate(scan):
                part = stacked[i].reshape(height, width)
                grid += part
                if g is not live:
                    self._density_cache.add(cache, g.gen_id, part)
                else:
                    for k in [k for k in cache
                              if isinstance(k, tuple) and k[0] == "live"
                              and k[1] == g.gen_id]:
                        cache.pop(k)   # superseded row counts
                    self._density_cache.add(
                        cache, ("live", g.gen_id, int(g.n)), part)
        for g in self.generations:
            if g.tier != "host":
                continue
            if pyr_ok:
                lvl = self._pyramid_level(g.gen_id, width)
                if lvl is not None:
                    self.pyramid_serve_hits += 1
                    grid += lvl
                    continue
            part = cache.get(g.gen_id)
            if part is None:
                part = g.run.sweep_partial(self.sfc, env_t, width, height,
                                           world)
                self._density_cache.add(cache, g.gen_id, part)
            grid += part
        return grid

    def build_pyramids(self, base: int | None = None,
                       levels: int | None = None) -> int:
        """Build the density pyramid of every sealed generation that lacks
        one: one whole-world sweep per generation at the pow2 ``base``
        resolution (device generations through the device sweep and the
        2×2 reduction ladder, spilled host runs through their numpy
        twins), cached under the PartialCache policy.  Idempotent
        build-behind: built generations are skipped, an interrupted build
        leaves every result exact (unbuilt generations keep sweeping),
        and the next call resumes with the missing ones.  Returns the
        number of pyramids built."""
        base = int(base if base is not None
                   else DensityProperties.PYRAMID_BASE.to_int())
        if base <= 0 or base & (base - 1):
            raise ValueError(
                f"pyramid base must be a power of two, got {base}")
        levels = int(levels if levels is not None
                     else DensityProperties.PYRAMID_LEVELS.to_int())
        depth = _ladder_depth(base, levels)
        cache = self._pyramid_cache.spec_cache(pyramid_spec(base))
        built = 0
        for g in self._sealed():
            if g.gen_id in cache:
                continue
            if g.tier == "host":
                pyr = DensityPyramid.from_base(
                    g.run.sweep_partial(self.sfc, _WORLD_ENV, base, base,
                                        True), levels)
            else:
                base_dev = self._sweep_device(
                    g, _WORLD_ENV, base, base, True).reshape(base, base)
                lv = {base: base_dev.cpu().numpy()}
                for arr in pyramid_reduce(base_dev, depth):
                    lv[arr.shape[0]] = arr.cpu().numpy()
                pyr = DensityPyramid(lv)
            self._pyramid_cache.add(cache, g.gen_id, pyr)
            built += 1
        return built

    def density_tile(self, z: int, x: int, y: int, tile: int = 256,
                     max_ranges: int = DEFAULT_MAX_RANGES) -> np.ndarray:
        """One slippy map tile's density grid (index/pyramid.py): a slice
        of the world sweep while ``tile·2^z`` stays at or below the
        pyramid base, a bbox density scan beyond."""
        from .pyramid import density_tile as _tile
        return _tile(self, z, x, y, tile, max_ranges)

    def range_count(self, boxes, t_lo_ms, t_hi_ms,
                    max_ranges: int = DEFAULT_MAX_RANGES) -> int:
        """Hit count with no candidate materialization (the StatsScan
        Count() push-down): a 1×1 density grid over the world."""
        return int(round(self.density(
            boxes, t_lo_ms, t_hi_ms, _WORLD_ENV, 1, 1,
            max_ranges=max_ranges).sum()))

    def z3_cell_counts(self, bits: int) -> dict:
        """WHOLE-EXTENT Z3Histogram push-down: fold every generation's
        sorted keys into coarse ``(time-bin, z-cell)`` counts — the
        stat's own cell function applied to the key the index already
        stores, so no payload and no candidates.  Returns
        ``{(bin, cell): count}`` (see :meth:`z3_cell_table`)."""
        b0, total = self.z3_cell_table(bits)
        nz = np.flatnonzero(total)
        c_per_bin = 1 << bits
        return dict(zip(zip((b0 + nz // c_per_bin).tolist(),
                            (nz % c_per_bin).tolist()),
                        total[nz].tolist()))

    def z3_cell_table(self, bits: int) -> tuple[int, np.ndarray]:
        """The cell counts of :meth:`z3_cell_counts` as a dense int64
        table: ``(b0, counts)`` with ``counts[(bin - b0) << bits | cell]``
        over the data's bin span (an empty table on an empty index).
        Sealed generations' tables cache under ``(bits, bin span)``
        (compaction invalidates); warm repeats fold only the live
        generation."""
        if self._n_rows == 0 or self.t_min_ms is None:
            return 0, np.zeros(0, np.int64)
        b0, _ = to_binned_time(np.int64(max(0, self.t_min_ms)),
                               self.period)
        b1, _ = to_binned_time(np.int64(max(0, self.t_max_ms)),
                               self.period)
        b0, nb = int(b0), int(b1) - int(b0) + 1
        cache = self._sketch_cache.spec_cache(("z3cells", int(bits), b0,
                                               nb))
        live = self.generations[-1] if self.generations else None
        total = np.zeros(nb << bits, np.int64)
        for g in self.generations:
            part = cache.get(g.gen_id) if g is not live else None
            if part is None:
                if g.tier == "host":
                    part = g.run.cell_counts(b0, nb, int(bits))
                else:
                    self.dispatch_count += 1
                    part = _z3_cells(g.bins[:g.n], g.z[:g.n], b0, nb,
                                     int(bits)).cpu().numpy()
                if g is not live:
                    self._sketch_cache.add(cache, g.gen_id, part)
            total += part
        return b0, total
