"""ShardedLeanZ3Index: the tiered lean generational z3 index over a mesh.

The port of the JAX package's ``parallel/lean.py``.  The reference's scan
plans fan out over tablet servers (AccumuloQueryPlan.scala:87-157); here
every generation's sorted key run is split over the mesh's devices — one
``(slots,)`` column per shard — and each program runs per shard: every
device seeks its own sorted runs, and the per-shard partials (candidate
totals, density grids, cell counts) sum on the host, the port's ``psum``.

Positions are GLOBAL gids (``process << GID_PROC_SHIFT | local_row``
under multihost, plain row ids on one process), minted on the host at
append time and carried as an int64 sort payload.

**Several processes** (``multihost=True``): each process appends its
LOCAL rows to its own shards, in steps whose slot count derives from the
agreed largest load, so every process rolls, seals, demotes and merges
the same generations (tier decisions read only process-invariant slot
counts).  Probe totals allgather into the global ``(shards, generations)``
table every dispatch decision and replan probe reads; hits allgather,
grids and cell tables all-reduce.  Spilled runs stay on their owning
process.  ``budget_ms`` is ignored under multihost: a wall-clock cut could
stop processes after different merges.

**Residency tiers** (the single-device ``index/z3_lean`` design composed
with the mesh — each generation demotes oldest-first under a PER-SHARD
device-memory budget):

* ``full`` — keys AND an (x, y, t) payload per shard: the exact
  bbox+time mask runs on the device and only true hits leave it.  A
  shard's rows are block-split slices of many appends, so gids are not
  generation-contiguous per shard and a ``pos - base`` gather (the
  single-device full tier's) cannot work: the payload is carried THROUGH
  the per-shard sort beside the keys, and the gather indexes it
  directly.
* ``keys`` — 20 B/slot per shard (bins int32 + z int64 + gid int64):
  device seeks + candidate gather; the exact mask runs on the host
  payload.
* ``host`` — each shard's sorted run spilled to host RAM as a
  :class:`~geomesa_tpu_torch.index.z3_lean.HostRun`, seeked through the
  shared :class:`~geomesa_tpu_torch.index.z3_lean.HostStack`.

**Parity with the JAX index.**  The slot layout is the JAX package's:
an append block-splits its rows over the shards (``per = ceil(m /
shards)``, ``m_pad = gather_capacity(per)``), consumes ``m_pad`` slots of
every shard per step and rolls the generation when the next step would
not fit.  The budget charges the same per-slot bytes against the same
per-shard budget, including the full-size sentinel generations the JAX
index allocates to pad its compile buckets, so every tier decision equals
the reference's.  The port runs eager PyTorch and pads nothing, so it
allocates no sentinel generation (``sentinel_bytes`` is 0) and its
device memory is exactly ``device_bytes``.  ``dispatch_count`` counts
what the JAX index dispatches: one per program over every shard (an
append step, a totals probe, a scan group, a merge, a density tier, a
cell fold).  The JAX sort of equal ``(bin, z)`` keys is not stable; here
runs sort by ``(bin, z, gid)``, so only hit sets and per-key sets are
held equal to the reference, never the raw layout.

No Pallas kernel sits on this path in the JAX package (its scan, density
and cell programs build their masks and grids inline), so none does here:
each program is plain PyTorch per shard.

**Tracing and heat.**  The JAX index's spans sit at the same sites:
``query.decompose``, the probe's and each tier's ``query.scan.device``
(each ends in its device→host copy), ``query.scan.host`` (seek,
recheck), ``write.seal``, ``write.spill`` and ``pyramid.build``.  Query,
density and cell-fold scans record their per-generation heat touches
(obs/heat.py, process-local, never a collective) under
:attr:`ShardedLeanZ3Index.heat_scope`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import DEFAULT_MAX_RANGES, DensityProperties
from ..curve.binnedtime import TimePeriod, to_binned_time
from ..curve.zorder import deinterleave3
from ..index.lsm import (
    compact_incremental, merged_capacity, notify_generation_event,
    plan_size_tiered, replace_group,
)
from ..index.partial_cache import PartialCache
from ..index.pyramid import DensityPyramid, pyramid_spec
from ..index.z3 import (
    _SENTINEL_BIN, _SENTINEL_Z, Z3_INDEX_VERSION, _lexsort2, plan_z3_query,
    z3_sfc_for_version,
)
from ..index.z3_lean import (
    _MAX_RANGES_PER_WINDOW, HostRun, HostStack, LeanZ3Index, _bins_spanned,
    _grid_cells, _grid_count, _in_boxes, _z3_cells, merge_host_runs,
)
from ..ops.search import (
    expand_ranges, gather_capacity, pad_pow2, pad_ranges, searchsorted2,
    split_coded,
)
from ..metrics import (
    LEAN_COMPACTION_MERGES, LEAN_COMPACTION_ROWS, LEAN_SKETCH_CACHE_HITS,
    LEAN_SKETCH_CACHE_MISSES, PYRAMID_BUILD_MS, PYRAMID_BUILDS,
    PYRAMID_SERVE_HITS, WRITE_SEALS, WRITE_SPILLS, registry as _metrics,
)
from ..obs.heat import (
    heat_enabled, merge_index_generations, record_index_scan,
)
from ..obs.trace import device_span, obs_count
from ..obs.trace import span as obs_span
from ..planning.adaptive import check_replan
from ..resilience.deadline import check_cancel
from ..resilience.degrade import breaker, classify_device_failure
from ..resilience.faults import fault_point
from .mesh import DeviceMesh
from .multihost import (
    agreed_int, allgather_concat, allreduce_tensor, process_index,
)
from .scan import (
    GID_PROC_SHIFT, _PerDevice, encode_gids, multihost_gid_span,
)

__all__ = ["ShardedLeanZ3Index", "KEYS_BYTES", "FULL_BYTES", "lexsort"]

#: the world extent pyramids align to
_PYRAMID_WORLD = (-180.0, -90.0, 180.0, 90.0)

#: per-slot byte widths, derived once from the column dtypes (bins int32
#: + z int64 + pos int64 — pos is an int64 gid here, unlike the
#: single-device index's int32 — and the full tier adds x/y float64 +
#: t int64).  Every budget computation uses these.
KEYS_BYTES = 4 + 8 + 8
PAYLOAD_BYTES = 8 + 8 + 8
FULL_BYTES = KEYS_BYTES + PAYLOAD_BYTES

#: the JAX package's generation-count compile bucket: its multi-generation
#: programs pad the device generations to a multiple of this, which
#: decides whether a batched scan fits ``BATCH_SCAN_BUDGET``
_GEN_BUCKET = 4


def lexsort(*cols):
    """Permutation sorting the columns lexicographically, the FIRST
    column most significant: one stable sort per column, least
    significant first (the keys and the gid fit no single sort key)."""
    perm = torch.sort(cols[-1], stable=True).indices
    for c in reversed(cols[:-1]):
        perm = perm[torch.sort(c[perm], stable=True).indices]
    return perm


def _sentinel_cols(slots: int, device, full: bool) -> list:
    cols = [torch.full((slots,), _SENTINEL_BIN, dtype=torch.int32,
                       device=device),
            torch.full((slots,), _SENTINEL_Z, dtype=torch.int64,
                       device=device),
            torch.full((slots,), -1, dtype=torch.int64, device=device)]
    if full:
        cols += [torch.zeros(slots, dtype=torch.float64, device=device),
                 torch.zeros(slots, dtype=torch.float64, device=device),
                 torch.zeros(slots, dtype=torch.int64, device=device)]
    return cols


class _ShardedGen:
    """One generation: a sorted run per shard.  ``bins``/``z``/``pos``
    (and ``x``/``y``/``t`` on the full tier) are lists with one
    ``(slots,)`` tensor per shard, each holding ``fill[s]`` valid rows at
    its front and sentinel keys after them.  ``tier`` ∈ {"full", "keys",
    "host"} (module doc)."""

    __slots__ = ("bins", "z", "pos", "x", "y", "t", "n_slots", "tier",
                 "runs", "fill", "gen_id")

    def __init__(self, mesh: DeviceMesh, slots: int, tier: str = "keys"):
        full = tier == "full"
        cols = [_sentinel_cols(slots, d, full) for d in mesh]
        self.bins, self.z, self.pos = ([c[i] for c in cols]
                                       for i in range(3))
        if full:
            self.x, self.y, self.t = ([c[i] for c in cols]
                                      for i in range(3, 6))
        else:
            self.x = self.y = self.t = None
        #: slot offset consumed so far, the same on every shard (each
        #: append step consumes the same m_pad slots of every shard)
        self.n_slots = 0
        self.tier = tier
        #: host tier: one spilled HostRun per shard
        self.runs: list[HostRun] | None = None
        #: valid rows per shard
        self.fill = np.zeros(mesh.size, np.int64)
        #: store-lifetime-unique run identity (the partial caches' key)
        self.gen_id = -1

    @classmethod
    def merged_keys(cls, bins, z, pos, fill, n_slots: int) -> "_ShardedGen":
        """A compacted ``keys``-tier generation from merged per-shard
        columns."""
        gen = cls.__new__(cls)
        gen.bins, gen.z, gen.pos = bins, z, pos
        gen.x = gen.y = gen.t = None
        gen.n_slots = int(n_slots)
        gen.tier = "keys"
        gen.runs = None
        gen.fill = np.asarray(fill, np.int64)
        gen.gen_id = -1
        return gen

    @classmethod
    def merged_host(cls, runs: list, n_slots: int) -> "_ShardedGen":
        """A compacted ``host``-tier generation from merged runs."""
        gen = cls.__new__(cls)
        gen.bins = gen.z = gen.pos = None
        gen.x = gen.y = gen.t = None
        gen.n_slots = int(n_slots)
        gen.tier = "host"
        gen.runs = runs
        gen.fill = np.array([len(r) for r in runs], np.int64)
        gen.gen_id = -1
        return gen

    @property
    def slots(self) -> int:
        return 0 if self.tier == "host" else int(self.z[0].shape[0])

    @property
    def n(self) -> int:
        """Valid rows over every shard."""
        return int(self.fill.sum())

    def per_shard_bytes(self) -> int:
        """Device bytes ONE shard holds for this generation (the unit the
        per-shard budget governs)."""
        if self.tier == "host":
            return 0
        per = FULL_BYTES if self.tier == "full" else KEYS_BYTES
        return self.slots * per

    def device_bytes(self) -> int:
        if self.tier == "host":
            return 0
        return len(self.z) * self.per_shard_bytes()

    def drop_payload(self) -> None:
        """full → keys: free the per-shard device payload (the host
        payload remains the re-check truth)."""
        if self.tier == "full":
            self.x = self.y = self.t = None
            self.tier = "keys"

    def spill_to_host(self) -> None:
        """keys → host: fetch every shard's sorted run into host RAM and
        free the device memory."""
        self.drop_payload()
        if self.tier != "keys":
            return
        self.runs = [HostRun(b[:k].cpu().numpy(), z[:k].cpu().numpy(),
                             p[:k].cpu().numpy())
                     for b, z, p, k in zip(self.bins, self.z, self.pos,
                                           self.fill.tolist())]
        self.bins = self.z = self.pos = None
        self.tier = "host"

    def host_key_bytes(self) -> int:
        if self.tier != "host":
            return 0
        return sum(len(r) * KEYS_BYTES for r in self.runs)


def _seek(b, z, a: dict):
    starts = searchsorted2(b, z, a["rbin"], a["rzlo"], side="left")
    ends = searchsorted2(b, z, a["rbin"], a["rzhi"], side="right")
    return starts, torch.clamp(ends - starts, min=0)


class ShardedLeanZ3Index:
    """Tiered lean generational z3 index over a device mesh (module
    doc)."""

    #: ``(schema, index_key)`` the heat touches record under, stamped by
    #: the store; an index built directly records under its class name
    heat_scope: tuple | None = None

    #: slots per generation PER SHARD
    GENERATION_SLOTS = 1 << 22
    DEFAULT_CAPACITY = 1 << 15
    #: per-shard slot budget for one batched scan output
    BATCH_SCAN_BUDGET = 1 << 26
    #: default PER-SHARD device-memory budget: the JAX package's default
    #: (a TPU v5e's usable HBM minus scan slack), kept only so that tier
    #: decisions equal the reference's for the same inputs — not a
    #: measurement on the card.  Stores set it with
    #: ``geomesa.lean.hbm.budget``.
    HBM_BUDGET_BYTES = int(13.5 * 2**30)
    #: size-tiered compaction trigger (see index/z3_lean.LeanZ3Index)
    COMPACTION_FACTOR = 4

    def __init__(self, period: TimePeriod | str = TimePeriod.WEEK,
                 mesh: DeviceMesh | None = None,
                 version: int = Z3_INDEX_VERSION,
                 generation_slots: int | None = None,
                 multihost: bool = False,
                 hbm_budget_bytes: int | None = None,
                 payload_on_device: bool = True,
                 compaction_factor: int | None = None):
        if mesh is None:
            raise ValueError("ShardedLeanZ3Index needs a mesh "
                             "(parallel.device_mesh)")
        self._multihost = bool(multihost)
        self.period = TimePeriod.parse(period)
        self.version = version
        self.sfc = z3_sfc_for_version(self.period, version)
        self.mesh = mesh
        self.generation_slots = generation_slots or self.GENERATION_SLOTS
        self.hbm_budget_bytes = hbm_budget_bytes or self.HBM_BUDGET_BYTES
        #: whether NEW generations carry per-shard payload for the exact
        #: device mask (they demote under budget pressure)
        self.payload_on_device = payload_on_device
        self.generations: list[_ShardedGen] = []
        #: host payload provider: () -> (x, y, t) of THIS process's rows
        #: (the store's columns); without one the appended slices are kept
        self.payload_provider = None
        self._payload: list = []
        self._flat = None
        self._n_local = 0      # this process's rows
        self._n_total = 0      # agreed rows over every process
        self.t_min_ms: int | None = None
        self.t_max_ms: int | None = None
        self.dispatch_count = 0
        #: stacked host-tier runs (built lazily after a spill)
        self._host_stack: HostStack | None = None
        #: opportunistic compaction factor (0 = off)
        self.compaction_factor = int(compaction_factor or 0)
        self.compactions = 0
        #: sealed generations whose world grid a pyramid level served
        self.pyramid_serve_hits = 0
        #: sealed-run z3 cell-count partials, keyed by gen_id
        self._sketch_cache = PartialCache(LeanZ3Index.SKETCH_CACHE_SPECS,
                                          LeanZ3Index.SKETCH_CACHE_MAX_BYTES)
        #: sealed-generation density pyramids, keyed by gen_id
        self._pyramid_cache = PartialCache(
            LeanZ3Index.PYRAMID_CACHE_SPECS,
            DensityProperties.PYRAMID_CACHE_BYTES.to_int())
        #: generation-lifecycle listeners ``(kind, gen_ids)`` fired on
        #: seal/merge (index/lsm.notify_generation_event)
        self.generation_listeners: list = []
        self._gen_counter = 0

    def _next_gen_id(self) -> int:
        self._gen_counter += 1
        return self._gen_counter

    def __len__(self) -> int:
        return self._n_total

    def total(self) -> int:
        return self._n_total

    @property
    def _shard0(self) -> int:
        """Global number of this process's first shard."""
        return process_index() * self.mesh.size if self._multihost else 0

    def _global_totals(self, local: np.ndarray) -> np.ndarray:
        """The ``(shards, generations)`` probe totals over every process
        (the local rows allgathered in process order)."""
        return allgather_concat(local) if self._multihost else local

    # -- accounting -------------------------------------------------------
    def device_bytes(self) -> int:
        """Device bytes of every generation over this process's shards."""
        return sum(g.device_bytes() for g in self.generations)

    def host_key_bytes(self) -> int:
        """Host RAM this process holds in spilled per-shard runs."""
        return sum(g.host_key_bytes() for g in self.generations)

    def tier_counts(self) -> dict:
        out = {"full": 0, "keys": 0, "host": 0}
        for g in self.generations:
            out[g.tier] += 1
        return out

    def sentinel_bytes(self) -> int:
        """Device bytes of sentinel padding generations: none, since the
        port pads nothing (the budget still charges the JAX package's,
        see :meth:`_per_shard_resident`)."""
        return 0

    def storage_stats(self) -> dict:
        """Where this index's bytes sit, per generation, from the same
        per-slot constants the budget uses."""
        gens = [{"gen_id": g.gen_id, "tier": g.tier,
                 "slots": int(g.n_slots), "capacity": g.slots,
                 "device_bytes": g.device_bytes(),
                 "host_bytes": g.host_key_bytes()}
                for g in self.generations]
        return {"kind": type(self).__name__, "rows": len(self),
                "tiers": self.tier_counts(),
                "device_bytes": self.device_bytes(),
                "host_bytes": self.host_key_bytes(),
                "sentinel_bytes": self.sentinel_bytes(),
                "hbm_budget_bytes": self.hbm_budget_bytes,
                "generations": gens,
                "caches": {"sketch": self._sketch_cache.stats(),
                           "pyramid": self._pyramid_cache.stats()},
                "dispatches": self.dispatch_count}

    def block(self) -> None:
        """Wait for the cards' queued work (appends are asynchronous)."""
        for d in dict.fromkeys(self.mesh):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    # -- write path -------------------------------------------------------
    def _per_shard_resident(self) -> int:
        """Per-shard device bytes plus the JAX package's full-size
        sentinel padding generations (a keys one always, a full one while
        full-tier generations exist)."""
        per = sum(g.per_shard_bytes() for g in self.generations)
        per += self.generation_slots * KEYS_BYTES
        if any(g.tier == "full" for g in self.generations):
            per += self.generation_slots * FULL_BYTES
        return per

    def _rebalance(self) -> None:
        """Demote oldest-first until each shard's residency fits the
        per-shard budget: payload drops first (full → keys, the live
        generation's too), then runs spill to host RAM (keys → host).
        The ACTIVE generation's keys never spill — appends sort there."""
        if self._per_shard_resident() <= self.hbm_budget_bytes:
            return
        for gen in self.generations:
            if gen.tier == "full":
                gen.drop_payload()
                if self._per_shard_resident() <= self.hbm_budget_bytes:
                    return
        for gen in self.generations[:-1]:
            if gen.tier == "keys":
                # the spill ends in the device→host copy of its shards
                with device_span("write.spill", gen_id=gen.gen_id,
                                 slots=int(gen.n_slots)):
                    obs_count(WRITE_SPILLS)
                    gen.spill_to_host()
                self._host_stack = None   # restacked on the next query
                if self._per_shard_resident() <= self.hbm_budget_bytes:
                    return
        if self._per_shard_resident() > self.hbm_budget_bytes:
            raise MemoryError(
                f"active generation ({self.generation_slots} slots/"
                f"shard) exceeds hbm_budget_bytes="
                f"{self.hbm_budget_bytes} minus sentinel overhead")

    def _new_generation(self) -> _ShardedGen:
        tier = "full" if self.payload_on_device else "keys"
        if tier == "full":
            # would the payload survive rebalance?  The drop loop runs
            # oldest→newest BEFORE any spill, so if demoting every
            # existing payload still busts the budget, this generation's
            # payload is doomed — don't allocate shards × slots × 24 B
            # that would free moments later
            floor = (sum(min(g.per_shard_bytes(),
                             self.generation_slots * KEYS_BYTES)
                         for g in self.generations)
                     + self.generation_slots
                     * (FULL_BYTES + KEYS_BYTES + FULL_BYTES))
            if floor > self.hbm_budget_bytes:
                tier = "keys"
        gen = _ShardedGen(self.mesh, self.generation_slots, tier=tier)
        gen.gen_id = self._next_gen_id()
        self.generations.append(gen)
        self._rebalance()
        return self.generations[-1]

    def _append_shard(self, gen: _ShardedGen, s: int, x, y, offs, bins,
                      gids, t) -> None:
        """Encode one shard's slice of an append step into its sentinel
        slots right after its valid rows and re-sort the valid prefix —
        the JAX append body on one device (writing the slice at the
        shard's fill instead of the consumed-slot offset changes no
        sorted run: every slot past the fill holds a sentinel)."""
        dev = self.mesh[s]

        def up(a):
            # a copy where the slice is read-only (columns reloaded from a
            # catalog are)
            return torch.from_numpy(np.require(a, requirements="CW")).to(dev)

        r, k = int(gen.fill[s]), len(x)
        xs, ys = up(x), up(y)
        w = slice(r, r + k)
        gen.bins[s][w] = up(bins)
        gen.z[s][w] = self.sfc.index(xs, ys, up(offs))
        gen.pos[s][w] = up(gids)
        cols = [gen.bins, gen.z, gen.pos]
        if gen.tier == "full":
            gen.x[s][w] = xs
            gen.y[s][w] = ys
            gen.t[s][w] = up(t)
            cols += [gen.x, gen.y, gen.t]
        end = r + k
        # new gids exceed every resident one, so the stable two-key sort
        # leaves equal keys in gid order: the run stays (bin, z, gid)
        # sorted
        perm = _lexsort2(gen.bins[s][:end], gen.z[s][:end])
        for c in cols:
            c[s][:end] = c[s][:end][perm]
        gen.fill[s] = end

    def append(self, x, y, dtg_ms) -> "ShardedLeanZ3Index":
        """Block-split the rows over the shards and merge them into the
        current generation (rolling when full).  Oversized appends loop
        through several generations.  Under multihost every process
        enters with its LOCAL rows: the step size derives from the agreed
        largest load, so every process takes the same steps (trailing
        ones feed empty slices)."""
        x = np.ascontiguousarray(x, dtype=np.float64)
        y = np.ascontiguousarray(y, dtype=np.float64)
        dtg_ms = np.ascontiguousarray(dtg_ms, dtype=np.int64)
        m = len(x)
        m_max = agreed_int(m, "max") if self._multihost else m
        if m_max == 0:
            return self
        if self.payload_provider is None:
            self._payload.append((x, y, dtg_ms))
            self._flat = None
        n_shards = self.mesh.size
        per = -(-m_max // n_shards)
        m_pad = min(gather_capacity(per, minimum=8), self.generation_slots)
        host_bins, host_offs = to_binned_time(dtg_ms, self.period)
        host_bins = host_bins.astype(np.int32)
        host_offs = host_offs.astype(np.float64)
        rows = self._n_local + np.arange(m, dtype=np.int64)
        gids = encode_gids(rows) if self._multihost else rows
        done = 0
        while done < m_max:
            gen = self.generations[-1] if self.generations else None
            if gen is None or gen.tier == "host" \
                    or gen.n_slots + m_pad > gen.slots:
                if gen is not None and gen.tier != "host":
                    # the live generation seals on rollover (the span
                    # covers the rebalance)
                    sealed = gen.gen_id
                    with obs_span("write.seal", gen_id=gen.gen_id,
                                  tier=gen.tier, slots=int(gen.n_slots)):
                        obs_count(WRITE_SEALS)
                        gen = self._new_generation()
                    notify_generation_event(self, "seal", [sealed])
                else:
                    gen = self._new_generation()
            take_all = min(m_pad * n_shards, max(0, m - done))
            for s in range(n_shards):
                lo, hi = done + s * m_pad, done + min(take_all,
                                                      (s + 1) * m_pad)
                if hi <= lo:
                    break
                sl = slice(lo, hi)
                self._append_shard(
                    gen, s, x[sl], y[sl], host_offs[sl], host_bins[sl],
                    gids[sl], dtg_ms[sl])
            self.dispatch_count += 1
            gen.n_slots += m_pad
            done += m_pad * n_shards
        self._n_local += m
        big = np.iinfo(np.int64)
        trip = np.array([[m, dtg_ms.min() if m else big.max,
                          dtg_ms.max() if m else big.min]], np.int64)
        if self._multihost:
            # one allgather agrees the row sum and the time extent together
            trip = allgather_concat(trip)
        self._n_total += int(trip[:, 0].sum())
        t_min, t_max = int(trip[:, 1].min()), int(trip[:, 2].max())
        self.t_min_ms = (t_min if self.t_min_ms is None
                         else min(self.t_min_ms, t_min))
        self.t_max_ms = (t_max if self.t_max_ms is None
                         else max(self.t_max_ms, t_max))
        if self.compaction_factor:
            # bounded opportunistic trigger: one merge group per append (a
            # deterministic cap, so every multihost process folds alike)
            self.compact(factor=self.compaction_factor, max_groups=1)
        return self

    # -- compaction (LSM maintenance) -------------------------------------
    def _compaction_groups(self, factor: int) -> list[list]:
        """Size-tiered merge plan over SEALED generations, bucketed by
        consumed slot count (the JAX index's plan)."""
        return plan_size_tiered(self.generations[:-1], ("keys", "host"),
                                lambda g: g.n_slots, factor)

    def _merge_group(self, group: list) -> None:
        n_slots = int(sum(g.n_slots for g in group))
        if group[0].tier == "keys":
            out_slots = merged_capacity(
                n_slots, sum(g.slots for g in group), gather_capacity)
            bins, z, pos = [], [], []
            fill = np.zeros(self.mesh.size, np.int64)
            for s, dev in enumerate(self.mesh):
                # each shard's valid rows of the K runs, sorted; sentinels
                # pad the merged run to out_slots
                k = [int(g.fill[s]) for g in group]
                cb = torch.cat([g.bins[s][:n] for g, n in zip(group, k)])
                cz = torch.cat([g.z[s][:n] for g, n in zip(group, k)])
                cp = torch.cat([g.pos[s][:n] for g, n in zip(group, k)])
                perm = lexsort(cb, cz, cp)
                sb, sz, sp = _sentinel_cols(out_slots, dev, False)
                fill[s] = len(perm)
                sb[:fill[s]], sz[:fill[s]], sp[:fill[s]] = (
                    cb[perm], cz[perm], cp[perm])
                bins.append(sb)
                z.append(sz)
                pos.append(sp)
            self.dispatch_count += 1
            merged = _ShardedGen.merged_keys(bins, z, pos, fill,
                                             n_slots=n_slots)
        else:
            merged = _ShardedGen.merged_host(
                [merge_host_runs([r for g in group for r in g.runs])],
                n_slots=n_slots)
            self._host_stack = None
        merged.gen_id = self._next_gen_id()
        dead_ids = [g.gen_id for g in group]
        self._sketch_cache.drop_generations(dead_ids)
        # the merged run inherits its sources' access temperature, before
        # the swap (see index/z3_lean.py)
        merge_index_generations(self, dead_ids, merged.gen_id)
        # the merged run's pyramid is the SUM of its parents', taken
        # before the parents' entries drop
        self._inherit_pyramids(dead_ids, merged.gen_id)
        self._pyramid_cache.drop_generations(dead_ids)
        self.generations = replace_group(self.generations, group, merged)
        self.compactions += 1
        _metrics.counter(LEAN_COMPACTION_MERGES).inc()
        # consumed-slot upper bound × shards: the exact per-shard valid
        # counts live on the devices
        _metrics.counter(LEAN_COMPACTION_ROWS).inc(n_slots * self.mesh.size)
        notify_generation_event(self, "merge", [merged.gen_id])

    def compact(self, budget_ms: float | None = None,
                factor: int | None = None,
                max_groups: int | None = None) -> dict:
        """Incremental size-tiered merge compaction over the sharded runs
        (see index/z3_lean.LeanZ3Index.compact).  Under multihost
        ``budget_ms`` is ignored (``max_groups`` and the invariant plan are
        the agreed stopping points).  Returns ``{"merged_groups",
        "generations", "tiers"}``."""
        f = int(factor or self.compaction_factor or self.COMPACTION_FACTOR)
        merged = compact_incremental(
            lambda: self._compaction_groups(f), self._merge_group,
            budget_ms=None if self._multihost else budget_ms,
            max_groups=max_groups)
        if merged:
            self._rebalance()
        return {"merged_groups": merged,
                "generations": len(self.generations),
                "tiers": self.tier_counts()}

    # -- payload ----------------------------------------------------------
    def _payload_flat(self):
        if self.payload_provider is not None:
            return self.payload_provider()
        if self._flat is None:
            xs, ys, ts = (zip(*self._payload) if self._payload
                          else ((), (), ()))
            self._flat = (
                np.concatenate(xs) if xs else np.empty(0),
                np.concatenate(ys) if ys else np.empty(0),
                np.concatenate(ts) if ts else np.empty(0, np.int64))
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

    def gather_payload(self, positions: np.ndarray):
        """(x, y, t) for the given LOCAL row positions (under multihost the
        caller decodes gids first): one vectorized take from
        the host payload (the sharded full tier stores its payload
        key-sorted per shard, so a row-addressed device take would need a
        per-row key search)."""
        positions = np.asarray(positions, dtype=np.int64)
        x, y, t = self._payload_flat()
        return (np.asarray(x)[positions], np.asarray(y)[positions],
                np.asarray(t, np.int64)[positions])

    # -- per-shard programs ------------------------------------------------
    def _uploads(self, **arrays) -> list[dict]:
        """Host arrays uploaded once per distinct device, one dict per
        shard."""
        per = _PerDevice(**arrays)
        return [per.on(d) for d in self.mesh]

    def _probe(self, gens, args):
        """Seek every (generation, shard) once: the seeks (kept on the
        devices for the scan that follows) and the ``(n_shards, n_gens)``
        candidate totals over EVERY process's shards (this process's rows
        start at :attr:`_shard0`), one device→host copy per device."""
        if not gens:
            return [], np.zeros((self.mesh.size, 0), np.int64)
        self.dispatch_count += 1
        with device_span("query.scan.device", stage="probe", runs=len(gens)):
            seeks = [[_seek(g.bins[s], g.z[s], args[s])
                      for s in range(self.mesh.size)] for g in gens]
            sums = [torch.stack([seeks[i][s][1].sum()
                                 for i in range(len(gens))])
                    for s in range(self.mesh.size)]
            return seeks, self._global_totals(
                np.stack([t.cpu().numpy() for t in sums]))

    def _scan_dispatches(self, totals: np.ndarray) -> int:
        """Scan programs the JAX index dispatches for one tier's probe
        totals: one over the tier's (bucket-padded) generations with
        candidates when the shared-capacity buffer fits
        ``BATCH_SCAN_BUDGET``, else one per such generation."""
        live = int((totals.max(axis=0) > 0).sum())
        if not live:
            return 0
        cap = gather_capacity(int(totals.max()), minimum=self.DEFAULT_CAPACITY)
        n_padded = live + (-live) % _GEN_BUCKET
        return 1 if cap * n_padded <= self.BATCH_SCAN_BUDGET else live

    def _scan(self, gens, seeks, totals, args, pos_bits: int,
              exact: bool) -> np.ndarray:
        """One tier's gather over every (generation, shard) with
        candidates: coded ``qid << pos_bits | gid`` values, exact hits on
        the full tier (``exact``: the float64 bbox+time mask over the
        sorted payload, a candidate matching only its own window's boxes
        and bounds), candidates on the keys tier.  Every gather is sized
        by its own total, so none truncates."""
        self.dispatch_count += self._scan_dispatches(totals)
        parts = []
        # no demote-and-retry here: the gathered candidates allgather, so
        # a process retrying alone would strand its peers.  A transient
        # failure (device memory pressure) is still recorded on the
        # breaker, then re-raised
        try:
            with device_span("query.scan.device",
                             tier="full" if exact else "keys",
                             runs=len(gens)):
                for i, gen in enumerate(gens):
                    for s in range(self.mesh.size):
                        tot = int(totals[self._shard0 + s, i])
                        if not tot:
                            continue
                        a = args[s]
                        starts, counts = seeks[i][s]
                        idx, valid, rid = expand_ranges(
                            starts, counts, gather_capacity(tot, minimum=8))
                        cqid = a["rqid"][rid]
                        ok = valid
                        if exact:
                            xc, yc = gen.x[s][idx], gen.y[s][idx]
                            tc = gen.t[s][idx]
                            in_box = (_in_boxes(xc, yc, a["boxes"])
                                      & (cqid[:, None]
                                         == a["bqid"][None, :])).any(dim=1)
                            ok = (valid & in_box & (tc >= a["qtlo"][cqid])
                                  & (tc <= a["qthi"][cqid]))
                        coded = (cqid << pos_bits) | gen.pos[s][idx]
                        parts.append(coded[ok].cpu().numpy())
        except Exception as e:  # noqa: BLE001 — classify, then re-raise
            if classify_device_failure(e) == "transient":
                for gen in gens:
                    breaker.record_failure((id(self), gen.gen_id))
            raise
        return (np.concatenate(parts) if parts
                else np.empty(0, np.int64))

    def _host_stack_of(self, host_gens: list) -> HostStack:
        """Every spilled run stacked into one HostStack (cached until the
        next spill or merge)."""
        if self._host_stack is None:
            self._host_stack = HostStack(
                [r for g in host_gens for r in g.runs])
        return self._host_stack

    # -- query path -------------------------------------------------------
    def query(self, boxes, t_lo_ms, t_hi_ms,
              max_ranges: int = DEFAULT_MAX_RANGES) -> np.ndarray:
        """Exact sorted row positions for one bbox(es)+time window."""
        return self.query_many([(boxes, t_lo_ms, t_hi_ms)],
                               max_ranges=max_ranges)[0]

    def query_many(self, windows,
                   max_ranges: int = DEFAULT_MAX_RANGES) -> list[np.ndarray]:
        """Batched multi-window scan over every shard × generation: one
        totals probe, one scan per populated device tier and the stacked
        numpy seeks over spilled runs.  Full-tier hits are exact on the
        device; keys/host candidates get the host exact mask.  Returns
        one sorted position array per window (global gids under
        multihost, the same on every process)."""
        n_q = len(windows)
        if n_q == 0 or self._n_total == 0:
            return [np.empty(0, dtype=np.int64) for _ in range(n_q)]
        rbin, rzlo, rzhi, rqid = [], [], [], []
        w_boxes: list = []
        qtlo = np.empty(n_q, dtype=np.int64)
        qthi = np.empty(n_q, dtype=np.int64)
        with obs_span("query.decompose", windows=n_q) as dsp:
            for q, (bxs, lo, hi) in enumerate(windows):
                # a per-process raise BETWEEN collective phases (the
                # planner's precedent); the PARTIAL break is
                # single-controller only: a process breaking on its own
                # clock would plan fewer ranges than its peers and strand
                # them in the next collective
                if not self._multihost and check_cancel("query.decompose"):
                    break
                lo, hi = self._clamp_time(lo, hi)
                qtlo[q], qthi[q] = lo, hi
                bxs = np.atleast_2d(np.asarray(bxs, dtype=np.float64))
                w_boxes.append(bxs)
                # per-BIN range budget (see index/z3_lean.query_many)
                budget = min(max_ranges * _bins_spanned(lo, hi,
                                                        self.period),
                             _MAX_RANGES_PER_WINDOW)
                plan = plan_z3_query(bxs, lo, hi, self.period, budget,
                                     sfc=self.sfc)
                if plan.num_ranges == 0:
                    continue
                rbin.append(plan.rbin)
                rzlo.append(plan.rzlo)
                rzhi.append(plan.rzhi)
                rqid.append(np.full(plan.num_ranges, q, dtype=np.int32))
            dsp.set_attr("ranges", int(sum(len(r) for r in rbin)))
        if not rbin:
            return [np.empty(0, dtype=np.int64) for _ in range(n_q)]
        ra = pad_ranges(
            {"rbin": np.concatenate(rbin), "rzlo": np.concatenate(rzlo),
             "rzhi": np.concatenate(rzhi), "rqid": np.concatenate(rqid)},
            pad_pow2(sum(len(r) for r in rbin)))
        span = multihost_gid_span() if self._multihost else self._n_total
        pos_bits = max(1, int(np.ceil(np.log2(max(2, span)))))
        full_gens = [g for g in self.generations if g.tier == "full"]
        keys_gens = [g for g in self.generations if g.tier == "keys"]
        host_gens = [g for g in self.generations if g.tier == "host"]
        boxes_c = np.concatenate(w_boxes)
        bqid_c = np.concatenate([np.full(len(b), q, dtype=np.int64)
                                 for q, b in enumerate(w_boxes)])
        args = self._uploads(
            rbin=ra["rbin"], rzlo=ra["rzlo"], rzhi=ra["rzhi"],
            rqid=ra["rqid"].astype(np.int64), boxes=boxes_c, bqid=bqid_c,
            qtlo=qtlo, qthi=qthi)
        nf = len(full_gens)
        seeks, totals = self._probe(full_gens + keys_gens, args)
        # replan probe point: the device totals are known BEFORE any
        # gather, so an abort here discards only the seeks (they are
        # global, so the signal is agreed under multihost)
        dev_total = int(totals.sum())
        check_replan("query.scan.probe", dev_total)
        exact = np.empty(0, np.int64)
        cand: list = []

        def yield_point(point: str) -> bool:
            # deadline yield points between tier phases: single-controller
            # only (a lone process skipping a collective tier dispatch
            # would strand its peers)
            return (not self._multihost) and check_cancel(point)

        if (full_gens and not yield_point("query.scan.full")
                and int(totals[:, :nf].sum())):
            exact = self._scan(full_gens, seeks[:nf], totals[:, :nf], args,
                               pos_bits, exact=True)
        if (keys_gens and not yield_point("query.scan.keys")
                and int(totals[:, nf:].sum())):
            cand.append(self._scan(keys_gens, seeks[nf:], totals[:, nf:],
                                   args, pos_bits, exact=False))
        host_cand_n = 0
        if host_gens and not yield_point("query.scan.host"):
            with obs_span("query.scan.host", stage="seek",
                          runs=len(host_gens)):
                got = self._host_stack_of(host_gens).candidates(
                    ra["rbin"], ra["rzlo"], ra["rzhi"], ra["rqid"],
                    pos_bits)
            host_cand_n = len(got)
            if host_cand_n:
                # second probe point, as on one device: host candidates
                # count before the payload re-check (process-local
                # counts: no probe under multihost)
                if not self._multihost:
                    check_replan("query.scan.probe", dev_total + host_cand_n)
                cand.append(got)
        if heat_enabled():
            # process-local, never a collective: device generations
            # attribute candidates exactly through the probe's per-shard
            # totals; host candidates split by consumed slots
            touches = [(g.gen_id, g.tier, int(g.n_slots), g.device_bytes(),
                        int(totals[:, i].sum()))
                       for i, g in enumerate(full_gens + keys_gens)]
            n_host = sum(g.n_slots for g in host_gens)
            touches += [(g.gen_id, "host", int(g.n_slots),
                         g.host_key_bytes(),
                         int(round(host_cand_n * g.n_slots / n_host)))
                        for g in host_gens]
            record_index_scan(self, touches)
        mask_bits = (np.int64(1) << pos_bits) - 1
        flat = np.concatenate(cand) if cand else np.empty(0, np.int64)
        with obs_span("query.scan.host", stage="recheck",
                      candidates=int(len(flat))):
            if len(flat):
                # the host exact mask on the payload (the client-side re-check
                # of keys/host-tier candidates, all of this process's rows)
                x, yv, t = self._payload_flat()
                qids = flat >> pos_bits
                rows = flat & mask_bits & ((np.int64(1) << GID_PROC_SHIFT) - 1)
                cx, cy, ct = x[rows], yv[rows], t[rows]
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
                flat = flat[keep]
        hits = np.concatenate([exact, flat])
        if self._multihost:
            hits = allgather_concat(hits)
        # overlapping covering ranges can repeat a row: split_coded drops
        # the repeats of each window's sorted run
        return split_coded(np.sort(hits), pos_bits, n_q)

    # -- aggregation push-down --------------------------------------------
    def density(self, boxes, t_lo_ms, t_hi_ms, env,
                width: int = 256, height: int = 256,
                max_ranges: int = DEFAULT_MAX_RANGES,
                _gens: list | None = None,
                _record_heat: bool = True) -> np.ndarray:
        """DensityScan push-down over the mesh: per-shard grids summed —
        the full tier masks exactly on its sorted payload, the keys tier
        decodes cell-granular coordinates from the z key, host-tier runs
        contribute numpy partials (the cell-inclusive contract of
        index/z3_lean.LeanZ3Index.density).

        Whole-world whole-time square requests at a cached pyramid
        resolution serve sealed generations from their density pyramids
        and scan only the live generation and any pyramid-less ones —
        exact, since each level is the generation's own grid at that
        width.  ``_gens`` restricts the scan and ``_record_heat=False``
        leaves its heat unrecorded (the pyramid build's and the fast
        path's hooks).  Under multihost the local partial grid
        all-reduces over the processes; pyramid levels are already
        global."""
        grid = np.zeros((height, width), np.float64)
        if self._n_total == 0:
            return grid
        lo, hi = self._clamp_time(t_lo_ms, t_hi_ms)
        bxs = np.atleast_2d(np.asarray(boxes, dtype=np.float64))
        env_t = tuple(float(v) for v in env)
        pyr_ok = (
            _gens is None and width == height
            and len(self.generations) > 1
            and env_t == _PYRAMID_WORLD
            and lo == self.t_min_ms and hi == self.t_max_ms
            and bool(np.any((bxs[:, 0] <= -180.0) & (bxs[:, 1] <= -90.0)
                            & (bxs[:, 2] >= 180.0) & (bxs[:, 3] >= 90.0))))
        if pyr_ok:
            rest: list = []
            served: set = set()
            for g in self.generations[:-1]:
                lvl = self._pyramid_level(g.gen_id, width)
                if lvl is not None:
                    self.pyramid_serve_hits += 1
                    obs_count(PYRAMID_SERVE_HITS)
                    grid += lvl
                    served.add(id(g))
                else:
                    rest.append(g)
            if served:
                rest.append(self.generations[-1])
                grid += self.density(boxes, t_lo_ms, t_hi_ms, env, width,
                                     height, max_ranges, _gens=rest,
                                     _record_heat=False)
                if heat_enabled():
                    # pyramid-served generations read zero bytes
                    record_index_scan(self, [
                        (g.gen_id, g.tier, int(g.n_slots),
                         0 if id(g) in served else self._gen_bytes(g), None)
                        for g in self.generations])
                return grid
        budget = min(max_ranges * _bins_spanned(lo, hi, self.period),
                     _MAX_RANGES_PER_WINDOW)
        plan = plan_z3_query(bxs, lo, hi, self.period, budget, sfc=self.sfc)
        if plan.num_ranges == 0:
            return grid
        ra = pad_ranges(
            {"rbin": plan.rbin, "rzlo": plan.rzlo, "rzhi": plan.rzhi},
            pad_pow2(plan.num_ranges))
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
        gens = self.generations if _gens is None else _gens
        full_gens = [g for g in gens if g.tier == "full"]
        keys_gens = [g for g in gens if g.tier == "keys"]
        host_gens = [g for g in gens if g.tier == "host"]
        args = self._uploads(rbin=ra["rbin"], rzlo=ra["rzlo"],
                             rzhi=ra["rzhi"], boxes=bxs, ixy=ixy)
        seeks, totals = self._probe(full_gens + keys_gens, args)
        nf = len(full_gens)
        if full_gens and int(totals[:, :nf].sum()):
            self.dispatch_count += 1
            with device_span("query.scan.device", tier="full",
                             runs=len(full_gens)):
                grid += self._density_tier(full_gens, seeks[:nf],
                                           totals[:, :nf], args, width,
                                           height, env_t, full=(lo, hi))
        if keys_gens and int(totals[:, nf:].sum()):
            self.dispatch_count += 1
            with device_span("query.scan.device", tier="keys",
                             runs=len(keys_gens)):
                grid += self._density_tier(keys_gens, seeks[nf:],
                                           totals[:, nf:], args, width,
                                           height, env_t, keys=tb)
        if host_gens:
            if _gens is None:
                stack = self._host_stack_of(host_gens)
            else:
                # a restricted scan stacks copies: the cached stack owns
                # the spilled runs' columns and must keep them
                stack = HostStack([HostRun(r.bins_column(), r.z, r.pos)
                                   for g in host_gens for r in g.runs])
            grid += stack.density_partials(
                ra["rbin"], ra["rzlo"], ra["rzhi"], self.sfc, ixy, tb,
                env_t, width, height).sum(axis=0)
        if self._multihost:
            t = torch.from_numpy(grid).to(self.mesh[0])
            grid = allreduce_tensor(t).cpu().numpy()
        if _record_heat and heat_enabled() and self.generations:
            # density reads every generation; its matches are grids, not
            # rows, so every touch is a full-weight access
            record_index_scan(self, [
                (g.gen_id, g.tier, int(g.n_slots), self._gen_bytes(g), None)
                for g in self.generations])
        return grid

    @staticmethod
    def _gen_bytes(g) -> int:
        """The bytes a scan of ``g`` reads: its device bytes, or its
        spilled runs' keys on the host tier."""
        return g.device_bytes() if g.tier != "host" else g.host_key_bytes()

    def _density_tier(self, gens, seeks, totals, args, width: int,
                      height: int, env, full=None, keys=None) -> np.ndarray:
        """One device tier's grid, summed over its (generation, shard)
        pairs with candidates.  ``full=(lo, hi)``: the value-exact mask on
        the sorted payload, binned through the z-cell midpoint
        (normalize → denormalize); ``keys=tb``: cell-granular masks
        decoded from the z key."""
        lon, lat = self.sfc.lon, self.sfc.lat
        acc = {}
        for i, gen in enumerate(gens):
            for s, dev in enumerate(self.mesh):
                tot = int(totals[self._shard0 + s, i])
                if not tot:
                    continue
                a = args[s]
                starts, counts = seeks[i][s]
                idx, valid, _rid = expand_ranges(
                    starts, counts, gather_capacity(tot, minimum=8))
                if full is not None:
                    xc, yc, tc = gen.x[s][idx], gen.y[s][idx], gen.t[s][idx]
                    ok = (valid & _in_boxes(xc, yc, a["boxes"]).any(dim=1)
                          & (tc >= full[0]) & (tc <= full[1]))
                    xd = lon.denormalize(lon.normalize(xc))
                    yd = lat.denormalize(lat.normalize(yc))
                else:
                    b_lo, c_lo, b_hi, c_hi = (int(v) for v in keys)
                    bc = gen.bins[s][idx].to(torch.int64)
                    ix, iy, it = deinterleave3(gen.z[s][idx])
                    in_box = _in_boxes(ix, iy, a["ixy"]).any(dim=1)
                    after = (bc > b_lo) | ((bc == b_lo) & (it >= c_lo))
                    before = (bc < b_hi) | ((bc == b_hi) & (it <= c_hi))
                    ok = valid & in_box & after & before
                    xd, yd = lon.denormalize(ix), lat.denormalize(iy)
                gx, gy = _grid_cells(xd, yd, env, width, height)
                part = _grid_count(gx, gy, ok, width, height)
                acc[dev] = part if dev not in acc else acc[dev] + part
        out = np.zeros(width * height, np.float64)
        for part in acc.values():
            out += part.cpu().numpy()
        return out.reshape(height, width)

    def range_count(self, boxes, t_lo_ms, t_hi_ms,
                    max_ranges: int = DEFAULT_MAX_RANGES) -> int:
        """Masked hit count with no candidate materialization (exact on
        full tiers and whole-extent scans; cell-inclusive otherwise)."""
        return int(round(self.density(
            boxes, t_lo_ms, t_hi_ms, _PYRAMID_WORLD, 1, 1,
            max_ranges=max_ranges).sum()))

    def z3_cell_counts(self, bits: int) -> dict:
        """WHOLE-EXTENT Z3Histogram push-down: ``{(bin, cell): count}``
        (see :meth:`z3_cell_table`)."""
        b0, total = self.z3_cell_table(bits)
        nz = np.flatnonzero(total)
        c_per_bin = 1 << bits
        return dict(zip(zip((b0 + nz // c_per_bin).tolist(),
                            (nz % c_per_bin).tolist()),
                        total[nz].tolist()))

    def z3_cell_table(self, bits: int) -> tuple[int, np.ndarray]:
        """The cell counts as a dense int64 table ``(b0, counts)`` over the
        data's bin span: each shard folds its own sorted runs' coarse
        ``(bin, cell)`` keys, the folds sum, spilled runs fold on the
        host.  Sealed generations' tables cache by gen_id; warm repeats
        fold only the live generation.  Under multihost every fold
        all-reduces, so every process caches the same global tables."""
        if self._n_total == 0 or self.t_min_ms is None:
            return 0, np.zeros(0, np.int64)
        b0, _ = to_binned_time(np.int64(max(0, self.t_min_ms)), self.period)
        b1, _ = to_binned_time(np.int64(max(0, self.t_max_ms)), self.period)
        b0, nb = int(b0), int(b1) - int(b0) + 1
        cache = self._sketch_cache.spec_cache(("z3cells", int(bits), b0, nb))
        live = self.generations[-1] if self.generations else None
        total = np.zeros(nb << bits, np.int64)
        fold: list = []
        for g in self.generations:
            part = cache.get(g.gen_id) if g is not live else None
            if part is not None:
                obs_count(LEAN_SKETCH_CACHE_HITS)
                total += part
            else:
                fold.append(g)
        dev_fold = [g for g in fold if g.tier != "host"]
        parts = np.zeros((len(fold), nb << bits), np.int64)
        if dev_fold:
            self.dispatch_count += 1
            with device_span("query.scan.device", stage="z3_cells",
                             runs=len(dev_fold)):
                for i, g in enumerate(fold):
                    if g.tier == "host":
                        continue
                    for s in range(self.mesh.size):
                        k = int(g.fill[s])
                        parts[i] += _z3_cells(g.bins[s][:k], g.z[s][:k], b0,
                                              nb, int(bits)).cpu().numpy()
        for i, g in enumerate(fold):
            if g.tier == "host":
                for run in g.runs:
                    parts[i] += run.cell_counts(b0, nb, int(bits))
        if self._multihost and fold:
            from .stats import allreduce_counts
            parts = allreduce_counts(parts.reshape(-1)).reshape(parts.shape)
        for g, part in zip(fold, parts):
            total += part
            if g is not live:
                obs_count(LEAN_SKETCH_CACHE_MISSES)
                self._sketch_cache.add(cache, g.gen_id, np.array(part))
        if heat_enabled() and self.generations:
            scanned = {id(g) for g in fold}
            record_index_scan(self, [
                (g.gen_id, g.tier, int(g.n_slots),
                 self._gen_bytes(g) if id(g) in scanned else 0, None)
                for g in self.generations])
        return b0, total

    # -- density pyramids -------------------------------------------------
    def build_pyramids(self, base: int | None = None,
                       levels: int | None = None) -> int:
        """Build whole-world density pyramids for the sealed generations
        that lack one: each base grid is ONE single-generation density
        push-down over the world, reduced on the host through the exact
        2×2 ladder.  Returns the number of pyramids built."""
        base = int(base if base is not None
                   else DensityProperties.PYRAMID_BASE.to_int())
        if base < 1 or base & (base - 1):
            raise ValueError(
                f"pyramid base must be a power of two, got {base}")
        levels = int(levels if levels is not None
                     else DensityProperties.PYRAMID_LEVELS.to_int())
        cache = self._pyramid_cache.spec_cache(pyramid_spec(base))
        built = 0
        for g in list(self.generations[:-1]):
            if g.gen_id in cache:
                continue
            fault_point("pyramid.build")
            t0 = time.perf_counter()
            with obs_span("pyramid.build", gen_id=g.gen_id, tier=g.tier,
                          base=base, sharded=True):
                part = self.density([_PYRAMID_WORLD], None, None,
                                    _PYRAMID_WORLD, base, base, _gens=[g],
                                    _record_heat=False)
            self._pyramid_cache.add(cache, g.gen_id,
                                    DensityPyramid.from_base(part, levels))
            obs_count(PYRAMID_BUILDS)
            _metrics.timer(PYRAMID_BUILD_MS).update(
                (time.perf_counter() - t0) * 1e3)
            built += 1
        return built

    def density_tile(self, z: int, x: int, y: int, tile: int = 256,
                     max_ranges: int = DEFAULT_MAX_RANGES) -> np.ndarray:
        """One (tile, tile) slippy-tile density grid — see
        :func:`geomesa_tpu_torch.index.pyramid.density_tile`."""
        from ..index.pyramid import density_tile as _density_tile
        return _density_tile(self, z, x, y, tile, max_ranges)

    def _inherit_pyramids(self, dead_ids: list, new_gen_id: int) -> None:
        """Compaction inheritance: when every parent has a pyramid under a
        spec, the merged generation's is their elementwise sum (density
        is additive over generations)."""
        for _spec, cache in self._pyramid_cache.items():
            parents = [cache.get(gid) for gid in dead_ids]
            if all(p is not None for p in parents):
                merged = DensityPyramid.sum(parents)
                if merged is not None:
                    self._pyramid_cache.add(cache, new_gen_id, merged)

    def _pyramid_level(self, gen_id: int, width: int):
        """The (width, width) pyramid grid of a sealed generation, or
        None when no cached pyramid carries that resolution."""
        for _spec, cache in self._pyramid_cache.items():
            pyr = cache.get(gen_id)
            if pyr is not None:
                lvl = pyr.level(width)
                if lvl is not None:
                    return lvl
        return None
