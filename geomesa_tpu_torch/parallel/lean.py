"""ShardedLeanZ3Index: the tiered lean generational z3 index over a mesh.

The port of the JAX package's ``parallel/lean.py``.  The reference's scan
plans fan out over tablet servers (AccumuloQueryPlan.scala:87-157); here
every generation's sorted key run is split over the mesh's devices — one
``(slots,)`` column per shard — and each program runs per shard: every
device seeks its own sorted runs, and the per-shard partials (candidate
totals, density grids, cell counts) sum on the host, the port's ``psum``.
One process drives every device, so the JAX package's multi-controller
agreement and allgathers do not arise.

Positions are global row ids (the gids of a single-controller JAX mesh),
minted on the host at append time and carried as an int64 sort payload.

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
each program is plain PyTorch per shard.  Spans, heat tracking,
cancellation points and the ``pyramid.build`` fault point are not ported.
"""

from __future__ import annotations

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
from ..planning.adaptive import check_replan
from .mesh import DeviceMesh
from .scan import _PerDevice

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
        if multihost:
            raise NotImplementedError(
                "multi-controller (multihost) lean indexes are not ported "
                "(ROADMAP A7)")
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
        #: host payload provider: () -> (x, y, t) of every row (the
        #: store's columns); without one the appended slices are kept
        self.payload_provider = None
        self._payload: list = []
        self._flat = None
        self._n_total = 0
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

    # -- accounting -------------------------------------------------------
    def device_bytes(self) -> int:
        """Device bytes of every generation over every shard."""
        return sum(g.device_bytes() for g in self.generations)

    def host_key_bytes(self) -> int:
        """Host RAM held in spilled per-shard runs."""
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
        through several generations."""
        x = np.ascontiguousarray(x, dtype=np.float64)
        y = np.ascontiguousarray(y, dtype=np.float64)
        dtg_ms = np.ascontiguousarray(dtg_ms, dtype=np.int64)
        m = len(x)
        if m == 0:
            return self
        if self.payload_provider is None:
            self._payload.append((x, y, dtg_ms))
            self._flat = None
        n_shards = self.mesh.size
        per = -(-m // n_shards)
        m_pad = min(gather_capacity(per, minimum=8), self.generation_slots)
        host_bins, host_offs = to_binned_time(dtg_ms, self.period)
        host_bins = host_bins.astype(np.int32)
        host_offs = host_offs.astype(np.float64)
        done = 0
        while done < m:
            gen = self.generations[-1] if self.generations else None
            if gen is None or gen.tier == "host" \
                    or gen.n_slots + m_pad > gen.slots:
                sealed = (gen.gen_id if gen is not None
                          and gen.tier != "host" else None)
                gen = self._new_generation()
                if sealed is not None:
                    notify_generation_event(self, "seal", [sealed])
            take_all = min(m_pad * n_shards, m - done)
            for s in range(n_shards):
                lo, hi = done + s * m_pad, done + min(take_all,
                                                      (s + 1) * m_pad)
                if hi <= lo:
                    break
                sl = slice(lo, hi)
                self._append_shard(
                    gen, s, x[sl], y[sl], host_offs[sl], host_bins[sl],
                    self._n_total + np.arange(lo, hi, dtype=np.int64),
                    dtg_ms[sl])
            self.dispatch_count += 1
            gen.n_slots += m_pad
            done += m_pad * n_shards
        self._n_total += m
        t_min, t_max = int(dtg_ms.min()), int(dtg_ms.max())
        self.t_min_ms = (t_min if self.t_min_ms is None
                         else min(self.t_min_ms, t_min))
        self.t_max_ms = (t_max if self.t_max_ms is None
                         else max(self.t_max_ms, t_max))
        if self.compaction_factor:
            # bounded opportunistic trigger: one merge group per append
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
        # the merged run's pyramid is the SUM of its parents', taken
        # before the parents' entries drop
        self._inherit_pyramids(dead_ids, merged.gen_id)
        self._pyramid_cache.drop_generations(dead_ids)
        self.generations = replace_group(self.generations, group, merged)
        self.compactions += 1
        notify_generation_event(self, "merge", [merged.gen_id])

    def compact(self, budget_ms: float | None = None,
                factor: int | None = None,
                max_groups: int | None = None) -> dict:
        """Incremental size-tiered merge compaction over the sharded runs
        (see index/z3_lean.LeanZ3Index.compact).  Returns
        ``{"merged_groups", "generations", "tiers"}``."""
        f = int(factor or self.compaction_factor or self.COMPACTION_FACTOR)
        merged = compact_incremental(
            lambda: self._compaction_groups(f), self._merge_group,
            budget_ms=budget_ms, max_groups=max_groups)
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
        """(x, y, t) for the given row positions: one vectorized take from
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
        candidate totals, one device→host copy per device."""
        if not gens:
            return [], np.zeros((self.mesh.size, 0), np.int64)
        seeks = [[_seek(g.bins[s], g.z[s], args[s])
                  for s in range(self.mesh.size)] for g in gens]
        sums = [torch.stack([seeks[i][s][1].sum() for i in range(len(gens))])
                for s in range(self.mesh.size)]
        self.dispatch_count += 1
        return seeks, np.stack([t.cpu().numpy() for t in sums])

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
        for i, gen in enumerate(gens):
            for s in range(self.mesh.size):
                tot = int(totals[s, i])
                if not tot:
                    continue
                a = args[s]
                starts, counts = seeks[i][s]
                idx, valid, rid = expand_ranges(
                    starts, counts, gather_capacity(tot, minimum=8))
                cqid = a["rqid"][rid]
                ok = valid
                if exact:
                    xc, yc, tc = gen.x[s][idx], gen.y[s][idx], gen.t[s][idx]
                    in_box = (_in_boxes(xc, yc, a["boxes"])
                              & (cqid[:, None] == a["bqid"][None, :])
                              ).any(dim=1)
                    ok = (valid & in_box & (tc >= a["qtlo"][cqid])
                          & (tc <= a["qthi"][cqid]))
                coded = (cqid << pos_bits) | gen.pos[s][idx]
                parts.append(coded[ok].cpu().numpy())
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
        one sorted position array per window."""
        n_q = len(windows)
        if n_q == 0 or self._n_total == 0:
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
            # per-BIN range budget (see index/z3_lean.query_many)
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
        pos_bits = max(1, int(np.ceil(np.log2(max(2, self._n_total)))))
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
        # gather, so an abort here discards only the seeks
        dev_total = int(totals.sum())
        check_replan("query.scan.probe", dev_total)
        exact = np.empty(0, np.int64)
        cand: list = []
        if full_gens and int(totals[:, :nf].sum()):
            exact = self._scan(full_gens, seeks[:nf], totals[:, :nf], args,
                               pos_bits, exact=True)
        if keys_gens and int(totals[:, nf:].sum()):
            cand.append(self._scan(keys_gens, seeks[nf:], totals[:, nf:],
                                   args, pos_bits, exact=False))
        if host_gens:
            got = self._host_stack_of(host_gens).candidates(
                ra["rbin"], ra["rzlo"], ra["rzhi"], ra["rqid"], pos_bits)
            if len(got):
                # second probe point, as on one device: host candidates
                # count before the payload re-check
                check_replan("query.scan.probe", dev_total + len(got))
                cand.append(got)
        mask_bits = (np.int64(1) << pos_bits) - 1
        flat = np.concatenate(cand) if cand else np.empty(0, np.int64)
        if len(flat):
            # the host exact mask on the payload (the client-side re-check
            # of keys/host-tier candidates)
            x, yv, t = self._payload_flat()
            qids = flat >> pos_bits
            rows = flat & mask_bits
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
        # overlapping covering ranges can repeat a row: split_coded drops
        # the repeats of each window's sorted run
        merged = np.sort(np.concatenate([exact, flat]))
        return split_coded(merged, pos_bits, n_q)

    # -- aggregation push-down --------------------------------------------
    def density(self, boxes, t_lo_ms, t_hi_ms, env,
                width: int = 256, height: int = 256,
                max_ranges: int = DEFAULT_MAX_RANGES,
                _gens: list | None = None) -> np.ndarray:
        """DensityScan push-down over the mesh: per-shard grids summed —
        the full tier masks exactly on its sorted payload, the keys tier
        decodes cell-granular coordinates from the z key, host-tier runs
        contribute numpy partials (the cell-inclusive contract of
        index/z3_lean.LeanZ3Index.density).

        Whole-world whole-time square requests at a cached pyramid
        resolution serve sealed generations from their density pyramids
        and scan only the live generation and any pyramid-less ones —
        exact, since each level is the generation's own grid at that
        width.  ``_gens`` restricts the scan (the pyramid builder's and
        the fast path's hook)."""
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
            served = 0
            for g in self.generations[:-1]:
                lvl = self._pyramid_level(g.gen_id, width)
                if lvl is not None:
                    self.pyramid_serve_hits += 1
                    grid += lvl
                    served += 1
                else:
                    rest.append(g)
            if served:
                rest.append(self.generations[-1])
                return grid + self.density(boxes, t_lo_ms, t_hi_ms, env,
                                           width, height, max_ranges,
                                           _gens=rest)
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
            grid += self._density_tier(full_gens, seeks[:nf],
                                       totals[:, :nf], args, width, height,
                                       env_t, full=(lo, hi))
        if keys_gens and int(totals[:, nf:].sum()):
            self.dispatch_count += 1
            grid += self._density_tier(keys_gens, seeks[nf:],
                                       totals[:, nf:], args, width, height,
                                       env_t, keys=tb)
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
        return grid

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
                tot = int(totals[s, i])
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
        fold only the live generation."""
        if self._n_total == 0 or self.t_min_ms is None:
            return 0, np.zeros(0, np.int64)
        b0, _ = to_binned_time(np.int64(max(0, self.t_min_ms)), self.period)
        b1, _ = to_binned_time(np.int64(max(0, self.t_max_ms)), self.period)
        b0, nb = int(b0), int(b1) - int(b0) + 1
        cache = self._sketch_cache.spec_cache(("z3cells", int(bits), b0, nb))
        live = self.generations[-1] if self.generations else None
        total = np.zeros(nb << bits, np.int64)
        scan: list = []
        for g in self.generations:
            part = cache.get(g.gen_id) if g is not live else None
            if part is not None:
                total += part
            elif g.tier == "host":
                part = np.zeros(nb << bits, np.int64)
                for run in g.runs:
                    part += run.cell_counts(b0, nb, int(bits))
                self._sketch_cache.add(cache, g.gen_id, part)
                total += part
            else:
                scan.append(g)
        if scan:
            self.dispatch_count += 1
            for g in scan:
                part = np.zeros(nb << bits, np.int64)
                for s in range(self.mesh.size):
                    k = int(g.fill[s])
                    part += _z3_cells(g.bins[s][:k], g.z[s][:k], b0, nb,
                                      int(bits)).cpu().numpy()
                total += part
                if g is not live:
                    self._sketch_cache.add(cache, g.gen_id, part)
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
            part = self.density([_PYRAMID_WORLD], None, None,
                                _PYRAMID_WORLD, base, base, _gens=[g])
            self._pyramid_cache.add(cache, g.gen_id,
                                    DensityPyramid.from_base(part, levels))
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
