"""ShardedLeanAttrIndex: the lean attribute tier over a device mesh, and
the lean XZ2/XZ3 indexes on it.

The port of the JAX package's ``parallel/attr_lean.py``: the single-device
:class:`~geomesa_tpu_torch.index.attr_lean.LeanAttrIndex` composed with
the mesh, the way :class:`~geomesa_tpu_torch.parallel.lean.
ShardedLeanZ3Index` composes the z3 tier.  Every generation's ``(key
int64, sec int64, gid int64)`` columns are split over the mesh's devices
— one ``(slots,)`` column per shard — and each program runs per shard:
every device seeks its own sorted runs, and the per-shard partials sum on
the host (the port's ``psum``).  Gids are global row ids.  Query results
are CANDIDATE gids; the planner's residual filter makes them exact.

Residency: ``device`` ↔ ``host`` under a PER-SHARD budget, demoted
oldest-first; spilled runs seek through the stacked composite bisection
of the single-device index, flat in run count.

**Parity with the JAX index.**  Appends block-split their rows over the
shards as the JAX index does and track each shard's fill: a step writes
each shard's slice right after that shard's valid rows, and the consumed
slot count grows by the rows the busiest shard gained, never by the
padded step size (the JAX index's fix of an older slot burn).  The budget
charges the JAX package's sentinel padding generation, which the port,
running eager PyTorch, never allocates.  ``dispatch_count`` counts the
JAX index's programs: one per append step, one totals probe and its
gather groups per query, one per device merge and one per device sketch
fold.  Runs sort by ``(key, sec, gid)``.

The lean XZ indexes over a mesh (:class:`ShardedLeanXZ2Index`,
:class:`ShardedLeanXZ3Index`) are the single-device facades over this
sharded core.

Not ported (each is absent): spans, heat tracking, the breaker's
failure classification and the multi-controller agreements.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.attr_lean import (
    _HostAttrStack, _I64_MAX, _I64_MIN, _SENTINEL_KEY, LeanAttrIndex,
    _lexsort_keys, encode_attr_value, encode_attr_values,
    merge_spilled_parts, string_prefix_bounds,
)
from ..index.lsm import (
    compact_incremental, merged_capacity, notify_generation_event,
    plan_size_tiered, replace_group,
)
from ..index.partial_cache import PartialCache
from ..index.xz2_lean import LeanXZ3Index, XZ2Facade
from ..ops.search import (
    expand_ranges, gather_capacity, pad_pow2, searchsorted2,
)
from ..planning.adaptive import check_replan
from .lean import lexsort
from .mesh import DeviceMesh
from .scan import _PerDevice

__all__ = ["ShardedLeanAttrIndex", "ShardedLeanXZ2Index",
           "ShardedLeanXZ3Index"]

#: the JAX package's generation-count compile bucket (see
#: ShardedLeanAttrIndex._gather_dispatches)
_GEN_BUCKET = 4


def _sentinel_cols(slots: int, device) -> list:
    return [torch.full((slots,), int(_SENTINEL_KEY), dtype=torch.int64,
                       device=device),
            torch.full((slots,), int(_I64_MAX), dtype=torch.int64,
                       device=device),
            torch.full((slots,), -1, dtype=torch.int64, device=device)]


class _ShardedAttrGen:
    """One generation: a sorted ``(key, sec, gid)`` run per shard (lists
    with one ``(slots,)`` tensor per shard, ``fill[s]`` valid rows at the
    front).  ``spilled`` holds a host run's per-shard mutable ``[k, s,
    g]`` lists."""

    __slots__ = ("keys", "sec", "gid", "n_slots", "tier", "spilled",
                 "fill", "gen_id")

    def __init__(self, mesh: DeviceMesh, slots: int):
        cols = [_sentinel_cols(slots, d) for d in mesh]
        self.keys, self.sec, self.gid = ([c[i] for c in cols]
                                         for i in range(3))
        #: the consumed-slot bound: no shard's fill exceeds it
        self.n_slots = 0
        self.tier = "device"
        self.spilled: list | None = None
        #: valid rows per shard (each shard's next write offset)
        self.fill = np.zeros(mesh.size, np.int64)
        self.gen_id = -1

    @classmethod
    def merged_device(cls, keys, sec, gid, fill,
                      n_slots: int) -> "_ShardedAttrGen":
        """A compacted device generation from merged per-shard columns."""
        gen = cls.__new__(cls)
        gen.keys, gen.sec, gen.gid = keys, sec, gid
        gen.n_slots = int(n_slots)
        gen.tier = "device"
        gen.spilled = None
        gen.fill = np.asarray(fill, np.int64)
        gen.gen_id = -1
        return gen

    @classmethod
    def merged_host(cls, parts: list, n_slots: int) -> "_ShardedAttrGen":
        """A compacted host generation from merged spilled parts."""
        gen = cls.__new__(cls)
        gen.keys = gen.sec = gen.gid = None
        gen.n_slots = int(n_slots)
        gen.tier = "host"
        gen.spilled = parts
        gen.fill = np.array([len(p[0]) for p in parts], np.int64)
        gen.gen_id = -1
        return gen

    @property
    def slots(self) -> int:
        return 0 if self.tier == "host" else int(self.keys[0].shape[0])

    @property
    def n(self) -> int:
        """Valid rows over every shard."""
        return int(self.fill.sum())

    def per_shard_bytes(self) -> int:
        return 0 if self.tier == "host" else self.slots * (8 + 8 + 8)

    def spill_to_host(self) -> None:
        """device → host: fetch every shard's sorted run and free the
        device memory."""
        if self.tier != "device":
            return
        # mutable lists: the host stack re-points them at views so one
        # copy survives
        self.spilled = [[k[:n].cpu().numpy(), s[:n].cpu().numpy(),
                         g[:n].cpu().numpy()]
                        for k, s, g, n in zip(self.keys, self.sec, self.gid,
                                              self.fill.tolist())]
        self.keys = self.sec = self.gid = None
        self.tier = "host"


class ShardedLeanAttrIndex:
    """Sharded tiered generational attribute index (module doc)."""

    @staticmethod
    def gather_payload(positions):
        """Sharded attribute runs key lexicodes, not a row-addressable
        payload: ``None`` routes result materialization to the host
        column store."""
        return None

    #: slots per generation PER SHARD
    GENERATION_SLOTS = 1 << 22
    DEFAULT_CAPACITY = 1 << 15
    BATCH_SCAN_BUDGET = 1 << 26
    #: default PER-SHARD budget: the JAX package's, kept only so that tier
    #: decisions equal the reference's (the store splits its lean budget)
    HBM_BUDGET_BYTES = int(2.0 * 2 ** 30)
    #: size-tiered compaction trigger (see index/attr_lean)
    COMPACTION_FACTOR = 4
    #: per-slot device bytes (keys int64 + sec int64 + gid int64 — the
    #: sharded gid column is int64, unlike the single-device int32)
    SLOT_BYTES = 8 + 8 + 8

    def __init__(self, attr: str, attr_type: str, mesh: DeviceMesh,
                 generation_slots: int | None = None,
                 multihost: bool = False,
                 hbm_budget_bytes: int | None = None,
                 compaction_factor: int | None = None):
        if multihost:
            raise NotImplementedError(
                "multi-controller (multihost) lean indexes are not ported "
                "(ROADMAP A7)")
        self.attr = attr
        self.attr_type = attr_type.lower()
        self.mesh = mesh
        self.generation_slots = generation_slots or self.GENERATION_SLOTS
        self.hbm_budget_bytes = hbm_budget_bytes or self.HBM_BUDGET_BYTES
        self.generations: list[_ShardedAttrGen] = []
        self._host_stack: _HostAttrStack | None = None
        self._n_total = 0
        self.dispatch_count = 0
        #: opportunistic compaction factor (0 = off)
        self.compaction_factor = int(compaction_factor or 0)
        self.compactions = 0
        #: sealed-run sketch partials: fold spec → {gen_id: RunSketch}
        self._sketch_cache = PartialCache(
            LeanAttrIndex.SKETCH_CACHE_SPECS,
            LeanAttrIndex.SKETCH_CACHE_MAX_BYTES)
        #: generation-lifecycle hooks ``(kind, gen_ids)`` fired on
        #: seal/merge (index/lsm.notify_generation_event)
        self.generation_listeners: list = []
        self._gen_counter = 0

    def _next_gen_id(self) -> int:
        self._gen_counter += 1
        return self._gen_counter

    def __len__(self) -> int:
        return self._n_total

    def tier_counts(self) -> dict:
        out = {"device": 0, "host": 0}
        for g in self.generations:
            out[g.tier] += 1
        return out

    def device_bytes(self) -> int:
        """Device bytes of every shard's device generations."""
        return sum(g.per_shard_bytes() * self.mesh.size
                   for g in self.generations)

    def host_key_bytes(self) -> int:
        """Host RAM held in spilled (key, sec, gid) runs."""
        return sum(len(p[0]) * self.SLOT_BYTES
                   for g in self.generations if g.spilled
                   for p in g.spilled)

    def sentinel_bytes(self) -> int:
        """Device bytes of sentinel padding: none, the port pads nothing
        (the budget still charges the JAX package's)."""
        return 0

    def storage_stats(self) -> dict:
        """Where this index's bytes sit, per generation."""
        gens = [{"gen_id": g.gen_id, "tier": g.tier,
                 "slots": int(g.n_slots), "capacity": g.slots,
                 "device_bytes": g.per_shard_bytes() * self.mesh.size,
                 "host_bytes": (sum(len(p[0]) * self.SLOT_BYTES
                                    for p in g.spilled)
                                if g.spilled else 0)}
                for g in self.generations]
        return {"kind": type(self).__name__, "rows": len(self),
                "attr": self.attr, "tiers": self.tier_counts(),
                "device_bytes": self.device_bytes(),
                "host_bytes": self.host_key_bytes(),
                "sentinel_bytes": self.sentinel_bytes(),
                "hbm_budget_bytes": self.hbm_budget_bytes,
                "generations": gens,
                "caches": {"sketch": self._sketch_cache.stats()},
                "dispatches": self.dispatch_count}

    def block(self) -> None:
        """Wait for the cards' queued work (appends are asynchronous)."""
        for d in dict.fromkeys(self.mesh):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    # -- write path -------------------------------------------------------
    def _per_shard_resident(self) -> int:
        per = sum(g.per_shard_bytes() for g in self.generations)
        return per + self.generation_slots * self.SLOT_BYTES  # sentinel

    def _rebalance(self) -> None:
        """Spill oldest-first until each shard's residency fits the budget;
        the ACTIVE generation never spills (appends sort there)."""
        for gen in self.generations[:-1]:
            if self._per_shard_resident() <= self.hbm_budget_bytes:
                return
            if gen.tier == "device":
                gen.spill_to_host()
                self._host_stack = None
        if self._per_shard_resident() > self.hbm_budget_bytes:
            raise MemoryError(
                f"active attr generation ({self.generation_slots} "
                f"slots/shard) exceeds hbm_budget_bytes="
                f"{self.hbm_budget_bytes}")

    def _roll_generation(self) -> _ShardedAttrGen:
        gen = _ShardedAttrGen(self.mesh, self.generation_slots)
        gen.gen_id = self._next_gen_id()
        self.generations.append(gen)
        self._rebalance()
        return self.generations[-1]

    def _append_shard(self, gen: _ShardedAttrGen, s: int, keys, sec,
                      gids) -> None:
        """Write one shard's slice right after its valid rows and re-sort
        the valid prefix (new gids exceed every resident one, so the
        stable two-key sort keeps the run (key, sec, gid) sorted)."""
        dev = self.mesh[s]
        r, k = int(gen.fill[s]), len(keys)
        w = slice(r, r + k)
        for col, a in ((gen.keys, keys), (gen.sec, sec), (gen.gid, gids)):
            # a copy where the slice is read-only (columns reloaded from a
            # catalog are)
            col[s][w] = torch.from_numpy(
                np.require(a, requirements="CW")).to(dev)
        end = r + k
        perm = _lexsort_keys(gen.keys[s][:end], gen.sec[s][:end])
        for c in (gen.keys, gen.sec, gen.gid):
            c[s][:end] = c[s][:end][perm]
        gen.fill[s] = end

    def append(self, values, dtg_ms,
               base_gid: int | None = None) -> "ShardedLeanAttrIndex":
        """Encode keys on the host, block-split them over the shards and
        merge each slice into its shard's unused region (rolling the
        generation when the next step would not fit).  ``base_gid``
        defaults to the running row count (the lean store's implicit
        ids)."""
        keys = np.ascontiguousarray(encode_attr_values(values,
                                                       self.attr_type))
        sec = np.ascontiguousarray(dtg_ms, np.int64)
        m = len(keys)
        if m == 0:
            return self
        n_shards = self.mesh.size
        per = -(-m // n_shards)
        m_pad = min(gather_capacity(per, minimum=8), self.generation_slots)
        base = self._n_total if base_gid is None else int(base_gid)
        done = 0
        while done < m:
            gen = self.generations[-1] if self.generations else None
            if gen is None or gen.tier == "host" \
                    or gen.n_slots + m_pad > gen.slots:
                sealed = (gen.gen_id if gen is not None
                          and gen.tier != "host" else None)
                gen = self._roll_generation()
                if sealed is not None:
                    notify_generation_event(self, "seal", [sealed])
            take_all = min(m_pad * n_shards, m - done)
            for s in range(n_shards):
                lo, hi = done + s * m_pad, done + min(take_all,
                                                      (s + 1) * m_pad)
                if hi <= lo:
                    break
                self._append_shard(
                    gen, s, keys[lo:hi], sec[lo:hi],
                    base + np.arange(lo, hi, dtype=np.int64))
            self.dispatch_count += 1
            # the busiest shard gained at most min(m_pad, rows left) valid
            # rows this step — NOT m_pad unconditionally
            gen.n_slots += int(min(m_pad, m - done))
            done += m_pad * n_shards
        self._n_total += m
        if self.compaction_factor:
            # bounded opportunistic trigger: one merge group per append
            self.compact(factor=self.compaction_factor, max_groups=1)
        return self

    # -- compaction (LSM maintenance) -------------------------------------
    def _compaction_groups(self, factor: int) -> list[list]:
        """Size-tiered merge plan over SEALED generations, bucketed by
        consumed slot count (the JAX index's plan)."""
        return plan_size_tiered(self.generations[:-1], ("device", "host"),
                                lambda g: g.n_slots, factor)

    def _merge_group(self, group: list) -> None:
        n_slots = int(sum(g.n_slots for g in group))
        if group[0].tier == "device":
            out_slots = merged_capacity(
                n_slots, sum(g.slots for g in group), gather_capacity)
            keys, sec, gid = [], [], []
            fill = np.zeros(self.mesh.size, np.int64)
            for s, dev in enumerate(self.mesh):
                k = [int(g.fill[s]) for g in group]
                ck = torch.cat([g.keys[s][:n] for g, n in zip(group, k)])
                cs = torch.cat([g.sec[s][:n] for g, n in zip(group, k)])
                cg = torch.cat([g.gid[s][:n] for g, n in zip(group, k)])
                perm = lexsort(ck, cs, cg)
                sk, ss, sg = _sentinel_cols(out_slots, dev)
                f = fill[s] = len(perm)
                sk[:f], ss[:f], sg[:f] = ck[perm], cs[perm], cg[perm]
                keys.append(sk)
                sec.append(ss)
                gid.append(sg)
            self.dispatch_count += 1
            merged = _ShardedAttrGen.merged_device(keys, sec, gid, fill,
                                                   n_slots=n_slots)
        else:
            merged = _ShardedAttrGen.merged_host(
                [merge_spilled_parts(
                    [p for g in group for p in g.spilled])],
                n_slots=n_slots)
            self._host_stack = None
        merged.gen_id = self._next_gen_id()
        # stale sketch partials must never double-count
        self._sketch_cache.drop_generations([g.gen_id for g in group])
        self.generations = replace_group(self.generations, group, merged)
        self.compactions += 1
        notify_generation_event(self, "merge", [merged.gen_id])

    def compact(self, budget_ms: float | None = None,
                factor: int | None = None,
                max_groups: int | None = None) -> dict:
        """Incremental size-tiered merge compaction of the sharded
        attribute runs (see LeanAttrIndex.compact)."""
        f = int(factor or self.compaction_factor or self.COMPACTION_FACTOR)
        merged = compact_incremental(
            lambda: self._compaction_groups(f), self._merge_group,
            budget_ms=budget_ms, max_groups=max_groups)
        if merged:
            self._rebalance()
        return {"merged_groups": merged,
                "generations": len(self.generations),
                "tiers": self.tier_counts()}

    # -- stat-sketch push-down --------------------------------------------
    def sketch_scan(self, fold):
        """Fold every run's rows matching ``fold``'s sec window into ONE
        merged RunSketch over the whole mesh — the sharded twin of
        :meth:`~geomesa_tpu_torch.index.attr_lean.LeanAttrIndex.
        sketch_scan`: device runs fold per shard (hist/count-min tables
        and moments summed over the shards, min/max reduced), host runs
        fold in one stacked numpy pass; sealed runs' partials cache by
        gen_id."""
        from ..parallel.stats import HIST_KERNEL_MAX_SLOTS
        from ..stats.sketch import RunSketch, device_fold_body, fold_attr_runs
        merged = RunSketch()
        if not self.generations:
            return merged
        live = self.generations[-1]
        cache = self._sketch_cache.spec_cache(fold)
        dev_scan: list = []
        host_scan: list = []
        for g in self.generations:
            part = cache.get(g.gen_id) if g is not live else None
            if part is not None:
                merged = merged + part
            elif g.tier == "device":
                dev_scan.append(g)
            else:
                host_scan.append(g)
        is_float = self.attr_type in ("float", "double")
        new_parts: dict[int, object] = {}
        if dev_scan and not fold.want_values:
            self.dispatch_count += 1
            for g in dev_scan:
                part = RunSketch()
                outs = [device_fold_body(
                    g.keys[s][:n], g.sec[s][:n], int(fold.slo),
                    int(fold.shi), float(fold.hlo), float(fold.hhi),
                    bins=int(fold.bins), depth=int(fold.depth),
                    width=int(fold.width), is_float=is_float,
                    hist_kernel=g.slots < HIST_KERNEL_MAX_SLOTS)
                    for s, n in enumerate(g.fill.tolist())]
                for o in outs:
                    n = int(o[0])
                    part = part + RunSketch(
                        n, int(o[1]) if n else None,
                        int(o[2]) if n else None,
                        float(o[3]), float(o[4]),
                        o[5].cpu().numpy() if fold.bins else None,
                        o[6].cpu().numpy() if fold.depth else None)
                new_parts[id(g)] = part
        elif dev_scan:
            # exact value→count folds are dict-valued: a host fold over
            # the fetched sorted runs of every shard
            for g in dev_scan:
                runs = [(k[:n].cpu().numpy(), s[:n].cpu().numpy())
                        for k, s, n in zip(g.keys, g.sec, g.fill.tolist())]
                part = RunSketch()
                for p in fold_attr_runs(runs, fold, self.attr_type):
                    part = part + p
                new_parts[id(g)] = part
        for g in host_scan:
            part = RunSketch()
            for p in fold_attr_runs([(p[0], p[1]) for p in g.spilled],
                                    fold, self.attr_type):
                part = part + p
            new_parts[id(g)] = part
        for g in dev_scan + host_scan:
            p = new_parts[id(g)]
            merged = merged + p
            if g is not live:
                self._sketch_cache.add(cache, g.gen_id, p)
        return merged

    # -- query path -------------------------------------------------------
    def _gather_dispatches(self, totals: np.ndarray) -> int:
        """Gather programs the JAX index dispatches for ``(n_shards,
        n_gens)`` probe totals: one over every (bucket-padded) device
        generation when the shared-capacity buffer fits
        ``BATCH_SCAN_BUDGET``, else one per generation with
        candidates."""
        cap = gather_capacity(int(totals.max()), minimum=self.DEFAULT_CAPACITY)
        n = totals.shape[1]
        if cap * (n + (-n) % _GEN_BUCKET) <= self.BATCH_SCAN_BUDGET:
            return 1
        return int((totals.max(axis=0) > 0).sum())

    def query_ranges(self, ranges: list, n_windows: int = 1,
                     total_rows: int | None = None) -> np.ndarray:
        """Candidate gids for inclusive composite ranges ``(klo, khi, slo,
        shi, qid)``: coded ``qid << pos_bits | gid`` when ``n_windows >
        1``, else sorted unique gids."""
        if not ranges or self._n_total == 0:
            return np.empty(0, np.int64)
        n_pad = pad_pow2(len(ranges))
        qklo = np.full(n_pad, 1, np.int64)    # never-matching padding
        qkhi = np.full(n_pad, 0, np.int64)
        qslo = np.full(n_pad, 1, np.int64)
        qshi = np.full(n_pad, 0, np.int64)
        qqid = np.zeros(n_pad, np.int32)
        for i, (klo, khi, slo, shi, qid) in enumerate(ranges):
            qklo[i] = klo
            qkhi[i] = khi
            qslo[i] = _I64_MIN if slo is None else slo
            qshi[i] = _I64_MAX if shi is None else shi
            qqid[i] = qid
        pos_bits = max(1, int(np.ceil(np.log2(max(2, self._n_total)))))
        dev_gens = [g for g in self.generations if g.tier == "device"]
        host_gens = [g for g in self.generations if g.tier == "host"]
        parts: list = []
        dev_total = 0
        if dev_gens:
            per = _PerDevice(klo=qklo, khi=qkhi, slo=qslo, shi=qshi,
                             qid=qqid.astype(np.int64))
            args = [per.on(d) for d in self.mesh]
            seeks = []
            for g in dev_gens:
                row = []
                for s, a in enumerate(args):
                    k, sc = g.keys[s], g.sec[s]
                    starts = searchsorted2(k, sc, a["klo"], a["slo"],
                                           side="left")
                    ends = searchsorted2(k, sc, a["khi"], a["shi"],
                                         side="right")
                    row.append((starts, torch.clamp(ends - starts, min=0)))
                seeks.append(row)
            self.dispatch_count += 1
            totals = np.stack([
                torch.stack([seeks[i][s][1].sum()
                             for i in range(len(dev_gens))]).cpu().numpy()
                for s in range(self.mesh.size)])
            # adaptive-replan probe point: device totals are known BEFORE
            # any gather, so aborting here discards nothing
            dev_total = int(totals.sum())
            check_replan("query.scan.probe", dev_total)
            if dev_total:
                self.dispatch_count += self._gather_dispatches(totals)
                coded = []
                for i, g in enumerate(dev_gens):
                    for s, a in enumerate(args):
                        t = int(totals[s, i])
                        if not t:
                            continue
                        starts, counts = seeks[i][s]
                        idx, valid, rid = expand_ranges(
                            starts, counts, gather_capacity(t, minimum=8))
                        c = (a["qid"][rid] << pos_bits) | g.gid[s][idx]
                        coded.append(c[valid].cpu().numpy())
                parts.append(np.concatenate(coded))
        if host_gens:
            if self._host_stack is None:
                self._host_stack = _HostAttrStack(
                    [p for g in host_gens for p in g.spilled])
            coded = self._host_stack.candidates(qklo, qkhi, qslo, qshi,
                                                qqid, pos_bits)
            if len(coded):
                # second probe point, as on one device: host candidates
                # count before any row is materialized
                check_replan("query.scan.probe", dev_total + len(coded))
                parts.append(coded)
        if not parts:
            return np.empty(0, np.int64)
        merged = np.concatenate(parts)
        if n_windows > 1:
            return merged
        return np.unique(merged & ((np.int64(1) << pos_bits) - 1))

    # -- planner-facing surface (mirrors index/attr_lean.LeanAttrIndex) --
    #: date-tier marker: equality/IN narrow by a dtg window
    secondary = True
    #: no z3 secondary on the lean attribute index (date tier only)
    sec_z = None

    @staticmethod
    def _sec(sec_window):
        return (None, None) if sec_window is None else sec_window

    def query_equals(self, value, sec_window=None,
                     z3_ranges=None) -> np.ndarray:
        k = encode_attr_value(value, self.attr_type)
        slo, shi = self._sec(sec_window)
        return self.query_ranges([(k, k, slo, shi, 0)])

    def query_in(self, values, sec_window=None,
                 z3_ranges=None) -> np.ndarray:
        if not len(values):
            return np.empty(0, np.int64)
        slo, shi = self._sec(sec_window)
        return self.query_ranges(
            [(encode_attr_value(v, self.attr_type),
              encode_attr_value(v, self.attr_type), slo, shi, 0)
             for v in values])

    def query_range(self, lo=None, hi=None, lo_inclusive=True,
                    hi_inclusive=True) -> np.ndarray:
        """Candidate gids for a value range (bounds conservatively
        inclusive at the key level; the residual filter applies the exact
        operator)."""
        klo = (_I64_MIN if lo is None
               else encode_attr_value(lo, self.attr_type))
        khi = (_SENTINEL_KEY - 1 if hi is None
               else encode_attr_value(hi, self.attr_type))
        return self.query_ranges([(klo, khi, None, None, 0)])

    def query_prefix(self, prefix: str) -> np.ndarray:
        if self.attr_type != "string":
            raise TypeError("prefix queries require a string attribute")
        klo, khi = string_prefix_bounds(prefix)
        return self.query_ranges([(klo, khi, None, None, 0)])


class ShardedLeanXZ2Index(XZ2Facade):
    """The lean XZ2 index over a mesh: the XZ2 sequence code rides the
    sharded ``(key, sec, gid)`` machinery (key = code, sec unused) — the
    shared :class:`~geomesa_tpu_torch.index.xz2_lean.XZ2Facade` over a
    :class:`ShardedLeanAttrIndex` core."""

    def __init__(self, mesh: DeviceMesh, g: int = 12,
                 multihost: bool = False,
                 generation_slots: int | None = None,
                 hbm_budget_bytes: int | None = None,
                 compaction_factor: int | None = None):
        super().__init__(ShardedLeanAttrIndex(
            "__xz2__", "long", mesh=mesh, multihost=multihost,
            generation_slots=generation_slots,
            hbm_budget_bytes=hbm_budget_bytes,
            compaction_factor=compaction_factor), g=g)


class ShardedLeanXZ3Index(LeanXZ3Index):
    """The lean XZ3 index over a mesh: ``(bin, code)`` keys on the
    sharded attribute core."""

    def __init__(self, period="week", mesh: DeviceMesh = None, g: int = 12,
                 multihost: bool = False,
                 generation_slots: int | None = None,
                 hbm_budget_bytes: int | None = None,
                 compaction_factor: int | None = None):
        super().__init__(period=period, g=g,
                         core=ShardedLeanAttrIndex(
                             "__xz3__", "long", mesh=mesh,
                             multihost=multihost,
                             generation_slots=generation_slots,
                             hbm_budget_bytes=hbm_budget_bytes,
                             compaction_factor=compaction_factor))
