"""LeanAttrIndex: tiered generational attribute index for lean schemas.

The port of the JAX package's ``index/attr_lean.py``.  The reference
serves attribute predicates from the lexicoded attribute index with
cost-based selection at any scale (geomesa-index-api/.../index/attribute/
AttributeIndexKey.scala:38-52, .../strategies/AttributeFilterStrategy.
scala); this module is that index in the lean profile's terms.

**Key layout.**  Sorted GENERATIONS (LSM runs, the
:class:`~geomesa_tpu_torch.index.z3_lean.LeanZ3Index` shape) of

    ``(key int64, sec int64, gid int32)``  — 20 B/row

where ``key`` is an ORDER-PRESERVING int64 encoding of the attribute
value (the lexicode analog of ``AttributeIndexKey.typeRegistry``):

* ints/longs/dates — the value itself (exact);
* floats/doubles — the IEEE-754 order-preserving bit transform (exact;
  -0.0 encodes as +0.0 and NaN sorts last);
* strings — the first 8 UTF-8 bytes big-endian (a PREFIX code: ties
  share a key and the planner's residual filter disambiguates).

Keys are encoded on the host with numpy, exactly as the JAX package
encodes them.  ``sec`` is the epoch-millis dtg — the reference's date
secondary tier (``DateIndexKeySpace``): runs sort by ``(key, sec)``, so
an equality/IN lookup with a time window seeks the sub-range directly
with the two-key :func:`~geomesa_tpu_torch.ops.search.searchsorted2`.
Range and prefix scans pass an open ``sec`` window.

**Tiers.**  ``device`` generations hold the three columns on the card
(demoted oldest-first under ``hbm_budget_bytes``); ``host`` generations
spill to RAM and seek through one stacked vectorized bisection, flat in
run count.  There is no ``full`` tier: the encoded key IS the payload.
The tier decisions are the JAX package's, slot for slot: the budget
charges the sentinel padding columns the JAX index allocates for its
compile buckets, although the port, running eager PyTorch, pads nothing
and allocates none.

**Programs.**  The JAX package runs the totals probe, the candidate
gather, the compaction merge and the sketch fold as one jitted dispatch
over every device generation; here each is a loop of plain PyTorch
operations over the generations (no Pallas kernel sits on this path in
the JAX package, so none does here).  ``dispatch_count`` counts what the
JAX index would dispatch for the same calls: one per append step, one
totals probe and one gather per group per query, one per device merge
and one per device sketch fold.

**Replanning.**  :meth:`LeanAttrIndex.query_ranges` reports its
candidate counts to an ambient replan scope (planning/adaptive.py) after
the device probe and after the host-tier seek, before any gather.

Not ported from the JAX index (each is absent): degraded execution on
device failure (a device error propagates), cancellation points, fault
injection, heat attribution, spans and metrics.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.search import (
    coded_pos_bits, expand_ranges, gather_capacity, pad_pow2,
    searchsorted2,
)
from ..planning.adaptive import check_replan
from .lsm import (
    compact_incremental, merged_capacity, notify_generation_event,
    plan_size_tiered, replace_group,
)
from .partial_cache import PartialCache

__all__ = ["LeanAttrIndex", "encode_attr_values", "encode_attr_value",
           "string_prefix_bounds", "merge_spilled_parts", "NUMERIC_TYPES"]

_SENTINEL_KEY = np.int64(np.iinfo(np.int64).max)
_I64_MIN = np.int64(np.iinfo(np.int64).min)
_I64_MAX = np.int64(np.iinfo(np.int64).max)

#: per-slot bytes: key int64 + sec int64 + gid int32
SLOT_BYTES = 8 + 8 + 4

#: the JAX package's generation-count compile bucket: its multi-generation
#: programs pad the device generations to a multiple of this with a
#: sentinel generation, which decides how its gathers group
_GEN_BUCKET = 4

#: attribute types served by the int64 lexicode (AttributeIndexKey's
#: typeRegistry analog); geometry/bytes/json are not indexable
NUMERIC_TYPES = frozenset({"int", "integer", "long", "float", "double",
                           "date"})


def _encode_float64(vals: np.ndarray) -> np.ndarray:
    """IEEE-754 double → order-preserving signed int64 (NaNs sort last)."""
    v = np.ascontiguousarray(vals, np.float64) + 0.0   # -0.0 → +0.0
    bits = v.view(np.int64)
    # negative floats (sign bit set) map reversed into [-2^63, -1];
    # positives keep their bits — order-preserving in the signed view
    return np.where(bits < 0, np.int64(-1) - (bits ^ _I64_MIN), bits)


def _encode_strings(vals: np.ndarray) -> np.ndarray:
    """First 8 UTF-8 bytes, big-endian, as signed int64 — a prefix code
    (lexicographic byte order is unsigned integer order; XOR 2^63 makes
    it signed-comparable).  ``None`` encodes as the EMPTY key on both
    paths: the ASCII ``astype('S8')`` path would stringify it to
    ``b'None'`` while the unicode fallback yields ``b''``."""
    arr = np.asarray(vals)
    if arr.dtype.kind == "U" and arr.dtype.itemsize:
        # a fixed-width unicode column holds UCS-4 code points: when all
        # are ASCII they ARE the UTF-8 bytes, so the key packs them
        # directly (the lean store keeps such columns fixed-width)
        cp = np.ascontiguousarray(arr).view(np.uint32).reshape(
            len(arr), arr.dtype.itemsize // 4)
        if not cp.size or int(cp.max()) < 128:
            u = np.zeros(len(arr), np.uint64)
            for i in range(min(cp.shape[1], 8)):
                u |= cp[:, i].astype(np.uint64) << np.uint64(8 * (7 - i))
            return (u ^ np.uint64(1 << 63)).view(np.int64)
    if arr.dtype == object:
        none_mask = arr == np.array(None)
        if none_mask.any():
            arr = arr.copy()
            arr[none_mask] = ""
    try:
        raw = arr.astype("S8")           # ASCII fast path (truncating)
    except UnicodeEncodeError:
        raw = np.array([("" if v is None else str(v)).encode("utf-8")[:8]
                        for v in arr], dtype="S8")
    u = np.ascontiguousarray(raw).view(">u8").astype(np.uint64).ravel()
    return (u ^ np.uint64(1 << 63)).view(np.int64)


def encode_attr_values(vals: np.ndarray, attr_type: str) -> np.ndarray:
    """Vectorized order-preserving int64 encoding of one column.

    Keys clamp to ``int64 max - 1``: the sentinel padding key is int64
    max, and a real key equal to it would let open-ended range seeks
    sweep every generation's padding into the candidate buffer.  The
    clamp aliases only the two topmost encodable values — a candidate
    superset the residual filter resolves, like string prefix ties."""
    t = attr_type.lower()
    if t in ("int", "integer", "long", "date"):
        keys = np.ascontiguousarray(vals, np.int64)
    elif t in ("float", "double"):
        keys = _encode_float64(np.asarray(vals, np.float64))
    elif t == "string":
        keys = _encode_strings(vals)
    else:
        raise TypeError(f"attribute type {attr_type!r} is not indexable "
                        "on a lean schema (indexable: numerics, dates, "
                        "strings)")
    return np.minimum(keys, _SENTINEL_KEY - 1)


def encode_attr_value(v, attr_type: str) -> np.int64:
    """Scalar twin of :func:`encode_attr_values` (query planning)."""
    return np.int64(encode_attr_values(np.array([v]), attr_type)[0])


def string_prefix_bounds(prefix: str) -> tuple[np.int64, np.int64]:
    """Inclusive key bounds covering every string starting with
    ``prefix`` (for LIKE 'abc%': [code(prefix·00…), code(prefix·ff…)])."""
    b = prefix.encode("utf-8")[:8]
    lo = int.from_bytes(b.ljust(8, b"\x00"), "big")
    hi = int.from_bytes(b.ljust(8, b"\xff"), "big")
    u = np.array([lo, hi], dtype=np.uint64) ^ np.uint64(1 << 63)
    s = u.view(np.int64)
    return np.int64(s[0]), np.int64(min(s[1], _SENTINEL_KEY - 1))


def _lexsort_keys(keys, sec):
    """Permutation sorting ``(keys, sec)`` lexicographically: two stable
    sorts.  Ties on equal ``(key, sec)`` keep their incoming order (the
    JAX sort leaves them unspecified; no result depends on it)."""
    perm = torch.sort(sec, stable=True).indices
    return perm[torch.sort(keys[perm], stable=True).indices]


def merge_spilled_parts(parts: list[list]) -> list:
    """Compaction merge of spilled (key, sec, gid) runs: one composite
    lexsort over the concatenation.  Returns a fresh mutable part list
    (the :class:`_HostAttrStack` re-pointing contract)."""
    k = np.concatenate([np.asarray(p[0]) for p in parts])
    s = np.concatenate([np.asarray(p[1]) for p in parts])
    g = np.concatenate([np.asarray(p[2]) for p in parts])
    order = np.lexsort((s, k))
    return [np.ascontiguousarray(k[order]), np.ascontiguousarray(s[order]),
            np.ascontiguousarray(g[order])]


def _bisect2(k: np.ndarray, s: np.ndarray, qk: np.ndarray, qs: np.ndarray,
             lo: np.ndarray, hi: np.ndarray, side: str) -> np.ndarray:
    """Vectorized composite-key binary search of ``(qk, qs)[i]`` within
    the (key, sec)-sorted segments ``[lo[i], hi[i])`` — the host twin of
    :func:`~geomesa_tpu_torch.ops.search.searchsorted2`, one bisection
    pass for every (range × run) pair."""
    lo = lo.astype(np.int64).copy()
    hi = hi.astype(np.int64).copy()
    while True:
        active = lo < hi
        if not active.any():
            return lo
        mid = (lo + hi) >> 1
        safe = np.where(active, mid, 0)
        km, sm = k[safe], s[safe]
        if side == "left":
            below = (km < qk) | ((km == qk) & (sm < qs))
        else:
            below = (km < qk) | ((km == qk) & (sm <= qs))
        lo = np.where(active & below, mid + 1, lo)
        hi = np.where(active & ~below, mid, hi)


class _HostAttrStack:
    """Spilled (key, sec, gid) runs stacked contiguously: each run is one
    segment, and one composite bisection pass per query batch serves
    every host generation.  The stack OWNS the concatenated arrays — each
    constituent part (a mutable ``[k, s, g]`` list) is re-pointed at views
    into them, so host RAM holds one copy of the spilled runs."""

    __slots__ = ("k", "s", "gid", "seg_lo", "seg_hi")

    def __init__(self, parts: list[list]):
        lens = [len(p[0]) for p in parts]
        self.k = (np.concatenate([p[0] for p in parts]) if parts
                  else np.empty(0, np.int64))
        self.s = (np.concatenate([p[1] for p in parts]) if parts
                  else np.empty(0, np.int64))
        self.gid = (np.concatenate([p[2] for p in parts]) if parts
                    else np.empty(0, np.int64))
        ends = np.cumsum(lens, dtype=np.int64)
        self.seg_lo = ends - np.asarray(lens, np.int64)
        self.seg_hi = ends
        for part, lo, hi in zip(parts, self.seg_lo, self.seg_hi):
            part[0] = self.k[lo:hi]
            part[1] = self.s[lo:hi]
            part[2] = self.gid[lo:hi]

    def candidates(self, qklo, qkhi, qslo, qshi, qqid,
                   pos_bits: int) -> np.ndarray:
        if not len(self.k) or not len(qklo):
            return np.empty(0, np.int64)
        n_seg = len(self.seg_lo)
        n_q = len(qklo)
        # every (range × run) pair — runs are few (spilled generations)
        rid = np.repeat(np.arange(n_q), n_seg)
        seg = np.tile(np.arange(n_seg), n_q)
        lo0, hi0 = self.seg_lo[seg], self.seg_hi[seg]
        starts = _bisect2(self.k, self.s, qklo[rid], qslo[rid], lo0, hi0,
                          side="left")
        ends = _bisect2(self.k, self.s, qkhi[rid], qshi[rid], lo0, hi0,
                        side="right")
        cnt = np.maximum(ends - starts, 0)
        cum = np.cumsum(cnt)
        total = int(cum[-1]) if len(cum) else 0
        if total == 0:
            return np.empty(0, np.int64)
        j = np.arange(total)
        pid = np.searchsorted(cum, j, side="right")
        prev = np.where(pid > 0, cum[pid - 1], 0)
        idx = starts[pid] + (j - prev)
        return ((qqid[rid[pid]].astype(np.int64) << pos_bits)
                | self.gid[idx].astype(np.int64))


class _AttrGeneration:
    """One sorted (key, sec, gid) run.  ``tier`` ∈ {"device", "host"};
    device columns span the run's capacity, sentinel-filled past ``n``
    valid rows; ``spilled`` is a host run's mutable ``[k, s, g]`` list;
    ``gen_id`` is a store-lifetime-unique identity that compaction mints
    afresh (the sketch-cache invalidation key)."""

    __slots__ = ("keys", "sec", "gid", "n", "tier", "spilled", "gen_id")

    def __init__(self, capacity: int, device):
        self.keys = torch.full((capacity,), int(_SENTINEL_KEY),
                               dtype=torch.int64, device=device)
        self.sec = torch.full((capacity,), int(_I64_MAX), dtype=torch.int64,
                              device=device)
        self.gid = torch.full((capacity,), -1, dtype=torch.int32,
                              device=device)
        self.n = 0
        self.tier = "device"
        self.spilled: list | None = None
        self.gen_id = -1

    @classmethod
    def merged_device(cls, keys, sec, gid, n: int) -> "_AttrGeneration":
        """A compacted device run from already-merged columns."""
        gen = cls.__new__(cls)
        gen.keys, gen.sec, gen.gid = keys, sec, gid
        gen.n = int(n)
        gen.tier = "device"
        gen.spilled = None
        gen.gen_id = -1
        return gen

    @classmethod
    def merged_host(cls, part: list) -> "_AttrGeneration":
        """A compacted host run from an already-merged spilled part."""
        gen = cls.__new__(cls)
        gen.keys = gen.sec = gen.gid = None
        gen.n = len(part[0])
        gen.tier = "host"
        gen.spilled = part
        gen.gen_id = -1
        return gen

    @property
    def capacity(self) -> int:
        return int(self.keys.shape[0])

    def device_bytes(self) -> int:
        return 0 if self.tier == "host" else self.capacity * SLOT_BYTES

    def spill_to_host(self) -> None:
        if self.tier != "device":
            return
        n = self.n
        # a mutable list: _HostAttrStack re-points it at views of the
        # stacked buffers so only one host copy survives
        self.spilled = [self.keys[:n].cpu().numpy(),
                        self.sec[:n].cpu().numpy(),
                        self.gid[:n].cpu().numpy()]
        self.keys = self.sec = self.gid = None
        self.tier = "host"


class LeanAttrIndex:
    """Tiered generational attribute index (see module doc).

    Queries take inclusive int64 key ranges with optional per-range sec
    windows; results are CANDIDATE gids (the planner's residual filter
    makes them exact, as for every index here)."""

    GENERATION_SLOTS = 1 << 24
    DEFAULT_CAPACITY = 1 << 15
    BATCH_SCAN_BUDGET = 1 << 26
    #: default device-memory budget: the JAX package's, kept so that tier
    #: decisions equal the reference's for the same inputs (the store
    #: splits its lean budget between the z3 index and the attribute
    #: indexes)
    HBM_BUDGET_BYTES = int(2.0 * 2 ** 30)
    #: size-tiered compaction trigger for explicit compact() calls
    COMPACTION_FACTOR = 4
    #: distinct sketch-fold specs whose per-sealed-run partials are
    #: retained (LRU), and the host-RAM ceiling across them (a partial is
    #: a few scalars plus small histogram and count-min tables)
    SKETCH_CACHE_SPECS = 8
    SKETCH_CACHE_MAX_BYTES = 64 * 2 ** 20

    def __init__(self, attr: str, attr_type: str,
                 generation_slots: int | None = None,
                 hbm_budget_bytes: int | None = None,
                 compaction_factor: int | None = None, device=None):
        """``device``: where the device tier lives — the CUDA card unless
        the caller names the CPU (with no card and no ``"cpu"`` this
        raises)."""
        self.attr = attr
        self.attr_type = attr_type.lower()
        if self.attr_type not in NUMERIC_TYPES | {"string"}:
            raise TypeError(f"attribute {attr!r}: type {attr_type!r} is "
                            "not indexable on a lean schema")
        self.device = resolve_device(device)
        self.generation_slots = generation_slots or self.GENERATION_SLOTS
        self.hbm_budget_bytes = hbm_budget_bytes or self.HBM_BUDGET_BYTES
        self.generations: list[_AttrGeneration] = []
        self._host_stack: _HostAttrStack | None = None
        self._n_rows = 0
        self.dispatch_count = 0
        #: opportunistic compaction factor (0 = off)
        self.compaction_factor = int(compaction_factor or 0)
        self.compactions = 0
        #: sealed-run sketch partials: fold spec → {gen_id: RunSketch}
        self._sketch_cache = PartialCache(self.SKETCH_CACHE_SPECS,
                                          self.SKETCH_CACHE_MAX_BYTES)
        #: generation-lifecycle hooks ``(kind, gen_ids)`` fired on
        #: seal/merge (lsm.notify_generation_event)
        self.generation_listeners: list = []
        self._gen_counter = 0

    def _next_gen_id(self) -> int:
        self._gen_counter += 1
        return self._gen_counter

    def __len__(self) -> int:
        return self._n_rows

    def device_bytes(self) -> int:
        return sum(g.device_bytes() for g in self.generations)

    def host_key_bytes(self) -> int:
        """Host RAM held by spilled runs — key + sec + gid per valid
        row."""
        return sum(g.n * SLOT_BYTES for g in self.generations
                   if g.tier == "host")

    def sentinel_bytes(self) -> int:
        """Device bytes of sentinel padding columns: none, since the port
        pads nothing (the budget still charges the JAX package's)."""
        return 0

    def tier_counts(self) -> dict:
        out = {"device": 0, "host": 0}
        for g in self.generations:
            out[g.tier] += 1
        return out

    def storage_stats(self) -> dict:
        """Where this index's bytes sit, per generation."""
        gens = [{"gen_id": g.gen_id, "tier": g.tier, "rows": int(g.n),
                 "capacity": 0 if g.tier == "host" else g.capacity,
                 "device_bytes": g.device_bytes(),
                 "host_bytes": g.n * SLOT_BYTES if g.tier == "host" else 0}
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
        """Wait for the card's queued work (appends are asynchronous)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- write path -------------------------------------------------------
    def _budget_after_sentinels(self) -> int:
        """The budget less the JAX package's sentinel padding columns (one
        generation's worth, module doc)."""
        return self.hbm_budget_bytes - self.generation_slots * SLOT_BYTES

    def _rebalance(self) -> None:
        """Spill oldest-first until the device residency fits the budget;
        the ACTIVE generation never spills (appends sort there)."""
        for gen in self.generations[:-1]:
            if self.device_bytes() <= self._budget_after_sentinels():
                return
            if gen.tier == "device":
                gen.spill_to_host()
                self._host_stack = None
        if self.device_bytes() > self._budget_after_sentinels():
            raise MemoryError(
                f"active attr generation ({self.generation_slots} slots) "
                f"exceeds hbm_budget_bytes={self.hbm_budget_bytes}")

    def _roll_generation(self) -> _AttrGeneration:
        gen = _AttrGeneration(self.generation_slots, self.device)
        gen.gen_id = self._next_gen_id()
        self.generations.append(gen)
        self._rebalance()
        return self.generations[-1]

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _append_step(self, gen: _AttrGeneration, keys, sec, gids,
                     take: int) -> None:
        """Write one encoded (padded) slice over the generation's sentinel
        slots at sorted offset ``gen.n`` and re-sort the occupied prefix
        (the sentinel tail stays sorted past it)."""
        r = gen.n
        m_pad = len(keys)
        valid = torch.arange(m_pad, device=self.device) < take
        w = slice(r, r + m_pad)
        gen.keys[w] = torch.where(valid, self._dev(keys),
                                  torch.full((m_pad,), int(_SENTINEL_KEY),
                                             dtype=torch.int64,
                                             device=self.device))
        gen.sec[w] = torch.where(valid, self._dev(sec),
                                 torch.full((m_pad,), int(_I64_MAX),
                                            dtype=torch.int64,
                                            device=self.device))
        gen.gid[w] = torch.where(valid, self._dev(gids),
                                 torch.full((m_pad,), -1, dtype=torch.int32,
                                            device=self.device))
        end = r + m_pad
        perm = _lexsort_keys(gen.keys[:end], gen.sec[:end])
        gen.keys[:end] = gen.keys[:end][perm]
        gen.sec[:end] = gen.sec[:end][perm]
        gen.gid[:end] = gen.gid[:end][perm]

    def append(self, values, dtg_ms, base_gid: int | None = None
               ) -> "LeanAttrIndex":
        """Stream one column slice in: encode keys on the host, merge them
        into the current generation (rolling on full).  ``base_gid``
        defaults to the running row count (the lean store's implicit
        ids)."""
        keys = encode_attr_values(values, self.attr_type)
        sec = np.ascontiguousarray(dtg_ms, np.int64)
        base = self._n_rows if base_gid is None else int(base_gid)
        if base + len(keys) > np.iinfo(np.int32).max:
            raise ValueError("LeanAttrIndex gids are int32: 2,147M rows "
                             "max per index")
        m_total = len(keys)
        done = 0
        while done < m_total:
            gen = self.generations[-1] if self.generations else None
            if gen is None or gen.tier == "host" or gen.n >= gen.capacity:
                sealed = (gen.gen_id if gen is not None
                          and gen.tier != "host" else None)
                gen = self._roll_generation()
                if sealed is not None:
                    notify_generation_event(self, "seal", [sealed])
            room = gen.capacity - gen.n
            take = min(room, m_total - done)
            m_pad = min(gather_capacity(take, minimum=8), room)
            pad = m_pad - take
            sl = slice(done, done + take)
            gids = (base + done + np.arange(take, dtype=np.int64)
                    ).astype(np.int32)
            self.dispatch_count += 1
            self._append_step(gen, np.pad(keys[sl], (0, pad)),
                              np.pad(sec[sl], (0, pad)),
                              np.pad(gids, (0, pad)), take)
            gen.n += take
            done += take
        self._n_rows += m_total
        if self.compaction_factor:
            # bounded opportunistic trigger: one merge group per append
            self.compact(factor=self.compaction_factor, max_groups=1)
        return self

    # -- compaction (LSM maintenance) -------------------------------------
    def _compaction_groups(self, factor: int) -> list[list]:
        return plan_size_tiered(self.generations[:-1], ("device", "host"),
                                lambda g: g.n, factor)

    def _merge_group(self, group: list) -> None:
        total = int(sum(g.n for g in group))
        if group[0].tier == "device":
            out_cap = merged_capacity(
                total, sum(g.capacity for g in group), gather_capacity)
            keys = torch.cat([g.keys for g in group])
            sec = torch.cat([g.sec for g in group])
            gid = torch.cat([g.gid for g in group])
            # every sentinel slot sorts past the valid rows, so the
            # leading out_cap slots of the sorted union are the merged run
            perm = _lexsort_keys(keys, sec)[:out_cap]
            self.dispatch_count += 1
            merged = _AttrGeneration.merged_device(keys[perm], sec[perm],
                                                   gid[perm], n=total)
        else:
            merged = _AttrGeneration.merged_host(
                merge_spilled_parts([g.spilled for g in group]))
            self._host_stack = None   # restacked lazily
        merged.gen_id = self._next_gen_id()
        # stale sketch partials must never double-count
        self._sketch_cache.drop_generations([g.gen_id for g in group])
        self.generations = replace_group(self.generations, group, merged)
        self.compactions += 1
        notify_generation_event(self, "merge", [merged.gen_id])

    def compact(self, budget_ms: float | None = None,
                factor: int | None = None,
                max_groups: int | None = None) -> dict:
        """Incremental size-tiered merge compaction over the attribute
        runs: merge one group, re-plan, stop past ``budget_ms`` or
        ``max_groups`` (≥ 1 group of progress per call; the next call
        resumes).  Candidate sets are identical at every intermediate
        state.  Returns ``{"merged_groups", "generations", "tiers"}``."""
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
        merged :class:`~geomesa_tpu_torch.stats.sketch.RunSketch` — the
        StatsScan push-down over the sorted key runs: the encoded key IS
        the value, so MinMax/Histogram/DescriptiveStats/Frequency (and
        Count) fold on the device for device runs, host runs fold in one
        stacked numpy pass, and no candidate row materializes.  Sealed
        runs' partials cache under ``fold`` (LRU + byte ceiling;
        compaction mints new gen_ids), so a warm repeat folds only the
        live run.  ``want_values`` folds (TopK/Enumeration's exact
        value→count maps) run on the host over the runs' key columns."""
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
            # every uncached device run, then ONE device→host copy
            self.dispatch_count += 1
            outs = [device_fold_body(
                g.keys[:g.n], g.sec[:g.n], int(fold.slo), int(fold.shi),
                float(fold.hlo), float(fold.hhi), bins=int(fold.bins),
                depth=int(fold.depth), width=int(fold.width),
                is_float=is_float,
                hist_kernel=g.capacity < HIST_KERNEL_MAX_SLOTS)
                for g in dev_scan]
            ints = torch.stack([torch.stack([o[0].to(torch.int64), o[1],
                                             o[2]]) for o in outs])
            sums = torch.stack([torch.stack([o[3], o[4]]) for o in outs])
            hists = [o[5] for o in outs]
            cmss = [o[6] for o in outs]
            ints, sums = ints.cpu().numpy(), sums.cpu().numpy()
            hists = torch.stack(hists).cpu().numpy()
            cmss = torch.stack(cmss).cpu().numpy()
            for i, g in enumerate(dev_scan):
                n = int(ints[i, 0])
                new_parts[id(g)] = RunSketch(
                    n, int(ints[i, 1]) if n else None,
                    int(ints[i, 2]) if n else None,
                    float(sums[i, 0]), float(sums[i, 1]),
                    np.array(hists[i]) if fold.bins else None,
                    np.array(cmss[i]) if fold.depth else None)
        elif dev_scan:
            # exact value→count folds are dict-valued — a host fold over
            # the fetched sorted key runs
            runs = [(g.keys[:g.n].cpu().numpy(), g.sec[:g.n].cpu().numpy())
                    for g in dev_scan]
            for g, p in zip(dev_scan,
                            fold_attr_runs(runs, fold, self.attr_type)):
                new_parts[id(g)] = p
        if host_scan:
            runs = [(g.spilled[0], g.spilled[1]) for g in host_scan]
            for g, p in zip(host_scan,
                            fold_attr_runs(runs, fold, self.attr_type)):
                new_parts[id(g)] = p
        for g in dev_scan + host_scan:
            p = new_parts[id(g)]
            merged = merged + p
            if g is not live:
                self._sketch_cache.add(cache, g.gen_id, p)
        return merged

    # -- query path -------------------------------------------------------
    def _gather_dispatches(self, totals: np.ndarray) -> int:
        """Gather dispatches the JAX index makes for these per-generation
        totals: one over every (bucket-padded) device generation when the
        padded buffer fits ``BATCH_SCAN_BUDGET``, else one per generation
        with candidates."""
        capacity = gather_capacity(int(totals.max()),
                                   minimum=self.DEFAULT_CAPACITY)
        n_padded = len(totals) + (-len(totals)) % _GEN_BUCKET
        if n_padded * capacity <= self.BATCH_SCAN_BUDGET:
            return 1
        return int((totals > 0).sum())

    def query_ranges(self, ranges: list, n_windows: int = 1,
                     total_rows: int | None = None) -> np.ndarray:
        """Candidate gids for inclusive composite ranges
        ``(klo, khi, slo, shi, qid)`` — equality narrows by sec, value
        ranges pass open sec bounds (module doc).  Returns coded
        ``qid << pos_bits | gid`` when ``n_windows > 1``, else plain
        sorted unique gids."""
        if not ranges or self._n_rows == 0:
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
        pos_bits = coded_pos_bits(
            total_rows if total_rows is not None else self._n_rows,
            max(1, n_windows))
        dev_gens = [g for g in self.generations if g.tier == "device"]
        host_gens = [g for g in self.generations if g.tier == "host"]
        parts: list = []
        dev_total = 0
        if dev_gens:
            jklo, jkhi = self._dev(qklo), self._dev(qkhi)
            jslo, jshi = self._dev(qslo), self._dev(qshi)
            jqid = self._dev(qqid).to(torch.int64)
            seeks = []
            for g in dev_gens:
                k, s = g.keys[:g.n], g.sec[:g.n]
                starts = searchsorted2(k, s, jklo, jslo, side="left")
                ends = searchsorted2(k, s, jkhi, jshi, side="right")
                seeks.append((starts, torch.clamp(ends - starts, min=0)))
            self.dispatch_count += 1
            totals = torch.stack([c.sum() for _, c in seeks]).cpu().numpy()
            # adaptive-replan probe point: device totals are known BEFORE
            # any gather, so aborting here discards nothing
            dev_total = int(totals.sum())
            check_replan("query.scan.probe", dev_total)
            if dev_total:
                self.dispatch_count += self._gather_dispatches(totals)
                coded = []
                for g, (starts, counts), t in zip(dev_gens, seeks, totals):
                    if not int(t):
                        continue
                    idx, valid, rid = expand_ranges(
                        starts, counts, gather_capacity(int(t), minimum=8))
                    c = (jqid[rid] << pos_bits) | g.gid[idx].to(torch.int64)
                    coded.append(c[valid])
                parts.append(torch.cat(coded).cpu().numpy())
        host_cand_n = 0
        if host_gens:
            if self._host_stack is None:
                self._host_stack = _HostAttrStack(
                    [g.spilled for g in host_gens])
            coded = self._host_stack.candidates(qklo, qkhi, qslo, qshi,
                                                qqid, pos_bits)
            host_cand_n = int(len(coded))
            if host_cand_n:
                parts.append(coded)
                check_replan("query.scan.probe", dev_total + host_cand_n)
        if not parts:
            return np.empty(0, np.int64)
        merged = np.concatenate(parts)
        if n_windows > 1:
            return merged
        return np.unique(merged & ((np.int64(1) << pos_bits) - 1))

    # -- planner-facing surface (mirrors index/attribute.AttributeIndex) --
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
        ranges = []
        for v in values:
            k = encode_attr_value(v, self.attr_type)
            ranges.append((k, k, slo, shi, 0))
        return self.query_ranges(ranges)

    def query_range(self, lo=None, hi=None, lo_inclusive=True,
                    hi_inclusive=True) -> np.ndarray:
        """Candidate gids for a value range.  Bounds are conservatively
        INCLUSIVE at the key level (string prefix codes alias; numeric
        exclusive endpoints survive as candidates) — the residual filter
        applies the exact operator."""
        klo = (_I64_MIN if lo is None
               else encode_attr_value(lo, self.attr_type))
        # an open hi stops just short of the sentinel key (encoded keys
        # clamp below it, so no real row is missed)
        khi = (_SENTINEL_KEY - 1 if hi is None
               else encode_attr_value(hi, self.attr_type))
        return self.query_ranges([(klo, khi, None, None, 0)])

    def query_prefix(self, prefix: str) -> np.ndarray:
        if self.attr_type != "string":
            raise TypeError("prefix queries require a string attribute")
        klo, khi = string_prefix_bounds(prefix)
        return self.query_ranges([(klo, khi, None, None, 0)])
