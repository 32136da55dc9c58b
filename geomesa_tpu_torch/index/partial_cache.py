"""Sealed-generation partial cache — the port's copy of the JAX
package's ``index/partial_cache.py``: the LRU + byte-ceiling +
compaction-invalidation policy the lean tiered index uses for immutable
per-generation aggregation partials (density grids):

* a cache holds per-SPEC dicts of ``{gen_id: partial}`` — a spec is
  whatever hashable tuple identifies one aggregation (query window,
  grid, fold config, ...);
* spec dicts are LRU-ordered; looking one up touches it and evicts the
  oldest OTHER specs past ``max_specs``;
* inserts respect a TOTAL byte ceiling across all specs (a single
  huge-partial spec must bound its own growth, not just evict
  siblings) — partials expose ``nbytes``;
* compaction mints fresh gen_ids for merged runs and calls
  :meth:`drop_generations` with the dead ids, so stale partials can
  never double-count.

Only SEALED generations may cache: the live run mutates under appends,
so callers never insert it (the caller owns that gate — it knows which
generation is live).

The SPEC MAP is lock-guarded: scrape threads walk
:meth:`stats` while query threads touch/evict specs, and an unlocked
LRU reorder racing an eviction corrupts the dict order that IS the
policy.  The per-spec inner dicts handed out by :meth:`spec_cache`
stay caller-owned — a spec's partials are only populated from the
scan path that owns the index, and reads of immutable partials are
safe; the lock's job is the cross-thread map structure.
"""

from __future__ import annotations

import threading

__all__ = ["PartialCache"]


class PartialCache:
    """LRU-of-specs store of immutable per-sealed-generation partials
    (module doc).  Exposes a dict-like surface over the spec map
    (``len``/``values``/``clear``/iteration) so diagnostics and tests
    can inspect it directly."""

    def __init__(self, max_specs: int, max_bytes: int):
        self.max_specs = int(max_specs)
        self.max_bytes = int(max_bytes)
        #: guarded-by: self._lock — spec -> {gen_id: partial}; dict
        #: order IS the LRU order, and scrapers race queries on it
        self._specs: dict = {}
        self._lock = threading.Lock()

    # -- dict-like inspection surface ---------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._specs)

    def __iter__(self):
        with self._lock:
            return iter(list(self._specs))

    def values(self):
        with self._lock:
            return list(self._specs.values())

    def items(self):
        with self._lock:
            return list(self._specs.items())

    def clear(self) -> None:
        with self._lock:
            self._specs.clear()

    # -- policy --------------------------------------------------------
    # gm-lint: holds: self._lock (internal sum; public paths lock first)
    def _cached_bytes(self) -> int:
        return sum(p.nbytes for c in self._specs.values()
                   for p in c.values())

    def cached_bytes(self) -> int:
        with self._lock:
            return self._cached_bytes()

    def stats(self) -> dict:
        """Storage-accounting view: spec
        count, total cached partials, resident bytes, and the policy
        ceilings they are bounded by."""
        with self._lock:
            return {"specs": len(self._specs),
                    "partials": sum(len(c) for c in self._specs.values()),
                    "bytes": self._cached_bytes(),
                    "max_specs": self.max_specs,
                    "max_bytes": self.max_bytes}

    def spec_cache(self, spec) -> dict:
        """The per-generation partial dict for one spec, LRU-touched;
        oldest OTHER specs evict past ``max_specs`` or the byte
        ceiling (inserts enforce the ceiling against the active spec
        too — :meth:`add`)."""
        with self._lock:
            cache = self._specs.pop(spec, None)
            if cache is None:
                cache = {}
                while len(self._specs) >= self.max_specs:
                    self._specs.pop(next(iter(self._specs)))
            self._specs[spec] = cache
            while (len(self._specs) > 1
                   and self._cached_bytes() > self.max_bytes):
                self._specs.pop(next(iter(self._specs)))
            return cache

    def add(self, cache: dict, gen_id: int, part) -> None:
        """Insert one sealed-generation partial unless it would push
        the TOTAL cached bytes — every spec, including the active one —
        past the ceiling."""
        with self._lock:
            if self._cached_bytes() + part.nbytes <= self.max_bytes:
                cache[gen_id] = part

    def drop_generations(self, gen_ids) -> None:
        """Invalidate every partial of the given (compacted-away)
        generations across all specs."""
        with self._lock:
            for cache in self._specs.values():
                for gid in gen_ids:
                    cache.pop(gid, None)
