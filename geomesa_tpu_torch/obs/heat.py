"""Access-temperature tracking: WHICH data queries actually touch.

The storage report (obs/resource.py) says where every byte lives and the
trace how long every query takes; this module records which
*generations* the queries read:

* every lean scan path (z3, attribute, xz2 and xz3 query, density, cell
  counts, sketch folds; one device and sharded) reports per-generation
  **touches** through :func:`record_index_scan`: scans, bytes read, rows
  matched, the residency tier at access time and the access time;
* touches fold into an **exponentially decayed temperature**: a touch at
  ``t`` contributes ``exp(-(now - t)/τ)`` (``geomesa.obs.heat.tau.s``),
  kept incrementally as ``temp = temp·exp(-Δt/τ) + weight``.  The weight
  is 1.0 for a touch that matched rows (or whose matches cannot be
  counted, a density grid or a sketch fold) and 0.0 for a probe that
  found nothing, so a generation every query probes but none draws from
  stays cold;
* :func:`heat_report` joins the tracked entries with the storage
  report's per-generation placement and ranks hot → cold; generations no
  query touched appear at temperature 0;
* :func:`publish_heat_gauges` folds per-(schema, index) aggregates into
  ``heat.*`` registry gauges.

Per-generation detail lives in the report, not the registry (generation
ids churn under compaction).  On compaction the merged run inherits its
sources' decayed temperatures (:func:`merge_index_generations`).

Tracking is process-local and thread-safe; host-tier match counts are
attributed in proportion to run size (the stacked host seek loses
per-run attribution).  With ``geomesa.obs.heat.enabled=false`` every
record site costs one cached bool read.  The entries, the ranking and
the report are the JAX package's (``geomesa_tpu/obs/heat.py``).
"""

from __future__ import annotations

import math
import threading
import time

from ..config import ObsProperties, config_generation
from ..metrics import registry as _metrics

__all__ = ["HeatTracker", "heat_tracker", "heat_enabled",
           "record_index_scan", "merge_index_generations",
           "heat_report", "publish_heat_gauges"]

#: cached ``geomesa.obs.heat.enabled`` keyed on config_generation() —
#: the scan hot path pays one int compare, not the override lock
_cfg_gen = -1
_cfg_enabled = True


def heat_enabled() -> bool:
    global _cfg_gen, _cfg_enabled
    gen = config_generation()
    if gen != _cfg_gen:
        _cfg_enabled = ObsProperties.HEAT_ENABLED.to_bool()
        _cfg_gen = gen
    return _cfg_enabled


class _HeatEntry:
    """Touch counters + the incrementally-decayed temperature for one
    (schema, index, generation)."""

    __slots__ = ("scans", "hits", "bytes_read", "rows_matched", "tier",
                 "first_ts", "last_ts", "temp", "temp_ts")

    def __init__(self, now: float):
        self.scans = 0
        self.hits = 0
        self.bytes_read = 0
        self.rows_matched = 0
        self.tier = ""
        self.first_ts = now
        self.last_ts = now
        self.temp = 0.0
        self.temp_ts = now

    def decayed(self, now: float, tau: float) -> float:
        dt = now - self.temp_ts
        if dt <= 0.0:
            return self.temp
        return self.temp * math.exp(-dt / tau)

    def touch(self, now: float, tau: float, tier: str, bytes_read: int,
              rows_matched, weight: float) -> None:
        self.scans += 1
        self.bytes_read += int(bytes_read)
        if rows_matched:
            self.rows_matched += int(rows_matched)
        if weight > 0.0:
            self.hits += 1
        self.tier = tier
        self.last_ts = now
        self.temp = self.decayed(now, tau) + weight
        self.temp_ts = now


class HeatTracker:
    """Process-wide decayed-temperature store keyed
    ``(schema, index, gen_id)``.  ``tau_s``/``max_entries`` pin the
    knobs for tests; by default they re-resolve from the
    ``geomesa.obs.heat.*`` options per call (live-tunable)."""

    def __init__(self, tau_s: float | None = None,
                 max_entries: int | None = None):
        self._tau_override = tau_s
        self._max_override = max_entries
        #: guarded-by: self._lock — scans, compaction merges, report
        #: snapshots and eviction all race on this map
        self._entries: dict[tuple, _HeatEntry] = {}
        self._lock = threading.Lock()

    def tau_s(self) -> float:
        if self._tau_override is not None:
            return float(self._tau_override)
        return max(1e-3, float(ObsProperties.HEAT_TAU_S.get()))

    def _max_entries(self) -> int:
        if self._max_override is not None:
            return int(self._max_override)
        return max(16, ObsProperties.HEAT_MAX_ENTRIES.to_int())

    def record(self, scope: tuple, touches, now: float | None = None
               ) -> None:
        """Fold one scan's per-generation touches in.  ``scope`` is
        ``(schema, index_key)``; each touch is ``(gen_id, tier,
        rows_scanned, bytes_read, rows_matched)`` where ``rows_matched
        is None`` means the path cannot attribute matches (density /
        sketch partials) and counts as a full-weight access."""
        now = time.time() if now is None else float(now)
        tau = self.tau_s()
        schema, index = scope
        with self._lock:
            for gen_id, tier, _rows, bytes_read, matched in touches:
                key = (schema, index, int(gen_id))
                e = self._entries.get(key)
                if e is None:
                    e = self._entries[key] = _HeatEntry(now)
                weight = 1.0 if (matched is None or matched > 0) else 0.0
                e.touch(now, tau, tier, bytes_read, matched, weight)
            if len(self._entries) > self._max_entries():
                self._evict_coldest(now, tau)

    # gm-lint: holds: self._lock (record() evicts inside its fold)
    def _evict_coldest(self, now: float, tau: float) -> None:
        """Drop the coldest ~10% (lock held) — amortized so a store
        with churning generations never grows the table unbounded."""
        n_drop = max(1, len(self._entries) // 10)
        ranked = sorted(self._entries.items(),
                        key=lambda kv: (kv[1].decayed(now, tau),
                                        kv[1].last_ts))
        for key, _ in ranked[:n_drop]:
            del self._entries[key]

    def merge_generations(self, scope: tuple, dead_ids, new_id: int,
                          now: float | None = None) -> None:
        """Compaction epilogue: the merged run inherits its sources'
        summed decayed temperature and counters (hot data must not
        read as cold just because maintenance renamed it)."""
        now = time.time() if now is None else float(now)
        tau = self.tau_s()
        schema, index = scope
        with self._lock:
            dead = [self._entries.pop((schema, index, int(g)), None)
                    for g in dead_ids]
            dead = [e for e in dead if e is not None]
            if not dead:
                return
            key = (schema, index, int(new_id))
            e = self._entries.get(key)
            if e is None:
                e = self._entries[key] = _HeatEntry(now)
            for d in dead:
                e.scans += d.scans
                e.hits += d.hits
                e.bytes_read += d.bytes_read
                e.rows_matched += d.rows_matched
                e.temp = e.decayed(now, tau) + d.decayed(now, tau)
                e.temp_ts = now
                e.first_ts = min(e.first_ts, d.first_ts)
                e.last_ts = max(e.last_ts, d.last_ts)

    def drop(self, scope: tuple, gen_ids) -> None:
        schema, index = scope
        with self._lock:
            for g in gen_ids:
                self._entries.pop((schema, index, int(g)), None)

    def snapshot(self, now: float | None = None) -> dict:
        """``{(schema, index, gen_id): {...}}`` with temperatures
        decayed to ``now``."""
        now = time.time() if now is None else float(now)
        tau = self.tau_s()
        with self._lock:
            items = list(self._entries.items())
        return {key: {"temperature": e.decayed(now, tau),
                      "scans": e.scans, "hits": e.hits,
                      "bytes_read": e.bytes_read,
                      "rows_matched": e.rows_matched,
                      "tier": e.tier, "last_access_ts": e.last_ts,
                      "first_access_ts": e.first_ts,
                      "updated_ts": e.temp_ts}
                for key, e in items}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


#: process-wide tracker (the shared-registry/tracer analog for heat)
heat_tracker = HeatTracker()


def record_index_scan(index, touches) -> None:
    """Record one scan's touches against ``index``'s heat scope.  The
    datastore stamps ``heat_scope = (schema, index_key)`` on every
    lean index it builds; directly-constructed indexes (tests, bench)
    record under ``("_", <class name>)`` — tracked for overhead
    honesty, just never joined with a storage report."""
    scope = getattr(index, "heat_scope", None) \
        or ("_", type(index).__name__)
    heat_tracker.record(scope, touches)


def merge_index_generations(index, dead_ids, new_id: int) -> None:
    """Compaction hook: fold dead generations' heat into the merged
    run (no-op when tracking is off or nothing was tracked)."""
    if not heat_enabled():
        return
    scope = getattr(index, "heat_scope", None) \
        or ("_", type(index).__name__)
    heat_tracker.merge_generations(scope, dead_ids, new_id)


def _placement_map(storage: dict) -> dict:
    """``(schema, index, gen_id) -> placement`` from a storage report
    (per-generation device/host residency, obs/resource)."""
    out: dict = {}
    for schema, entry in storage.get("schemas", {}).items():
        for key, st in entry.get("indexes", {}).items():
            for g in st.get("generations", ()):  # lean indexes only
                out[(schema, key, int(g["gen_id"]))] = {
                    "tier": g.get("tier", ""),
                    "rows": int(g.get("rows", 0)),
                    "device_bytes": int(g.get("device_bytes", 0)),
                    "host_bytes": int(g.get("host_bytes", 0))}
    return out


#: stale-entry pruning grace (s): a tracker entry UPDATED within this
#: window is never pruned even when the storage snapshot lacks its
#: generation — a compaction merge credit or a scan of a just-opened
#: generation lands milliseconds around the placement walk, and racing
#: the prune must not erase it (the next report reconciles)
_PRUNE_GRACE_S = 10.0


def heat_report(store, tracker: HeatTracker | None = None,
                now: float | None = None, limit: int | None = None,
                storage: dict | None = None) -> dict:
    """The ranked hot→cold picture: every tracked touch entry joined
    with its generation's CURRENT placement from the storage report,
    plus zero-temperature rows for generations the storage report
    knows but no query ever touched.  Entries whose generation no
    longer exists (compacted away without a merge credit, schema
    removed) are pruned from the tracker for scopes the storage
    report covers — after a grace window, so a racing compaction's
    merge credit survives — and the table self-bounds under churn.

    Ranking: temperature desc, then last access desc, then gen_id.
    ``limit`` truncates the ranked list;
    aggregates always cover everything.  ``storage`` reuses an
    already-computed storage report instead of walking the store
    again (the one-walk-per-scrape discipline)."""
    from .resource import storage_report
    now = time.time() if now is None else float(now)
    tracker = tracker if tracker is not None else heat_tracker
    if storage is None:
        storage = storage_report(store, audit=False)
    placement = _placement_map(storage)
    covered_scopes = {(s, i) for (s, i, _g) in placement}
    snap = tracker.snapshot(now=now)
    rows: list = []
    stale: dict = {}
    for key, e in snap.items():
        schema, index, gen_id = key
        updated_ts = e.pop("updated_ts")
        place = placement.get(key)
        if place is None:
            if ((schema, index) in covered_scopes
                    and now - updated_ts > _PRUNE_GRACE_S):
                # this store's scope, but the generation is gone —
                # prune (foreign scopes are left alone: another store
                # in this process may own them; freshly-updated
                # entries get the grace window above)
                stale.setdefault((schema, index), []).append(gen_id)
            continue
        rows.append({"schema": schema, "index": index, "gen_id": gen_id,
                     **{k: (round(v, 6) if isinstance(v, float) else v)
                        for k, v in e.items()},
                     "placement": place})
    for scope, gens in stale.items():
        tracker.drop(scope, gens)
    for key, place in placement.items():
        if key in snap:
            continue
        schema, index, gen_id = key
        rows.append({"schema": schema, "index": index, "gen_id": gen_id,
                     "temperature": 0.0, "scans": 0, "hits": 0,
                     "bytes_read": 0, "rows_matched": 0,
                     "tier": place["tier"], "last_access_ts": 0.0,
                     "first_access_ts": 0.0, "placement": place})
    rows.sort(key=lambda r: (-r["temperature"], -r["last_access_ts"],
                             r["schema"], r["index"], r["gen_id"]))
    for rank, r in enumerate(rows, start=1):
        r["rank"] = rank
    aggregates: dict = {}
    for r in rows:
        agg = aggregates.setdefault(f"{r['schema']}.{r['index']}", {
            "temperature": 0.0, "scans": 0, "bytes_read": 0,
            "rows_matched": 0, "generations": 0, "touched": 0})
        agg["temperature"] += r["temperature"]
        agg["scans"] += r["scans"]
        agg["bytes_read"] += r["bytes_read"]
        agg["rows_matched"] += r["rows_matched"]
        agg["generations"] += 1
        agg["touched"] += 1 if r["scans"] else 0
    for agg in aggregates.values():
        agg["temperature"] = round(agg["temperature"], 6)
    return {
        "generated_ts": round(now, 3),
        "tau_s": tracker.tau_s(),
        "enabled": heat_enabled(),
        "tracked_entries": len(tracker),
        "generations": rows if limit is None else rows[:limit],
        "indexes": aggregates,
    }


#: serializes gauge publication (the storage-gauge discipline: the
#: publish-then-retire sequence must not interleave across scrapes)
_publish_lock = threading.Lock()


def publish_heat_gauges(store, report: dict | None = None,
                        storage: dict | None = None) -> dict:
    """Fold a heat report's per-(schema, index) aggregates into
    ``heat.*`` registry gauges, beside the ``storage.*`` ones:

    * ``heat.<schema>.<index>.{temperature,scans,bytes_read,
      rows_matched}``
    * ``heat.total.{temperature,tracked_generations}``

    Under multihost every process runs the same scans and records the
    same touches, and a snapshot merged over the processes SUMS gauges,
    so all heat values publish divided by the process count, the
    ``publish_storage_gauges`` shared-value discipline.  Per-store key
    tracking + stale-key retirement likewise mirror the storage
    gauges (bounded key set under schema churn).  ``storage`` is the
    optional already-computed storage report for the fresh-report
    path.  Returns the report used."""
    if report is None:
        report = heat_report(store, storage=storage)
    procs = 1
    if getattr(store, "_multihost", False):
        from ..parallel.multihost import process_count
        procs = max(1, process_count())
    published: set = set()

    def _set(key: str, value) -> None:
        _metrics.gauge(key).set(value / procs if procs > 1 else value)
        published.add(key)

    with _publish_lock:
        total_temp = 0.0
        for scope, agg in report["indexes"].items():
            base = f"heat.{scope}"
            _set(f"{base}.temperature", agg["temperature"])
            _set(f"{base}.scans", agg["scans"])
            _set(f"{base}.bytes_read", agg["bytes_read"])
            _set(f"{base}.rows_matched", agg["rows_matched"])
            total_temp += agg["temperature"]
        # totals LAST: a schema literally named "total" must never
        # leave its values in the rollup keys
        _set("heat.total.temperature", round(total_temp, 6))
        _set("heat.total.tracked_generations",
             report["tracked_entries"])
        prev = getattr(store, "_heat_gauge_keys", set())
        for stale in prev - published:
            _metrics.remove(stale)
        store._heat_gauge_keys = published
    return report
