"""Storage and device-memory accounting, audited.

Every lean index tier budgets device memory from per-slot constants
(``device_bytes`` / ``host_key_bytes`` and the ``hbm_budget_bytes``
rebalance); this module turns that accounting into an operator surface
and audits it, as the JAX package's ``obs/resource.py`` does:

* :func:`storage_report` walks a :class:`~geomesa_tpu_torch.datastore.
  TpuDataStore` and collects every index's ``storage_stats()`` (the
  accounted view: device runs and host-spilled runs per generation, the
  sealed-partial caches) plus the column store's host bytes, then
  re-derives the same totals from the ACTUAL buffers: torch tensors by
  ``untyped_storage().nbytes()`` and numpy arrays by ``nbytes``, each
  storage counted once.  For a store on the card the report also carries
  ``torch.cuda.memory_allocated()``.
* :func:`publish_storage_gauges` folds the report into ``storage.*``
  registry gauges; the admission gate's device-memory check reads
  ``storage.total.device_bytes``.

Reconciliation tolerances, one-directional (they excuse OVERSTATEMENT
only; accounting that understates actual residency beyond 1% fails):

* **device**: exact (1% float slack);
* **host**: accounted may overstate actual by up to 35%;
* **sentinel**: by up to 25%.  The port pads nothing, so its indexes
  charge their budgets the JAX package's sentinel buffers without
  reporting or allocating them: accounted and actual are both 0;
* **caches**: exact (partials self-report their bytes).

Per-generation detail lives in the report, not the registry: generation
ids churn under compaction and gauges must stay a bounded key set.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..metrics import registry as _metrics

__all__ = ["storage_report", "publish_storage_gauges",
           "index_actual_nbytes"]

#: reconciliation tolerances, percent of actual (module doc)
TOLERANCE_PCT = {"device": 1.0, "host": 35.0, "sentinel": 25.0,
                 "cache": 1.0}

#: buffer attributes a generation may carry, across every lean variant
#: (z3: bins/z/pos/x/y/t; attribute and xz: keys/sec/gid)
_GEN_ARRAYS = ("bins", "z", "pos", "x", "y", "t", "keys", "sec", "gid")
#: buffer attributes of a spilled HostRun (z3 family)
_RUN_ARRAYS = ("bins", "z", "pos")


def _buffers(obj):
    """Tensors and arrays in ``obj``: a tensor, an array, a HostRun, or
    a list/tuple of them (the sharded indexes keep one per shard)."""
    if obj is None or isinstance(obj, (int, float)):
        return
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _buffers(o)
    elif all(hasattr(obj, n) for n in _RUN_ARRAYS):
        for n in _RUN_ARRAYS:
            yield from _buffers(getattr(obj, n))


def _add_buffers(total: int, seen: set, *objs) -> int:
    """Sum the bytes of every buffer in ``objs``, each storage once: a
    tensor view counts its whole storage, identified by its data pointer;
    a numpy view its base array."""
    for o in objs:
        for a in _buffers(o):
            if isinstance(a, torch.Tensor):
                st = a.untyped_storage()
                key = ("t", a.device.type, a.device.index, st.data_ptr())
                nbytes = int(st.nbytes())
            else:
                base = a
                while isinstance(base.base, np.ndarray):
                    base = base.base
                key = ("a", id(base))
                nbytes = int(base.nbytes)
            if key in seen:
                continue
            seen.add(key)
            total += nbytes
    return total


def index_actual_nbytes(idx) -> dict:
    """Re-derive one lean index's resident bytes from its ACTUAL buffers
    (device runs, host runs, partial caches): the audit side of the
    reconciliation, walking the generation shapes of every lean variant
    generically (facades unwrap through ``_core``)."""
    core = getattr(idx, "_core", idx)
    seen: set = set()
    dev = host = 0
    for g in getattr(core, "generations", ()):
        if getattr(g, "tier", None) == "host":
            host = _add_buffers(host, seen, getattr(g, "run", None),
                                getattr(g, "runs", None),
                                getattr(g, "spilled", None))
        else:
            dev = _add_buffers(dev, seen,
                               *(getattr(g, n, None) for n in _GEN_ARRAYS))
    cache = 0
    # every partial cache the accounted view lists (the JAX audit leaves
    # the pyramid cache out, so a store with pyramids fails its cache
    # reconciliation there; ROADMAP C)
    for name in ("_density_cache", "_sketch_cache", "_pyramid_cache"):
        c = getattr(core, name, None)
        if c is not None:
            cache += int(c.cached_bytes())
    return {"device_bytes": dev, "host_bytes": host, "sentinel_bytes": 0,
            "cache_bytes": cache}


def _accounted_cache_bytes(stats: dict) -> int:
    return sum(int(c.get("bytes", 0))
               for c in (stats.get("caches") or {}).values())


def _batch_bytes(batch) -> int:
    """Host bytes of a schema's column store: ``LeanBatch.host_bytes``
    on the lean profile, the summed column bytes of a FeatureBatch."""
    if batch is None:
        return 0
    if hasattr(batch, "host_bytes"):
        return int(batch.host_bytes())
    total, seen = 0, set()
    for a in getattr(batch, "columns", {}).values():
        if id(a) not in seen:
            seen.add(id(a))
            total += int(getattr(a, "nbytes", 0))
    return total


def _reconcile(accounted: int, actual: int, kind: str) -> dict:
    """One-directional verdict: the per-kind tolerance excuses only
    OVERSTATEMENT; understatement beyond the 1% slack always fails."""
    tol_over = TOLERANCE_PCT[kind]
    tol_under = TOLERANCE_PCT["device"]
    if actual:
        delta_pct = (accounted - actual) / actual * 100.0
    else:
        delta_pct = 100.0 if accounted else 0.0
    return {"accounted": int(accounted), "actual": int(actual),
            "delta_pct": round(delta_pct, 2), "tolerance_pct": tol_over,
            "ok": -tol_under <= delta_pct <= tol_over}


def storage_report(store, audit: bool = True) -> dict:
    """Accounted storage per schema and index, the actual-buffer audit,
    and the reconciliation verdict (module doc).  ``audit=False`` skips
    the buffer walk: the accounted-only form the gauges publish."""
    schemas: dict = {}
    acc = {"device_bytes": 0, "host_bytes": 0, "sentinel_bytes": 0,
           "cache_bytes": 0, "batch_bytes": 0}
    act = {"device_bytes": 0, "host_bytes": 0, "sentinel_bytes": 0,
           "cache_bytes": 0}
    for name, s in store._schemas.items():
        batch_bytes = _batch_bytes(s.batch)
        entry: dict = {
            "rows": 0 if s.batch is None else len(s.batch),
            "lean": bool(s.lean),
            "batch_host_bytes": batch_bytes,
            "indexes": {},
        }
        acc["batch_bytes"] += batch_bytes
        for key, idx in s._indexes.items():
            if hasattr(idx, "storage_stats"):
                st = idx.storage_stats()
                acc["device_bytes"] += int(st.get("device_bytes", 0))
                acc["host_bytes"] += int(st.get("host_bytes", 0))
                acc["sentinel_bytes"] += int(st.get("sentinel_bytes", 0))
                acc["cache_bytes"] += _accounted_cache_bytes(st)
                if audit:
                    actual = index_actual_nbytes(idx)
                    st["actual"] = actual
                    for k in act:
                        act[k] += actual[k]
            else:
                # non-generational (default-profile) indexes: presence
                # and rows only
                st = {"kind": type(idx).__name__}
                try:
                    st["rows"] = len(idx)
                except TypeError:
                    pass
            entry["indexes"][key] = st
        schemas[name] = entry
    out = {
        "generated_ts": round(time.time(), 3),
        "schemas": schemas,
        "totals": dict(acc),
    }
    dev = getattr(store, "device", None)
    if dev is not None and dev.type == "cuda":
        out["cuda_memory_allocated"] = int(torch.cuda.memory_allocated(dev))
    if audit:
        recon = {
            "device": _reconcile(acc["device_bytes"],
                                 act["device_bytes"], "device"),
            "host": _reconcile(acc["host_bytes"], act["host_bytes"],
                               "host"),
            "sentinel": _reconcile(acc["sentinel_bytes"],
                                   act["sentinel_bytes"], "sentinel"),
            "cache": _reconcile(acc["cache_bytes"], act["cache_bytes"],
                                "cache"),
        }
        out["actual_totals"] = dict(act)
        out["reconciliation"] = {
            **recon,
            "within_tolerance": all(v["ok"] for v in recon.values()),
        }
    return out


#: serializes gauge publication: concurrent publishes must not race the
#: publish-then-retire sequence
_publish_lock = threading.Lock()


def publish_storage_gauges(store, report: dict | None = None) -> dict:
    """Set the ``storage.*`` registry gauges from a (fresh or given)
    report; returns the report used (a fresh one skips the audit).

    * ``storage.total.{device,host,sentinel,cache,batch}_bytes``
    * ``storage.<schema>.batch_bytes``
    * ``storage.<schema>.<index>.{device,host,cache}_bytes``

    Under multihost the device and sentinel values are divided by the
    process count: every process accounts the same mesh-wide device
    bytes, and a merged snapshot sums gauges over processes.  The keys
    published last time are tracked per store, and stale ones retire."""
    from ..parallel.multihost import process_count
    report = (report if report is not None
              else storage_report(store, audit=False))
    procs = 1
    if getattr(store, "_multihost", False):
        procs = max(1, process_count())

    published: set = set()

    def _set(key: str, value, shared: bool = False) -> None:
        _metrics.gauge(key).set(value / procs if shared else value)
        published.add(key)

    with _publish_lock:
        for schema, entry in report["schemas"].items():
            _set(f"storage.{schema}.batch_bytes",
                 entry["batch_host_bytes"])
            for key, st in entry["indexes"].items():
                if "device_bytes" not in st:
                    continue
                base = f"storage.{schema}.{key}"
                _set(f"{base}.device_bytes", st["device_bytes"],
                     shared=True)
                _set(f"{base}.host_bytes", st["host_bytes"])
                _set(f"{base}.cache_bytes", _accounted_cache_bytes(st))
        # totals LAST: a schema literally named "total" never leaves its
        # values in the process-total keys
        tot = report["totals"]
        for leaf in ("device_bytes", "sentinel_bytes"):
            _set(f"storage.total.{leaf}", tot[leaf], shared=True)
        for leaf in ("host_bytes", "cache_bytes", "batch_bytes"):
            _set(f"storage.total.{leaf}", tot[leaf])
        prev = getattr(store, "_storage_gauge_keys", set())
        for stale in prev - published:
            _metrics.remove(stale)
        store._storage_gauge_keys = published
    return report
