"""Metrics: counters, gauges, timers and histograms with pluggable
reporters.

The port's copy of the JAX package's metrics module (the analog of the
reference's geomesa-metrics: a dropwizard MetricRegistry with
config-driven reporters, geomesa-metrics/.../config/MetricsConfig.scala:
15-17).  Sinks are logging and delimited-file, behind one reporter
protocol, plus a :class:`PeriodicReporter` daemon-thread scheduler (the
dropwizard ScheduledReporter role).  Pure Python: nothing here touches a
device.

Histograms and timers keep log-bucketed value counts (~15%-wide buckets)
beside the streaming moments, so ``snapshot()`` serves p50/p95/p99 at
O(1) memory.  Bucket tables are mergeable (:func:`merge_snapshots`),
which is how a multihost store folds one registry per process into one
view (:func:`~geomesa_tpu_torch.parallel.stats.
allreduce_metrics_snapshot`).
"""

from __future__ import annotations

import logging
import math
import re
import threading
import time
from dataclasses import dataclass, field

__all__ = ["MetricRegistry", "Timer", "Counter", "Gauge", "HistogramMetric",
           "LoggingReporter", "DelimitedFileReporter", "PeriodicReporter",
           "merge_snapshots", "registry",
           "METRIC_NAMESPACES", "lint_metric_names",
           "LEAN_COMPACTION_MERGES", "LEAN_COMPACTION_ROWS",
           "LEAN_DENSITY_CACHE_HITS", "LEAN_DENSITY_CACHE_MISSES",
           "LEAN_SKETCH_CACHE_HITS", "LEAN_SKETCH_CACHE_MISSES",
           "LEAN_SKETCH_SCANS", "LEAN_STATS_MATERIALIZED",
           "LEAN_DEVICE_DISPATCHES", "LEAN_DEVICE_MS",
           "JAX_COMPILE_COUNT", "JAX_COMPILE_MS", "JAX_COMPILE_FALLBACK",
           "PLAN_ESTIMATE_RATIO", "PLAN_REPLANNED",
           "WRITE_SEALS", "WRITE_SPILLS",
           "ARROW_CHUNKS", "ARROW_ROWS", "ARROW_BYTES",
           "QUERY_TIMEOUTS", "QUERY_SHED",
           "RESILIENCE_DEGRADED", "RESILIENCE_RETRIES",
           "RESILIENCE_BREAKER_OPEN", "RESILIENCE_FAULTS",
           "RESILIENCE_ADMISSION_ACTIVE", "RESILIENCE_ADMISSION_QUEUE_MS",
           "RESILIENCE_ADMISSION_ADMITTED",
           "SERVING_FUSED_BATCHES", "SERVING_FUSED_REQUESTS",
           "SERVING_FANIN", "SERVING_COALESCE_MS",
           "SERVING_BATCH_WINDOWS", "SERVING_BYPASS",
           "SERVING_TENANT_SHED", "SERVING_RIDER_EXPIRED",
           "TILE_REQUESTS", "TILE_REQUEST_MS",
           "PYRAMID_BUILDS", "PYRAMID_BUILD_MS",
           "PYRAMID_SERVE_HITS", "PYRAMID_SERVE_FALLBACKS",
           "OBS_SCRAPE_MS", "OBS_SCRAPE_CACHED", "OBS_SPANS_DROPPED",
           "ALERT_SLO_FIRED", "ALERT_SLO_ACTIVE"]

# The metric-name constants are the JAX package's, so one dashboard reads
# both packages.  Some name families (compile tracking, scrape
# self-observation, alerts) belong to layers the port does not have yet;
# their keys are declared here and recorded by nobody.

#: lean LSM lifecycle: compaction work (index/*_lean ``compact()``) and
#: the sealed-generation density-partial cache
LEAN_COMPACTION_MERGES = "lean.compaction.merges"
LEAN_COMPACTION_ROWS = "lean.compaction.rows_merged"
LEAN_DENSITY_CACHE_HITS = "lean.density.cache.hits"
LEAN_DENSITY_CACHE_MISSES = "lean.density.cache.misses"
#: stat-sketch push-down lifecycle (process/stats_process): per-run
#: partial cache traffic, served push-down scans, and stat requests on a
#: lean store that fell back to materializing the candidate hits
LEAN_SKETCH_CACHE_HITS = "lean.sketch.cache.hits"
LEAN_SKETCH_CACHE_MISSES = "lean.sketch.cache.misses"
LEAN_SKETCH_SCANS = "lean.sketch.scans"
LEAN_STATS_MATERIALIZED = "lean.sketch.materialized_fallbacks"
#: device-dispatch attribution of the lean indexes
LEAN_DEVICE_DISPATCHES = "lean.device.dispatches"
LEAN_DEVICE_MS = "lean.device.ms"
#: compile tracking of the JAX package (kept for name parity)
JAX_COMPILE_COUNT = "jax.compile.count"
JAX_COMPILE_MS = "jax.compile.ms"
JAX_COMPILE_FALLBACK = "jax.compile.fallback_count"
#: planner estimate audit: per planned query, chosen estimate over
#: actual rows scanned — a log-bucketed histogram whose quantiles say
#: how wrong the cost model runs
PLAN_ESTIMATE_RATIO = "plan.estimate.ratio"
#: adaptive mid-query replans (planning/adaptive.py): scans whose
#: candidate probe diverged past ``geomesa.planning.replan.threshold``
PLAN_REPLANNED = "plan.replanned"
#: write-path lifecycle events: generations sealed by a rollover, key
#: runs spilled device → host under budget pressure
WRITE_SEALS = "write.seals"
WRITE_SPILLS = "write.spills"
#: Arrow streaming result path
ARROW_CHUNKS = "arrow.chunks"
ARROW_ROWS = "arrow.rows"
ARROW_BYTES = "arrow.ipc_bytes"
#: resilience layer (resilience/): deadline expiries and admission sheds
#: are QUERY-plane outcomes (a caller saw a timeout, a partial result or
#: a shed), so they live under ``query.``; the ``resilience.`` namespace
#: carries the layer's own mechanics and the admission gate's live state
QUERY_TIMEOUTS = "query.timeout"
QUERY_SHED = "query.shed"
RESILIENCE_DEGRADED = "resilience.degraded"
RESILIENCE_RETRIES = "resilience.retries"
RESILIENCE_BREAKER_OPEN = "resilience.breaker.open"
RESILIENCE_FAULTS = "resilience.faults.injected"
RESILIENCE_ADMISSION_ACTIVE = "resilience.admission.active"
RESILIENCE_ADMISSION_QUEUE_MS = "resilience.admission.queue_ms"
RESILIENCE_ADMISSION_ADMITTED = "resilience.admission.admitted"

#: the fused serving plane (serving/): fan-in is the requests-per-batch
#: histogram (1.0 = no coalescing happened), coalesce_ms the time a
#: request waited in the fusion queue before its batch dispatched,
#: batch_windows the fused window count per batch (before padding).
#: Per-tenant sheds append the tenant as a trailing segment:
#: ``serving.tenant.shed.<tenant>``.
SERVING_FUSED_BATCHES = "serving.fused.batches"
SERVING_FUSED_REQUESTS = "serving.fused.requests"
SERVING_FANIN = "serving.fanin"
SERVING_COALESCE_MS = "serving.coalesce_ms"
SERVING_BATCH_WINDOWS = "serving.batch.windows"
SERVING_BYPASS = "serving.bypass"
SERVING_TENANT_SHED = "serving.tenant.shed"
SERVING_RIDER_EXPIRED = "serving.rider.expired"

#: density pyramids and tile serving: ``tile.*`` is the request plane
#: (``density_tile`` calls and their latency), ``pyramid.*`` the
#: precompute mechanics — builds and their durations, requests served
#: from cached pyramid cells, and tile requests finer than the pyramid
#: base, which ran the bbox density scan instead
TILE_REQUESTS = "tile.requests"
TILE_REQUEST_MS = "tile.request.ms"
PYRAMID_BUILDS = "pyramid.builds"
PYRAMID_BUILD_MS = "pyramid.build.ms"
PYRAMID_SERVE_HITS = "pyramid.serve.hits"
PYRAMID_SERVE_FALLBACKS = "pyramid.serve.fallbacks"

#: scrape and trace self-observation, and SLO burn alerts
OBS_SCRAPE_MS = "obs.scrape.ms"
OBS_SCRAPE_CACHED = "obs.scrape.cached"
OBS_SPANS_DROPPED = "obs.trace.spans.dropped"
ALERT_SLO_FIRED = "alert.slo.fired"
ALERT_SLO_ACTIVE = "alert.slo.active"

#: the metric naming contract: every registry key lives under one of
#: these top-level namespaces, dot-separated, segments drawn from
#: [A-Za-z0-9_:-] (attribute-index keys like
#: ``storage.evt.attr:score.device_bytes`` carry a colon)
METRIC_NAMESPACES = ("query", "write", "lean", "jax", "web", "storage",
                     "plan", "obs", "pallas", "heat", "job", "arrow",
                     "resilience", "serving", "tile", "pyramid",
                     "slo", "alert")
_METRIC_KEY_RE = re.compile(
    r"^(?:" + "|".join(METRIC_NAMESPACES)
    + r")(?:\.[A-Za-z0-9_:\-]+)+$")




def lint_metric_names(names) -> list[str]:
    """Names violating the metric naming contract (empty = clean)."""
    return sorted(n for n in names if not _METRIC_KEY_RE.match(n))


@dataclass
class Counter:
    count: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def inc(self, n: int = 1):
        with self._lock:
            self.count += n


@dataclass
class Gauge:
    """A point-in-time level (resident bytes, cache fill, queue depth)
    — ``set`` replaces rather than accumulates.  Snapshots carry it as
    ``{"value": v}``; :func:`merge_snapshots` SUMS gauges across
    processes (the multihost uses are all byte/level totals where a
    mesh-wide sum is the meaningful roll-up)."""

    value: float = 0.0
    updated_ts: float = 0.0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def set(self, v) -> None:
        with self._lock:
            self.value = float(v)
            self.updated_ts = time.time()


#: log-bucket geometry for the quantile tables: bucket b holds values in
#: (BASE**(b-1), BASE**b], so a quantile estimate (the bucket's geometric
#: midpoint) is within ~7% of the true value — plenty for p50/p95/p99
#: reporting, at a handful of ints per decade of dynamic range
_Q_BASE = 1.15
_Q_LOG = math.log(_Q_BASE)


def _quantile_from_buckets(q: float, count: int, zero: int,
                           buckets: dict, vmin: float, vmax: float
                           ) -> float:
    """Quantile estimate from a log-bucket table (shared by the live
    histogram and merged multihost snapshots).  ``zero`` counts values
    <= 0 (they have no log bucket).  Estimates clamp into the observed
    [min, max] so tiny histograms never report out-of-range values."""
    if count <= 0:
        return 0.0
    rank = max(1, math.ceil(q * count))
    seen = zero
    if rank <= seen:
        return min(0.0, vmax) if vmax < 0 else 0.0
    est = vmax
    for b in sorted(buckets):
        seen += buckets[b]
        if rank <= seen:
            est = _Q_BASE ** (b - 0.5)
            break
    return max(min(est, vmax), vmin)


@dataclass
class HistogramMetric:
    """Streaming count/mean/min/max plus a log-bucket table serving
    p50/p95/p99 (module doc)."""

    count: int = 0
    total: float = 0.0
    min: float = float("inf")
    max: float = float("-inf")
    _zero: int = 0
    _buckets: dict = field(default_factory=dict, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def update(self, value: float):
        with self._lock:
            self.count += 1
            self.total += value
            self.min = min(self.min, value)
            self.max = max(self.max, value)
            if value <= 0.0:
                self._zero += 1
            else:
                b = int(math.ceil(math.log(value) / _Q_LOG))
                self._buckets[b] = self._buckets.get(b, 0) + 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        with self._lock:
            return _quantile_from_buckets(q, self.count, self._zero,
                                          self._buckets, self.min, self.max)


@dataclass
class Timer(HistogramMetric):
    """Histogram of durations (ms) usable as a context manager.

    Registry timers are shared singletons, so start times live in a
    thread-local stack — concurrent (even nested) ``with`` blocks on the
    same timer record independent durations.  The thread-local is an
    eagerly-created dataclass field: no lazy init race on first use.
    """

    _local: threading.local = field(default_factory=threading.local,
                                    repr=False)

    def _starts(self) -> list:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def __enter__(self):
        self._starts().append(time.perf_counter())
        return self

    def __exit__(self, *exc):
        t0 = self._starts().pop()
        self.update((time.perf_counter() - t0) * 1000.0)
        return False


class MetricRegistry:
    def __init__(self):
        #: guarded-by: self._lock — every thread in the process
        #: (queries, writers, scrapers, reporters) hits this map
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def _get(self, name: str, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def timer(self, name: str) -> Timer:
        return self._get(name, Timer)

    def histogram(self, name: str) -> HistogramMetric:
        return self._get(name, HistogramMetric)

    def names(self) -> list[str]:
        """Every registered metric key (the naming-lint surface)."""
        with self._lock:
            return sorted(self._metrics)

    def remove(self, name: str) -> None:
        """Drop a metric (gauge republication uses this to retire keys
        for deleted schemas/indexes — the registry key set must stay
        bounded under schema churn)."""
        with self._lock:
            self._metrics.pop(name, None)

    def snapshot(self, buckets: bool = False) -> dict:
        """Point-in-time view: counters as ``{"count"}``, gauges as
        ``{"value"}``, histograms/timers with moments + p50/p95/p99.
        ``buckets=True`` adds the raw log-bucket table (``total``/
        ``zero``/``buckets``) — the mergeable form
        :func:`merge_snapshots` consumes."""
        with self._lock:
            items = sorted(self._metrics.items())
        out = {}
        for name, m in items:
            if isinstance(m, Gauge):
                out[name] = {"value": m.value}
                continue
            if isinstance(m, Counter):
                out[name] = {"count": m.count}
                continue
            with m._lock:
                vals = {"count": m.count, "mean": m.mean,
                        "min": m.min if m.count else 0.0,
                        "max": m.max if m.count else 0.0}
                for key, q in (("p50", 0.50), ("p95", 0.95),
                               ("p99", 0.99)):
                    vals[key] = _quantile_from_buckets(
                        q, m.count, m._zero, m._buckets, m.min, m.max)
                if buckets:
                    vals["total"] = m.total
                    vals["zero"] = m._zero
                    vals["buckets"] = {str(b): n
                                       for b, n in m._buckets.items()}
            out[name] = vals
        return out


def merge_snapshots(snaps: list) -> dict:
    """Monoid merge of per-process ``snapshot(buckets=True)`` dicts into
    one plain snapshot (quantiles recomputed from the summed bucket
    tables, bucket internals dropped) — the multihost scrape reducer
    (parallel/stats.allreduce_metrics_snapshot)."""
    merged: dict = {}
    gauges: dict = {}
    for snap in snaps:
        for name, vals in snap.items():
            if "value" in vals and "mean" not in vals:
                # gauge: mesh-wide SUM (byte/level totals per process)
                gauges[name] = gauges.get(name, 0.0) + float(vals["value"])
                continue
            cur = merged.setdefault(name, {
                "count": 0, "total": 0.0, "zero": 0, "buckets": {},
                "min": float("inf"), "max": float("-inf"),
                "hist": "mean" in vals})
            cur["count"] += int(vals.get("count", 0))
            if "mean" in vals:
                if "buckets" not in vals and vals.get("count", 0):
                    # a bucket-less histogram entry means the caller
                    # passed plain snapshot() output — quantiles would
                    # silently degenerate to max; fail loudly instead
                    raise ValueError(
                        f"merge_snapshots needs snapshot(buckets=True) "
                        f"input; {name!r} has no bucket table")
                cur["hist"] = True
                cur["total"] += float(
                    vals.get("total", vals["mean"] * vals.get("count", 0)))
                if vals.get("count"):
                    cur["min"] = min(cur["min"], float(vals["min"]))
                    cur["max"] = max(cur["max"], float(vals["max"]))
                cur["zero"] += int(vals.get("zero", 0))
                for b, n in (vals.get("buckets") or {}).items():
                    cur["buckets"][int(b)] = (cur["buckets"].get(int(b), 0)
                                              + int(n))
    out = {}
    for name, cur in sorted(merged.items()):
        if not cur["hist"]:
            out[name] = {"count": cur["count"]}
            continue
        n = cur["count"]
        vmin = cur["min"] if n else 0.0
        vmax = cur["max"] if n else 0.0
        vals = {"count": n, "mean": cur["total"] / n if n else 0.0,
                "min": vmin, "max": vmax}
        for key, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
            vals[key] = _quantile_from_buckets(
                q, n, cur["zero"], cur["buckets"], vmin, vmax)
        out[name] = vals
    for name, v in gauges.items():
        out[name] = {"value": v}
    return dict(sorted(out.items()))


class _ReporterBase:
    """Shared interval-delta tracking: each ``report()`` also emits the
    per-metric count DELTA since the previous report (the dropwizard
    one-minute-rate role, without the decay math) — cumulative-only
    rows made rate regressions invisible in long-lived processes."""

    def __init__(self, reg: MetricRegistry):
        self.registry = reg
        self._last_counts: dict = {}

    def _rows(self):
        for name, vals in self.registry.snapshot().items():
            if "count" not in vals:      # gauges carry levels, not counts
                yield name, dict(vals)
                continue
            delta = vals["count"] - self._last_counts.get(name, 0)
            self._last_counts[name] = vals["count"]
            yield name, {**vals, "delta": delta}


class LoggingReporter(_ReporterBase):
    """SLF4J-reporter analog: dump the registry (with interval deltas)
    to a logger."""

    def __init__(self, reg: MetricRegistry, logger=None,
                 level: int = logging.INFO):
        super().__init__(reg)
        self.logger = logger or logging.getLogger(
            "geomesa_tpu_torch.metrics")
        self.level = level

    def report(self):
        for name, vals in self._rows():
            self.logger.log(self.level, "%s %s", name, vals)


class DelimitedFileReporter(_ReporterBase):
    """Delimited-file-reporter analog: append CSV rows per metric
    (cumulative values plus the interval delta)."""

    def __init__(self, reg: MetricRegistry, path: str, delimiter: str = ","):
        super().__init__(reg)
        self.path = path
        self.delimiter = delimiter

    def report(self):
        ts = time.time()
        with open(self.path, "a") as f:
            for name, vals in self._rows():
                row = [f"{ts:.3f}", name] + [
                    f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in vals.items()]
                f.write(self.delimiter.join(row) + "\n")


class PeriodicReporter:
    """Daemon-thread scheduler driving any reporter on an interval —
    the dropwizard ScheduledReporter.start() analog.  ``stop()`` wakes
    the thread immediately, joins it, and (by default) flushes one
    final report so shutdown never loses the tail interval."""

    def __init__(self, reporter, interval_s: float = 60.0):
        self.reporter = reporter
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        #: guarded-by: self._lock — concurrent start()/stop() (an
        #: embedder's lifecycle hooks racing a test teardown) must
        #: never double-start the daemon or join a replaced thread
        self._thread: threading.Thread | None = None

    def start(self) -> "PeriodicReporter":
        with self._lock:
            if self._thread is None:
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._loop, name="geomesa-metrics-reporter",
                    daemon=True)
                self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.reporter.report()
            except Exception:  # a broken sink must not kill the thread
                logging.getLogger("geomesa_tpu_torch.metrics").warning(
                    "metrics reporter failed", exc_info=True)

    def stop(self, final_report: bool = True) -> None:
        with self._lock:
            # set INSIDE the lock: a set racing ahead of it lets a
            # concurrent start() clear the event between set and join,
            # orphaning the old daemon while _thread resets to None
            self._stop.set()
            if self._thread is not None:
                self._thread.join(timeout=5.0)
                self._thread = None
        if final_report:
            try:
                self.reporter.report()
            except Exception:
                pass


#: process-wide default registry (the reference's shared MetricRegistry)
registry = MetricRegistry()
