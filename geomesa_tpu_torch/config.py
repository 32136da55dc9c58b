"""Typed system properties: the port's config/flag system.

Values resolve, in order: programmatic override (:func:`set_property`)
→ environment variable (dots become underscores, upper-cased) → default.
Per-schema user data (features/feature_type.py) and per-query hints are
the other two tiers.

This holds only the knobs the port's sources read; the names and
defaults are those of ``geomesa_tpu.config``, so one environment
configures both packages alike.

**The option registry.**  Every declared knob (a :class:`SystemProperty`
or a per-schema :class:`SchemaOption`) is registered by name.  A
``geomesa.*`` name nobody declared warns once with
:class:`UnknownOptionWarning` when it is set, cleared or looked up, and
raises ``ValueError`` under ``geomesa.config.strict`` (clearing only
warns, so a stale override stays removable).  Names outside ``geomesa.``
pass untouched.  The JAX package declares a few names the port does
not: ``geomesa.query.loose.bounding.box`` and ``geomesa.query.cost.type``
(read by nothing in either package); ``geomesa.scan.pallas`` (the port's
kernels never fall back) and ``geomesa.obs.write.block`` (the port's
writes end without a device copy): those two are deliberate differences
(ROADMAP C).  Setting any of them here warns.
"""

from __future__ import annotations

import os
import threading
import warnings
from dataclasses import dataclass
from typing import Any

__all__ = ["SystemProperty", "SchemaOption", "QueryProperties",
           "DensityProperties", "PlanningProperties", "ResilienceProperties",
           "ServingProperties", "ObsProperties", "SloProperties",
           "ArrowProperties",
           "SchemaProperties", "ConfigProperties", "DEFAULT_MAX_RANGES",
           "set_property", "clear_property", "config_generation",
           "known_option_names", "check_option_name",
           "UnknownOptionWarning"]

_overrides: dict[str, Any] = {}
_lock = threading.Lock()
#: bumped on every override change: hot paths (the fault registry, the
#: tracer) cache resolved values keyed on it, paying one int read a call
_generation = 0

#: the option registry: every declared knob, system property and schema
#: option alike, keyed by name (filled by ``_register_declarations``)
_REGISTRY: dict[str, Any] = {}
#: names already warned about (one warning per unknown name)
_warned: set[str] = set()


class UnknownOptionWarning(UserWarning):
    """A ``geomesa.*`` option name nobody declared: almost always a typo
    that would otherwise silently read the default forever."""


def known_option_names() -> frozenset:
    """Every declared option name (system properties and schema
    options)."""
    return frozenset(_REGISTRY)


def check_option_name(name: str, *, raise_in_strict: bool = True) -> None:
    """Warn about an undeclared ``geomesa.*`` name, and raise under
    ``geomesa.config.strict`` unless ``raise_in_strict`` is False
    (:func:`clear_property`: removing a stale override must stay
    possible while strict mode is on).  Other names pass untouched."""
    if not name.startswith("geomesa.") or name in _REGISTRY \
            or not _REGISTRY:
        return
    msg = (f"unregistered option {name!r}: not declared in "
           f"geomesa_tpu_torch/config.py (typo?)")
    if raise_in_strict and ConfigProperties.STRICT.to_bool():
        raise ValueError(msg)
    if name not in _warned:
        _warned.add(name)
        warnings.warn(msg, UnknownOptionWarning, stacklevel=3)


def config_generation() -> int:
    return _generation


def set_property(name: str, value) -> None:
    """Override a property for this process (wins over the environment)."""
    global _generation
    check_option_name(name)
    with _lock:
        _overrides[name] = value
        _generation += 1


def clear_property(name: str) -> None:
    global _generation
    check_option_name(name, raise_in_strict=False)
    with _lock:
        _overrides.pop(name, None)
        _generation += 1


@dataclass(frozen=True)
class SystemProperty:
    """A named, typed knob with programmatic and env-var overrides."""

    name: str
    default: Any

    @property
    def env_var(self) -> str:
        return self.name.replace(".", "_").upper()

    def get(self):
        check_option_name(self.name)
        with _lock:
            if self.name in _overrides:
                return _overrides[self.name]
        raw = os.environ.get(self.env_var)
        if raw is None:
            return self.default
        if isinstance(self.default, bool):
            return raw.strip().lower() in ("1", "true", "yes")
        if isinstance(self.default, int):
            return int(raw)
        if isinstance(self.default, float):
            return float(raw)
        return raw

    def to_int(self) -> int:
        return int(self.get())

    def to_bool(self) -> bool:
        return bool(self.get())


@dataclass(frozen=True)
class SchemaOption:
    """A declared per-schema option: a ``geomesa.*`` key read from a
    schema's user data (features/feature_type.py, the store), declared
    here only so the registry knows it; it resolves where it always did
    (``sft.user_data.get(...)``)."""

    name: str
    default: Any = None
    doc: str = ""


class ConfigProperties:
    """The config system's own knobs."""

    #: strict option mode: an undeclared ``geomesa.*`` name raises at
    #: ``set_property`` and at lookup instead of warning
    STRICT = SystemProperty("geomesa.config.strict", False)


class SchemaProperties:
    """Per-schema option declarations (the user-data keys the store and
    the feature types read)."""

    #: index layout profile: ``lean`` selects the tiered lean indexes
    INDEX_PROFILE = SchemaOption("geomesa.index.profile", "",
                                 "index layout profile ('lean')")
    #: explicit index-version pin list, or 'current'
    INDEX_VERSIONS = SchemaOption("geomesa.index.versions", "",
                                  "pin index versions")
    #: which attribute is THE temporal axis (else the first Date one)
    INDEX_DTG = SchemaOption("geomesa.index.dtg", "",
                             "temporal attribute override")
    #: comma list restricting which index kinds build
    INDICES_ENABLED = SchemaOption("geomesa.indices.enabled", "",
                                   "restrict built indexes")
    #: z3 time-bin interval: 'day' | 'week' | 'month' | 'year'
    Z3_INTERVAL = SchemaOption("geomesa.z3.interval", "week",
                               "z3 time-bin period")
    #: xz curve resolution (g in the XZ-ordering papers)
    XZ_PRECISION = SchemaOption("geomesa.xz.precision", 12,
                                "xz curve precision")
    #: feature-id minting strategy ('z3' = locality-preserving)
    FID_STRATEGY = SchemaOption("geomesa.fid.strategy", "",
                                "feature-id strategy")
    #: age-off retention expression (age_off.py)
    AGE_OFF = SchemaOption("geomesa.age.off", "",
                           "age-off retention window")
    #: registered query interceptors (planning/interceptor.py)
    QUERY_INTERCEPTORS = SchemaOption("geomesa.query.interceptors", "",
                                      "query interceptor chain")
    #: lean-profile device budget in bytes for this schema's tiers
    LEAN_HBM_BUDGET = SchemaOption("geomesa.lean.hbm.budget", 0,
                                   "lean device-tier byte budget")
    #: lean LSM size-tier factor (0 disables auto-compaction)
    LEAN_COMPACTION_FACTOR = SchemaOption(
        "geomesa.lean.compaction.factor", 4, "LSM size-tier factor")
    #: lean generation capacity in slots (rollover threshold)
    LEAN_GENERATION_SLOTS = SchemaOption(
        "geomesa.lean.generation.slots", 0, "generation slot capacity")


class QueryProperties:
    """Planner guardrails (QueryProperties.scala:17-44 equivalents)."""

    #: target number of scan ranges per query (split across time bins)
    SCAN_RANGES_TARGET = SystemProperty("geomesa.scan.ranges.target", 2000)
    #: query timeout in seconds; 0 disables (ThreadManagement reaper analog)
    QUERY_TIMEOUT = SystemProperty("geomesa.query.timeout", 0)
    #: refuse queries that would scan the full table (opt-in, like the
    #: reference's BlockFullTableScans)
    BLOCK_FULL_TABLE_SCANS = SystemProperty(
        "geomesa.scan.block.full.table", False)


class DensityProperties:
    """Density-pyramid knobs (docs/density.md): sealed lean generations
    precompute world-aligned multi-resolution density grids, so
    whole-extent heatmaps and zoomed-out tiles sum cached cells instead
    of rescanning history."""

    #: base pyramid resolution (cells per axis, a power of two): each
    #: sealed generation's pyramid starts at a (base, base) world grid
    #: and halves down from there.  A lean tile is a slice of the
    #: whole-world density while ``tile·2^z`` stays at or below it;
    #: finer tiles run a bbox density scan over the tile's envelope
    PYRAMID_BASE = SystemProperty("geomesa.density.pyramid.base", 512)
    #: reduction-ladder depth; 0 = the full ladder down to 1×1
    PYRAMID_LEVELS = SystemProperty("geomesa.density.pyramid.levels", 0)
    #: byte ceiling of a lean index's pyramid cache
    PYRAMID_CACHE_BYTES = SystemProperty(
        "geomesa.density.pyramid.cache.bytes", 256 * (1 << 20))
    #: build trigger: ``off`` (only explicit ``build_pyramids`` calls
    #: build) or ``seal`` (a generation seal runs one build-behind pass,
    #: never failing the write and never changing results)
    PYRAMID_BUILD = SystemProperty("geomesa.density.pyramid.build", "off")


class PlanningProperties:
    """Cost-based planning knobs (docs/planning.md): sketch-fed
    cardinality estimation and adaptive mid-query replanning, re-read
    per query plan."""

    #: sketch-fed estimation master switch: off costs strategies from
    #: whole-store stats and heuristics only
    ESTIMATOR_ENABLED = SystemProperty(
        "geomesa.planning.estimator.enabled", True)
    #: live-row floor below which a lean store plans without the sketch
    #: tier (the cold per-generation folds cannot amortize on a store a
    #: whole scan finishes quickly); 0 sketches every lean store
    ESTIMATOR_MIN_ROWS = SystemProperty(
        "geomesa.planning.estimator.min.rows", 262_144)
    #: assumed selectivity of an attribute equality with no usable stat
    SELECTIVITY_EQUALS_DEFAULT = SystemProperty(
        "geomesa.planning.selectivity.equals.default", 0.1)
    #: assumed selectivity of an attribute range or prefix with no usable
    #: stat
    SELECTIVITY_RANGE_DEFAULT = SystemProperty(
        "geomesa.planning.selectivity.range.default", 0.25)
    #: adaptive-replan divergence trigger: when a scan's candidate probe
    #: observes more than ``threshold × estimate`` rows, the scan aborts
    #: and the query replans ONCE with the observed count folded in;
    #: <= 0 disables replanning
    REPLAN_THRESHOLD = SystemProperty(
        "geomesa.planning.replan.threshold", 8.0)
    #: observed-row floor below which a divergence never replans
    REPLAN_MIN_ROWS = SystemProperty(
        "geomesa.planning.replan.min.rows", 4096)


class ResilienceProperties:
    """Resilience knobs: admission (resilience/admission.py), degraded
    execution (resilience/degrade.py) and fault injection
    (resilience/faults.py).  Everything defaults OFF: an unconfigured
    store admits every query and injects nothing."""

    #: device-memory admission ceiling in bytes: new queries shed
    #: (Backpressure) while the ``storage.total.device_bytes`` gauge
    #: exceeds this; 0 disables the check
    HBM_HEADROOM = SystemProperty("geomesa.resilience.hbm.headroom", 0)
    #: max concurrently admitted queries per process; 0 = unbounded
    ADMISSION_MAX_CONCURRENT = SystemProperty(
        "geomesa.resilience.admission.max.concurrent", 0)
    #: how long an over-budget request may queue (ms) before shedding
    ADMISSION_QUEUE_MS = SystemProperty(
        "geomesa.resilience.admission.queue.ms", 50.0)
    #: bounded retries after a transient device failure (device memory
    #: pressure) demotes the offending generations to the host tier
    RETRY_MAX = SystemProperty("geomesa.resilience.retry.max", 1)
    #: consecutive transient failures before a generation's device
    #: dispatch circuit opens (host-tier routing until cooldown)
    BREAKER_THRESHOLD = SystemProperty(
        "geomesa.resilience.breaker.threshold", 3)
    #: seconds an open breaker refuses device dispatch before half-open
    BREAKER_COOLDOWN_S = SystemProperty(
        "geomesa.resilience.breaker.cooldown.s", 30.0)
    #: armed fault points: comma-separated ``point[:trigger][=kind]``
    #: (resilience/faults.py); empty disables injection
    FAULT_POINTS = SystemProperty("geomesa.resilience.fault.points", "")
    #: seed of the probabilistic triggers: same seed and hit order, same
    #: injected failures
    FAULT_SEED = SystemProperty("geomesa.resilience.fault.seed", 0)


class ServingProperties:
    """Fused serving knobs (serving/fusion.py): coalescing concurrent
    compatible queries into one batched scan, and per-tenant fairness
    over it."""

    #: master switch for query fusion; False routes every request down
    #: the solo path untouched
    FUSE_ENABLED = SystemProperty("geomesa.serving.fuse.enabled", True)
    #: how long (ms) a batch leader lingers collecting riders before
    #: dispatching the fused batch
    FUSE_WINDOW_MS = SystemProperty("geomesa.serving.fuse.window.ms", 2.0)
    #: max requests fused into one batched scan; a full batch dispatches
    #: at once without waiting out the window
    FUSE_MAX_BATCH = SystemProperty("geomesa.serving.fuse.max.batch", 64)
    #: per-tenant queued-request ceiling; a tenant at its ceiling sheds
    #: (Backpressure) instead of growing the queue; 0 = unbounded
    TENANT_QUEUE_MAX = SystemProperty("geomesa.serving.tenant.queue.max", 0)
    #: deficit-round-robin quantum (requests) each tenant earns per
    #: batch-assembly pass
    TENANT_QUANTUM = SystemProperty("geomesa.serving.tenant.quantum", 4)


class ObsProperties:
    """Observability knobs (obs/).  The sampler and the slow threshold
    re-resolve whenever :func:`set_property` bumps the config generation;
    the trace capacities are read when a tracer is built."""

    #: master switch: off makes every span a shared no-op
    ENABLED = SystemProperty("geomesa.obs.enabled", True)
    #: root-span sampling: 'always', 'ratio', 'slow' or 'never'
    SAMPLER = SystemProperty("geomesa.obs.sampler", "always")
    #: fraction of root spans recorded under the 'ratio' sampler
    SAMPLE_RATIO = SystemProperty("geomesa.obs.sample.ratio", 0.1)
    #: slow-query threshold in ms (the slow log); <= 0 disables
    SLOW_MS = SystemProperty("geomesa.obs.slow.ms", 500.0)
    #: ring exporter capacity (traces)
    TRACE_CAPACITY = SystemProperty("geomesa.obs.trace.capacity", 256)
    #: JSONL sink cap in bytes (live file plus one rotated predecessor);
    #: <= 0 disables rotation
    TRACE_MAX_BYTES = SystemProperty("geomesa.obs.trace.max_bytes",
                                     128 * 2 ** 20)
    #: slow-query log capacity (traces)
    SLOW_CAPACITY = SystemProperty("geomesa.obs.slow.capacity", 64)
    #: spans a trace may record before children become no-ops (the root
    #: counts ``spans.dropped``); <= 0 disables the cap
    TRACE_MAX_SPANS = SystemProperty("geomesa.obs.trace.max.spans", 4096)
    #: the kernel-build watch (obs/recompile.py): count each completed
    #: ``nvcc`` build into the ``jax.compile.*`` metrics
    RECOMPILE_TRACK = SystemProperty("geomesa.obs.recompile.track", True)
    #: access-temperature tracking (obs/heat.py): per-(schema, index,
    #: generation) touch counters folded into a decayed temperature;
    #: off reduces every record site to one cached bool read
    HEAT_ENABLED = SystemProperty("geomesa.obs.heat.enabled", True)
    #: temperature decay constant τ in seconds: a touch contributes
    #: ``exp(-(now - t)/τ)`` to its generation's score
    HEAT_TAU_S = SystemProperty("geomesa.obs.heat.tau.s", 600.0)
    #: bound on tracked (schema, index, generation) entries; past it the
    #: coldest tenth evicts
    HEAT_MAX_ENTRIES = SystemProperty("geomesa.obs.heat.max.entries", 8192)
    #: finished job records the job registry keeps (obs/jobs.py)
    JOBS_CAPACITY = SystemProperty("geomesa.obs.jobs.capacity", 128)
    #: scrape cache of ``/metrics.prom`` (web/app.py): a scrape younger
    #: than this many ms is reused; <= 0 disables
    SCRAPE_MIN_INTERVAL_MS = SystemProperty(
        "geomesa.obs.scrape.min.interval.ms", 0.0)


class SloProperties:
    """SLO plane knobs (obs/slo.py): per-class latency objectives,
    rolling burn windows and the alert ring, re-read whenever the config
    generation moves."""

    #: master switch: off makes the trace finish hook a no-op
    ENABLED = SystemProperty("geomesa.slo.enabled", True)
    #: objectives, one per request class: comma-separated
    #: ``class:latency_ms:target`` triples.  A request spends budget when
    #: it errored or its latency (admission queue included) passed
    #: ``latency_ms``; burn = bad fraction / (1 - target)
    OBJECTIVES = SystemProperty(
        "geomesa.slo.objectives",
        "query:250:0.99,write:1000:0.99,tile.render:250:0.99")
    #: short burn window in seconds (the fast-burn signal)
    WINDOW_SHORT_S = SystemProperty("geomesa.slo.window.short.s", 300.0)
    #: long burn window in seconds (the sustained-burn confirmation)
    WINDOW_LONG_S = SystemProperty("geomesa.slo.window.long.s", 3600.0)
    #: rolling-window bucket width in seconds
    BUCKET_S = SystemProperty("geomesa.slo.bucket.s", 10.0)
    #: alert threshold: fires (edge-triggered) when both windows burn
    #: past it, re-arms when the short one drops back; <= 0 disables
    BURN_ALERT = SystemProperty("geomesa.slo.burn.alert", 10.0)
    #: alert ring capacity (threshold crossings kept)
    ALERTS_CAPACITY = SystemProperty("geomesa.slo.alerts.capacity", 128)
    #: distinct-tenant label bound: past it new tenants fold into
    #: ``other``
    TENANTS_MAX = SystemProperty("geomesa.slo.tenants.max", 64)


class ArrowProperties:
    """Arrow result path knobs (the ``geomesa.arrow.*`` family), re-read
    a stream, so a live serving process can be tuned."""

    #: rows a record batch on the streaming result path
    #: (``store.query_arrow``'s default when ``chunk_rows`` is not passed)
    CHUNK_ROWS = SystemProperty("geomesa.arrow.chunk.rows", 65536)
    #: distinct-value ceiling of AUTO dictionary encoding: a string
    #: attribute dictionary-encodes only while its sampled cardinality
    #: stays at or below it; past it the column ships as plain utf8
    DICTIONARY_THRESHOLD = SystemProperty(
        "geomesa.arrow.dictionary.threshold", 1024)
    #: flush threshold (bytes) of :func:`~geomesa_tpu_torch.arrow.
    #: ipc_chunks`: encoded IPC messages coalesce until at least this
    #: many bytes are buffered; <= 0 flushes a batch at a time
    STREAM_BUFFER_BYTES = SystemProperty(
        "geomesa.arrow.stream.buffer.bytes", 1 << 20)


def _register_declarations() -> None:
    """Fill the option registry from the declaration classes above: the
    one place a knob becomes known to the strict mode."""
    for cls in (QueryProperties, ObsProperties, SchemaProperties,
                ConfigProperties, ResilienceProperties, ServingProperties,
                DensityProperties, PlanningProperties, SloProperties,
                ArrowProperties):
        for value in vars(cls).values():
            if isinstance(value, (SystemProperty, SchemaOption)):
                _REGISTRY[value.name] = value


_register_declarations()


#: default scan-ranges budget (import-time snapshot users can override per
#: call; the live knob is QueryProperties.SCAN_RANGES_TARGET)
DEFAULT_MAX_RANGES = QueryProperties.SCAN_RANGES_TARGET.default
