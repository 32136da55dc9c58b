"""Dapper-style query tracing: spans, samplers, exporters, one tracer.

A query is ONE trace: a ``trace_id`` plus a tree of timed :class:`Span`\\ s
(plan / decompose / device scan / host scan / post-filter, each carrying
attributes such as device ms, runs and bytes scanned, cache hits),
propagated through the call stack by a ``contextvars.ContextVar`` so
index internals attach to whatever query is running without a handle
threaded through every signature.  The span names, attributes and JSON
keys are the JAX package's (``geomesa_tpu/obs/trace.py``).

Sampling is head and tail: the sampler decides at the root span whether
to RECORD (``sample``) and at trace end whether to RETAIN (``retain``):
``always`` records everything, ``ratio`` a fraction, ``slow`` records
everything but retains only traces at or over the slow threshold.  While
the slow log is on (``geomesa.obs.slow.ms`` > 0), every finished trace at
or over the threshold also lands in the slow-query log, including roots
the ratio sampler declined (the ``never`` sampler is a true off switch).

:func:`device_span` times a block that ends in a device→host copy
(``.cpu()``, ``.item()``, ``.numpy()``), the copy that waits for the
card's queued work, so the block's wall time is the device round trip.
A span never adds a ``torch.cuda.synchronize()`` of its own: a site whose
work ends without a copy carries no device span.

Spans are process-local only: nothing here enters a collective, so
tracing can never diverge a multihost program.  When tracing is disabled
(or a root was not sampled) every ``span()`` yields a shared no-op whose
methods do nothing: the hot path pays one contextvar read.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import random
import sys
import threading
import time
from collections import deque

from ..config import ObsProperties, config_generation
from ..metrics import (
    LEAN_DEVICE_DISPATCHES, LEAN_DEVICE_MS, OBS_SPANS_DROPPED,
    registry as _metrics,
)

__all__ = ["Span", "Trace", "Tracer", "Sampler", "AlwaysSampler",
           "NeverSampler", "RatioSampler", "SlowOnlySampler",
           "RingExporter", "JsonlExporter", "tracer", "span",
           "device_span", "current_span", "current_trace_id",
           "obs_count"]


#: process-local id source: ``uuid4`` reads ``os.urandom`` (~80 µs per
#: id — measured dominating span cost); a Mersenne stream seeded from
#: urandom once gives the same 64-bit uniqueness for ~1 µs
_ids = random.Random()


def _new_id() -> str:
    return f"{_ids.getrandbits(64):016x}"


class Span:
    """One timed phase of a trace.  ``duration_ms`` (alias ``ms``) is
    set when the ``span()`` block exits; ``attributes`` is free-form
    (JSON-safe values only — it serializes on export)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start_ts",
                 "duration_ms", "attributes", "_t0")

    recording = True

    def __init__(self, trace_id: str, parent_id: str | None, name: str,
                 attributes: dict):
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.name = name
        self.start_ts = time.time()
        self.duration_ms = 0.0
        self.attributes = attributes
        self._t0 = time.perf_counter()

    @property
    def ms(self) -> float:
        return self.duration_ms

    def set_attr(self, key: str, value) -> None:
        self.attributes[key] = value

    def add_attr(self, key: str, n=1) -> None:
        """Accumulate a numeric attribute (cache hit counts, device ms
        rollups — anything incremented from multiple sites)."""
        self.attributes[key] = self.attributes.get(key, 0) + n

    def to_json(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "start_ts": self.start_ts,
                "duration_ms": round(self.duration_ms, 3),
                "attributes": self.attributes}


class _NoopSpan:
    """Shared do-nothing span: what ``span()`` yields when tracing is
    off or the root was not sampled."""

    __slots__ = ()
    recording = False
    trace_id = ""
    span_id = ""
    parent_id = None
    name = ""
    duration_ms = 0.0
    ms = 0.0
    start_ts = 0.0
    attributes: dict = {}

    def set_attr(self, key, value) -> None:
        pass

    def add_attr(self, key, n=1) -> None:
        pass

    def to_json(self) -> dict:
        return {}


NOOP_SPAN = _NoopSpan()


class Trace:
    """A finished (or in-flight) trace: its id, root span, and every
    finished span in FINISH order (the root is appended last)."""

    __slots__ = ("trace_id", "spans", "root_span")

    def __init__(self, trace_id: str):
        self.trace_id = trace_id
        self.spans: list[Span] = []
        self.root_span: Span | None = None

    @property
    def name(self) -> str:
        return self.root_span.name if self.root_span is not None else ""

    @property
    def duration_ms(self) -> float:
        return (self.root_span.duration_ms
                if self.root_span is not None else 0.0)

    def summary(self) -> dict:
        root = self.root_span
        return {"trace_id": self.trace_id, "name": self.name,
                "duration_ms": round(self.duration_ms, 3),
                "spans": len(self.spans),
                "start_ts": root.start_ts if root else 0.0,
                "attributes": dict(root.attributes) if root else {}}

    def to_json(self) -> dict:
        return {"trace_id": self.trace_id, "name": self.name,
                "duration_ms": round(self.duration_ms, 3),
                "spans": [s.to_json() for s in self.spans]}


# -- samplers -------------------------------------------------------------
class Sampler:
    """Head (``sample``) + tail (``retain``) decisions; base = always."""

    def sample(self, name: str) -> bool:
        return True

    def retain(self, trace: Trace) -> bool:
        return True


class AlwaysSampler(Sampler):
    pass


class NeverSampler(Sampler):
    def sample(self, name: str) -> bool:
        return False


class RatioSampler(Sampler):
    """Record a fraction of root spans (head-based)."""

    def __init__(self, ratio: float):
        self.ratio = max(0.0, min(1.0, float(ratio)))

    def sample(self, name: str) -> bool:
        return random.random() < self.ratio


class SlowOnlySampler(Sampler):
    """Record everything, retain only slower-than-threshold traces
    (tail-based — duration is unknowable at the head)."""

    def __init__(self, threshold_ms: float):
        self.threshold_ms = float(threshold_ms)

    def retain(self, trace: Trace) -> bool:
        return trace.duration_ms >= self.threshold_ms


_ALWAYS = AlwaysSampler()


# -- exporters ------------------------------------------------------------
class RingExporter:
    """Bounded in-memory trace store (what :meth:`Tracer.find` reads back)."""

    def __init__(self, capacity: int = 256):
        self._traces: deque[Trace] = deque(maxlen=int(capacity))
        self._lock = threading.Lock()

    def export(self, trace: Trace) -> None:
        with self._lock:
            self._traces.append(trace)

    def traces(self) -> list[Trace]:
        with self._lock:
            return list(self._traces)

    def get(self, trace_id: str) -> Trace | None:
        with self._lock:
            for t in self._traces:
                if t.trace_id == trace_id:
                    return t
        return None

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)


class JsonlExporter:
    """Append finished traces as JSON lines (the durable sink; same
    line-buffered open-once discipline as audit.JsonlAuditWriter).

    The sink is size-capped: once the live file would pass HALF of
    ``geomesa.obs.trace.max_bytes`` (or the explicit ``max_bytes``),
    it rotates to ``<path>.1`` (replacing any previous rollover), so a
    long run retains the newest ~N MB of traces across at most
    two files instead of growing without bound.  A cap of <= 0
    disables rotation."""

    def __init__(self, path: str, max_bytes: int | None = None):
        self.path = path
        self._max_override = max_bytes
        self._lock = threading.Lock()
        self._file = None
        self._bytes = 0

    def _max_bytes(self) -> int:
        if self._max_override is not None:
            return int(self._max_override)
        return ObsProperties.TRACE_MAX_BYTES.to_int()

    def export(self, trace: Trace) -> None:
        line = json.dumps(trace.to_json(), default=str) + "\n"
        with self._lock:
            if self._file is None:
                self._file = open(self.path, "a", buffering=1)
                try:
                    self._bytes = os.path.getsize(self.path)
                except OSError:
                    self._bytes = 0
            cap = self._max_bytes()
            if (cap > 0 and self._bytes
                    and self._bytes + len(line) > cap // 2):
                self._rotate()
            self._file.write(line)
            self._bytes += len(line)

    def _rotate(self) -> None:
        """Roll the live file to ``<path>.1`` (lock held).  One rolled
        predecessor is kept, so total retention is bounded by the cap
        (half live + half rolled)."""
        try:
            self._file.close()
        except OSError:
            pass   # flush failure (e.g. ENOSPC) — fall through: the
            #        replace/reopen below still bound the sink
        # None while reopening: if open() raises, the next export
        # retries from a clean slate instead of writing to a closed file
        self._file = None
        try:
            os.replace(self.path, self.path + ".1")
        except OSError:
            pass   # a lost rollover only loses history, never traces
        self._file = open(self.path, "a", buffering=1)
        # re-stat instead of assuming 0: if the replace failed, the old
        # contents are still in the live file and must keep counting
        # against the cap, or a persistent failure grows it unbounded
        try:
            self._bytes = os.path.getsize(self.path)
        except OSError:
            self._bytes = 0

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


# -- tracer ---------------------------------------------------------------
class _Ctx:
    """Contextvar node: the active trace (None = declined root — child
    spans short-circuit to the no-op), current span, and the sampler
    that made the root decision."""

    __slots__ = ("trace", "span", "sampler")

    def __init__(self, trace, span, sampler):
        self.trace = trace
        self.span = span
        self.sampler = sampler


_current: contextvars.ContextVar = contextvars.ContextVar(
    "geomesa_obs_span", default=None)
_DECLINED = _Ctx(None, NOOP_SPAN, _ALWAYS)
#: active EXPLAIN ANALYZE collector (Tracer.capture): roots opened in
#: this context RECORD regardless of sampler/enabled and their
#: finished traces land in the collector — an explicit "explain this
#: query" ask must never come back empty because the operator had
#: sampling turned down
_capture: contextvars.ContextVar = contextvars.ContextVar(
    "geomesa_obs_capture", default=None)


class Tracer:
    """Creates spans, finishes traces, routes them to exporters and the
    slow-query log.  The sampler kind and slow threshold re-resolve from
    ``geomesa.obs.*`` options per root/finish (live-tunable); a sampler
    passed to the constructor pins the choice instead."""

    def __init__(self, sampler: Sampler | None = None, exporters=None,
                 slow_capacity: int | None = None):
        self._pinned_sampler = sampler
        self.exporters = list(exporters) if exporters is not None else [
            RingExporter(ObsProperties.TRACE_CAPACITY.to_int())]
        self.slow_log = RingExporter(
            slow_capacity if slow_capacity is not None
            else ObsProperties.SLOW_CAPACITY.to_int())
        # resolved-config cache keyed on config_generation(): the span
        # hot path pays one plain int read, not the override lock; any
        # set_property/clear_property bumps the generation and the next
        # span re-resolves (env-var changes need a set_property nudge)
        self._cfg_gen = -1
        self._cfg_enabled = True
        self._cfg_sampler: Sampler = _ALWAYS
        self._cfg_slow_ms = 0.0
        self._cfg_max_spans = 0
        # finish hooks: called for EVERY naturally finished root trace
        # with (trace, retained) — retained says
        # whether the trace also landed in the exporters, i.e. whether
        # its trace_id will resolve through :meth:`find`
        self._finish_hooks: list = []

    def _refresh_config(self) -> None:
        gen = config_generation()
        if gen != self._cfg_gen:
            self._cfg_enabled = ObsProperties.ENABLED.to_bool()
            self._cfg_sampler = self._resolve_sampler()
            self._cfg_slow_ms = float(ObsProperties.SLOW_MS.get())
            self._cfg_max_spans = ObsProperties.TRACE_MAX_SPANS.to_int()
            self._cfg_gen = gen

    def add_finish_hook(self, fn) -> None:
        """Register ``fn(trace, retained)`` to run on every finished
        root trace (after exporter/slow-log routing).  Hooks must be
        cheap and must not raise — a raising hook is logged and the
        query proceeds."""
        if fn not in self._finish_hooks:
            self._finish_hooks.append(fn)

    def remove_finish_hook(self, fn) -> None:
        try:
            self._finish_hooks.remove(fn)
        except ValueError:
            pass

    @property
    def ring(self) -> RingExporter | None:
        for e in self.exporters:
            if isinstance(e, RingExporter):
                return e
        return None

    def _resolve_sampler(self) -> Sampler:
        if self._pinned_sampler is not None:
            return self._pinned_sampler
        kind = str(ObsProperties.SAMPLER.get()).lower()
        if kind == "ratio":
            return RatioSampler(float(ObsProperties.SAMPLE_RATIO.get()))
        if kind in ("slow", "slow-only", "slow_only"):
            return SlowOnlySampler(float(ObsProperties.SLOW_MS.get()))
        if kind in ("never", "off", "none"):
            return NeverSampler()
        return _ALWAYS

    @contextlib.contextmanager
    def span(self, name: str, **attributes):
        """Open a span: a root (new trace, sampler consulted) when no
        span is active in this context, else a child of the current
        one.  Yields the :class:`Span` (or the shared no-op)."""
        self._refresh_config()
        if not self._cfg_enabled and _capture.get() is None:
            yield NOOP_SPAN
            return
        parent = _current.get()
        if parent is not None and parent.trace is None:
            yield NOOP_SPAN       # inside a declined trace
            return
        sampled = True
        natural = True
        if parent is None:
            sampler = self._cfg_sampler
            sampled = sampler.sample(name)
            # would this root have recorded WITHOUT a capture in play?
            # Capture-only roots must stay out of the shared ring and
            # slow log — an operator who turned tracing off (or 'never')
            # asked for those surfaces to stay silent
            natural = self._cfg_enabled and (
                sampled or (self._cfg_slow_ms > 0
                            and not isinstance(sampler, NeverSampler)))
            if not sampled and _capture.get() is None \
                    and (self._cfg_slow_ms <= 0
                         or isinstance(sampler, NeverSampler)):
                # head-declined with the slow log off — or tracing
                # explicitly 'never': the genuinely free path, no
                # trace object at all
                token = _current.set(_DECLINED)
                try:
                    yield NOOP_SPAN
                finally:
                    _current.reset(token)
                return
            # head-declined roots still RECORD while the slow log is
            # on (a 30s query must be explainable even when the ratio
            # sampler would have dropped it) — _finish routes them to
            # the slow log only, never the exporters
            trace = Trace(_new_id())
            sp = Span(trace.trace_id, None, name, dict(attributes))
            trace.root_span = sp
        else:
            trace = parent.trace
            sampler = parent.sampler
            if self._cfg_max_spans > 0 \
                    and len(trace.spans) >= self._cfg_max_spans:
                # pathological trace (10k-generation scan): stop
                # recording children, count the overflow on the root so
                # the truncation is visible in the span tree
                if trace.root_span is not None:
                    trace.root_span.add_attr("spans.dropped", 1)
                _metrics.counter(OBS_SPANS_DROPPED).inc()
                yield NOOP_SPAN
                return
            sp = Span(trace.trace_id, parent.span.span_id, name,
                      dict(attributes))
        token = _current.set(_Ctx(trace, sp, sampler))
        try:
            yield sp
        finally:
            exc = sys.exc_info()[1]
            if exc is not None:
                # the error signal: a root that exits via
                # an exception is a failed request for RED accounting
                sp.set_attr("error", type(exc).__name__)
            sp.duration_ms = (time.perf_counter() - sp._t0) * 1e3
            trace.spans.append(sp)
            _current.reset(token)
            if parent is None:
                self._finish(trace, sampler, sampled, natural)

    def _finish(self, trace: Trace, sampler: Sampler,
                sampled: bool = True, natural: bool = True) -> None:
        retained = natural and sampled and sampler.retain(trace)
        if retained:
            for e in self.exporters:
                try:
                    e.export(trace)
                except Exception:
                    # a broken sink (ENOSPC in the JSONL file, a dead
                    # disk) must never fail the QUERY whose trace this
                    # is — same discipline as PeriodicReporter
                    import logging
                    logging.getLogger("geomesa_tpu_torch.obs").warning(
                        "trace exporter failed", exc_info=True)
        cap = _capture.get()
        if cap is not None:
            # EXPLAIN ANALYZE collector: gets every root finished in
            # its context, independent of the sampler's verdict
            cap.export(trace)
        if natural:
            slow_ms = self._cfg_slow_ms
            if slow_ms > 0 and trace.duration_ms >= slow_ms:
                self.slow_log.export(trace)
            for h in self._finish_hooks:
                try:
                    h(trace, retained)
                except Exception:
                    import logging
                    logging.getLogger("geomesa_tpu_torch.obs").warning(
                        "trace finish hook failed", exc_info=True)

    @contextlib.contextmanager
    def capture(self, capacity: int = 16):
        """Force-record root spans opened in this context and collect
        their finished traces locally (the EXPLAIN ANALYZE hook):
        yields a :class:`RingExporter` that receives every root trace
        finished inside the block, regardless of the configured
        sampler — and even with ``geomesa.obs.enabled=false``, since
        an explicit explain request IS the ask to trace.  The shared
        ring and slow log receive a captured trace only when the root
        would have recorded WITHOUT the capture (the ``natural`` gate
        in ``_finish``), so capturing never makes tracing-off or
        'never' surfaces non-silent."""
        collector = RingExporter(capacity)
        token = _capture.set(collector)
        try:
            yield collector
        finally:
            _capture.reset(token)

    def find(self, trace_id: str) -> Trace | None:
        """Look a trace up across the ring exporter and the slow log."""
        ring = self.ring
        t = ring.get(trace_id) if ring is not None else None
        return t if t is not None else self.slow_log.get(trace_id)


#: process-wide tracer (the shared-MetricRegistry analog for traces)
tracer = Tracer()


def span(name: str, **attributes):
    """Module-level shorthand for ``tracer.span`` — the one import the
    instrumented layers need."""
    return tracer.span(name, **attributes)


def current_span() -> Span | None:
    """The recording span active in this context, else None."""
    ctx = _current.get()
    return ctx.span if ctx is not None and ctx.trace is not None else None


def current_trace_id() -> str:
    """The active trace id, or "" — what audit events stamp."""
    ctx = _current.get()
    return ctx.trace.trace_id if ctx is not None and ctx.trace is not None \
        else ""


#: the device metrics are process singletons — resolve them once so a
#: dispatch pays the metric's own lock, not a registry lookup too
_DEV_DISPATCHES = _metrics.counter(LEAN_DEVICE_DISPATCHES)
_DEV_MS = _metrics.timer(LEAN_DEVICE_MS)


@contextlib.contextmanager
def device_span(name: str, **attributes):
    """A span around one device dispatch.  The block must end in the
    device→host copy that materializes its results (``.cpu()``,
    ``.item()``, ``.numpy()``), so the measured wall time IS the device
    round trip; it records as
    the span's ``device_ms``, accumulates onto the trace ROOT (whole-
    query device attribution), and feeds the ``lean.device.*``
    metrics whether or not a trace is active."""
    t0 = time.perf_counter()
    with tracer.span(name, kind="device", **attributes) as sp:
        try:
            yield sp
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            _DEV_DISPATCHES.inc()
            _DEV_MS.update(ms)
            sp.set_attr("device_ms", round(ms, 3))
            ctx = _current.get()
            if ctx is not None and ctx.trace is not None \
                    and ctx.trace.root_span is not None \
                    and ctx.trace.root_span is not sp:
                ctx.trace.root_span.add_attr("device_ms", round(ms, 3))


def obs_count(metric_name: str, n: int = 1) -> None:
    """Increment a registry counter AND mirror it onto the current
    span's attributes — how cache hits/misses and other per-query
    events attribute to the query that caused them."""
    _metrics.counter(metric_name).inc(n)
    sp = current_span()
    if sp is not None:
        sp.add_attr(metric_name, n)
