"""The SLO plane: objectives, burn rates, exemplars, alerts.

The aggregation half of the SLO layer (attribution.py is the
decomposition half): a :class:`SloPlane` registered as a tracer finish
hook folds every completed ``query`` / ``write`` / ``tile.render`` trace
into

- per-class stage timers, ``slo.<class>.stage.<stage>.ms``;
- per-class and per-tenant RED metrics (``slo.<class>.requests`` /
  ``.errors`` / ``.total.ms``; ``slo.tenant.<t>.*``);
- rolling time-bucket windows per (class, tenant) behind the short and
  long **error-budget burn** against the objectives of
  ``geomesa.slo.objectives``; and
- an :class:`ExemplarHistogram` per class whose buckets keep the newest
  retained ``trace_id``, rendered in OpenMetrics exemplar syntax
  (``# {trace_id="..."}``) after the Prometheus text.

Burn is the fraction of requests that were *bad* (errored, or slower
than the class objective) over the budget ``1 - target``.  The alert
fires edge-triggered when BOTH windows burn past
``geomesa.slo.burn.alert`` and re-arms when the short window recovers;
crossings land in a bounded ring (:meth:`SloPlane.alerts`).

The plane sees only traces the tracer RECORDS: every request under the
default ``always`` sampler, a sample under ``ratio``, nothing under
``never``.  Its clock is the module's ``_clock`` (wall seconds), which a
test replaces to move the windows without sleeping.  The metric keys,
the report and the exposition are the JAX package's
(``geomesa_tpu/obs/slo.py``).
"""

from __future__ import annotations

import math
import re
import threading
import time
from collections import deque

from ..config import SloProperties, config_generation
from ..metrics import (
    ALERT_SLO_ACTIVE, ALERT_SLO_FIRED, registry as _metrics,
)
from . import attribution
from .prom import metric_name
from .trace import Trace

__all__ = ["SloPlane", "ExemplarHistogram", "Objective", "slo_plane"]

_SEGMENT_RE = re.compile(r"[^A-Za-z0-9_:\-]")

#: same log-bucket geometry as the registry histograms (metrics.py):
#: bucket b holds values in (BASE**(b-1), BASE**b]
_Q_BASE = 1.15
_Q_LOG = math.log(_Q_BASE)

#: the plane's clock (wall seconds): windows, alerts and exemplar stamps
#: read it; tests replace it
_clock = time.time


class Objective:
    """One class's SLO: requests complete under ``latency_ms`` with
    ``target`` success fraction (e.g. 250 ms at 0.99)."""

    __slots__ = ("cls", "latency_ms", "target")

    def __init__(self, cls: str, latency_ms: float, target: float):
        self.cls = cls
        self.latency_ms = float(latency_ms)
        self.target = min(max(float(target), 0.0), 0.999999)

    def to_json(self) -> dict:
        return {"class": self.cls, "latency_ms": self.latency_ms,
                "target": self.target}


def _parse_objectives(spec: str) -> dict[str, Objective]:
    """Parse ``geomesa.slo.objectives``: comma-separated
    ``class:latency_ms:target`` triples.  Malformed entries are
    skipped (config must never crash the serving path)."""
    out: dict[str, Objective] = {}
    for part in str(spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.rsplit(":", 2)
        if len(bits) != 3:
            continue
        try:
            out[bits[0]] = Objective(bits[0], float(bits[1]),
                                     float(bits[2]))
        except ValueError:
            continue
    return out


class ExemplarHistogram:
    """A latency histogram whose buckets remember the newest trace_id
    that landed in them — the join key between a bad bucket on a
    dashboard and the span tree that explains it.

    Kept OUTSIDE the metric registry (the registry's histograms carry
    no per-bucket metadata and the naming lint walks registry keys):
    this renders itself directly as OpenMetrics classic-histogram text
    with exemplar suffixes, appended after ``prometheus_text`` output.
    """

    __slots__ = ("_buckets", "_count", "_sum", "_lock")

    def __init__(self):
        # bucket index -> [count, trace_id, value, ts]
        self._buckets: dict[int, list] = {}
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def update(self, value_ms: float, trace_id: str = "") -> None:
        b = 0 if value_ms <= 0 else int(
            math.ceil(math.log(value_ms) / _Q_LOG))
        with self._lock:
            ent = self._buckets.get(b)
            if ent is None:
                ent = self._buckets[b] = [0, "", 0.0, 0.0]
            ent[0] += 1
            if trace_id:
                ent[1] = trace_id
                ent[2] = value_ms
                ent[3] = _clock()
            self._count += 1
            self._sum += value_ms

    def exemplars(self) -> list[dict]:
        """Retained exemplars, slowest bucket first (the report's worst
        recent traces)."""
        with self._lock:
            items = [(b, list(e)) for b, e in self._buckets.items()
                     if e[1]]
        items.sort(reverse=True)
        return [{"bucket_le_ms": round(_Q_BASE ** b, 3),
                 "trace_id": e[1], "value_ms": round(e[2], 3),
                 "ts": e[3]} for b, e in items]

    def render(self, name: str) -> list[str]:
        """OpenMetrics classic histogram lines: cumulative buckets
        (exemplar-suffixed where one is retained), +Inf, _sum/_count."""
        with self._lock:
            items = sorted((b, list(e)) for b, e in self._buckets.items())
            count, total = self._count, self._sum
        lines = [f"# TYPE {name} histogram"]
        cum = 0
        for b, e in items:
            cum += e[0]
            le = repr(round(_Q_BASE ** b, 6))
            line = f'{name}_bucket{{le="{le}"}} {cum}'
            if e[1]:
                line += (f' # {{trace_id="{e[1]}"}} '
                         f"{repr(round(e[2], 6))}")
            lines.append(line)
        lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{name}_sum {repr(round(total, 6))}")
        lines.append(f"{name}_count {count}")
        return lines

    def reset(self) -> None:
        with self._lock:
            self._buckets.clear()
            self._count = 0
            self._sum = 0.0


class SloPlane:
    """Aggregates attribution results into SLO signals (see module
    docstring).  One process-wide instance (``slo_plane``) is wired as
    a tracer finish hook at obs package import."""

    def __init__(self):
        self._lock = threading.RLock()
        # (class, tenant) -> deque of [bucket_idx, count, bad, errors]
        self._windows: dict[tuple[str, str], deque] = {}
        self._exemplars: dict[str, ExemplarHistogram] = {}
        # class -> [root_ms_sum, unattributed_ms_sum] for the residual
        # gauge (cumulative — a ratio of totals, not of quantiles)
        self._residual: dict[str, list] = {}
        self._alerts: deque = deque(maxlen=128)
        self._alert_active: dict[str, bool] = {}
        self._tenants: set[str] = set()
        # config-generation cache (same discipline as Tracer)
        self._cfg_gen = -1
        self._cfg_enabled = True
        self._cfg_objectives: dict[str, Objective] = {}
        self._cfg_short_s = 300.0
        self._cfg_long_s = 3600.0
        self._cfg_bucket_s = 10.0
        self._cfg_burn_alert = 10.0
        self._cfg_tenants_max = 64

    def _refresh_config(self) -> None:
        gen = config_generation()
        if gen != self._cfg_gen:
            self._cfg_enabled = SloProperties.ENABLED.to_bool()
            self._cfg_objectives = _parse_objectives(
                SloProperties.OBJECTIVES.get())
            self._cfg_short_s = float(SloProperties.WINDOW_SHORT_S.get())
            self._cfg_long_s = float(SloProperties.WINDOW_LONG_S.get())
            self._cfg_bucket_s = max(
                1.0, float(SloProperties.BUCKET_S.get()))
            self._cfg_burn_alert = float(SloProperties.BURN_ALERT.get())
            self._cfg_tenants_max = SloProperties.TENANTS_MAX.to_int()
            cap = SloProperties.ALERTS_CAPACITY.to_int()
            if cap != (self._alerts.maxlen or 0):
                with self._lock:
                    self._alerts = deque(self._alerts, maxlen=max(1, cap))
            self._cfg_gen = gen

    # -- identity helpers -------------------------------------------------
    def _tenant_key(self, tenant: str) -> str:
        """Sanitized, bounded tenant label: past ``geomesa.slo.
        tenants.max`` distinct tenants, new ones fold into ``other``
        so a tenant-id flood cannot balloon the registry."""
        t = _SEGMENT_RE.sub("_", tenant) if tenant else ""
        if not t:
            return "default"
        with self._lock:
            if t in self._tenants:
                return t
            if len(self._tenants) >= self._cfg_tenants_max:
                return "other"
            self._tenants.add(t)
            return t

    def classes(self) -> tuple[str, ...]:
        self._refresh_config()
        return tuple(self._cfg_objectives)

    # -- ingestion --------------------------------------------------------
    def on_trace_finish(self, trace: Trace, retained: bool) -> None:
        """Tracer finish hook: attribute the trace and fold it in.
        Fast-exits for disabled plane or classes with no objective."""
        self._refresh_config()
        if not self._cfg_enabled:
            return
        root = trace.root_span
        if root is None or root.name not in self._cfg_objectives:
            return
        att = attribution.attribute(trace)
        if att is None:
            return
        cls = att["class"]
        obj = self._cfg_objectives[cls]
        tenant = self._tenant_key(att["tenant"])
        total_ms = att["total_ms"]
        error = att["error"]
        bad = error or total_ms > obj.latency_ms

        for stage, ms in att["stages"].items():
            if ms > 0.0:
                _metrics.timer(f"slo.{cls}.stage.{stage}.ms").update(ms)
        _metrics.timer(f"slo.{cls}.total.ms").update(total_ms)
        _metrics.counter(f"slo.{cls}.requests").inc()
        if error:
            _metrics.counter(f"slo.{cls}.errors").inc()
        _metrics.counter(f"slo.tenant.{tenant}.requests").inc()
        _metrics.timer(f"slo.tenant.{tenant}.ms").update(total_ms)
        if error:
            _metrics.counter(f"slo.tenant.{tenant}.errors").inc()

        with self._lock:
            res = self._residual.setdefault(cls, [0.0, 0.0])
            res[0] += att["root_ms"]
            res[1] += att["stages"]["unattributed"]
            hist = self._exemplars.get(cls)
            if hist is None:
                hist = self._exemplars[cls] = ExemplarHistogram()
        # exemplars only for retained traces: an exemplar that 404s at
        # /traces/<id> is worse than none
        hist.update(total_ms, att["trace_id"] if retained else "")
        self._fold_window(cls, tenant, bad, error)
        self._check_alert(cls, obj)

    def observe_web(self, endpoint: str, tenant: str, status: int,
                    total_ms: float, drain_ms: float = 0.0,
                    aborted: bool = False) -> None:
        """Web middleware feed: per-endpoint RED plus the web_drain
        stage (response streaming time — outside the datastore root
        span, so only the WSGI layer can see it).  Endpoint RED is
        separate from class RED on purpose: a request can 400 before
        any trace exists."""
        self._refresh_config()
        if not self._cfg_enabled:
            return
        ep = _SEGMENT_RE.sub("_", endpoint) or "other"
        _metrics.counter(f"slo.web.{ep}.requests").inc()
        _metrics.timer(f"slo.web.{ep}.ms").update(total_ms)
        if aborted or status >= 500:
            _metrics.counter(f"slo.web.{ep}.errors").inc()
        if drain_ms > 0.0:
            cls = {"query": "query", "tiles": "tile.render"}.get(ep)
            if cls is not None and cls in self._cfg_objectives:
                _metrics.timer(f"slo.{cls}.stage.web_drain.ms").update(
                    drain_ms)

    def _fold_window(self, cls: str, tenant: str, bad: bool,
                     error: bool) -> None:
        now = _clock()
        idx = int(now / self._cfg_bucket_s)
        horizon = idx - int(self._cfg_long_s / self._cfg_bucket_s) - 1
        with self._lock:
            win = self._windows.setdefault((cls, tenant), deque())
            if win and win[-1][0] == idx:
                ent = win[-1]
            else:
                ent = [idx, 0, 0, 0]
                win.append(ent)
            ent[1] += 1
            ent[2] += 1 if bad else 0
            ent[3] += 1 if error else 0
            while win and win[0][0] < horizon:
                win.popleft()

    # -- burn -------------------------------------------------------------
    def burn(self, cls: str, window_s: float) -> float:
        """Error-budget burn for ``cls`` over the trailing
        ``window_s``: bad fraction / (1 - target), summed across
        tenants.  0.0 with no traffic (no news is good news)."""
        self._refresh_config()
        obj = self._cfg_objectives.get(cls)
        if obj is None:
            return 0.0
        lo = int((_clock() - window_s) / self._cfg_bucket_s)
        total = bad = 0
        with self._lock:
            for (c, _t), win in self._windows.items():
                if c != cls:
                    continue
                for idx, n, b, _e in win:
                    if idx >= lo:
                        total += n
                        bad += b
        if total == 0:
            return 0.0
        budget = 1.0 - obj.target
        return (bad / total) / budget if budget > 0 else 0.0

    def _check_alert(self, cls: str, obj: Objective) -> None:
        """Edge-triggered multi-window alert: fire when BOTH windows
        burn over threshold; re-arm when the short window recovers."""
        thr = self._cfg_burn_alert
        if thr <= 0:
            return
        short = self.burn(cls, self._cfg_short_s)
        longb = self.burn(cls, self._cfg_long_s)
        with self._lock:
            active = self._alert_active.get(cls, False)
            if short > thr and longb > thr and not active:
                self._alert_active[cls] = True
                self._alerts.append({
                    "ts": _clock(), "class": cls,
                    "burn_short": round(short, 3),
                    "burn_long": round(longb, 3),
                    "threshold": thr,
                    "objective": obj.to_json(),
                })
                _metrics.counter(ALERT_SLO_FIRED).inc()
            elif active and short <= thr:
                self._alert_active[cls] = False
            _metrics.gauge(ALERT_SLO_ACTIVE).set(
                sum(1 for v in self._alert_active.values() if v))

    # -- read surfaces ----------------------------------------------------
    def publish(self) -> None:
        """Refresh the derived gauges (burn per window, residual pct)
        — called before a snapshot is rendered, the same
        publish-on-scrape discipline as the storage gauges."""
        self._refresh_config()
        if not self._cfg_enabled:
            return
        for cls in self._cfg_objectives:
            _metrics.gauge(f"slo.{cls}.burn.5m").set(
                round(self.burn(cls, self._cfg_short_s), 4))
            _metrics.gauge(f"slo.{cls}.burn.1h").set(
                round(self.burn(cls, self._cfg_long_s), 4))
            with self._lock:
                res = self._residual.get(cls)
            if res and res[0] > 0:
                _metrics.gauge(f"slo.{cls}.residual.pct").set(
                    round(100.0 * res[1] / res[0], 3))

    def exposition(self) -> str:
        """OpenMetrics exemplar histograms, one per class with traffic
        (``geomesa_slo_query_latency_ms`` etc.), to append verbatim
        after the ``prometheus_text`` body."""
        self._refresh_config()
        if not self._cfg_enabled:
            return ""
        with self._lock:
            hists = sorted(self._exemplars.items())
        lines: list[str] = []
        for cls, hist in hists:
            lines.extend(hist.render(
                metric_name(f"slo.{cls}.latency.ms")))
        return "\n".join(lines) + ("\n" if lines else "")

    def report(self) -> dict:
        """The JSON join: objectives, current burn, residual
        pct, active alerts, and the worst recent exemplar traces per
        class."""
        self._refresh_config()
        out = {"enabled": self._cfg_enabled, "classes": {},
               "alerts_active": sorted(
                   c for c, v in self._alert_active.items() if v)}
        for cls, obj in sorted(self._cfg_objectives.items()):
            with self._lock:
                res = self._residual.get(cls)
                hist = self._exemplars.get(cls)
            out["classes"][cls] = {
                "objective": obj.to_json(),
                "burn_5m": round(self.burn(cls, self._cfg_short_s), 4),
                "burn_1h": round(self.burn(cls, self._cfg_long_s), 4),
                "residual_pct": (round(100.0 * res[1] / res[0], 3)
                                 if res and res[0] > 0 else 0.0),
                "exemplars": hist.exemplars()[:8] if hist else [],
            }
        return out

    def alerts(self, limit: int | None = None,
               cls: str | None = None) -> list[dict]:
        """Recent burn-alert crossings, newest first."""
        with self._lock:
            items = list(self._alerts)
        items.reverse()
        if cls is not None:
            items = [a for a in items if a["class"] == cls]
        if limit is not None:
            items = items[:max(0, int(limit))]
        return items

    def reset(self) -> None:
        """Test hook: drop all windows/exemplars/alerts (registry keys
        are the caller's problem — tests use a fresh registry or accept
        accumulation)."""
        with self._lock:
            self._windows.clear()
            self._exemplars.clear()
            self._residual.clear()
            self._alerts.clear()
            self._alert_active.clear()
            self._tenants.clear()
            self._cfg_gen = -1


#: process-wide SLO plane (wired to the tracer in obs/__init__.py)
slo_plane = SloPlane()
