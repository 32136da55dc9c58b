"""REST endpoints over a TpuDataStore — the port's copy of the JAX
package's ``web/app.py``, with the same routes, status codes and bodies.
The store under it runs on the card: ``/api/data``, ``/query`` and
``/explain`` launch the z3 and z2 mask kernels through the store's
queries, ``/tiles`` the density kernel, and ``/wcs`` mosaics on the
raster store's device; every handler receives host arrays (the store's
results are copied off the card once, inside the store).

The analog of the reference's geomesa-web module (Scalatra servlets:
data endpoint `geomesa-web/geomesa-web-data`, stats endpoint
`geomesa-web/.../stats/GeoMesaStatsEndpoint.scala`, audit readback
`geomesa-web/.../QueryAuditEndpoint.scala`), re-expressed as a plain
WSGI application (stdlib only — runnable under ``wsgiref`` or any WSGI
container) instead of JVM servlets.

Routes::

    GET    /api/version
    GET    /api/schemas                      list type names
    POST   /api/schemas                      {"name":..., "spec":...}
    GET    /api/schemas/{name}               schema description
    DELETE /api/schemas/{name}
    GET    /api/data/{name}?cql=&max=&format=geojson|csv|gml   query
    POST   /api/data/{name}                  ingest GeoJSON FeatureCollection
    GET    /api/stats/{name}/count?cql=      estimated/exact counts
    GET    /api/stats/{name}/bounds
    GET    /api/stats/{name}/minmax?attribute=
    GET    /api/stats/{name}/histogram?attribute=&bins=
    GET    /api/stats/{name}/topk?attribute=
    GET    /api/audit/{name}?since=          query-event readback
    GET    /api/metrics                      request + store metrics dump
    GET    /query?schema=&cql=&format=arrow  chunked Arrow-IPC result stream
    GET    /metrics.prom                     Prometheus text exposition
    GET    /traces?slow=1&limit=N&schema=    recent (or slow-log) traces
    GET    /traces/{trace_id}                full span tree of one trace
    GET    /debug/storage?audit=0            storage/HBM accounting report
    GET    /debug/heat?limit=N               access-temperature ranking
    GET    /debug/jobs?kind=&state=&limit=N  background-job registry
    GET    /debug/slo                        SLO report (burn, exemplars)
    GET    /debug/alerts?limit=N&class=      burn-alert crossing ring
    GET    /explain?schema=&cql=             EXPLAIN ANALYZE (plan+actuals)
    GET    /explain?sql=                     EXPLAIN ANALYZE of a SQL text
    GET    /tiles/{z}/{x}/{y}?schema=&cql=&format=json|png   density tile

Malformed query-string parameters (a non-numeric ``limit``, an
unrecognized flag value, an unknown ``state``) are a **400** with the
offending parameter named — never a 500 or a silently-empty 200; the
same contract covers malformed CQL/SQL on the query endpoints
(``/api/data``, ``/query``, ``/explain``), which answer a 400 with the
parse error instead of a traceback.

Per-request metrics are recorded in the global registry (the reference's
servlet-level ``AggregatedMetricsFilter``).  The trace endpoints read
the process tracer's ring buffer and slow-query log (obs/trace.py);
``/metrics.prom`` serves p50/p95/p99 summaries from the log-bucketed
histograms, merged across the whole mesh under multihost
(parallel/stats.allreduce_metrics_snapshot, over ``torch.distributed``).
"""

from __future__ import annotations

import json
import time

import numpy as np

from ..metrics import registry as _metrics
from .wsgi import (
    HttpError, Router, StreamingBody, bool_param, float_param, int_param,
    read_json_body,
)

__all__ = ["WebApp", "serve"]


class WebApp:
    """WSGI application exposing a TpuDataStore over HTTP."""

    def __init__(self, store, audit_writer=None, geojson=None, blob=None,
                 raster=None):
        self.store = store
        # prefer an explicitly-passed audit writer, else the store's
        self.audit = audit_writer or getattr(store, "_audit_writer", None)
        # optional schemaless GeoJSON API mounted under /geojson/
        self.geojson_app = None
        if geojson is not None:
            from ..geojson.servlet import GeoJsonApp
            self.geojson_app = (geojson if isinstance(geojson, GeoJsonApp)
                                else GeoJsonApp(geojson))
        #: optional GeoIndexedBlobStore (BlobstoreServlet analog)
        self.blob = blob
        #: optional raster coverages for the WCS-shaped endpoint
        #: (geomesa-accumulo-raster's WCS role): name → RasterStore
        if raster is not None and not isinstance(raster, dict):
            raster = {getattr(raster, "name", "default"): raster}
        self.raster = raster
        self._router = Router([
            (r"^/api/version$", self._version),
            (r"^/api/schemas$", self._schemas),
            (r"^/api/schemas/([^/]+)$", self._schema),
            (r"^/api/data/([^/]+)$", self._data),
            (r"^/api/stats/([^/]+)/([a-z]+)$", self._stats),
            (r"^/api/audit/([^/]+)$", self._audit_events),
            (r"^/api/metrics$", self._metrics_dump),
            (r"^/metrics\.prom$", self._metrics_prom),
            (r"^/api/metrics\.prom$", self._metrics_prom),
            (r"^/query$", self._query_stream),
            (r"^/traces$", self._traces),
            (r"^/traces/([^/]+)$", self._trace_item),
            (r"^/debug/storage$", self._debug_storage),
            (r"^/debug/heat$", self._debug_heat),
            (r"^/debug/jobs$", self._debug_jobs),
            (r"^/debug/slo$", self._debug_slo),
            (r"^/debug/alerts$", self._debug_alerts),
            (r"^/explain$", self._explain),
            (r"^/tiles/([^/]+)/([^/]+)/([^/]+)$", self._tile),
            (r"^/api/blob$", self._blob_index),
            (r"^/api/blob/([^/]+)$", self._blob_item),
            (r"^/wcs$", self._wcs),
        ])
        #: /metrics.prom response cache: (monotonic ts, body text) —
        #: geomesa.obs.scrape.min.interval.ms bounds the walk rate
        self._scrape_cache: tuple | None = None

    # -- WSGI entry point --------------------------------------------------
    def __call__(self, environ, start_response):
        if (self.geojson_app is not None
                and environ.get("PATH_INFO", "/").startswith("/geojson/")):
            return self.geojson_app(environ, start_response)
        t0 = time.perf_counter()
        path = environ.get("PATH_INFO", "/")
        tenant = environ.get("HTTP_X_TENANT", "") or ""

        def on_metrics(status: int, aborted: bool = False,
                       drain_ms: float = 0.0):
            _metrics.counter(f"web.{status}").inc()
            if aborted:
                # a streaming body died after the status line went out
                # — the status counter alone would read as a clean
                # response (wsgi.Router streams call this from the
                # body generator's except path)
                _metrics.counter("web.stream_aborted").inc()
            total_ms = (time.perf_counter() - t0) * 1e3
            _metrics.timer("web.request_ms").update(total_ms)
            try:
                # SLO middleware: per-endpoint tenant-aware
                # RED plus the web_drain stage (streamed-body drain
                # time no datastore span can see)
                from ..obs import slo_plane
                slo_plane.observe_web(_endpoint_class(path), tenant,
                                      status, total_ms,
                                      drain_ms=drain_ms, aborted=aborted)
            except Exception:   # the SLO plane must never fail a request
                pass

        return self._router.dispatch(environ, start_response, on_metrics)

    # -- helpers -----------------------------------------------------------
    def _sft(self, name: str):
        try:
            return self.store.get_schema(name)
        except KeyError:
            raise HttpError(404, f"no such schema: {name!r}")

    def _parse_cql(self, cql: str, **kw):
        """CQL text → Query, or a strict 400 naming the parse failure —
        a malformed filter on a query endpoint must never surface as a
        500 traceback (the hardening of the debug endpoints, applied
        to the query plane)."""
        from ..planning.planner import Query
        try:
            return Query.of(cql, **kw)
        except Exception as e:
            raise HttpError(400, f"CQL parse error in {cql!r}: {e}")

    def _query(self, name: str, params: dict):
        self._sft(name)
        cql = params.get("cql", "INCLUDE")
        kw = {}
        max_features = int_param(params, "max")
        if max_features is not None:
            kw["max_features"] = max_features
        return self.store.query(name, self._parse_cql(cql, **kw))

    def _visible_batch(self, name: str):
        """The schema's batch restricted to rows this caller may see
        (mirrors the datastore's _restricted_mask so no stats route can
        leak hidden rows)."""
        store = self.store._store(name)
        if store.batch is None or len(store.batch) == 0:
            return None
        batch = store.batch
        auth = self.store._auth_provider
        if auth is not None:
            batch = store.masked_batch(auth.get_authorizations())
        mask = self.store._restricted_mask(store)
        if mask is None:
            return batch
        return batch.take(np.flatnonzero(mask))

    # -- handlers ----------------------------------------------------------
    def _version(self, method, params, environ):
        from .. import __version__
        return 200, {"version": __version__, "framework": "geomesa-tpu"}

    def _schemas(self, method, params, environ):
        if method == "GET":
            return 200, self.store.type_names
        if method == "POST":
            body = read_json_body(environ)
            if "name" not in body or "spec" not in body:
                raise HttpError(400, "need 'name' and 'spec'")
            try:
                sft = self.store.create_schema(body["name"], body["spec"])
            except ValueError as e:
                raise HttpError(400, str(e))
            return 201, {"name": sft.name, "spec": sft.spec_string()}
        raise HttpError(405, method)

    def _schema(self, method, params, environ, name):
        sft = self._sft(name)
        if method == "GET":
            return 200, {
                "name": sft.name,
                "spec": sft.spec_string(),
                "attributes": [{"name": a.name, "type": a.type,
                                "indexed": a.indexed,
                                "default": a.name == sft.default_geom}
                               for a in sft.attributes],
                "dtg": sft.dtg_field,
            }
        if method == "DELETE":
            self.store.remove_schema(name)
            return 204, None
        raise HttpError(405, method)

    def _data(self, method, params, environ, name):
        if method == "GET":
            batch = self._query(name, params)
            fmt = params.get("format", "geojson")
            from ..io import export
            if fmt == "geojson":
                return 200, export.to_geojson(batch), "application/geo+json"
            if fmt == "csv":
                return 200, export.to_csv(batch), "text/csv"
            if fmt == "gml":
                return 200, export.to_gml(batch), "application/gml+xml"
            raise HttpError(400, f"unknown format: {fmt!r}")
        if method == "POST":
            body = read_json_body(environ)
            feats = body.get("features")
            if feats is None:
                raise HttpError(400, "expected GeoJSON FeatureCollection")
            sft = self._sft(name)
            from ..io.converters import EvaluationContext, converter_from_config
            fields = [{"name": a.name,
                       "transform": ("$geometry" if a.is_geometry
                                     else f"${a.name}")}
                      for a in sft.attributes]
            config = {"type": "geojson", "fields": fields}
            if all("id" in f for f in feats):
                config["id-field"] = "$id"
            conv = converter_from_config(sft, config)
            ec = EvaluationContext()
            batch = conv.convert(json.dumps(body), ec)
            n = self.store.write(name, batch) if len(batch) else 0
            return 200, {"ingested": n, "errors": ec.errors}
        raise HttpError(405, method)

    def _stats(self, method, params, environ, name, which):
        if method != "GET":
            raise HttpError(405, method)
        sft = self._sft(name)
        if which == "count":
            cql = params.get("cql")
            return 200, {"count": self.store.get_count(name, cql)}
        if which == "bounds":
            env = self.store.get_bounds(name)
            body = (None if env is None else
                    {"minx": env.xmin, "miny": env.ymin,
                     "maxx": env.xmax, "maxy": env.ymax})
            return 200, {"bounds": body}
        attr = params.get("attribute")
        if which in ("minmax", "histogram", "topk"):
            if not attr:
                raise HttpError(400, "need ?attribute=")
            if attr not in sft.attribute_names:
                raise HttpError(404, f"no such attribute: {attr!r}")
        if which == "minmax":
            mm = self.store.get_attribute_bounds(name, attr)
            return 200, {"attribute": attr,
                         "bounds": None if mm is None else
                         [_jsonable(mm[0]), _jsonable(mm[1])]}
        if which == "histogram":
            from ..stats.stat import Histogram
            bins = int_param(params, "bins", 20)
            batch = self._visible_batch(name)
            if batch is None or len(batch) == 0:
                raise HttpError(404, "no data")
            try:
                col = batch.column(attr).astype(float)
            except (ValueError, TypeError):
                raise HttpError(400, f"attribute {attr!r} is not numeric")
            h = Histogram(attr, bins=bins,
                          lo=float(col.min()), hi=float(col.max()))
            h.observe(batch)
            return 200, h.to_json()
        if which == "topk":
            s = self.store.stat(name, f"{attr}_topk")
            if s is None:
                raise HttpError(404, f"no topk stat for {attr!r}")
            return 200, s.to_json()
        raise HttpError(404, f"unknown stat: {which!r}")

    def _audit_events(self, method, params, environ, name):
        if method != "GET":
            raise HttpError(405, method)
        if self.audit is None or not hasattr(self.audit, "query_events"):
            raise HttpError(404, "no queryable audit writer configured")
        since = float_param(params, "since")
        events = self.audit.query_events(type_name=name, since=since)
        return 200, [json.loads(e.to_json()) for e in events]

    def _metrics_dump(self, method, params, environ):
        return 200, _metrics.snapshot()

    def _metrics_prom(self, method, params, environ):
        """Prometheus text exposition (p50/p95/p99 summaries from the
        log-bucketed histograms).  Serves THIS process's registry by
        default — safe for a normal scraper that hits one host.  On a
        multihost store, ``?mesh=1`` merges every process's registry so
        one response reflects the whole mesh, but that path is a
        blocking COLLECTIVE: it must be driven identically on every
        process (an SPMD metrics job, not a single-endpoint scraper —
        a lone scrape would strand the mesh in the allgather)."""
        if method != "GET":
            raise HttpError(405, method)
        from ..config import ObsProperties
        from ..metrics import OBS_SCRAPE_CACHED, OBS_SCRAPE_MS
        from ..obs import (
            prometheus_text, publish_heat_gauges, publish_storage_gauges,
            slo_plane, storage_report,
        )
        mesh = (params.get("mesh") in ("1", "true", "yes")
                and getattr(self.store, "_multihost", False))
        min_interval_ms = float(
            ObsProperties.SCRAPE_MIN_INTERVAL_MS.get() or 0.0)
        # scrape cache: an aggressive scraper reuses the last rendered
        # body instead of re-walking storage.  Mesh scrapes NEVER cache
        # (the merge is a collective every process must enter).
        if min_interval_ms > 0 and not mesh:
            cached = self._scrape_cache
            if (cached is not None
                    and (time.perf_counter() - cached[0]) * 1e3
                    < min_interval_ms):
                _metrics.counter(OBS_SCRAPE_CACHED).inc()
                return 200, cached[1], "text/plain; version=0.0.4"
        t0 = time.perf_counter()
        rep = None
        try:
            # refresh the storage.* gauges so every scrape carries
            # CURRENT resident bytes, not the last /debug/storage hit
            rep = storage_report(self.store, audit=False)
            publish_storage_gauges(self.store, rep)
        except Exception:   # accounting must never break the scrape
            pass
        try:
            # heat.* likewise: every scrape carries the CURRENT decayed
            # workload temperatures (obs/heat), reusing the one store
            # walk above for the placement join
            publish_heat_gauges(self.store, storage=rep)
        except Exception:
            pass
        try:
            # slo.* burn + residual gauges (obs/slo) — same
            # publish-on-scrape discipline
            slo_plane.publish()
        except Exception:
            pass
        if mesh:
            from ..parallel.stats import allreduce_metrics_snapshot
            snap = allreduce_metrics_snapshot()
        else:
            snap = _metrics.snapshot()
        body = prometheus_text(snap)
        try:
            # OpenMetrics exemplar histograms (trace_id-linked latency
            # buckets) append after the summary body
            body += slo_plane.exposition()
        except Exception:
            pass
        # the scrape's own cost, recorded for the NEXT scrape to report
        _metrics.timer(OBS_SCRAPE_MS).update(
            (time.perf_counter() - t0) * 1e3)
        if not mesh:
            self._scrape_cache = (time.perf_counter(), body)
        return 200, body, "text/plain; version=0.0.4"

    def _query_stream(self, method, params, environ):
        """Chunked Arrow-IPC query results:
        ``/query?schema=&cql=&format=arrow[&chunk_rows=N][&dicts=a,b]``
        streams delta-dictionary record batches AS THE STORE
        MATERIALIZES THEM — a client renders the first chunk while the
        scan-side gather is still running, and no full result is ever
        buffered server-side.  ``dicts`` names the attributes to
        dictionary-encode (default: auto by
        ``geomesa.arrow.dictionary.threshold``; ``dicts=none`` disables);
        flush granularity is ``geomesa.arrow.stream.buffer.bytes``.
        Malformed CQL is a strict 400."""
        if method != "GET":
            raise HttpError(405, method)
        name = params.get("schema")
        if not name:
            raise HttpError(400, "need ?schema=...[&cql=...]")
        self._sft(name)
        fmt = params.get("format", "arrow")
        if fmt != "arrow":
            raise HttpError(400, f"unsupported stream format {fmt!r} "
                                 "(only 'arrow')")
        kw = {}
        max_features = int_param(params, "max")
        if max_features is not None:
            kw["max_features"] = max_features
        q = self._parse_cql(params.get("cql", "INCLUDE"), **kw)
        chunk_rows = int_param(params, "chunk_rows")
        if chunk_rows is not None and chunk_rows <= 0:
            raise HttpError(400,
                            f"bad 'chunk_rows' parameter: {chunk_rows}")
        dicts = params.get("dicts")
        if dicts is None:
            dictionary_fields = "auto"
        elif dicts.strip().lower() == "none":
            dictionary_fields = ()
        else:
            dictionary_fields = tuple(d for d in dicts.split(",") if d)
            sft = self.store.get_schema(name)
            for d in dictionary_fields:
                if d not in sft.attribute_names:
                    raise HttpError(400, f"bad 'dicts' parameter: "
                                         f"no attribute {d!r}")
        timeout_ms = int_param(params, "timeout_ms")
        if timeout_ms is not None and timeout_ms <= 0:
            raise HttpError(400,
                            f"bad 'timeout_ms' parameter: {timeout_ms}")
        # partial=1 keeps an expired deadline from 504ing: the stream
        # ends early but well-formed (Arrow EOS), rows-so-far delivered
        partial = bool_param(params, "partial")
        # fused serving plane: the tenant id (X-Tenant
        # header, or ?tenant=) keys per-tenant fair batch assembly in
        # the fusion scheduler; compatible queries coalesce into shared
        # device dispatches and the Arrow stream picks up from the
        # demuxed per-caller positions
        tenant = (environ.get("HTTP_X_TENANT")
                  or params.get("tenant", "") or "")
        from ..arrow.stream import ipc_chunks
        stream = self.store.query_arrow(
            name, q, chunk_rows=chunk_rows,
            dictionary_fields=dictionary_fields,
            timeout_ms=timeout_ms, partial_results=partial,
            tenant=tenant)
        return (200, StreamingBody(ipc_chunks(stream)),
                "application/vnd.apache.arrow.stream")

    def _traces(self, method, params, environ):
        """Recent traces (ring buffer), or the slow-query log with
        ``?slow=1`` — newest last, summaries only.  ``?limit=N`` pages
        to the NEWEST N; ``?schema=`` keeps only traces whose root
        recorded that schema (filter BEFORE limit, so the page is N
        matching traces); malformed params are a 400."""
        if method != "GET":
            raise HttpError(405, method)
        from ..obs import tracer
        limit = int_param(params, "limit")
        if limit is not None and limit < 0:
            raise HttpError(400, f"bad 'limit' parameter: {limit}")
        schema = params.get("schema")
        if schema is not None and not schema:
            raise HttpError(400, "bad 'schema' parameter: ''")
        if bool_param(params, "slow"):
            traces = tracer.slow_log.traces()
        else:
            ring = tracer.ring
            traces = ring.traces() if ring is not None else []
        if schema is not None:
            traces = [t for t in traces
                      if t.root_span is not None
                      and t.root_span.attributes.get("schema") == schema]
        if limit is not None:
            traces = traces[len(traces) - min(limit, len(traces)):]
        return 200, [t.summary() for t in traces]

    def _trace_item(self, method, params, environ, trace_id):
        if method != "GET":
            raise HttpError(405, method)
        from ..obs import tracer
        t = tracer.find(trace_id)
        if t is None:
            raise HttpError(404, f"no such trace: {trace_id!r}")
        return 200, t.to_json()

    def _debug_storage(self, method, params, environ):
        """Storage/HBM accounting: per-schema/per-index byte residency
        (device runs vs host spill vs caches, per generation) with the
        accounted-vs-actual-nbytes reconciliation (obs/resource).  The
        walk also refreshes the ``storage.*`` gauges.  ``?audit=0``
        skips the actual-nbytes walk (the cheap accounted-only form);
        an unrecognized value is a 400."""
        if method != "GET":
            raise HttpError(405, method)
        if not bool_param(params, "audit", default=True):
            from ..obs import publish_storage_gauges, storage_report
            rep = storage_report(self.store, audit=False)
            publish_storage_gauges(self.store, rep)
            return 200, rep
        return 200, self.store.storage_report()

    def _debug_heat(self, method, params, environ):
        """Access-temperature ranking (obs/heat): every lean
        generation hot→cold by decayed touch temperature, joined with
        its current device/host placement from the storage accounting.
        ``?limit=N`` truncates the ranked list; also refreshes the
        ``heat.*`` gauges."""
        if method != "GET":
            raise HttpError(405, method)
        limit = int_param(params, "limit")
        if limit is not None and limit < 0:
            raise HttpError(400, f"bad 'limit' parameter: {limit}")
        return 200, self.store.heat_report(limit=limit)

    def _debug_jobs(self, method, params, environ):
        """Background-job registry (obs/jobs): active + recent
        ingest/compaction runs, newest first, with phase spans,
        progress, and terminal outcomes.  Filters: ``?kind=``,
        ``?state=running|succeeded|failed``, ``?limit=N``."""
        if method != "GET":
            raise HttpError(405, method)
        from ..obs import jobs_registry
        limit = int_param(params, "limit")
        if limit is not None and limit < 0:
            raise HttpError(400, f"bad 'limit' parameter: {limit}")
        state = params.get("state")
        if state is not None and state not in ("running", "succeeded",
                                               "failed"):
            raise HttpError(400, f"bad 'state' parameter: {state!r}")
        jobs = self.store_jobs().jobs(kind=params.get("kind"),
                                      state=state, limit=limit)
        return 200, {"jobs": [j.to_json() for j in jobs]}

    def _debug_slo(self, method, params, environ):
        """SLO plane report (obs/slo): per-class objectives, 5m/1h
        error-budget burn, unattributed residual pct, and the worst
        recent exemplar traces (each trace_id resolvable at
        ``/traces/<id>``) — the JSON join of what /metrics.prom
        exposes as gauges + exemplars."""
        if method != "GET":
            raise HttpError(405, method)
        from ..obs import slo_plane
        return 200, slo_plane.report()

    def _debug_alerts(self, method, params, environ):
        """Burn-alert crossing ring (obs/slo): newest first.
        ``?limit=N`` truncates; ``?class=`` filters to one SLO class
        (unknown classes are a strict 400 naming the valid set)."""
        if method != "GET":
            raise HttpError(405, method)
        from ..obs import slo_plane
        limit = int_param(params, "limit")
        if limit is not None and limit < 0:
            raise HttpError(400, f"bad 'limit' parameter: {limit}")
        cls = params.get("class")
        if cls is not None:
            known = slo_plane.classes()
            if cls not in known:
                raise HttpError(
                    400, f"bad 'class' parameter: {cls!r} "
                         f"(known: {', '.join(sorted(known))})")
        return 200, {"alerts": slo_plane.alerts(limit=limit, cls=cls)}

    def store_jobs(self):
        """The registry /debug/jobs serves — the process-wide one
        unless a test/app injected ``self.jobs_registry``."""
        reg = getattr(self, "jobs_registry", None)
        if reg is None:
            from ..obs import jobs_registry as reg
        return reg

    def _explain(self, method, params, environ):
        """EXPLAIN ANALYZE: the plan narration merged with measured
        actuals (obs/explain_analyze).  ``?schema=&cql=`` explains one
        planner query; ``?sql=`` explains a SQL text (every store
        query it runs is captured).  ``&format=text`` renders the
        human tree instead of JSON."""
        if method != "GET":
            raise HttpError(405, method)
        from ..obs import explain_analyze, explain_analyze_sql
        sql = params.get("sql")
        if sql:
            # parse-validate BEFORE executing: malformed SQL is a
            # strict 400 naming the parse failure, never a 500
            from ..sql import parse_sql
            try:
                parse_sql(sql)
            except Exception as e:
                raise HttpError(400, f"SQL parse error in {sql!r}: {e}")
            res = explain_analyze_sql(self.store, sql)
        else:
            name = params.get("schema")
            if not name:
                raise HttpError(400,
                                "need ?sql=... or ?schema=...[&cql=...]")
            self._sft(name)
            cql = params.get("cql", "INCLUDE")
            self._parse_cql(cql)
            res = explain_analyze(self.store, name, cql)
        if params.get("format") == "text":
            return 200, res.render() + "\n", "text/plain"
        return 200, res.to_json()

    # -- WCS-shaped raster serving (geomesa-accumulo-raster WCS role) -----
    def _wcs(self, method, params, environ):
        """Minimal WCS 1.0-shaped surface: GetCapabilities /
        DescribeCoverage list the configured RasterStores,
        GetCoverage mosaics a bbox at a target resolution into PNG
        (8-bit grayscale) or npy (raw float grid) — the coverage-store
        serving role of ``geomesa-accumulo/geomesa-accumulo-raster``."""
        if not self.raster:
            raise HttpError(404, "no raster coverages configured")
        req = (params.get("request") or "GetCapabilities").lower()
        if req == "getcapabilities":
            items = "".join(
                f"<CoverageOfferingBrief><name>{n}</name>"
                f"</CoverageOfferingBrief>" for n in sorted(self.raster))
            return (200, f"<WCS_Capabilities><ContentMetadata>{items}"
                         "</ContentMetadata></WCS_Capabilities>",
                    "text/xml")
        name = params.get("coverage") or next(iter(sorted(self.raster)))
        rs = self.raster.get(name)
        if rs is None:
            raise HttpError(404, f"no coverage {name!r}")
        if req == "describecoverage":
            b = rs.bounds()
            res = ",".join(str(r) for r in rs.available_resolutions)
            env = ("" if b is None else
                   f"<lonLatEnvelope>{b[0]} {b[1]} {b[2]} {b[3]}"
                   "</lonLatEnvelope>")
            return (200, f"<CoverageDescription><CoverageOffering>"
                         f"<name>{name}</name>{env}"
                         f"<resolutions>{res}</resolutions>"
                         "</CoverageOffering></CoverageDescription>",
                    "text/xml")
        if req != "getcoverage":
            raise HttpError(400, f"unsupported WCS request {req!r}")
        bbox = params.get("bbox")
        if bbox:
            box = tuple(float(v) for v in bbox.split(","))
        else:
            box = rs.bounds()
            if box is None:
                raise HttpError(404, f"coverage {name!r} is empty")
        width = int_param(params, "width", 256)
        height = int_param(params, "height", 256)
        res = float_param(params, "resolution", None)
        grid = rs.mosaic(box, width, height, resolution=res)
        fmt = (params.get("format") or "png").lower()
        if fmt in ("npy", "arraybuffer"):
            import io as _io
            buf = _io.BytesIO()
            np.save(buf, np.asarray(grid))
            return 200, buf.getvalue(), "application/octet-stream"
        if fmt != "png":
            raise HttpError(400, f"unsupported format {fmt!r}")
        return 200, _png_gray(np.asarray(grid)), "image/png"

    # -- map tiles ---------------------------------------------------------
    def _tile(self, method, params, environ, z, x, y):
        """``GET /tiles/{z}/{x}/{y}?schema=&cql=&format=json|png`` —
        one density tile, pyramid-served over sealed generations while
        the zoom stays at/below the pyramid base (the store's
        density_tile contract).  Strict hardening: malformed z/x/y or
        params are a 400 naming the offender, an unknown schema a 404,
        malformed CQL a 400 — never a 500."""
        if method != "GET":
            raise HttpError(405, method)
        try:
            zi, xi, yi = int(z), int(x), int(y)
        except ValueError:
            raise HttpError(400, f"malformed tile address {z}/{x}/{y}: "
                                 "z, x, y must be integers")
        n = 1 << zi if zi >= 0 else 0
        if not (0 <= zi <= 30) or not (0 <= xi < n and 0 <= yi < n):
            raise HttpError(400, f"tile ({zi}/{xi}/{yi}) out of range: "
                                 "need 0 <= z <= 30 and 0 <= x,y < 2^z")
        name = params.get("schema")
        if not name:
            raise HttpError(400, "need ?schema=")
        self._sft(name)
        cql = params.get("cql")
        if cql:
            self._parse_cql(cql)  # strict 400 before any scan work
        tile = int_param(params, "tile", 256)
        if tile is None or not (1 <= tile <= 4096):
            raise HttpError(400, f"tile size {tile} out of range (1-4096)")
        timeout_ms = float_param(params, "timeout_ms", None)
        fmt = (params.get("format") or "json").lower()
        if fmt not in ("json", "png"):
            raise HttpError(400, f"unsupported format {fmt!r}")
        grid = np.asarray(self.store.density_tile(
            name, zi, xi, yi, tile=tile, query=cql,
            timeout_ms=timeout_ms))
        if fmt == "png":
            # grid row 0 is SOUTH; PNG row 0 renders on top → flip for
            # the north-up image a slippy map expects
            return 200, _png_gray(grid[::-1]), "image/png"
        return 200, {"z": zi, "x": xi, "y": yi, "tile": tile,
                     "total": float(grid.sum()),
                     "grid": grid.tolist()}

    # -- blob store (geomesa-blobstore-web BlobstoreServlet analog) -------
    def _require_blob(self):
        if self.blob is None:
            raise HttpError(404, "no blob store configured")
        return self.blob

    def _blob_index(self, method, params, environ):
        bs = self._require_blob()
        if method == "GET":
            return 200, {"ids": bs.query_ids(params.get("cql", "INCLUDE"))}
        if method == "POST":
            n = int(environ.get("CONTENT_LENGTH") or 0)
            data = environ["wsgi.input"].read(n) if n else b""
            if not data:
                raise HttpError(400, "empty blob body")
            from ..blob import wkt_handler
            kw = {}
            if "wkt" in params:
                kw.update(handler=wkt_handler, params={"wkt": params["wkt"]})
            else:
                raise HttpError(400, "need ?wkt= for the blob geometry")
            bid = bs.put(data, dtg=int_param(params, "dtg", 0) or 0,
                         filename=params.get("filename", ""), **kw)
            return 201, {"id": bid}
        raise HttpError(405, method)

    def _blob_item(self, method, params, environ, bid):
        bs = self._require_blob()
        if method == "GET":
            hit = bs.get(bid)
            if hit is None:
                raise HttpError(404, f"no such blob: {bid!r}")
            data, filename = hit
            return 200, data, "application/octet-stream"
        if method == "DELETE":
            bs.delete_blob(bid)
            return 204, None
        raise HttpError(405, method)


def _png_gray(grid: np.ndarray) -> bytes:
    """Encode a 2-D float grid as an 8-bit grayscale PNG (stdlib only:
    zlib deflate + crc32 chunks) — min/max-normalized."""
    import struct
    import zlib

    g = np.asarray(grid, dtype=np.float64)
    lo, hi = float(np.nanmin(g)), float(np.nanmax(g))
    scale = (g - lo) / (hi - lo) if hi > lo else np.zeros_like(g)
    img = np.nan_to_num(scale * 255.0).astype(np.uint8)
    h, w = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)  # 8-bit gray
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _endpoint_class(path: str) -> str:
    """Fold a request path into a BOUNDED endpoint label for the
    ``slo.web.*`` metrics — raw paths carry schema names / trace ids
    and would grow the registry without bound."""
    if path == "/query":
        return "query"
    if path.startswith("/api/data"):
        return "data"
    if path.startswith("/api/stats"):
        return "stats"
    if path.startswith("/tiles"):
        return "tiles"
    if path in ("/metrics.prom", "/api/metrics", "/api/metrics.prom"):
        return "metrics"
    if path.startswith("/traces"):
        return "traces"
    if path.startswith("/debug"):
        return "debug"
    if path == "/explain":
        return "explain"
    if path.startswith("/api"):
        return "api"
    return "other"


def _jsonable(v):
    """Numpy scalars / datetimes → JSON-safe values."""
    if isinstance(v, np.generic):
        return v.item()
    return v if isinstance(v, (int, float, str, bool, type(None))) else str(v)


def serve(app: WebApp, host: str = "127.0.0.1", port: int = 8765,
          max_concurrent: int = 32):
    """Run the app under wsgiref (dev/demo server) — threaded with a
    bounded in-flight cap: past ``max_concurrent`` requests shed 503 +
    Retry-After instead of growing an unbounded thread pile."""
    from .wsgi import make_bounded_server
    with make_bounded_server(host, port, app,
                             max_concurrent=max_concurrent) as httpd:
        print(f"geomesa-tpu web on http://{host}:{port}/api/version")
        httpd.serve_forever()
