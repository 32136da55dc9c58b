"""Observability: tracing, storage accounting and EXPLAIN ANALYZE.

* :mod:`.trace`: Dapper-style spans with contextvar propagation, the
  always/ratio/slow/never samplers, ring and JSONL exporters, a slow-query
  log, and :func:`device_span`, which attributes the device round trip of
  a block ending in a device→host copy to the owning query;
* :mod:`.resource`: storage and device-memory accounting, the
  ``storage.*`` gauges the admission gate reads, and the
  accounted-against-actual reconciliation;
* :mod:`.explain_analyze`: the plan narration merged with measured
  actuals.

Everything configures through the ``geomesa.obs.*`` properties
(:class:`~geomesa_tpu_torch.config.ObsProperties`).  Not ported yet:
heat tracking, the SLO plane, attribution, the job registry, the
Prometheus exposition and the recompile watch (ROADMAP A8d).
"""

from __future__ import annotations

from .explain_analyze import (
    ExplainAnalyzeResult, explain_analyze, explain_analyze_sql,
)
from .resource import publish_storage_gauges, storage_report
from .trace import (
    AlwaysSampler, JsonlExporter, NeverSampler, RatioSampler,
    RingExporter, Sampler, SlowOnlySampler, Span, Trace, Tracer,
    current_span, current_trace_id, device_span, obs_count, span, tracer,
)

__all__ = ["Span", "Trace", "Tracer", "Sampler", "AlwaysSampler",
           "NeverSampler", "RatioSampler", "SlowOnlySampler",
           "RingExporter", "JsonlExporter", "tracer", "span",
           "device_span", "current_span", "current_trace_id", "obs_count",
           "storage_report", "publish_storage_gauges",
           "ExplainAnalyzeResult", "explain_analyze",
           "explain_analyze_sql"]
