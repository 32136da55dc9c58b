"""Observability: tracing, metrics exposition, storage accounting,
EXPLAIN ANALYZE, access heat, jobs, the SLO plane and the kernel-build
watch.

* :mod:`.trace`: Dapper-style spans with contextvar propagation, the
  always/ratio/slow/never samplers, ring and JSONL exporters, a slow-query
  log, and :func:`device_span`, which attributes the device round trip of
  a block ending in a device→host copy to the owning query;
* :mod:`.recompile`: the kernel-build watch, which counts each ``nvcc``
  build into the ``jax.compile.*`` metrics and stamps the span it ran
  under;
* :mod:`.prom`: Prometheus text exposition over metric snapshots;
* :mod:`.resource`: storage and device-memory accounting, the
  ``storage.*`` gauges the admission gate reads, and the
  accounted-against-actual reconciliation;
* :mod:`.explain_analyze`: the plan narration merged with measured
  actuals;
* :mod:`.heat`: per-(schema, index, generation) access temperature, the
  ranked hot→cold report joined with storage placement, and the
  ``heat.*`` gauges;
* :mod:`.jobs`: the background-job registry (compaction and pyramid
  runs with phase spans, progress and terminal outcomes);
* :mod:`.attribution` and :mod:`.slo`: the fixed stage ledger of a
  finished trace, and the SLO plane that folds it into per-class burn,
  alerts and exemplars.

Everything configures through the ``geomesa.obs.*`` and ``geomesa.slo.*``
properties (:class:`~geomesa_tpu_torch.config.ObsProperties`,
:class:`~geomesa_tpu_torch.config.SloProperties`).
"""

from __future__ import annotations

from ..config import ObsProperties
from .attribution import STAGES as SLO_STAGES, attribute
from .explain_analyze import (
    ExplainAnalyzeResult, explain_analyze, explain_analyze_sql,
)
from .heat import (
    HeatTracker, heat_enabled, heat_report, heat_tracker,
    merge_index_generations, publish_heat_gauges, record_index_scan,
)
from .jobs import JobRecord, JobRegistry, jobs_registry
from .prom import prometheus_text
from .recompile import compile_count, install as install_recompile_tracker
from .resource import publish_storage_gauges, storage_report
from .slo import ExemplarHistogram, Objective, SloPlane, slo_plane
from .trace import (
    AlwaysSampler, JsonlExporter, NeverSampler, RatioSampler,
    RingExporter, Sampler, SlowOnlySampler, Span, Trace, Tracer,
    current_span, current_trace_id, device_span, obs_count, span, tracer,
)

__all__ = ["Span", "Trace", "Tracer", "Sampler", "AlwaysSampler",
           "NeverSampler", "RatioSampler", "SlowOnlySampler",
           "RingExporter", "JsonlExporter", "tracer", "span",
           "device_span", "current_span", "current_trace_id", "obs_count",
           "prometheus_text", "compile_count",
           "install_recompile_tracker",
           "storage_report", "publish_storage_gauges",
           "ExplainAnalyzeResult", "explain_analyze",
           "explain_analyze_sql",
           "HeatTracker", "heat_tracker", "heat_enabled",
           "record_index_scan", "merge_index_generations",
           "heat_report", "publish_heat_gauges",
           "JobRecord", "JobRegistry", "jobs_registry",
           "SloPlane", "slo_plane", "ExemplarHistogram", "Objective",
           "SLO_STAGES", "attribute"]

# the build watch is process-global and costs a few counter increments a
# build; the option keeps fully instrumentation-silent runs possible
if ObsProperties.RECOMPILE_TRACK.to_bool():
    install_recompile_tracker()

# the SLO plane feeds off finished root traces; the hook fast-exits while
# geomesa.slo.enabled is off
tracer.add_finish_hook(slo_plane.on_trace_finish)
