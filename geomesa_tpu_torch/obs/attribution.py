"""Stage attribution: decompose a finished trace into a fixed ledger.

The SLO plane needs "where did the p99 millisecond go" per request
class, so every finished ``query`` / ``write`` / ``tile.render`` root
decomposes into the SAME fixed set of stages whatever physical spans it
recorded.  This module is that mapping: pure functions over a
:class:`~.trace.Trace`, no registry access, no config reads; the SLO
plane owns aggregation.  The stages, the span map and the arithmetic are
the JAX package's (``geomesa_tpu/obs/attribution.py``).

Attribution is **exclusive-time**: a span contributes its own wall ms
minus the summed wall ms of its direct children, clamped at zero, so a
``query.materialize`` span that wraps a ``query.scan.device`` does not
bill the same milliseconds to both stages.

Three stages never appear as spans and come from root attributes:

- ``queue``: ``admission.queue_ms``, the admission wait stamped onto the
  root after the gate admitted it (outside the root's wall);
- ``coalesce``: ``coalesce.ms``, a fused request's non-executing wall in
  the fusion scheduler (the window linger and the wake-up);
- ``device_scan`` also absorbs ``fused.dispatch.ms``, but ONLY when the
  trace has no ``serving.fuse`` span: the batch leader's trace already
  holds the fuse span as a child, and riders get the batch cost through
  the attribute.

``unattributed`` is the residual: root wall ms minus every in-root stage
(``queue`` and ``web_drain`` lie outside the root span's wall).  An
unmapped span falls into it, which makes its share a watchdog for spans
a path forgot to place.
"""

from __future__ import annotations

from .trace import Trace

__all__ = ["STAGES", "SPAN_STAGE", "attribute"]

#: the fixed stage ledger — every attribution result has exactly these
#: keys, so ``slo.<class>.stage.<stage>.ms`` is a closed metric family
STAGES = ("queue", "coalesce", "plan", "decompose", "device_scan",
          "host_scan", "post_filter", "materialize", "web_drain",
          "unattributed")

#: span name -> stage.  Unmapped spans (pure structural wrappers, or
#: future additions) fall into the residual, which is what makes the
#: residual gauge a watchdog for attribution drift.
SPAN_STAGE = {
    # query pipeline
    "query.plan": "plan",
    "query.replan": "plan",
    "query.decompose": "decompose",
    "query.scan.device": "device_scan",
    "query.scan.host": "host_scan",
    "query.scan.degraded": "host_scan",
    "query.post_filter": "post_filter",
    "query.materialize": "materialize",
    # fusion leader: the batch runs inline on the leader's thread
    "serving.fuse": "device_scan",
    # write pipeline
    "write.encode": "plan",
    "write.index": "decompose",
    "write.device": "device_scan",
    "write.spill": "device_scan",
    "write.seal": "host_scan",
    "write.observe": "post_filter",
    # tile rendering (density query under the hood)
    "lean.density": "device_scan",
    "lean.sketch": "plan",
}

#: stages whose time is OUTSIDE the root span's wall clock — excluded
#: from the residual subtraction and added on top for ``total_ms``
_OUT_OF_ROOT = ("queue", "web_drain", "unattributed")


def attribute(trace: Trace) -> dict | None:
    """Decompose ``trace`` into the stage ledger.

    Returns ``None`` for traces with no root span (nothing to
    attribute), else a dict::

        {"class": root name, "tenant": str, "trace_id": str,
         "total_ms": queue + root wall, "root_ms": root wall,
         "error": bool, "stages": {stage: ms for stage in STAGES}}
    """
    root = trace.root_span
    if root is None:
        return None

    ledger = {s: 0.0 for s in STAGES}

    # exclusive time per span: subtract direct children's wall ms
    child_ms: dict[str, float] = {}
    has_fuse_span = False
    for sp in trace.spans:
        if sp.parent_id is not None:
            child_ms[sp.parent_id] = (child_ms.get(sp.parent_id, 0.0)
                                      + sp.duration_ms)
        if sp.name == "serving.fuse":
            has_fuse_span = True
    for sp in trace.spans:
        if sp is root:
            continue
        stage = SPAN_STAGE.get(sp.name)
        if stage is None:
            continue
        excl = sp.duration_ms - child_ms.get(sp.span_id, 0.0)
        if excl > 0.0:
            ledger[stage] += excl

    attrs = root.attributes
    queue_ms = float(attrs.get("admission.queue_ms", 0.0) or 0.0)
    ledger["queue"] = queue_ms
    ledger["coalesce"] += float(attrs.get("coalesce.ms", 0.0) or 0.0)
    if not has_fuse_span:
        # rider: the batch ran on the leader's thread — the only record
        # of the device work is the stamped dispatch attribute
        ledger["device_scan"] += float(
            attrs.get("fused.dispatch.ms", 0.0) or 0.0)

    in_root = sum(ms for s, ms in ledger.items() if s not in _OUT_OF_ROOT)
    ledger["unattributed"] = max(0.0, root.duration_ms - in_root)

    return {
        "class": root.name,
        "tenant": str(attrs.get("tenant", "") or ""),
        "trace_id": trace.trace_id,
        "total_ms": queue_ms + root.duration_ms,
        "root_ms": root.duration_ms,
        "error": "error" in attrs,
        "stages": ledger,
    }
