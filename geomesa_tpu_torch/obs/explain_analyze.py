"""EXPLAIN ANALYZE: the plan narration merged with measured actuals.

The reference's ``explainQuery`` narrates what the planner WOULD do;
this is that surface with measured numbers, as in the JAX package's
``obs/explain_analyze.py``: one call runs the query under a forced trace
capture (:meth:`~geomesa_tpu_torch.obs.trace.Tracer.capture` records
whatever the configured sampler says), collects the planner's
hierarchical explain text AND the finished span tree, and renders them
merged: the strategy with every option's estimated cost, the chosen
estimate (``plan.estimate.rows``), the actual rows scanned and matched,
the mispredict ratio, per-phase wall ms and device ms.

:func:`explain_analyze_sql` waits for the SQL layer (ROADMAP item 10)
and raises.  Everything here is read-path observability: the query runs
exactly as it normally would, and nothing enters a collective beyond
what the query itself does.
"""

from __future__ import annotations

import time

__all__ = ["ExplainAnalyzeResult", "explain_analyze",
           "explain_analyze_sql"]


def _span_tree(trace) -> dict | None:
    """Nest a finished trace's flat span list into a tree (children in
    start order), each node carrying name, ms and attributes."""
    if trace is None:
        return None
    children: dict = {}
    root = None
    for s in trace.spans:
        if s.parent_id is None:
            root = s
        else:
            children.setdefault(s.parent_id, []).append(s)

    def node(s) -> dict:
        kids = sorted(children.get(s.span_id, ()),
                      key=lambda c: c.start_ts)
        return {"name": s.name, "duration_ms": round(s.duration_ms, 3),
                "attributes": dict(s.attributes),
                "children": [node(c) for c in kids]}

    return node(root) if root is not None else None


def _fmt_attr(v):
    return round(v, 3) if isinstance(v, float) else v


def _render_tree(node: dict, lines: list, prefix: str = "",
                 last: bool = True) -> None:
    attrs = " ".join(f"{k}={_fmt_attr(v)}"
                     for k, v in node["attributes"].items()
                     if not isinstance(v, dict))
    tick = "└─ " if last else "├─ "
    lines.append(f"{prefix}{tick}{node['name']} "
                 f"{node['duration_ms']:.1f}ms"
                 + (f"  [{attrs}]" if attrs else ""))
    ext = "   " if last else "│  "
    kids = node["children"]
    for i, c in enumerate(kids):
        _render_tree(c, lines, prefix + ext, i == len(kids) - 1)


def _summary_from(trace) -> dict:
    """Pull the estimate-vs-actual numbers the planner stamped on the
    root span (planning/planner.run) into a flat summary."""
    out = {"trace_id": None, "duration_ms": 0.0}
    if trace is None or trace.root_span is None:
        return out
    root = trace.root_span
    a = root.attributes
    out.update({
        "trace_id": trace.trace_id,
        "duration_ms": round(trace.duration_ms, 3),
        "hits": a.get("hits"),
        "device_ms": a.get("device_ms"),
        "estimate_rows": a.get("plan.estimate.rows"),
        "actual_scanned": a.get("plan.actual.scanned"),
        "actual_matched": a.get("plan.actual.matched"),
        "estimate_ratio": a.get("plan.estimate.ratio"),
        "estimate_source": a.get("plan.estimate.source"),
        "replanned": bool(a.get("plan.replanned", False)),
    })
    for s in trace.spans:
        if s.name == "query.plan":
            out.setdefault("strategy", s.attributes.get("strategy"))
            opts = s.attributes.get("plan.options")
            if opts:
                out["options"] = opts
    return out


class ExplainAnalyzeResult:
    """One explain-analyze run: summary numbers, span tree(s), planner
    narration, and renderers (``render()`` text / ``to_json()``)."""

    def __init__(self, target: str, traces: list, plan_text: str = "",
                 result_summary: dict | None = None,
                 wall_ms: float = 0.0):
        #: what was explained: ``schema:<name>`` or ``sql``
        self.target = target
        self.traces = list(traces)
        self.plan_text = plan_text
        self.result_summary = result_summary or {}
        self.wall_ms = round(wall_ms, 3)

    @property
    def trace(self):
        """The primary (last-finished) trace, if any was recorded."""
        return self.traces[-1] if self.traces else None

    @property
    def summary(self) -> dict:
        return _summary_from(self.trace)

    def tree(self) -> dict | None:
        return _span_tree(self.trace)

    def to_json(self) -> dict:
        return {
            "target": self.target,
            "wall_ms": self.wall_ms,
            "summary": self.summary,
            "result": self.result_summary,
            "plans": [_span_tree(t) for t in self.traces],
            "narration": self.plan_text.splitlines(),
        }

    def render(self) -> str:
        lines = [f"EXPLAIN ANALYZE {self.target} "
                 f"({self.wall_ms:.1f}ms wall)"]
        s = self.summary
        if s.get("trace_id"):
            est, act = s.get("estimate_rows"), s.get("actual_scanned")
            lines.append(
                f"  strategy={s.get('strategy')} "
                f"estimated_rows={est} "
                f"({s.get('estimate_source') or 'heuristic'}) "
                f"scanned={act} "
                f"matched={s.get('actual_matched')} "
                f"ratio={s.get('estimate_ratio')}x "
                f"hits={s.get('hits')} "
                f"device_ms={_fmt_attr(s.get('device_ms'))}"
                + (" REPLANNED" if s.get("replanned") else ""))
            if s.get("options"):
                opts = " ".join(f"{k}={v}"
                                for k, v in s["options"].items())
                lines.append(f"  options: {opts}")
        for t in self.traces:
            tree = _span_tree(t)
            if tree is not None:
                _render_tree(tree, lines)
        if self.plan_text:
            lines.append("Plan narration:")
            lines.extend("  " + ln for ln in self.plan_text.splitlines())
        return "\n".join(lines)


def explain_analyze(store, name: str, query="INCLUDE"
                    ) -> ExplainAnalyzeResult:
    """Run one planner query under forced trace capture and return the
    merged plan + actuals (module doc)."""
    from ..planning.explain import ExplainString
    from ..planning.planner import Query
    from .trace import tracer
    q = query if isinstance(query, Query) else Query.of(query)
    ex = ExplainString()
    t0 = time.perf_counter()
    with tracer.capture() as cap:
        result = store.query_result(name, q, explain=ex)
    wall_ms = (time.perf_counter() - t0) * 1e3
    return ExplainAnalyzeResult(
        target=f"schema:{name}", traces=cap.traces(),
        plan_text=str(ex),
        result_summary={"hits": int(len(result.positions)),
                        "strategy": result.strategy.index,
                        "plan_ms": round(result.plan_time_ms, 3),
                        "scan_ms": round(result.scan_time_ms, 3)},
        wall_ms=wall_ms)


def explain_analyze_sql(store, text: str) -> ExplainAnalyzeResult:
    """EXPLAIN ANALYZE of a SQL text: needs the SQL layer, not ported."""
    raise NotImplementedError(
        "explain_analyze_sql needs the SQL layer (sql/), which is not "
        "ported (ROADMAP A10)")
