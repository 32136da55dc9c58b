"""Prometheus text exposition of a metrics snapshot.

Renders a ``MetricRegistry.snapshot()`` (or one merged over processes
with ``metrics.merge_snapshots``) in the text exposition format (version
0.0.4): counters as ``<name>_total``, gauges (the ``storage.*`` and
``heat.*`` levels) as plain gauge samples, histograms and timers as
summaries with p50/p95/p99 quantile samples plus ``_sum``/``_count``.
The text is the JAX package's (``geomesa_tpu/obs/prom.py``) for the same
snapshot.

Metric names sanitize dot-separated registry keys into the Prometheus
charset under a ``geomesa_`` prefix (``query.pts.plan_ms`` →
``geomesa_query_pts_plan_ms``).  Empty histograms render with zero
quantiles, never ``inf``/``nan``, which scrapers reject.
"""

from __future__ import annotations

import math
import re

__all__ = ["prometheus_text", "metric_name"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

#: quantile sample keys in the snapshot → Prometheus quantile labels
_QUANTILES = (("p50", "0.5"), ("p95", "0.95"), ("p99", "0.99"))


def _fmt(v) -> str:
    f = float(v)
    if math.isnan(f) or math.isinf(f):
        f = 0.0
    return repr(round(f, 6))


def metric_name(key: str) -> str:
    """The Prometheus name of a registry key."""
    return "geomesa_" + _NAME_RE.sub("_", key)


def prometheus_text(snapshot: dict) -> str:
    """The exposition text of ``snapshot``, keys in sorted order."""
    lines: list[str] = []
    for key in sorted(snapshot):
        vals = snapshot[key]
        name = metric_name(key)
        if "value" in vals and "mean" not in vals:   # gauge (levels)
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {_fmt(vals['value'])}")
            continue
        if "mean" not in vals:           # plain counter
            lines.append(f"# TYPE {name}_total counter")
            lines.append(f"{name}_total {int(vals.get('count', 0))}")
            continue
        lines.append(f"# TYPE {name} summary")
        for skey, label in _QUANTILES:
            lines.append(f'{name}{{quantile="{label}"}} '
                         f"{_fmt(vals.get(skey, 0.0))}")
        count = int(vals.get("count", 0))
        total = vals.get("total", float(vals.get("mean", 0.0)) * count)
        lines.append(f"{name}_sum {_fmt(total)}")
        lines.append(f"{name}_count {count}")
    return "\n".join(lines) + "\n"
