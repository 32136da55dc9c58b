"""Stats process: run a stat DSL over query results (the reference's
StatsProcess / STATS_STRING hint, process/analytic/StatsProcess.scala +
iterators/StatsScan.scala)."""

from __future__ import annotations

import numpy as np

from ..stats.stat import (
    CountStat, Frequency, Histogram, MinMax, SeqStat, Stat, parse_stat,
)
from .density import _bbox_time_only

__all__ = ["stats_process"]


def stats_process(store, schema: str, query, stat_spec: str) -> Stat:
    """Evaluate ``stat_spec`` (e.g. "Count();MinMax(score)") over the
    features matching ``query``.

    On a mesh-backed store, pure bbox+time queries whose specs are all
    Count / MinMax / Histogram / Frequency take the PUSH-DOWN path:
    per-shard moments, histograms and count-min tables on the device,
    summed (:func:`_collective_stats`), with no host materialization of
    the hits.  Everything else materializes the hits and, on a mesh,
    folds per-shard partials through the Stat monoid (the reference's
    per-node StatsScan + client Reducer, iterators/StatsScan.scala:125).
    The JAX package's lean-profile push-downs are not ported (the port
    has no lean profile)."""
    mesh = getattr(store, "_mesh", None)
    if mesh is not None:
        pushed = _collective_stats(store, schema, query, stat_spec)
        if pushed is not None:
            return pushed
    result = store.query_result(schema, query)
    if mesh is not None and len(result.positions):
        from ..parallel.stats import merged_stats
        st = store._store(schema)
        shards = store._hit_residency(st, result.positions)
        return st.merge_stat_global(
            merged_stats(result.batch, stat_spec, shards))
    stat = parse_stat(stat_spec)
    if len(result.batch):
        stat.observe(result.batch)
    return stat


def _collective_stats(store, schema: str, query, stat_spec: str):
    """Device-resident stats for bbox+time filters over point schemas:
    one sharded scan per requested attribute.  Returns None whenever the
    filter needs a residual check or the spec holds a kind the sharded
    scans cannot serve (the caller then materializes the hits)."""
    from ..parallel.stats import sharded_frequency_scan, sharded_stats_scan
    from ..planning.planner import Query

    q = query if isinstance(query, Query) else Query.of(query)
    sft = store.get_schema(schema)
    st = store._store(schema)
    n_gate = 0 if st.batch is None else len(st.batch)
    if not (sft.is_points and sft.dtg_field and n_gate):
        return None
    plan = _bbox_time_only(q.filter, sft.geom_field, sft.dtg_field)
    if plan is None:
        return None
    boxes, lo, hi = plan
    stat = parse_stat(stat_spec)
    stats = stat.stats if isinstance(stat, SeqStat) else [stat]
    per_attr: dict[str, list] = {}
    freqs: list = []
    for s in stats:
        if isinstance(s, CountStat):
            continue
        if isinstance(s, (MinMax, Histogram)):
            per_attr.setdefault(s.attr, []).append(s)
        elif isinstance(s, Frequency):
            # device count-min sketch — numerics travel exact, strings as
            # a host-side UTF-8 digest (bit-identical either way); checked
            # before any scan runs so an ineligible spec wastes none
            col = st.batch.columns.get(s.attr)
            if col is None or (col.dtype.kind not in "if"
                               and col.dtype != object):
                return None
            freqs.append(s)
        else:
            return None  # other sketch kinds fold via the monoid path
    if any(len([s for s in ss if isinstance(s, Histogram)]) > 1
           for ss in per_attr.values()):
        return None
    idx = st.z3_index()
    count = None
    for attr, ss in per_attr.items():
        col = st.batch.columns.get(attr)
        if col is None or col.dtype.kind not in "if":
            return None
        hist = next((s for s in ss if isinstance(s, Histogram)), None)
        res = sharded_stats_scan(
            idx, boxes, lo, hi, values=col,
            hist_bins=hist.bins if hist else 0,
            hist_range=(hist.lo, hist.hi) if hist else None)
        count = res["count"]
        for s in ss:
            if isinstance(s, MinMax) and count:
                if col.dtype.kind == "i":
                    s.min = int(round(res["min"]))
                    s.max = int(round(res["max"]))
                else:
                    s.min, s.max = res["min"], res["max"]
            elif isinstance(s, Histogram):
                s.counts = np.asarray(res["histogram"], dtype=np.int64)
    for s in freqs:
        got = sharded_frequency_scan(idx, boxes, lo, hi,
                                     st.batch.column(s.attr),
                                     depth=s.depth, width=s.width)
        s.table = got.table
    if count is None and any(isinstance(s, CountStat) for s in stats):
        count = sharded_stats_scan(idx, boxes, lo, hi)["count"]
    for s in stats:
        if isinstance(s, CountStat):
            s.count = int(count)
    return stat
