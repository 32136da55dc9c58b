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

    On a lean store a Count()-only spec is answered from the keys when the
    count is provably exact (:func:`_lean_count_pushdown`), then a spec
    of Count, whole-extent Z3Histogram and indexed numeric attribute
    sub-stats over a window that covers the data's extent folds next to
    the keys (:func:`_lean_sketch_pushdown`); every other spec
    materializes the hits.  Tombstones turn the lean push-downs off, and
    an auth provider every push-down: their sketches cover rows the
    caller may not see."""
    mesh = getattr(store, "_mesh", None)
    st = store._store(schema)
    if getattr(store, "_auth_provider", None) is None:
        # the push-downs read sketches over every row: a caller with an
        # auth provider takes the materializing path, which sees only
        # the rows (and values) it may
        if getattr(st, "lean", False):
            pushed = _lean_count_pushdown(store, schema, query, stat_spec)
            if pushed is None:
                pushed = _lean_sketch_pushdown(store, schema, query,
                                               stat_spec)
            if pushed is not None:
                return pushed
        elif mesh is not None:
            pushed = _collective_stats(store, schema, query, stat_spec)
            if pushed is not None:
                return pushed
    if mesh is not None:
        result = store.query_result(schema, query)
        if len(result.positions):
            from ..parallel.stats import merged_stats
            shards = store._hit_residency(st, result.positions)
            return st.merge_stat_global(
                merged_stats(result.batch, stat_spec, shards))
        hits = result.batch
    else:
        # the hits' columns only (a lean store mints no feature ids)
        _, hits = store._hit_columns(schema, query)
    stat = parse_stat(stat_spec)
    if len(hits):
        stat.observe(hits)
    return stat


def _lean_count_pushdown(store, schema: str, query, stat_spec: str):
    """Count() on a lean store answered from the keys with NO candidate
    materialization (StatsScan.scala's Count aggregate): the tiered
    ``range_count``.  Returns None — falling back to the materializing
    path — unless the count is provably EXACT: every generation full-tier
    (value-exact device masks), or a whole-extent scan (cell-granular
    masks cover everything by construction)."""
    from ..planning.planner import Query

    stat = parse_stat(stat_spec)
    stats = stat.stats if isinstance(stat, SeqStat) else [stat]
    if not all(isinstance(s, CountStat) for s in stats):
        return None
    q = query if isinstance(query, Query) else Query.of(query)
    sft = store.get_schema(schema)
    st = store._store(schema)
    if not (sft.is_points and sft.dtg_field and st.batch is not None):
        return None
    plan = _bbox_time_only(q.filter, sft.geom_field, sft.dtg_field)
    if plan is None:
        return None
    boxes, lo, hi = plan
    if st.has_tombstones():
        # deleted rows need row visibility: the materializing path
        return None
    idx = st.z3_index()
    tiers = idx.tier_counts()
    if tiers["keys"] or tiers["host"]:
        # cell-granular tiers are exact only for whole-extent scans
        bb = st.stats_map().get(f"{sft.geom_field}_bbox")
        if bb is None or bb.is_empty:
            return None
        x0, y0, x1, y1 = bb.bounds
        covered = any(b[0] <= x0 and b[1] <= y0
                      and b[2] >= x1 and b[3] >= y1 for b in boxes)
        t_open = ((lo is None or (idx.t_min_ms is not None
                                  and lo <= idx.t_min_ms))
                  and (hi is None or (idx.t_max_ms is not None
                                      and hi >= idx.t_max_ms)))
        if not (covered and t_open):
            return None
    count = idx.range_count(boxes, lo, hi)
    for s in stats:
        s.count = int(count)
    return stat


def _lean_sketch_pushdown(store, schema: str, query, stat_spec: str):
    """Stat-sketch push-down on a lean store: when every sub-stat is
    pushable and the candidate set is exact, the whole spec answers from
    the index keys and NO candidate hit materializes.

    Exactness gates (docs/stats_pushdown.md): the filter is a pure
    bbox+time conjunction whose boxes COVER the data extent; Z3Histogram
    needs the index at the current key version, a matching period and a
    whole-extent window (its cells come straight off the keys, sealed
    generations' tables cached); Count over a whole-extent window is the
    live-row total; attribute sub-stats (MinMax, Histogram,
    DescriptiveStats, Frequency, TopK, Enumeration of an indexed numeric
    or date attribute) fold over that attribute's lean index keys with
    the exact sec (dtg) window — one ``sketch_scan`` per attribute — and
    a Count beside them (or with a selective window) rides such a fold.

    Returns the filled Stat, or ``None`` → the materializing path."""
    from ..planning.planner import Query
    from ..stats.sketch import (
        fill_stats_from_partial, flatten_stats, plan_pushdown,
    )

    q = query if isinstance(query, Query) else Query.of(query)
    sft = store.get_schema(schema)
    st = store._store(schema)
    if st.batch is None:
        return None
    smap = st.stats_map()
    n_rows = int(smap["count"].count)
    if n_rows == 0:
        return None
    plan0 = _bbox_time_only(q.filter, sft.geom_field, sft.dtg_field)
    if plan0 is None:
        return None
    boxes, lo, hi = plan0
    if st.has_tombstones():
        # deleted rows need row visibility: the materializing path
        return None
    bb = smap.get(f"{sft.geom_field}_bbox")
    if bb is None or bb.is_empty:
        return None
    x0, y0, x1, y1 = bb.bounds
    if not any(b[0] <= x0 and b[1] <= y0 and b[2] >= x1 and b[3] >= y1
               for b in boxes):
        return None
    mm = smap.get("dtg_minmax")
    if mm is not None and not mm.is_empty:
        t_open = ((lo is None or lo <= int(mm.min))
                  and (hi is None or hi >= int(mm.max)))
    else:
        t_open = lo is None and hi is None
    i64 = np.iinfo(np.int64)
    slo = i64.min if lo is None else int(lo)
    shi = i64.max if hi is None else int(hi)

    stat = parse_stat(stat_spec)
    stats = flatten_stats(stat)
    attr_types = {a: sft.attribute(a).type for a in st._lean_attr_names()}
    # Z3Histogram pushes down on a lean z3 store only (its cells come off
    # the z3 keys); a lean XZ store's attribute sub-stats still fold
    idx = st._lean_index() if st.lean_kind == "z3" else None
    z3_period = (idx.period if idx is not None and idx.version >= 2
                 else None)
    plan = plan_pushdown(stats, attr_types, st.lean_kind, sft.geom_field,
                         sft.dtg_field, slo, shi, t_open,
                         z3_period=z3_period)
    if plan is None:
        return None
    parts: dict = {}
    for attr, (fold, group) in plan.attr_groups.items():
        part = st._lean_attr_index(attr).sketch_scan(fold)
        parts[attr] = part
        fill_stats_from_partial(group, part, attr_types[attr])
    for s in plan.z3hists:
        s.counts = idx.z3_cell_counts(int(s.bits))
    if plan.counts:
        count = (parts[plan.count_source[5:]].count
                 if plan.count_source.startswith("attr:") else n_rows)
        for s in plan.counts:
            s.count = int(count)
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
