"""Query planner: strategy → index scan → residual filter → sort/limit.

The orchestration layer mirroring the reference's QueryPlanner
(geomesa-index-api/.../index/planning/QueryPlanner.scala:41-134): choose a
strategy (StrategyDecider), run the chosen index's scan to get candidate
positions, apply the full filter as a vectorized re-check (the reference's
secondary-filter / FilterTransformIterator role), then projection, sort
and max-features (configureQuery's hint handling, :157-230).

Exactness contract: whatever the index strategy returns is treated as a
*candidate superset*; the final mask is always the full filter evaluated
on candidates, so results are oracle-equal regardless of strategy.

The port serves the strategies of its store's indexes — ``z3`` (with
several time windows batched into one scan), ``z2``, ``xz3`` and ``xz2``
(candidates envelope-exact; the residual filter runs the exact geometry
predicate; a temporal-only ``xz3`` query scans the whole world), ``id``,
``attr:<name>`` (tier-refined by the query's time window, or by a
covering z3 plan where the attribute index carries the z3 tier, plus the
rows appended since the index was built), ``full`` and ``none``, and an
OR split over them; on a lean store ``z3``, ``xz3``, ``xz2`` and
``attr`` run on the tiered lean indexes, costed by the store's sketch-fed estimator where it has
one, and a scan whose probe observes far more candidates than costed
replans once (planning/adaptive.py).  Hints it does not serve raise.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np

from ..config import PlanningProperties, QueryProperties
from ..features.batch import FeatureBatch
from ..features.feature_type import FeatureType
from ..filters.ast import And, Filter, IdFilter, Include, Not, Or
from ..filters.ecql import parse_ecql
from ..filters.evaluate import evaluate_filter
from ..geometry.types import Polygon
from .adaptive import ReplanSignal, replan_scope
from .explain import Explainer, ExplainNull
from .strategy import FilterStrategy, StrategyDecider

__all__ = ["Query", "QueryPlanner", "QueryResult", "QueryTimeoutError"]

#: query hints the port does not serve: each raises rather than being
#: silently ignored
_UNSERVED_HINTS = ("SAMPLING", "SAMPLE_BY")


@dataclass
class Query:
    """A query against one schema (the GeoTools Query analog)."""

    filter: Filter = Include
    properties: list | None = None       # projection; None = all
    sort_by: str | None = None           # attribute name
    sort_desc: bool = False
    max_features: int | None = None
    crs: str | None = None               # output CRS; None = storage (4326)
    hints: dict = field(default_factory=dict)

    @classmethod
    def of(cls, filter_or_ecql="INCLUDE", **kw) -> "Query":
        f = (parse_ecql(filter_or_ecql)
             if isinstance(filter_or_ecql, str) else filter_or_ecql)
        return cls(filter=f, **kw)


@dataclass
class QueryResult:
    #: materialized hit rows
    batch: FeatureBatch | None
    positions: np.ndarray
    strategy: FilterStrategy
    plan_time_ms: float
    scan_time_ms: float


class QueryTimeoutError(TimeoutError):
    """Query exceeded ``geomesa.query.timeout`` (the reference's
    ThreadManagement reaper killing runaway scans)."""


class QueryPlanner:
    """Plans and runs queries against a store's index set."""

    def __init__(self, sft: FeatureType, store):
        self.sft = sft
        self.store = store  # _SchemaStore (datastore.py)

    def run(self, query: Query, explain: Explainer | None = None,
            allowed: np.ndarray | None = None,
            materialize: bool = True) -> QueryResult:
        """Plan and execute.  ``allowed`` is an optional per-feature bool
        mask (row-level security, lean tombstones) applied before
        sort/limit so that ``max_features`` fills from authorized rows
        only.  ``materialize=False`` skips the result-batch gather
        (positions only: the caller reads the columns it needs)."""
        for hint in _UNSERVED_HINTS:
            if hint in query.hints:
                raise NotImplementedError(f"query hint {hint} is not ported")
        if query.crs:
            raise NotImplementedError(
                "output CRS reprojection (Query.crs) is not ported")
        explain = explain or ExplainNull()
        store = self.store
        batch = store.batch
        explain.push(lambda: f"Planning query on '{self.sft.name}' "
                             f"({len(batch)} features)")
        explain(lambda: f"Filter: {query.filter!r}")

        timeout_s = QueryProperties.QUERY_TIMEOUT.to_int()
        deadline = (time.perf_counter() + timeout_s) if timeout_s else None

        def check_deadline(stage: str):
            if deadline is not None and time.perf_counter() > deadline:
                raise QueryTimeoutError(
                    f"query on {self.sft.name!r} exceeded "
                    f"{timeout_s}s during {stage}")

        t0 = time.perf_counter()
        decider = StrategyDecider(
            self.sft, store.stats_map(), len(batch),
            allowed_indices=store.query_indices,
            attr_z3_tier=not store.lean,
            servable_attrs=(set(store._lean_attr_names())
                            if store.lean else None),
            estimator=store.estimator())
        strategy, _ = decider.decide_with_options(
            query.filter, explain, forced=query.hints.get("QUERY_INDEX"))
        plan_ms = (time.perf_counter() - t0) * 1000
        check_deadline("planning")

        t1 = time.perf_counter()
        try:
            with self._replan_scope_for(strategy, query):
                candidates = self._scan(strategy, query, explain)
        except ReplanSignal as sig:
            # adaptive mid-query replan: the scan's probe observed
            # candidates diverging past the threshold — re-decide with
            # the actual folded in, re-scan ONCE
            strategy, candidates = self._replan(sig, strategy, decider,
                                                query, explain)
        check_deadline("index scan")
        if candidates is None:  # full scan
            mask = evaluate_filter(query.filter, batch)
            positions = np.flatnonzero(mask)
        elif len(candidates):
            # lean column stores re-check through an id-free ChunkView: a
            # take() would mint O(candidates) feature-id strings just to
            # throw them away.  Id-predicated filters still need real ids.
            if (hasattr(batch, "take_view")
                    and not _filter_needs_ids(query.filter)):
                sub = batch.take_view(candidates)
            else:
                sub = batch.take(candidates)
            mask = evaluate_filter(query.filter, sub)
            positions = candidates[mask]
        else:
            positions = np.asarray(candidates, dtype=np.int64)
        scan_ms = (time.perf_counter() - t1) * 1000
        check_deadline("filtering")
        explain(lambda: f"Scan: {len(positions)} hits "
                        f"(plan {plan_ms:.1f}ms, scan {scan_ms:.1f}ms)")
        # estimate-vs-actual close-out: rows scanned (the candidate
        # superset; the whole table on a full scan) and matched
        actual_scanned = int(len(batch) if candidates is None
                             else len(candidates))
        ratio = (float(strategy.cost) + 1.0) / (actual_scanned + 1.0)
        explain(lambda: f"Estimate audit: predicted {strategy.cost:.0f} "
                        f"rows ({strategy.source}), scanned "
                        f"{actual_scanned}, matched "
                        f"{len(positions)} (ratio {ratio:.2f}x)")

        if allowed is not None and len(positions):
            positions = positions[allowed[positions]]
        positions = self._sort_limit(positions, batch, query)
        if not materialize:
            return QueryResult(None, positions, strategy, plan_ms, scan_ms)
        properties = query.properties
        if properties is None and "COLUMN_GROUP" in query.hints:
            group = query.hints["COLUMN_GROUP"]
            groups = self.sft.column_groups
            if group not in groups:
                raise ValueError(f"no column group {group!r} on "
                                 f"{self.sft.name!r}")
            properties = groups[group]
        take_cols = None
        if properties is not None:
            # projection pushes INTO the take: only the projected
            # physical columns are gathered for the hit rows
            take_cols = set()
            for p in properties:
                if self.sft.attribute(p).is_geometry:
                    take_cols.update((f"{p}_x", f"{p}_y", f"{p}_bbox"))
                else:
                    take_cols.add(p)
        result_batch = batch.take(positions, columns=take_cols)
        if properties is not None:
            result_batch = _project(result_batch, properties)
        explain.pop()
        return QueryResult(result_batch, positions, strategy, plan_ms,
                           scan_ms)

    # -- adaptive replanning ---------------------------------------------
    def _replan_scope_for(self, strategy: FilterStrategy, query: Query):
        """A replan scope around one strategy's scan, or a null context
        when replanning can't help: disabled by config, strategy pinned
        by a QUERY_INDEX hint, no probe on the chosen path ('none' /
        'id' / 'full'), or an or-split (its per-branch probe counts
        can't re-cost the split as a whole)."""
        if (query.hints.get("QUERY_INDEX") is not None
                or strategy.index in ("none", "id", "full", "or-split")):
            return contextlib.nullcontext()
        threshold = float(PlanningProperties.REPLAN_THRESHOLD.get())
        if threshold <= 0.0:
            return contextlib.nullcontext()
        return replan_scope(float(strategy.cost), threshold,
                            int(PlanningProperties.REPLAN_MIN_ROWS.get()))

    def _replan(self, sig: ReplanSignal, strategy: FilterStrategy,
                decider: StrategyDecider, query: Query,
                explain: Explainer) -> tuple[FilterStrategy, np.ndarray]:
        """One bounded mid-query replan: the aborted scan's observed
        candidate count replaces the mispredicted strategy's cost and the
        decider re-runs; the re-scan executes OUTSIDE any replan scope,
        so a query replans at most once.  Exactness is structural — the
        probe-point abort happened before any gather (nothing collected,
        the probe's seeks dropped with the aborted call), and the new
        strategy's candidate superset passes the same residual filter as
        always."""
        explain(lambda: f"Replanning: {strategy.index} observed "
                        f"{sig.observed} candidates at {sig.point} "
                        f"vs estimate {sig.estimate:.0f}")
        try:
            new, _ = decider.decide_with_options(
                query.filter, explain,
                observed={strategy.index: float(sig.observed)})
        except RuntimeError:
            # blocked full-table scan surfaced by the re-decide: finish
            # under the original strategy rather than fail a query that
            # was already running
            new = strategy
        return new, self._scan(new, query, explain)

    # -- strategy execution ----------------------------------------------
    def _scan(self, strategy: FilterStrategy, query: Query,
              explain: Explainer) -> np.ndarray | None:
        store = self.store
        name = strategy.index
        if name == "none":
            return np.empty(0, dtype=np.int64)
        if name == "or-split":
            explain(lambda: f"OR-split across {len(strategy.branches)} "
                            "indexed branches")
            return self._scan_or_split(strategy, query, explain)
        if name == "full":
            explain("Executing full-table scan")
            return None
        if (name not in ("z3", "z2", "xz3", "xz2", "id")
                and not name.startswith("attr:")):
            raise NotImplementedError(f"strategy {name!r} is not ported")
        explain(lambda: f"Executing {name} index scan")
        if name == "id":
            return store.id_index().query(strategy.ids)
        if name.startswith("attr:"):
            return self._add_tail(self._scan_attr(strategy), name)
        if name in ("xz3", "xz2"):
            return self._scan_xz(strategy)
        boxes = [g.envelope.as_tuple() for g in strategy.geometries] or [
            (-180.0, -90.0, 180.0, 90.0)
        ]
        if name == "z2":
            return store.z2_index().query(boxes)
        idx = store.z3_index()
        # sketch-sized decomposition budget: only ever set by the lean
        # estimator, whose index accepts the keyword
        mr = ({} if strategy.max_ranges is None
              else {"max_ranges": int(strategy.max_ranges)})
        if len(strategy.intervals) > 1:
            # batch disjoint time windows into ONE scan (the
            # multi-window BatchScanner pattern)
            explain(lambda: f"Auto-batched {len(strategy.intervals)} "
                            "time windows into one dispatch")
            parts = idx.query_many(
                [(boxes, lo, hi) for lo, hi in strategy.intervals], **mr)
            return _union(list(parts))
        parts = [idx.query(boxes, lo, hi, **mr)
                 for lo, hi in strategy.intervals]
        return _union(parts)

    def _scan_xz(self, strategy: FilterStrategy) -> np.ndarray:
        """Candidates of an xz3 / xz2 strategy, envelope-exact (the
        residual filter runs the exact geometry predicate), with the rows
        appended since a kept index's build."""
        name = strategy.index
        if name == "xz2":
            idx = self.store.xz2_index()
            parts = [idx.query(g, exact=False) for g in strategy.geometries]
            return self._add_tail(_union(parts), name)
        idx = self.store.xz3_index()
        # temporal-only: scan the whole world (a strategy with no geometry
        # would otherwise produce no scan at all)
        geoms_q = strategy.geometries or (
            Polygon([(-180.0, -90.0), (180.0, -90.0), (180.0, 90.0),
                     (-180.0, 90.0)]),)
        parts = [idx.query(g, lo, hi, exact=False)
                 for g in geoms_q for lo, hi in strategy.intervals]
        return self._add_tail(_union(parts), name)

    def _scan_attr(self, strategy: FilterStrategy) -> np.ndarray:
        """Candidates of an attribute strategy: its predicate on the
        attribute index, with the covering secondary refinement of the
        index's tier (exactness comes from the residual filter)."""
        idx = self.store.attribute_index(strategy.index[5:])
        (_, kind, payload) = strategy.attr_values[0]
        sec_window = None
        z3_ranges = None
        if strategy.intervals and idx.secondary is not None:
            los = [iv[0] for iv in strategy.intervals]
            his = [iv[1] for iv in strategy.intervals]
            sec_window = (None if any(v is None for v in los) else min(los),
                          None if any(v is None for v in his) else max(his))
        if idx.sec_z is not None and (strategy.geometries
                                      or strategy.intervals):
            z3_ranges = self._attr_z3_ranges(strategy)
        if kind == "equals":
            return idx.query_equals(payload, sec_window, z3_ranges)
        if kind == "in":
            return idx.query_in(payload, sec_window, z3_ranges)
        if kind == "range":
            lo, hi, lo_inc, hi_inc = payload
            return idx.query_range(lo, hi, lo_inc, hi_inc)
        if kind == "prefix":
            return idx.query_prefix(payload)
        raise ValueError(f"unknown attribute query {kind!r}")

    def _attr_z3_ranges(self, strategy: FilterStrategy):
        """Covering (bin, zlo, zhi) plan for the attribute index's z3
        tier; open time bounds clamp to the data's extent (the same
        clamping the primary z3 index applies)."""
        from ..index.z3 import plan_z3_query
        # the data extent from the maintained MinMax stat (O(1)); one
        # column scan only when the stat is absent
        mm = self.store.stats_map().get("dtg_minmax")
        if mm is not None and not mm.is_empty:
            data_lo, data_hi = int(mm.min), int(mm.max)
        else:
            dtg = self.store.batch.column(self.sft.dtg_field)
            if len(dtg) == 0:
                return None
            data_lo, data_hi = int(dtg.min()), int(dtg.max())
        lo, hi = data_lo, data_hi
        if strategy.intervals:
            los = [iv[0] for iv in strategy.intervals]
            his = [iv[1] for iv in strategy.intervals]
            if not any(v is None for v in los):
                lo = max(lo, min(los))
            if not any(v is None for v in his):
                hi = min(hi, max(his))
        boxes = ([g.envelope.as_tuple() for g in strategy.geometries]
                 or [(-180.0, -90.0, 180.0, 90.0)])
        plan = plan_z3_query(boxes, lo, hi, self.sft.z3_interval,
                             max_ranges=256)
        if plan.num_ranges == 0:
            return None
        return plan.rbin, plan.rzlo, plan.rzhi

    def _add_tail(self, cand: np.ndarray, key: str) -> np.ndarray:
        """Union the rows appended after a kept index's build into its
        candidate set (kept indexes serve their covered rows; the tail
        rides as unconditional candidates and the residual filter keeps
        results exact)."""
        tail = self.store.index_tail(key)
        if tail is None or not len(tail):
            return cand
        return _union([cand, tail])

    def _scan_or_split(self, strategy: FilterStrategy, query: Query,
                       explain: Explainer) -> np.ndarray | None:
        """Execute an OR-split (FilterSplitter's disjunction rewrite,
        planning/FilterSplitter.scala:294-307), batching its z3 branches
        into one multi-window scan and its z2 branches into one
        multi-box-set scan; the planner's full-OR residual re-check keeps
        the union exact."""
        store = self.store
        world = (-180.0, -90.0, 180.0, 90.0)
        z3_windows: list = []
        z2_sets: list = []
        rest: list = []
        for _, st in strategy.branches:
            bx = [g.envelope.as_tuple() for g in st.geometries] or [world]
            if st.index == "z3" and st.intervals:
                z3_windows.extend((bx, lo, hi) for lo, hi in st.intervals)
            elif st.index == "z2":
                z2_sets.append(bx)
            else:
                rest.append(st)
        parts = []
        if len(z3_windows) > 1:
            explain(lambda: f"Auto-batched {len(z3_windows)} z3 windows "
                            "into one dispatch")
            parts.extend(store.z3_index().query_many(z3_windows))
        elif z3_windows:
            bx, lo, hi = z3_windows[0]
            parts.append(store.z3_index().query(bx, lo, hi))
        if len(z2_sets) > 1:
            explain(lambda: f"Auto-batched {len(z2_sets)} z2 box sets "
                            "into one dispatch")
            parts.extend(store.z2_index().query_many(z2_sets))
        elif z2_sets:
            parts.append(store.z2_index().query(z2_sets[0]))
        for st in rest:
            cand = self._scan(st, query, explain)
            if cand is None:
                # a full-scan branch would lose its rows from the union —
                # degrade the whole split to one full scan instead
                return None
            parts.append(cand)
        parts = [p for p in parts if len(p)]
        return _union(parts) if parts else np.empty(0, dtype=np.int64)

    def _sort_limit(self, positions: np.ndarray, batch: FeatureBatch,
                    query: Query) -> np.ndarray:
        if query.sort_by:
            keys = batch.column(query.sort_by)[positions]
            if keys.dtype == object:
                # object columns may mix None (masked/sparse values) with
                # comparables: sort Nones last, stably
                order = np.asarray(sorted(
                    range(len(keys)),
                    key=lambda i: (keys[i] is None, keys[i]
                                   if keys[i] is not None else 0)),
                    dtype=np.int64)
            else:
                order = np.argsort(keys, kind="stable")
            if query.sort_desc:
                order = order[::-1]
            positions = positions[order]
        if query.max_features is not None:
            positions = positions[: query.max_features]
        return positions


def _filter_needs_ids(f: Filter) -> bool:
    """Does any node of the filter read feature ids?  (IdFilter is the one
    evaluate_filter branch touching ``batch.ids`` — id-free filters may
    re-check over an id-less ChunkView.)"""
    if isinstance(f, IdFilter):
        return True
    if isinstance(f, (And, Or)):
        return any(_filter_needs_ids(p) for p in f.filters)
    if isinstance(f, Not):
        return _filter_needs_ids(f.filter)
    return False


def _union(parts: list[np.ndarray]) -> np.ndarray:
    parts = [p for p in parts if len(p)]
    if not parts:
        return np.empty(0, dtype=np.int64)
    return np.unique(np.concatenate(parts))


def _project(batch: FeatureBatch, properties: list) -> FeatureBatch:
    """Column projection (the reference's transform schemas,
    QueryPlanner.setQueryTransforms)."""
    keep: dict = {}
    for p in properties:
        attr = batch.sft.attribute(p)
        if attr.is_geometry:
            for suffix in ("_x", "_y", "_bbox"):
                if f"{p}{suffix}" in batch.columns:
                    keep[f"{p}{suffix}"] = batch.columns[f"{p}{suffix}"]
        else:
            keep[p] = batch.columns[p]
    sub_attrs = tuple(a for a in batch.sft.attributes if a.name in properties)
    sub_sft = FeatureType(batch.sft.name, sub_attrs,
                          batch.sft.default_geom if batch.sft.default_geom in properties else None,
                          batch.sft.user_data)
    return FeatureBatch(sub_sft, keep, batch.ids,
                        batch.geoms if sub_sft.default_geom else None)
