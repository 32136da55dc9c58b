"""Filter strategies and cost-based index selection.

Mirrors the reference's strategy machinery: per-index applicability
heuristics (geomesa-index-api/.../index/strategies/
{SpatioTemporalFilterStrategy, SpatialFilterStrategy,
AttributeFilterStrategy, IdFilterStrategy}.scala) and the cost-based
decider (planning/StrategyDecider.scala:67-112,140-152) that estimates
per-strategy feature counts from stats and picks the cheapest.

The port offers the JAX package's strategies: ``id`` for feature-id
filters, ``z3`` on point schemas with a dtg attribute and ``xz3`` on
non-point ones (bounded intervals only), ``z2`` on point schemas and
``xz2`` on non-point ones, ``attr:<name>`` for each indexed-attribute
predicate at the top AND level, the full scan, the empty plan, and an OR
split over them, in the JAX package's order so that ties in the cost
comparison resolve alike.  A lean store allows its scale index
(``z3``, ``xz3`` or ``xz2``), ``id`` and, for its lexicode-indexable
attributes, ``attr``, so a pure-spatial query runs on z3 (or xz3) with
an open interval; there z3 and attribute options are costed from the
sketch-fed estimator (planning/estimator.py) when the store has one (an
xz3 option asks it too, and its missing z3 table answers None).  A
replanning query folds its observed candidate count back in
(``decide_with_options(observed=)``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from ..config import PlanningProperties, QueryProperties
from ..features.feature_type import FeatureType
from ..filters.ast import (
    And, Between, Filter, IdFilter, In, Like, Or, PropertyCompare, _Exclude,
)
from ..filters.extract import extract_geometries, extract_intervals
from ..stats.stat import EnumerationStat, Frequency, Histogram, MinMax
from .explain import Explainer, ExplainNull

__all__ = ["FilterStrategy", "StrategyDecider"]


@dataclass
class FilterStrategy:
    """A candidate execution strategy: which index serves the query and at
    what estimated cost (feature count to scan)."""

    #: 'z3' | 'z2' | 'xz3' | 'xz2' | 'id' | 'attr:<name>' | 'or-split'
    #: | 'full' | 'none'
    index: str
    cost: float
    geometries: tuple = ()      # extracted query geometries
    intervals: tuple = ()       # extracted (lo_ms, hi_ms)
    ids: tuple = ()             # extracted feature ids
    branches: tuple = ()        # ('or-split') per-branch FilterStrategy
    attr_values: tuple = ()     # attribute predicate descriptors
    #: which estimator tier produced ``cost``: 'sketch' (per-generation
    #: sketches), 'stats' (whole-store stats), 'heuristic' (fallback
    #: constants), or 'observed' (a replan folded a scan's actual in)
    source: str = "heuristic"
    #: sketch-sized covering-range budget for z3/xz scans; None = the
    #: geomesa.scan.ranges.target default
    max_ranges: int | None = None

    def __repr__(self):
        return f"FilterStrategy({self.index}, cost={self.cost:.0f})"


def _collect_id_filters(f: Filter) -> tuple:
    """Feature ids of the id filters at the top AND level."""
    if isinstance(f, IdFilter):
        return tuple(f.ids)
    if isinstance(f, And):
        out = []
        for p in f.filters:
            out.extend(_collect_id_filters(p))
        return tuple(out)
    return ()


def _collect_attr_predicates(f: Filter, indexed: set[str]) -> list:
    """(attr, kind, payload) descriptors for indexed-attribute predicates
    at the top AND level."""
    out = []
    if isinstance(f, And):
        for p in f.filters:
            out.extend(_collect_attr_predicates(p, indexed))
        return out
    if isinstance(f, PropertyCompare) and f.prop in indexed:
        if f.op == "=":
            out.append((f.prop, "equals", f.value))
        elif f.op in ("<", "<="):
            out.append((f.prop, "range", (None, f.value, True, f.op == "<=")))
        elif f.op in (">", ">="):
            out.append((f.prop, "range", (f.value, None, f.op == ">=", True)))
    elif isinstance(f, Between) and f.prop in indexed:
        out.append((f.prop, "range", (f.lo, f.hi, True, True)))
    elif isinstance(f, In) and f.prop in indexed:
        out.append((f.prop, "in", tuple(f.values)))
    elif isinstance(f, Like) and f.prop in indexed and not f.case_insensitive:
        pat = f.pattern
        if pat and "%" not in pat[:-1] and pat.endswith("%") and "_" not in pat:
            out.append((f.prop, "prefix", pat[:-1]))
    return out


class StrategyDecider:
    """Enumerate viable strategies for a filter and pick the cheapest."""

    def __init__(self, sft: FeatureType, stats: dict | None = None,
                 total_count: int = 0,
                 allowed_indices: set[str] | None = None,
                 attr_z3_tier: bool = True,
                 servable_attrs: set[str] | None = None,
                 estimator=None):
        """``allowed_indices`` further restricts the offered strategies
        beyond the schema's ``geomesa.indices.enabled`` user data (the
        indexes the store has; None = all).  ``attr_z3_tier``: whether
        the store's attribute index carries a z3 secondary (the default
        profile's does; the lean one tiers by date only) — costing a
        spatial discount the index cannot deliver would mis-prefer attr
        over z3.  ``servable_attrs``: the attributes the store can
        index-serve (None = every indexed attribute) — the lean lexicode
        covers numerics, dates and strings only.  ``estimator``: a
        :class:`~geomesa_tpu_torch.planning.estimator.CardinalityEstimator`
        answering z3 and attribute selectivity from per-generation
        sketches — the preferred costing tier when it can answer; ignored
        while ``geomesa.planning.estimator.enabled`` is off."""
        self.sft = sft
        self.stats = stats or {}
        self.total = max(1, total_count)
        self.allowed_indices = allowed_indices
        self.attr_z3_tier = attr_z3_tier
        self.servable_attrs = servable_attrs
        self.estimator = (
            estimator if estimator is not None
            and PlanningProperties.ESTIMATOR_ENABLED.to_bool() else None)

    # -- cost estimates (StatsBasedEstimator spirit) ----------------------
    def _spatial_fraction(self, geometries) -> float:
        """Estimated fraction of the data a query geometry set covers:
        the intersection with the DATA extent (the maintained bbox
        sketch) over that extent — a box covering all the data costs
        ~1.0 even when it is tiny against the world, so a selective
        attribute strategy can beat z3 there."""
        if not geometries:
            return 1.0
        bb = self.stats.get(f"{self.sft.geom_field}_bbox")
        if bb is not None and not bb.is_empty:
            x0, y0, x1, y1 = bb.bounds

            def axis(qlo, qhi, lo, hi):
                if hi - lo <= 0:   # degenerate extent: in or out
                    return 1.0 if qlo <= lo <= qhi else 0.0
                return max(0.0, (min(qhi, hi) - max(qlo, lo)) / (hi - lo))

            inter = sum(axis(g.envelope.as_tuple()[0],
                             g.envelope.as_tuple()[2], x0, x1)
                        * axis(g.envelope.as_tuple()[1],
                               g.envelope.as_tuple()[3], y0, y1)
                        for g in geometries)
            return min(1.0, inter)
        area = sum(g.envelope.area for g in geometries)
        return min(1.0, area / (360.0 * 180.0))

    def _temporal_fraction(self, intervals) -> float:
        if not intervals:
            return 1.0
        mm: MinMax | None = self.stats.get("dtg_minmax")
        if mm is None or mm.is_empty or mm.max == mm.min:
            return 0.1
        span = float(mm.max - mm.min)
        covered = 0.0
        for lo, hi in intervals:
            lo = mm.min if lo is None else lo
            hi = mm.max if hi is None else hi
            covered += max(0.0, min(float(hi), float(mm.max)) - max(float(lo), float(mm.min)))
        return min(1.0, covered / span)

    def _frac_source(self, spatial: bool, temporal: bool) -> str:
        """Whether the fraction-product cost for a z-index strategy was
        stats-backed ('stats') or ran on fallback constants
        ('heuristic')."""
        ok = True
        if spatial:
            bb = self.stats.get(f"{self.sft.geom_field}_bbox")
            ok = bb is not None and not bb.is_empty
        if ok and temporal:
            mm = self.stats.get("dtg_minmax")
            ok = mm is not None and not mm.is_empty and mm.max != mm.min
        return "stats" if ok else "heuristic"

    def _attr_cost(self, attr: str, kind: str, payload) -> tuple[float, str]:
        """(cost, source) of an attribute predicate from whole-store
        stats, falling back to the named heuristic selectivities
        (``geomesa.planning.selectivity.*``)."""
        enum: EnumerationStat | None = self.stats.get(f"{attr}_enumeration")
        freq: Frequency | None = self.stats.get(f"{attr}_frequency")
        hist: Histogram | None = self.stats.get(f"{attr}_histogram")
        if kind == "equals":
            if enum is not None and not enum.is_empty:
                return float(enum.counts.get(
                    payload, enum.counts.get(str(payload), 0))), "stats"
            if freq is not None and not freq.is_empty:
                return float(freq.count(payload)), "stats"
            return self.total * float(
                PlanningProperties.SELECTIVITY_EQUALS_DEFAULT.get()), \
                "heuristic"
        if kind == "in":
            total, source = 0.0, "stats"
            for v in payload:
                c, s = self._attr_cost(attr, "equals", v)
                total += c
                if s != "stats":
                    source = s
            return total, source
        if kind == "range" and hist is not None and not hist.is_empty:
            lo, hi, *_ = payload
            return float(hist.estimate_range(
                float(lo) if lo is not None else hist.lo,
                float(hi) if hi is not None else hist.hi)), "stats"
        return self.total * float(
            PlanningProperties.SELECTIVITY_RANGE_DEFAULT.get()), "heuristic"

    def _estimate_z3(self, geometries, intervals):
        """Sketch-tier candidate estimate for a z3 scan, or None when the
        tier can't answer (no estimator, no z3 cell-count sketch).
        Estimation must never fail a plan."""
        if self.estimator is None or not intervals:
            return None
        boxes = [g.envelope.as_tuple() for g in geometries]
        if not boxes:
            boxes = [(-180.0, -90.0, 180.0, 90.0)]
        try:
            return self.estimator.z3_rows(boxes, intervals)
        except Exception:  # noqa: BLE001 — fall back to the stats tier
            return None

    def _estimate_attr(self, attr: str, kind: str, payload):
        """Sketch-tier row estimate for an attribute predicate, or None
        when the tier can't answer."""
        if self.estimator is None:
            return None
        try:
            if kind == "equals":
                return self.estimator.attr_equals_rows(attr, (payload,))
            if kind == "in":
                return self.estimator.attr_equals_rows(attr, payload)
            if kind == "range":
                lo, hi, *_ = payload
                return self.estimator.attr_range_rows(attr, lo, hi)
        except Exception:  # noqa: BLE001 — fall back to the stats tier
            return None
        return None

    def _z3_option(self, geometries, intervals, frac_cost: float,
                   frac_source: str, index: str = "z3") -> FilterStrategy:
        """A z3 (or xz3) option costed by the sketch tier when it answers,
        else by the fraction product."""
        cost, source, mr = frac_cost, frac_source, None
        est = self._estimate_z3(geometries, intervals)
        if est is not None:
            cost, source = float(est), "sketch"
            mr = self.estimator.size_max_ranges(est)
        return FilterStrategy(index, max(1.0, cost), geometries=geometries,
                              intervals=intervals, source=source,
                              max_ranges=mr)

    # -- strategy enumeration ---------------------------------------------
    def _enabled(self, index: str) -> bool:
        """Schema-level index restriction (``geomesa.indices.enabled``
        user data — the reference's per-schema index configuration,
        RichSimpleFeatureType.getIndices): a disabled index is never
        offered as a strategy."""
        if (self.allowed_indices is not None
                and index not in self.allowed_indices):
            return False
        enabled = self.sft.enabled_indices
        return enabled is None or index in enabled

    def strategies(self, f: Filter) -> list[FilterStrategy]:
        sft = self.sft
        out: list[FilterStrategy] = []

        ids = _collect_id_filters(f)
        if ids and self._enabled("id"):
            out.append(FilterStrategy("id", float(len(ids)), ids=ids))

        geom = sft.geom_field
        dtg = sft.dtg_field
        geoms = extract_geometries(f, geom) if geom else None
        intervals = extract_intervals(f, dtg) if dtg else None

        if geoms is not None and geoms.disjoint or intervals is not None and intervals.disjoint:
            return [FilterStrategy("none", 0.0)]

        spatial = bool(geoms and geoms.values)
        # fully-bounded intervals serve either z index; the z3 POINT index
        # also serves half-open intervals because it clamps them to the
        # data's time extent (the reference requires bounded intervals,
        # SpatioTemporalFilterStrategy — clamping removes that need here)
        all_ivs = tuple(intervals.values) if intervals else ()
        bounded = tuple(iv for iv in all_ivs
                        if iv[0] is not None and iv[1] is not None)
        usable = all_ivs if sft.is_points else bounded
        temporal = bool(usable)

        sp_frac = self._spatial_fraction(geoms.values if geoms else ())
        tm_frac = self._temporal_fraction(usable)

        if temporal and dtg:
            idx = "z3" if sft.is_points else "xz3"
            if self._enabled(idx):
                qgeoms = tuple(geoms.values) if geoms else ()
                out.append(self._z3_option(
                    qgeoms, usable, self.total * sp_frac * tm_frac,
                    self._frac_source(spatial, True), index=idx))
        if spatial:
            idx = "z2" if sft.is_points else "xz2"
            if self._enabled(idx):
                out.append(FilterStrategy(
                    idx, max(1.0, self.total * sp_frac),
                    geometries=tuple(geoms.values),
                    intervals=tuple(intervals.values) if intervals else (),
                    source=self._frac_source(True, False)))
            elif (not temporal and dtg and sft.is_points
                  and self._enabled("z3")):
                # no z2 available (the lean profile serves only the z3
                # scale index, or geomesa.indices.enabled=z3): a
                # pure-spatial query runs on z3 with an OPEN interval,
                # which the point index clamps to the data's time extent
                out.append(self._z3_option(
                    tuple(geoms.values), ((None, None),),
                    self.total * sp_frac, self._frac_source(True, False)))
            elif (not temporal and dtg and not sft.is_points
                  and self._enabled("xz3")):
                # the non-point analog: a lean XZ3 schema (no xz2) serves
                # pure-spatial queries with an open interval, which the
                # xz3 indexes clamp to the data's extent
                out.append(FilterStrategy(
                    "xz3", max(1.0, self.total * sp_frac),
                    geometries=tuple(geoms.values),
                    intervals=((None, None),),
                    source=self._frac_source(True, False)))

        indexed = ({a.name for a in sft.attributes if a.indexed}
                   if self._enabled("attr") else set())
        if self.servable_attrs is not None:
            indexed &= self.servable_attrs
        for attr, kind, payload in _collect_attr_predicates(f, indexed):
            cost, source = self._attr_cost(attr, kind, payload)
            est = self._estimate_attr(attr, kind, payload)
            if est is not None:
                cost, source = float(est), "sketch"
            # secondary tiers narrow equality/IN runs (tiered-range
            # assembly, api/GeoMesaFeatureIndex.scala:248-338): the date
            # tier by the temporal fraction; the z3 tier (schemas with
            # point geom + dtg) by the spatial fraction too
            tiered_ivs = all_ivs if dtg and kind in ("equals", "in") else ()
            tiered_geoms = ()
            if tiered_ivs:
                cost *= self._temporal_fraction(all_ivs)
            if (dtg and geom and sft.is_points and kind in ("equals", "in")
                    and spatial and self.attr_z3_tier):
                tiered_geoms = tuple(geoms.values)
                cost *= sp_frac
            out.append(FilterStrategy(
                f"attr:{attr}", max(1.0, cost),
                attr_values=((attr, kind, payload),),
                intervals=tiered_ivs, geometries=tiered_geoms,
                source=source))

        # the full-scan cost is the maintained row count — exact
        out.append(FilterStrategy("full", float(self.total),
                                  source="stats"))
        return out

    def decide(self, f: Filter, explain: Explainer | None = None,
               forced: str | None = None) -> FilterStrategy:
        """``forced`` pins the strategy to a named index (the reference's
        QUERY_INDEX hint, index/planning/StrategyDecider.scala:67-79:
        a requested index bypasses cost comparison)."""
        return self.decide_with_options(f, explain, forced)[0]

    def decide_with_options(
            self, f: Filter, explain: Explainer | None = None,
            forced: str | None = None,
            observed: dict | None = None,
    ) -> tuple[FilterStrategy, tuple]:
        """:meth:`decide` plus every option costed.  ``observed`` maps
        strategy-index names to actual candidate counts a replanning
        query measured mid-scan (planning/adaptive.py): a named
        strategy's cost is replaced by its observed count before
        comparison."""
        explain = explain or ExplainNull()
        chosen, options = self._decide(f, observed)
        explain.push("Strategy selection:")
        for o in options:
            explain(lambda o=o: f"option {o.index}: estimated cost "
                    f"{o.cost:.0f} [{o.source}]")
        if forced is not None:
            match = [o for o in options
                     if o.index == forced or o.index.startswith(f"{forced}:")]
            if not match:
                raise ValueError(
                    f"QUERY_INDEX hint requested {forced!r} but no such "
                    f"strategy applies (have: "
                    f"{sorted(o.index for o in options)})")
            chosen = min(match, key=lambda o: o.cost)
            explain(lambda: f"forced by QUERY_INDEX hint: {chosen.index}")
        if chosen.index == "full" and QueryProperties.BLOCK_FULL_TABLE_SCANS.to_bool():
            raise RuntimeError(
                "full-table scan required but blocked "
                "(geomesa.scan.block.full.table=true)")
        explain(lambda: f"chosen: {chosen.index} (cost {chosen.cost:.0f}, "
                f"source {chosen.source})")
        explain.pop()
        return chosen, tuple(options)

    def _reobserve(self, o: FilterStrategy, observed: dict) -> FilterStrategy:
        """Fold a replanning query's measured candidate count into the
        strategy it was measured on (the probe count IS that strategy's
        candidate cardinality)."""
        if o.index not in observed:
            return o
        cost = max(1.0, float(observed[o.index]))
        mr = o.max_ranges
        if self.estimator is not None and o.index in ("z3", "xz3"):
            mr = self.estimator.size_max_ranges(cost)
        return replace(o, cost=cost, source="observed", max_ranges=mr)

    def _decide(self, f: Filter,
                observed: dict | None = None) -> tuple[FilterStrategy, list]:
        if isinstance(f, _Exclude):
            return FilterStrategy("none", 0.0), []
        options = self.strategies(f)
        if observed:
            options = [self._reobserve(o, observed) for o in options]
        chosen = min(options, key=lambda o: o.cost)
        if chosen.index == "full" and isinstance(f, Or):
            # OR-split (FilterSplitter's disjunction handling,
            # planning/FilterSplitter.scala:294-307): when every branch of
            # a top-level OR is individually indexable and the summed
            # branch costs beat one full scan, serve the query per branch
            branch = [(p, self._decide(p, observed)[0]) for p in f.filters]
            if all(st.index != "full" for _, st in branch):
                total = sum(st.cost for _, st in branch)
                if total < chosen.cost:
                    split = FilterStrategy("or-split", total,
                                           branches=tuple(branch))
                    return split, options + [split]
        return chosen, options
