"""Typed system properties: the port's config/flag system.

Values resolve, in order: environment variable (dots become underscores,
upper-cased) → default.  Per-schema user data
(features/feature_type.py) and per-query hints are the other two tiers.

This holds only the knobs the ported main path reads; the names and
defaults are those of ``geomesa_tpu.config``, so one environment
configures both packages alike.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

__all__ = ["SystemProperty", "QueryProperties", "DensityProperties",
           "PlanningProperties", "DEFAULT_MAX_RANGES"]


@dataclass(frozen=True)
class SystemProperty:
    """A named, typed knob with an env-var override."""

    name: str
    default: Any

    @property
    def env_var(self) -> str:
        return self.name.replace(".", "_").upper()

    def get(self):
        raw = os.environ.get(self.env_var)
        if raw is None:
            return self.default
        if isinstance(self.default, bool):
            return raw.strip().lower() in ("1", "true", "yes")
        if isinstance(self.default, int):
            return int(raw)
        if isinstance(self.default, float):
            return float(raw)
        return raw

    def to_int(self) -> int:
        return int(self.get())

    def to_bool(self) -> bool:
        return bool(self.get())


class QueryProperties:
    """Planner guardrails (QueryProperties.scala:17-44 equivalents)."""

    #: target number of scan ranges per query (split across time bins)
    SCAN_RANGES_TARGET = SystemProperty("geomesa.scan.ranges.target", 2000)
    #: query timeout in seconds; 0 disables (ThreadManagement reaper analog)
    QUERY_TIMEOUT = SystemProperty("geomesa.query.timeout", 0)
    #: refuse queries that would scan the full table (opt-in, like the
    #: reference's BlockFullTableScans)
    BLOCK_FULL_TABLE_SCANS = SystemProperty(
        "geomesa.scan.block.full.table", False)


class DensityProperties:
    """Density-pyramid knobs (docs/density.md): sealed lean generations
    precompute world-aligned multi-resolution density grids, so
    whole-extent heatmaps and zoomed-out tiles sum cached cells instead
    of rescanning history."""

    #: base pyramid resolution (cells per axis, a power of two): each
    #: sealed generation's pyramid starts at a (base, base) world grid
    #: and halves down from there.  A lean tile is a slice of the
    #: whole-world density while ``tile·2^z`` stays at or below it;
    #: finer tiles run a bbox density scan over the tile's envelope
    PYRAMID_BASE = SystemProperty("geomesa.density.pyramid.base", 512)
    #: reduction-ladder depth; 0 = the full ladder down to 1×1
    PYRAMID_LEVELS = SystemProperty("geomesa.density.pyramid.levels", 0)
    #: byte ceiling of a lean index's pyramid cache
    PYRAMID_CACHE_BYTES = SystemProperty(
        "geomesa.density.pyramid.cache.bytes", 256 * (1 << 20))
    #: build trigger: ``off`` (only explicit ``build_pyramids`` calls
    #: build) or ``seal`` (a generation seal runs one build-behind pass,
    #: never failing the write and never changing results)
    PYRAMID_BUILD = SystemProperty("geomesa.density.pyramid.build", "off")


class PlanningProperties:
    """Cost-based planning knobs (docs/planning.md): sketch-fed
    cardinality estimation and adaptive mid-query replanning, re-read
    per query plan."""

    #: sketch-fed estimation master switch: off costs strategies from
    #: whole-store stats and heuristics only
    ESTIMATOR_ENABLED = SystemProperty(
        "geomesa.planning.estimator.enabled", True)
    #: live-row floor below which a lean store plans without the sketch
    #: tier (the cold per-generation folds cannot amortize on a store a
    #: whole scan finishes quickly); 0 sketches every lean store
    ESTIMATOR_MIN_ROWS = SystemProperty(
        "geomesa.planning.estimator.min.rows", 262_144)
    #: assumed selectivity of an attribute equality with no usable stat
    SELECTIVITY_EQUALS_DEFAULT = SystemProperty(
        "geomesa.planning.selectivity.equals.default", 0.1)
    #: assumed selectivity of an attribute range or prefix with no usable
    #: stat
    SELECTIVITY_RANGE_DEFAULT = SystemProperty(
        "geomesa.planning.selectivity.range.default", 0.25)
    #: adaptive-replan divergence trigger: when a scan's candidate probe
    #: observes more than ``threshold × estimate`` rows, the scan aborts
    #: and the query replans ONCE with the observed count folded in;
    #: <= 0 disables replanning
    REPLAN_THRESHOLD = SystemProperty(
        "geomesa.planning.replan.threshold", 8.0)
    #: observed-row floor below which a divergence never replans
    REPLAN_MIN_ROWS = SystemProperty(
        "geomesa.planning.replan.min.rows", 4096)


#: default scan-ranges budget (import-time snapshot users can override per
#: call; the live knob is QueryProperties.SCAN_RANGES_TARGET)
DEFAULT_MAX_RANGES = QueryProperties.SCAN_RANGES_TARGET.default
