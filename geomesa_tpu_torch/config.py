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
           "DEFAULT_MAX_RANGES"]


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
    """Density-tile knobs (docs/density.md)."""

    #: world grid resolution (cells per axis, a power of two) up to which
    #: a lean tile is a slice of the whole-world sweep; finer tiles run a
    #: bbox density scan over the tile's envelope.  The JAX package also
    #: builds its density pyramids at this base; the port has none.
    PYRAMID_BASE = SystemProperty("geomesa.density.pyramid.base", 512)


#: default scan-ranges budget (import-time snapshot users can override per
#: call; the live knob is QueryProperties.SCAN_RANGES_TARGET)
DEFAULT_MAX_RANGES = QueryProperties.SCAN_RANGES_TARGET.default
