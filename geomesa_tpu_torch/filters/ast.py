"""Filter AST: the framework's predicate language.

Replaces the reference's dependency on GeoTools ``org.opengis.filter``
objects with small immutable dataclasses.  The node set covers what the
reference's planner understands (FilterHelper / strategy heuristics):
spatial (BBOX/INTERSECTS/CONTAINS/WITHIN/DWITHIN), temporal (DURING,
BEFORE/AFTER via comparisons), attribute comparisons, logical combinators
and the INCLUDE/EXCLUDE constants.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

from ..geometry.types import Envelope, Geometry

__all__ = [
    "Filter", "Include", "Exclude", "And", "Or", "Not", "BBox", "Intersects",
    "Contains", "Within", "DWithin", "GeomEquals", "Touches",
    "Crosses", "Overlaps", "During",
    "PropertyCompare", "Between", "In", "IdFilter", "Like", "Attribute",
]


@dataclass(frozen=True)
class Attribute:
    """A property reference by name."""
    name: str


class Filter:
    """Base class for all filter nodes."""

    def __and__(self, other: "Filter") -> "Filter":
        return And((self, other))

    def __or__(self, other: "Filter") -> "Filter":
        return Or((self, other))

    def __invert__(self) -> "Filter":
        return Not(self)


@dataclass(frozen=True)
class _Include(Filter):
    def __repr__(self):
        return "INCLUDE"


@dataclass(frozen=True)
class _Exclude(Filter):
    def __repr__(self):
        return "EXCLUDE"


Include = _Include()
Exclude = _Exclude()


@dataclass(frozen=True)
class And(Filter):
    filters: tuple

    def __post_init__(self):
        object.__setattr__(self, "filters", tuple(self.filters))


@dataclass(frozen=True)
class Or(Filter):
    filters: tuple

    def __post_init__(self):
        object.__setattr__(self, "filters", tuple(self.filters))


@dataclass(frozen=True)
class Not(Filter):
    filter: Filter


@dataclass(frozen=True)
class BBox(Filter):
    prop: str
    xmin: float
    ymin: float
    xmax: float
    ymax: float

    @property
    def envelope(self) -> Envelope:
        return Envelope(self.xmin, self.ymin, self.xmax, self.ymax)


@dataclass(frozen=True)
class Intersects(Filter):
    prop: str
    geometry: Geometry


@dataclass(frozen=True)
class Contains(Filter):
    """Query geometry contains the feature geometry? No — CQL CONTAINS(prop, g)
    means the feature geometry contains g."""
    prop: str
    geometry: Geometry


@dataclass(frozen=True)
class Within(Filter):
    """Feature geometry within the query geometry."""
    prop: str
    geometry: Geometry


@dataclass(frozen=True)
class DWithin(Filter):
    """Feature geometry within ``distance`` of the query geometry.

    ``distance`` is in degrees unless ``meters`` is set (the ECQL units
    suffix, converted via the reference's meters multiplier,
    GeometryProcessing.metersMultiplier/distanceDegrees)."""
    prop: str
    geometry: Geometry
    distance: float
    meters: bool = False

    @property
    def degrees(self) -> float:
        """Covering degree-space equivalent of the distance (the larger
        lon-degree equivalent at the geometry's latitude, mirroring the
        reference's buffer-by-east-degrees rewrite)."""
        if not self.meters:
            return self.distance
        import math
        env = self.geometry.envelope
        lat = min(89.0, max(abs(env.ymin), abs(env.ymax)))
        return self.distance / (111_320.0 * max(0.017, math.cos(math.radians(lat))))


@dataclass(frozen=True)
class Touches(Filter):
    """Boundaries meet, interiors do not (CQL TOUCHES)."""
    prop: str
    geometry: Geometry


@dataclass(frozen=True)
class Crosses(Filter):
    """Interiors intersect in a lower dimension (CQL CROSSES)."""
    prop: str
    geometry: Geometry


@dataclass(frozen=True)
class Overlaps(Filter):
    """Same-dimension interiors partially shared (CQL OVERLAPS)."""
    prop: str
    geometry: Geometry


@dataclass(frozen=True)
class GeomEquals(Filter):
    """Feature geometry exactly equals the query geometry (ECQL EQUALS)."""
    prop: str
    geometry: Geometry


@dataclass(frozen=True)
class During(Filter):
    """Temporal interval predicate: lo <= t <= hi (epoch millis).

    ``None`` bounds are open (the reference models these as ±∞ bounds in
    extractIntervals)."""
    prop: str
    lo_ms: int | None
    hi_ms: int | None


@dataclass(frozen=True)
class PropertyCompare(Filter):
    """prop <op> literal with op in =, <>, <, <=, >, >=."""
    prop: str
    op: str
    value: Any

    _OPS = ("=", "<>", "<", "<=", ">", ">=")

    def __post_init__(self):
        if self.op not in self._OPS:
            raise ValueError(f"bad comparison op {self.op!r}")


@dataclass(frozen=True)
class Between(Filter):
    prop: str
    lo: Any
    hi: Any


@dataclass(frozen=True)
class In(Filter):
    prop: str
    values: tuple

    def __post_init__(self):
        object.__setattr__(self, "values", tuple(self.values))


@dataclass(frozen=True)
class IdFilter(Filter):
    """Feature-id filter (GeoTools ``Filter.id`` / bare ``IN ('id1', …)``) —
    served by the record/id index."""
    ids: tuple

    def __post_init__(self):
        object.__setattr__(self, "ids", tuple(str(i) for i in self.ids))


@dataclass(frozen=True)
class Like(Filter):
    """SQL LIKE with % and _ wildcards (the attribute-index prefix-scan
    candidate in the reference's planner)."""
    prop: str
    pattern: str
    case_insensitive: bool = False
