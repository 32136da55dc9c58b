"""Geometry object model (host side).

Minimal, self-contained replacement for the JTS types the reference builds
on (com.vividsolutions.jts.geom.*): coordinates are numpy ``(n, 2)``
float64 arrays; polygons are a shell plus optional holes; envelopes are
(xmin, ymin, xmax, ymax).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import ClassVar, Iterable, Sequence

import numpy as np

__all__ = [
    "Envelope", "Geometry", "Point", "MultiPoint", "LineString",
    "MultiLineString", "Polygon", "MultiPolygon",
]


@dataclass(frozen=True)
class Envelope:
    xmin: float
    ymin: float
    xmax: float
    ymax: float

    WHOLE_WORLD: ClassVar["Envelope"]  # assigned after class definition

    def intersects(self, other: "Envelope") -> bool:
        return not (
            self.xmax < other.xmin or other.xmax < self.xmin
            or self.ymax < other.ymin or other.ymax < self.ymin
        )

    def contains(self, other: "Envelope") -> bool:
        return (
            self.xmin <= other.xmin and self.ymin <= other.ymin
            and self.xmax >= other.xmax and self.ymax >= other.ymax
        )

    def intersection(self, other: "Envelope") -> "Envelope | None":
        if not self.intersects(other):
            return None
        return Envelope(
            max(self.xmin, other.xmin), max(self.ymin, other.ymin),
            min(self.xmax, other.xmax), min(self.ymax, other.ymax),
        )

    def expand(self, other: "Envelope") -> "Envelope":
        return Envelope(
            min(self.xmin, other.xmin), min(self.ymin, other.ymin),
            max(self.xmax, other.xmax), max(self.ymax, other.ymax),
        )

    @property
    def width(self) -> float:
        return self.xmax - self.xmin

    @property
    def height(self) -> float:
        return self.ymax - self.ymin

    @property
    def area(self) -> float:
        return max(0.0, self.width) * max(0.0, self.height)

    def as_tuple(self):
        return (self.xmin, self.ymin, self.xmax, self.ymax)


Envelope.WHOLE_WORLD = Envelope(-180.0, -90.0, 180.0, 90.0)


class Geometry:
    """Base class; subclasses expose ``envelope`` and ``geom_type``."""

    geom_type: str = "Geometry"

    @property
    def envelope(self) -> Envelope:
        raise NotImplementedError

    @property
    def is_point(self) -> bool:
        return isinstance(self, Point)


def _coords(a) -> np.ndarray:
    out = np.asarray(a, dtype=np.float64)
    if out.ndim != 2 or out.shape[1] != 2:
        raise ValueError(f"expected (n, 2) coordinates, got shape {out.shape}")
    return out


def _env_of(coords: np.ndarray) -> Envelope:
    return Envelope(
        float(coords[:, 0].min()), float(coords[:, 1].min()),
        float(coords[:, 0].max()), float(coords[:, 1].max()),
    )


@dataclass(frozen=True)
class Point(Geometry):
    x: float
    y: float
    geom_type = "Point"

    @property
    def envelope(self) -> Envelope:
        return Envelope(self.x, self.y, self.x, self.y)


@dataclass(frozen=True)
class MultiPoint(Geometry):
    coords: np.ndarray  # (n, 2)
    geom_type = "MultiPoint"

    def __post_init__(self):
        object.__setattr__(self, "coords", _coords(self.coords))

    @property
    def envelope(self) -> Envelope:
        return _env_of(self.coords)


@dataclass(frozen=True)
class LineString(Geometry):
    coords: np.ndarray  # (n, 2)
    geom_type = "LineString"

    def __post_init__(self):
        object.__setattr__(self, "coords", _coords(self.coords))

    @property
    def envelope(self) -> Envelope:
        return _env_of(self.coords)


@dataclass(frozen=True)
class MultiLineString(Geometry):
    lines: tuple
    geom_type = "MultiLineString"

    def __post_init__(self):
        object.__setattr__(
            self, "lines",
            tuple(l if isinstance(l, LineString) else LineString(l) for l in self.lines),
        )

    @property
    def envelope(self) -> Envelope:
        env = self.lines[0].envelope
        for l in self.lines[1:]:
            env = env.expand(l.envelope)
        return env


@dataclass(frozen=True)
class Polygon(Geometry):
    shell: np.ndarray          # (n, 2), closed or open (auto-closed)
    holes: tuple = ()
    geom_type = "Polygon"

    def __post_init__(self):
        shell = _coords(self.shell)
        if not np.array_equal(shell[0], shell[-1]):
            shell = np.vstack([shell, shell[:1]])
        object.__setattr__(self, "shell", shell)
        holes = []
        for h in self.holes:
            h = _coords(h)
            if not np.array_equal(h[0], h[-1]):
                h = np.vstack([h, h[:1]])
            holes.append(h)
        object.__setattr__(self, "holes", tuple(holes))

    @property
    def envelope(self) -> Envelope:
        return _env_of(self.shell)

    @classmethod
    def from_envelope(cls, env: Envelope) -> "Polygon":
        return cls(np.array([
            [env.xmin, env.ymin], [env.xmax, env.ymin],
            [env.xmax, env.ymax], [env.xmin, env.ymax], [env.xmin, env.ymin],
        ]))


@dataclass(frozen=True)
class MultiPolygon(Geometry):
    polygons: tuple
    geom_type = "MultiPolygon"

    def __post_init__(self):
        object.__setattr__(
            self, "polygons",
            tuple(p if isinstance(p, Polygon) else Polygon(p) for p in self.polygons),
        )

    @property
    def envelope(self) -> Envelope:
        env = self.polygons[0].envelope
        for p in self.polygons[1:]:
            env = env.expand(p.envelope)
        return env
