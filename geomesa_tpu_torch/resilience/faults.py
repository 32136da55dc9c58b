"""Deterministic fault injection.

A closed registry of named injection points threaded through the write,
query and compaction planes.  Arming is pure config:
``geomesa.resilience.fault.points`` holds a comma-separated spec of
``point[:trigger][=kind]`` entries:

- a bare ``point`` fires on every hit;
- an integer trigger (``compaction.merge_step:2``) fires on exactly the
  Nth hit of that point (then never again until re-armed);
- a float trigger below 1 (``device.dispatch:0.25``) fires with that
  probability, drawn from ``random.Random(geomesa.resilience.fault.seed)``
  (the JAX package's stream: the same spec, seed and hit order fire on
  the same hits in both packages);
- ``kind`` is ``error`` (the default: poison, propagates) or ``oom``
  (its message carries RESOURCE_EXHAUSTED, so :mod:`.degrade` classifies
  it transient and the demote-and-retry path runs).

Arming an unknown point or kind raises at the first injection check.
``arrow.flush`` stays in the catalog with no site until the Arrow result
path is ported.
"""

from __future__ import annotations

import random
import threading

from .. import config as _config
from .. import metrics as _metrics
from ..config import ResilienceProperties
from ..metrics import RESILIENCE_FAULTS

__all__ = ["FAULT_POINTS", "FaultInjected", "FaultRegistry", "fault_point",
           "registry"]

#: the closed catalog (``ingest.append`` is the boundary between "row
#: accepted" and "row indexed": the store has no write-ahead log)
FAULT_POINTS = ("device.dispatch", "host.spill", "arrow.flush",
                "compaction.merge_step", "ingest.append",
                "pyramid.build")


class FaultInjected(RuntimeError):
    """An injected failure.  ``kind='oom'`` messages carry the
    RESOURCE_EXHAUSTED marker, so the failure classifier treats them as
    transient device pressure."""

    def __init__(self, point: str, kind: str = "error"):
        marker = "RESOURCE_EXHAUSTED" if kind == "oom" else "INJECTED_FAULT"
        super().__init__(f"{marker}: injected fault at {point!r}")
        self.point = point
        self.kind = kind


class FaultRegistry:
    """Per-process injection state.  Disabled (the default), the check
    is one generation compare and one empty-dict test."""

    def __init__(self):
        self._lock = threading.Lock()
        self._gen = -1
        self._arms: dict[str, tuple] = {}
        self._hits: dict[str, int] = {}
        self._rng = random.Random(0)

    def _refresh_locked(self) -> None:
        gen = _config.config_generation()
        if gen == self._gen:
            return
        spec = str(ResilienceProperties.FAULT_POINTS.get() or "")
        arms: dict[str, tuple] = {}
        for part in (p.strip() for p in spec.split(",") if p.strip()):
            kind = "error"
            if "=" in part:
                part, kind = part.rsplit("=", 1)
            trigger = None
            if ":" in part:
                part, raw = part.rsplit(":", 1)
                trigger = float(raw) if "." in raw else int(raw)
            if part not in FAULT_POINTS:
                raise ValueError(
                    f"unknown fault point {part!r}; known: {FAULT_POINTS}")
            if kind not in ("error", "oom"):
                raise ValueError(f"unknown fault kind {kind!r} for {part!r}")
            arms[part] = (trigger, kind)
        self._arms = arms
        self._hits = {}
        self._rng = random.Random(
            int(ResilienceProperties.FAULT_SEED.get() or 0))
        self._gen = gen

    def hits(self, point: str) -> int:
        with self._lock:
            return self._hits.get(point, 0)

    def maybe_fail(self, point: str) -> None:
        # disabled fast path: no lock, no allocation
        if _config.config_generation() == self._gen and not self._arms:
            return
        with self._lock:
            self._refresh_locked()
            arm = self._arms.get(point)
            if arm is None:
                return
            self._hits[point] = hit = self._hits.get(point, 0) + 1
            trigger, kind = arm
            if trigger is None:
                fire = True
            elif isinstance(trigger, float) and trigger < 1.0:
                fire = self._rng.random() < trigger
            else:
                fire = hit == int(trigger)
            if not fire:
                return
        _metrics.registry.counter(RESILIENCE_FAULTS).inc()
        raise FaultInjected(point, kind)


registry = FaultRegistry()


def fault_point(point: str) -> None:
    """The hook instrumented code calls: raises :class:`FaultInjected`
    when ``point`` is armed and its trigger fires, else returns."""
    registry.maybe_fail(point)
