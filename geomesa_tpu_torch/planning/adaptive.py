"""Adaptive mid-query replanning: the scan-side half of closing the
cost-based-planning loop.

The port's copy of the JAX package's ``planning/adaptive.py``.  The
planner installs a :class:`ReplanScope` (ambient, per task, through a
contextvar) around a strategy's scan, carrying the decider's row
estimate and the configured divergence threshold.  The lean scan calls
:func:`check_replan` at its candidate-count probe points — the counting
step it runs BEFORE any gather — and when the observed candidate count
exceeds ``threshold × estimate`` the scan aborts by raising
:class:`ReplanSignal`.  The planner catches it, re-enters the
``StrategyDecider`` with the observed count folded in, and re-scans
under the new strategy.

Contracts:

* **one replan per query** — the scope disarms on its first raise, and
  the planner's second scan runs outside any scope;
* **exact results** — the probe precedes every gather, so an abort
  discards no collected hits, and the re-scan's candidate superset
  passes through the same residual ``evaluate_filter`` re-check as any
  other scan.

Only an *under*-estimate triggers: observed ≫ estimate means the chosen
strategy scans far more than costed and an alternative may be cheaper.
An over-estimate is free — aborting it would only add latency.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar

__all__ = [
    "ReplanSignal", "ReplanScope", "replan_scope", "check_replan",
    "current_replan_scope",
]


class ReplanSignal(Exception):
    """Raised at a scan probe point when observed candidates diverge
    past the scope threshold.  Carries the probe point, the observed
    candidate count, and the estimate it diverged from.  Caught ONLY by
    ``QueryPlanner`` — never by scan code."""

    def __init__(self, point: str, observed: int, estimate: float):
        super().__init__(
            f"replan at {point}: observed {int(observed)} candidates "
            f"vs estimate {estimate:.0f}")
        self.point = point
        self.observed = int(observed)
        self.estimate = float(estimate)


class ReplanScope:
    """One query's replan budget: the estimate to diverge from, the
    trigger ratio, a row floor (tiny scans never replan — the abort
    costs more than finishing), and a one-shot arm."""

    __slots__ = ("estimate", "threshold", "min_rows", "armed")

    def __init__(self, estimate: float, threshold: float,
                 min_rows: int = 0):
        self.estimate = float(estimate)
        self.threshold = float(threshold)
        self.min_rows = int(min_rows)
        self.armed = self.threshold > 0.0


_current_scope: ContextVar[ReplanScope | None] = ContextVar(
    "geomesa_torch_replan_scope", default=None)


def current_replan_scope() -> ReplanScope | None:
    """The ambient scope, or None outside any replan-armed scan."""
    return _current_scope.get()


@contextlib.contextmanager
def replan_scope(estimate: float, threshold: float, min_rows: int = 0):
    """Install a :class:`ReplanScope` for the duration of one scan."""
    scope = ReplanScope(estimate, threshold, min_rows)
    token = _current_scope.set(scope)
    try:
        yield scope
    finally:
        _current_scope.reset(token)


def check_replan(point: str, observed: int) -> None:
    """Probe-point hook: raise :class:`ReplanSignal` when ``observed``
    candidates diverge past the ambient scope's threshold.  A no-op (one
    contextvar read) outside a scope, so direct index callers never pay
    for it."""
    scope = _current_scope.get()
    if scope is None or not scope.armed:
        return
    if observed < scope.min_rows:
        return
    if observed + 1.0 < scope.threshold * (scope.estimate + 1.0):
        return
    scope.armed = False
    raise ReplanSignal(point, observed, scope.estimate)
