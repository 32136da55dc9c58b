"""Degraded execution: device-failure classification, a bounded retry
budget, and a per-generation circuit breaker.

The lean indexes' dispatch boundaries wrap each device scan, together
with the copy that materializes it, in ``try``; on failure they ask
:func:`classify_device_failure` whether the error is *transient* (device
memory pressure: the scan can succeed after demoting the failed
generations to the host tier) or *poison* (anything else: it
propagates).  A transient failure triggers at most
``geomesa.resilience.retry.max`` demote-and-retry rounds, recorded as a
``resilience.degraded`` span attribute, not a user-facing error.

On the card the transient failure is the caching allocator's
``torch.OutOfMemoryError`` ("CUDA out of memory"), raised synchronously
where the allocation is made.  A launch error reported by a kernel
wrapper, and an asynchronous kernel fault (``cudaErrorIllegalAddress``
and the like, which surfaces at the next synchronization and leaves the
CUDA context unusable), are poison: nothing retries after one.

The breaker keeps a generation that trips repeatedly off the device:
after ``breaker.threshold`` consecutive transient failures its circuit
opens for ``breaker.cooldown.s`` seconds, during which callers route that
generation through the host tier directly.
"""

from __future__ import annotations

import threading
import time

import torch

from .. import metrics as _metrics
from ..config import ResilienceProperties
from ..metrics import RESILIENCE_BREAKER_OPEN
from .faults import FaultInjected

__all__ = ["classify_device_failure", "CircuitBreaker", "breaker",
           "retry_budget"]

#: the breaker's clock; tests replace it to move time without sleeping
_clock = time.monotonic

#: the allocator's out-of-memory error (``torch.cuda.OutOfMemoryError``
#: before it moved to the top level)
_OOM_TYPES = tuple(t for t in (getattr(torch, "OutOfMemoryError", None),
                               getattr(torch.cuda, "OutOfMemoryError", None))
                   if isinstance(t, type))

#: substrings (upper-cased match) that mark a failure as memory pressure:
#: the JAX package's markers (so injected ``oom`` faults classify alike)
#: and the caching allocator's message
_TRANSIENT_MARKERS = ("RESOURCE_EXHAUSTED", "OUT OF MEMORY",
                      "HBM OOM", "ALLOCATION FAILURE")


def classify_device_failure(exc: BaseException) -> str:
    """``'transient'`` (retry after demotion) or ``'poison'``
    (propagate).  Injected faults classify by their armed kind, the
    allocator's out-of-memory error by its type, anything else by its
    message."""
    if isinstance(exc, FaultInjected):
        return "transient" if exc.kind == "oom" else "poison"
    if _OOM_TYPES and isinstance(exc, _OOM_TYPES):
        return "transient"
    msg = str(exc).upper()
    for marker in _TRANSIENT_MARKERS:
        if marker in msg:
            return "transient"
    return "poison"


def retry_budget() -> int:
    return int(ResilienceProperties.RETRY_MAX.get() or 0)


class CircuitBreaker:
    """Consecutive-failure breaker keyed by an opaque hashable (the lean
    indexes use ``(id(index), gen_id)``).  Closed: counts failures; at
    the threshold: open for the cooldown (``allows`` False, counted as
    ``resilience.breaker.open``); after the cooldown: half-open (one trial
    dispatch; a success resets, a failure re-opens)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._state: dict = {}  # key -> [consecutive_failures, open_until_t]

    def allows(self, key) -> bool:
        with self._lock:
            st = self._state.get(key)
            if st is None:
                return True
            failures, open_until = st
            threshold = int(
                ResilienceProperties.BREAKER_THRESHOLD.get() or 0)
            if threshold <= 0 or failures < threshold:
                return True
            if _clock() >= open_until:
                # half-open: admit one trial; a failure re-opens below
                st[0] = threshold - 1
                return True
        _metrics.registry.counter(RESILIENCE_BREAKER_OPEN).inc()
        return False

    def record_failure(self, key) -> None:
        with self._lock:
            st = self._state.setdefault(key, [0, 0.0])
            st[0] += 1
            threshold = int(
                ResilienceProperties.BREAKER_THRESHOLD.get() or 0)
            if threshold > 0 and st[0] >= threshold:
                cooldown = float(
                    ResilienceProperties.BREAKER_COOLDOWN_S.get() or 0.0)
                st[1] = _clock() + cooldown

    def record_success(self, key) -> None:
        with self._lock:
            self._state.pop(key, None)

    def reset(self) -> None:
        with self._lock:
            self._state.clear()


#: process-wide breaker (generations are process-local objects)
breaker = CircuitBreaker()
