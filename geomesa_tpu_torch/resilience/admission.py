"""Admission control for the query plane.

A token gate in front of the store's query entry points: each query
acquires an :class:`AdmissionToken` before planning and releases it when
its results are delivered.  Two shed conditions, both config-driven and
both OFF by default:

- concurrency: more than ``geomesa.resilience.admission.max.concurrent``
  queries in flight;
- device-memory pressure: the ``storage.total.device_bytes`` gauge above
  ``geomesa.resilience.hbm.headroom`` bytes.  The gauge is what
  :func:`~geomesa_tpu_torch.obs.resource.publish_storage_gauges` last
  published (or whatever a caller set).

An over-budget request queues up to ``admission.queue.ms`` (a brief wait
absorbs bursts without queueing unboundedly), then sheds with
:class:`Backpressure`.  Waiters admit in arrival order (FIFO tickets),
and token release is idempotent.
"""

from __future__ import annotations

import threading
import time

from .. import metrics as _metrics
from ..config import ResilienceProperties
from ..metrics import (QUERY_SHED, RESILIENCE_ADMISSION_ACTIVE,
                       RESILIENCE_ADMISSION_ADMITTED,
                       RESILIENCE_ADMISSION_QUEUE_MS)

__all__ = ["Backpressure", "AdmissionToken", "AdmissionGate", "gate"]

#: the storage gauge the device-memory check reads
_DEVICE_BYTES_GAUGE = "storage.total.device_bytes"


class Backpressure(RuntimeError):
    """The admission gate (or a tenant's serving queue) shed this
    request; retry after ``retry_after_s``."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class AdmissionToken:
    """One admitted query's slot.  ``release()`` is idempotent: the
    abort, timeout and normal-completion paths may all reach it without
    double-decrementing the in-flight count.  ``queue_ms`` is the wait
    this request spent inside the gate.  ``AdmissionToken(None)`` is a
    token of no gate: a nested query that rides its caller's slot."""

    __slots__ = ("_gate", "_released", "queue_ms")

    def __init__(self, gate: "AdmissionGate | None"):
        self._gate = gate
        self._released = False
        self.queue_ms = 0.0

    @property
    def released(self) -> bool:
        return self._released

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        if self._gate is not None:
            self._gate._release()


class AdmissionGate:
    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._inflight = 0
        self._max = 0
        self._queue_ms = 50.0
        self._headroom = 0
        # FIFO ticket queue: notify_all wakes every waiter, but only the
        # queue head may take a freed slot, so a late arrival cannot
        # barge past waiters queued for most of their budget
        self._tickets: list[object] = []
        self._next_ticket = 0

    def _refresh_locked(self) -> None:
        # re-read on every acquire (three lookups), so a changed
        # setting (environment or set_property) takes effect at once
        self._max = int(
            ResilienceProperties.ADMISSION_MAX_CONCURRENT.get() or 0)
        self._queue_ms = float(
            ResilienceProperties.ADMISSION_QUEUE_MS.get() or 0.0)
        self._headroom = int(ResilienceProperties.HBM_HEADROOM.get() or 0)

    def _hbm_over_budget(self) -> bool:
        if self._headroom <= 0:
            return False
        return (_metrics.registry.gauge(_DEVICE_BYTES_GAUGE).value
                > self._headroom)

    @property
    def inflight(self) -> int:
        with self._cond:
            return self._inflight

    def _ticket_count(self) -> int:
        """Queued-waiter count."""
        with self._cond:
            return len(self._tickets)

    def _admitted(self, t0: float) -> AdmissionToken:
        queue_ms = (time.perf_counter() - t0) * 1000.0
        _metrics.registry.timer(RESILIENCE_ADMISSION_QUEUE_MS).update(
            queue_ms)
        _metrics.registry.counter(RESILIENCE_ADMISSION_ADMITTED).inc()
        token = AdmissionToken(self)
        token.queue_ms = queue_ms
        return token

    def acquire(self, schema: str = "") -> AdmissionToken:
        t0 = time.perf_counter()
        with self._cond:
            self._refresh_locked()
            if self._max <= 0 and self._headroom <= 0:
                # gate disabled: admit unconditionally but still track
                # in-flight (enabling the gate mid-flight sees the
                # truth), and record the admitted counter and queue
                # timer, so dashboards do not undercount
                self._inflight += 1
                _metrics.registry.gauge(
                    RESILIENCE_ADMISSION_ACTIVE).set(self._inflight)
                return self._admitted(t0)
            ticket = self._next_ticket
            self._next_ticket += 1
            self._tickets.append(ticket)
            queue_deadline = t0 + self._queue_ms / 1000.0
            try:
                while (self._tickets[0] != ticket
                       or (self._max > 0 and self._inflight >= self._max)
                       or self._hbm_over_budget()):
                    remaining = queue_deadline - time.perf_counter()
                    if remaining <= 0:
                        _metrics.registry.counter(QUERY_SHED).inc()
                        reason = ("concurrency"
                                  if (self._max > 0
                                      and self._inflight >= self._max)
                                  else ("hbm" if self._hbm_over_budget()
                                        else "queued"))
                        raise Backpressure(
                            f"admission shed ({reason}) for "
                            f"{schema or 'query'}: {self._inflight} in "
                            "flight",
                            retry_after_s=max(0.05, self._queue_ms / 1000.0))
                    self._cond.wait(remaining)
                self._inflight += 1
                _metrics.registry.gauge(
                    RESILIENCE_ADMISSION_ACTIVE).set(self._inflight)
            finally:
                # admitted or shed, this waiter leaves the queue; wake the
                # rest so the new head re-checks its turn
                self._tickets.remove(ticket)
                self._cond.notify_all()
        return self._admitted(t0)

    def reset(self) -> None:
        """Zero the in-flight count and wake queued waiters: a
        leaked-token recovery hook for tests and operators, not part of
        the query path (tokens are idempotent and the count floors at
        zero, so live queries double-release harmlessly)."""
        with self._cond:
            self._inflight = 0
            _metrics.registry.gauge(RESILIENCE_ADMISSION_ACTIVE).set(0)
            self._cond.notify_all()

    def _release(self) -> None:
        with self._cond:
            self._inflight = max(0, self._inflight - 1)
            _metrics.registry.gauge(
                RESILIENCE_ADMISSION_ACTIVE).set(self._inflight)
            self._cond.notify_all()


#: process-wide gate (one device memory, one process: the unit that sheds)
gate = AdmissionGate()
