"""Resilience layer: query deadlines with cooperative cancellation
(:mod:`.deadline`), admission control (:mod:`.admission`), degraded
execution with a circuit breaker (:mod:`.degrade`), and a deterministic
fault-injection harness (:mod:`.faults`).

Host-side bookkeeping only (contextvars, locks, clock comparisons),
threaded through the query, ingest and serving planes.  Only a
classified device-memory failure in the lean indexes degrades to the
host tier; every other device error reaches the caller.
"""

from .admission import AdmissionGate, AdmissionToken, Backpressure
from .admission import gate as admission_gate
from .deadline import (Cancelled, CancelScope, QueryTimeout, check_cancel,
                       current_scope, deadline_scope)
from .degrade import CircuitBreaker, breaker, classify_device_failure
from .degrade import retry_budget
from .faults import FAULT_POINTS, FaultInjected, FaultRegistry, fault_point
from .faults import registry as fault_registry

__all__ = [
    "QueryTimeout", "Cancelled", "CancelScope", "deadline_scope",
    "check_cancel", "current_scope",
    "Backpressure", "AdmissionToken", "AdmissionGate", "admission_gate",
    "classify_device_failure", "CircuitBreaker", "breaker", "retry_budget",
    "FAULT_POINTS", "FaultInjected", "FaultRegistry", "fault_point",
    "fault_registry",
]
