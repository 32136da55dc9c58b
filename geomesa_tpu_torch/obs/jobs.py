"""Background-job registry: compaction and pyramid runs as inspectable
records.

Every run of a job in ``jobs.py`` registers here:

* a :class:`JobRecord` with a process-unique id, kind, free-form
  detail, **phase spans** (name, wall ms and attributes, kept in the
  registry itself so a job is visible even when the tracer's sampler
  declined its trace), live **progress** counters, and a **terminal
  outcome**, ``succeeded`` or ``failed`` (with the error), stamped even
  when the job raises;
* each run also opens a ``job.<kind>`` root span (phases are
  ``job.phase`` children), and the record keeps its trace id;
* ``job.<kind>.runs`` / ``job.<kind>.failures`` counters and a
  ``job.<kind>.ms`` timer land in the shared metric registry.

Finished records are kept in a bounded deque
(``geomesa.obs.jobs.capacity``); active records live until their
context exits.  Registration is process-local and thread-safe.  The
records and metrics are the JAX package's (``geomesa_tpu/obs/jobs.py``).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque

from ..config import ObsProperties
from ..metrics import registry as _metrics
from .trace import current_trace_id, span as obs_span

__all__ = ["JobRecord", "JobRegistry", "jobs_registry"]


class JobRecord:
    """One job run.  ``state`` walks running → succeeded | failed."""

    __slots__ = ("job_id", "kind", "detail", "state", "start_ts",
                 "end_ts", "duration_ms", "phases", "progress", "error",
                 "trace_id")

    def __init__(self, job_id: str, kind: str, detail: dict):
        self.job_id = job_id
        self.kind = kind
        self.detail = detail
        self.state = "running"
        self.start_ts = time.time()
        self.end_ts = 0.0
        self.duration_ms = 0.0
        self.phases: list[dict] = []
        self.progress: dict = {}
        self.error = ""
        self.trace_id = ""

    def to_json(self) -> dict:
        return {"job_id": self.job_id, "kind": self.kind,
                "detail": dict(self.detail), "state": self.state,
                "start_ts": round(self.start_ts, 3),
                "end_ts": round(self.end_ts, 3),
                "duration_ms": round(self.duration_ms, 3),
                "phases": [dict(p) for p in self.phases],
                "progress": dict(self.progress), "error": self.error,
                "trace_id": self.trace_id}


class _ActiveJob:
    """The handle a running job drives: phases + progress."""

    def __init__(self, record: JobRecord):
        self.record = record

    @property
    def job_id(self) -> str:
        return self.record.job_id

    @contextlib.contextmanager
    def phase(self, name: str, **attributes):
        """One timed phase: recorded into the registry record always,
        and as a ``job.phase`` child span when the trace records."""
        entry = {"name": name, "ms": 0.0, **attributes}
        t0 = time.perf_counter()
        try:
            with obs_span("job.phase", job=self.record.kind,
                          phase=name, **attributes):
                yield entry
        finally:
            entry["ms"] = round((time.perf_counter() - t0) * 1e3, 3)
            self.record.phases.append(entry)

    def progress(self, **counters) -> None:
        """Merge live progress counters (groups merged, pyramids
        built…) into the record, readable mid-run."""
        self.record.progress.update(counters)


class JobRegistry:
    """Process-wide registry of active + recently-finished jobs."""

    def __init__(self, capacity: int | None = None):
        self._capacity_override = capacity
        #: guarded-by: self._lock — concurrent jobs register/retire here
        self._active: dict[str, JobRecord] = {}
        #: guarded-by: self._lock — bounded finished-record ring
        self._recent: deque[JobRecord] = deque()
        #: guarded-by: self._lock — the process-unique id source
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    def _capacity(self) -> int:
        """Retention re-resolves per finished job (live-tunable, like
        every other ``geomesa.obs.*`` knob) unless pinned for tests."""
        if self._capacity_override is not None:
            return max(1, int(self._capacity_override))
        return max(1, ObsProperties.JOBS_CAPACITY.to_int())

    @contextlib.contextmanager
    def run(self, kind: str, **detail):
        """Register one job run: yields the :class:`_ActiveJob`
        handle; the record gets a terminal outcome on EVERY exit path
        (an exception marks it failed with the error and re-raises —
        a crashed job must be visible, not vanish)."""
        with self._lock:
            job_id = f"{kind}-{next(self._ids)}"
            rec = JobRecord(job_id, kind, detail)
            self._active[job_id] = rec
        _metrics.counter(f"job.{kind}.runs").inc()
        t0 = time.perf_counter()
        try:
            with obs_span(f"job.{kind}", job_id=job_id, **detail):
                rec.trace_id = current_trace_id()
                yield _ActiveJob(rec)
            rec.state = "succeeded"
        except BaseException as e:
            rec.state = "failed"
            rec.error = repr(e)
            _metrics.counter(f"job.{kind}.failures").inc()
            raise
        finally:
            rec.duration_ms = (time.perf_counter() - t0) * 1e3
            rec.end_ts = time.time()
            _metrics.timer(f"job.{kind}.ms").update(rec.duration_ms)
            with self._lock:
                self._active.pop(job_id, None)
                self._recent.append(rec)
                cap = self._capacity()
                while len(self._recent) > cap:
                    self._recent.popleft()

    def jobs(self, kind: str | None = None, state: str | None = None,
             limit: int | None = None) -> list[JobRecord]:
        """Active jobs first, then finished newest-first."""
        with self._lock:
            rows = list(self._active.values()) + list(
                reversed(self._recent))
        if kind is not None:
            rows = [r for r in rows if r.kind == kind]
        if state is not None:
            rows = [r for r in rows if r.state == state]
        return rows if limit is None else rows[:limit]

    def get(self, job_id: str) -> JobRecord | None:
        with self._lock:
            rec = self._active.get(job_id)
            if rec is not None:
                return rec
            for r in self._recent:
                if r.job_id == job_id:
                    return r
        return None

    def clear(self) -> None:
        """Drop FINISHED records (tests); active jobs keep running."""
        with self._lock:
            self._recent.clear()


#: process-wide registry (the tracer/heat_tracker analog for jobs)
jobs_registry = JobRegistry()
