"""Query fusion: N concurrent compatible queries, ONE batched scan.

The scheduler is a per-compatibility-key coalescing queue.  The first
arrival becomes the batch LEADER and lingers up to
``geomesa.serving.fuse.window.ms`` collecting riders (or until
``geomesa.serving.fuse.max.batch`` requests are queued); it then
assembles a batch by deficit-weighted round-robin across per-tenant FIFO
queues, runs the store's batched multi-window scan once on its own
thread, and hands every member its own hit positions.  Riders left in the
queue promote a new leader and form the next batch, so under sustained
load batch follows batch with no scheduler thread.

Deadlines compose:

* a rider whose deadline expires while QUEUED drops out before dispatch
  (``QueryTimeout``, or an empty partial result, per its own flag);
* a batch dispatches under its members' MINIMUM remaining margin, in
  partial mode: expiry stops the scan at a yield point instead of
  raising out of a shared dispatch;
* when the batch scope expires, exactly the members whose own deadlines
  passed time out; the survivors' partial hits are discarded and the
  survivors re-dispatch (each round retires at least the minimum-margin
  member, so the loop is bounded).

The scheduler never touches the admission gate: every entry point holds
its own token before it submits, so a fused batch can never deadlock a
small gate.  Nothing here catches a device error: it reaches every
member of the batch.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np

from ..config import ServingProperties
from ..filters.ast import And, BBox, During, Or
from ..metrics import (SERVING_BATCH_WINDOWS, SERVING_COALESCE_MS,
                       SERVING_FANIN, SERVING_FUSED_BATCHES,
                       SERVING_FUSED_REQUESTS, SERVING_RIDER_EXPIRED,
                       SERVING_TENANT_SHED)
from ..metrics import registry as _registry
from ..obs.trace import span as obs_span
from ..resilience import (Backpressure, CancelScope, QueryTimeout,
                          deadline_scope)

__all__ = ["FusionScheduler", "FusedOutcome", "extract_fused_window"]

_SEGMENT_RE = re.compile(r"[^A-Za-z0-9_:\-]")


def _tenant_segment(tenant: str) -> str:
    """Tenant id as a metric-key segment (the naming contract allows
    ``[A-Za-z0-9_:-]``; anything else folds to ``_``)."""
    return _SEGMENT_RE.sub("_", tenant) or "default"


def extract_fused_window(sft, f):
    """Invert the filter shapes ``query_windows`` builds back into one
    ``(boxes, lo_ms, hi_ms)`` window, or None when the filter is not a
    pure bbox(+time) predicate over this schema's default geometry.

    Accepted shapes (exactly what the per-window fallback emits, so a
    fused scan answers the same question the planner would):
    ``BBox(geom, …)``, ``Or((BBox, …))``, and either of those wrapped
    in ``And((spatial, During(dtg, lo, hi)))``.
    """
    lo = hi = None
    spatial = f
    if isinstance(f, And):
        if len(f.filters) != 2:
            return None
        a, b = f.filters
        if isinstance(b, During):
            spatial, temporal = a, b
        elif isinstance(a, During):
            spatial, temporal = b, a
        else:
            return None
        if not sft.dtg_field or temporal.prop != sft.dtg_field:
            return None
        lo, hi = temporal.lo_ms, temporal.hi_ms
    parts = spatial.filters if isinstance(spatial, Or) else (spatial,)
    if not parts:
        return None
    boxes = []
    for p in parts:
        if not isinstance(p, BBox) or p.prop != sft.geom_field:
            return None
        boxes.append((p.xmin, p.ymin, p.xmax, p.ymax))
    return tuple(boxes), lo, hi


@dataclass
class FusedOutcome:
    """What ``submit`` hands back: the member's exact hit positions and
    whether its deadline expired (partial mode only — without
    ``partial`` an expiry raises instead).  ``coalesce_ms`` is this
    member's wait inside the fuse window; ``dispatch_ms`` the wall time
    of the batch round(s) it rode (riders block in ``submit`` while the
    LEADER's thread runs the batch, so these two values are where a
    rider's wall clock went)."""

    positions: np.ndarray
    timed_out: bool = False
    coalesce_ms: float = 0.0
    dispatch_ms: float = 0.0


class _Member:
    __slots__ = ("window", "tenant", "scope", "partial", "enqueued_at",
                 "queued", "done", "positions", "error", "timed_out",
                 "coalesce_ms", "dispatch_ms")

    def __init__(self, window, tenant, scope, partial):
        self.window = window
        self.tenant = tenant
        self.scope = scope
        self.partial = partial
        self.enqueued_at = 0.0
        self.queued = True
        self.done = False
        self.positions = None
        self.error = None
        self.timed_out = False
        self.coalesce_ms = 0.0
        self.dispatch_ms = 0.0


class _FuseQueue:
    """One compatibility key's coalescing state: per-tenant FIFO
    deques, the deficit-round-robin rotation, and the current leader."""

    __slots__ = ("tenants", "rr", "deficit", "size", "leader")

    def __init__(self):
        self.tenants: dict[str, deque] = {}
        self.rr: list[str] = []
        self.deficit: dict[str, int] = {}
        self.size = 0
        self.leader: _Member | None = None


class FusionScheduler:
    """Coalesce concurrent compatible queries into shared dispatches.

    One instance per datastore; ``submit`` blocks the calling thread
    until its request's fused result is ready (the leader role rotates
    among request threads — there is no scheduler thread to die)."""

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._queues: dict = {}

    # -- public -----------------------------------------------------------
    def submit(self, key, window, dispatch, *, scope: CancelScope | None
               = None, partial: bool = False, tenant: str = "",
               schema: str = "") -> FusedOutcome:
        """Enqueue one request and block until its demuxed positions
        are ready.  ``dispatch`` is the batched program: it takes a
        list of ``(boxes, lo, hi)`` windows and returns one position
        array per window (the datastore binds schema + capacity
        bucketing into it).  Raises :class:`Backpressure` when this
        tenant's queue is at its ceiling, :class:`QueryTimeout` when
        the member's deadline expires without ``partial``."""
        window_ms = float(ServingProperties.FUSE_WINDOW_MS.get() or 0.0)
        max_batch = max(1, int(ServingProperties.FUSE_MAX_BATCH.get() or 1))
        queue_max = int(ServingProperties.TENANT_QUEUE_MAX.get() or 0)
        quantum = max(1, int(ServingProperties.TENANT_QUANTUM.get() or 1))
        me = _Member(window, tenant, scope, partial)
        with self._cond:
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = _FuseQueue()
            dq = q.tenants.get(tenant)
            if queue_max > 0 and dq is not None and len(dq) >= queue_max:
                _registry.counter(SERVING_TENANT_SHED).inc()
                _registry.counter(
                    f"{SERVING_TENANT_SHED}.{_tenant_segment(tenant)}").inc()
                raise Backpressure(
                    f"serving queue full for tenant "
                    f"{tenant or 'default'!r} ({queue_max} queued)",
                    retry_after_s=max(0.05, window_ms / 1000.0))
            if dq is None:
                dq = q.tenants[tenant] = deque()
                q.rr.append(tenant)
            me.enqueued_at = time.perf_counter()
            dq.append(me)
            q.size += 1
            if q.leader is None:
                q.leader = me
            elif q.size >= max_batch:
                # a full batch dispatches immediately — wake the
                # collecting leader out of its linger wait
                self._cond.notify_all()
            batch = None
            while batch is None:
                if me.done:
                    return self._finish(me)
                if q.leader is me:
                    batch = self._collect(q, me, window_ms, max_batch,
                                          quantum)
                    q.leader = None
                    self._cond.notify_all()
                    break
                # rider: wait for my batch's result (or my own deadline)
                if (me.queued and me.scope is not None
                        and me.scope.poll()):
                    self._unlink(q, me)
                    me.done, me.timed_out = True, True
                    me.coalesce_ms = (time.perf_counter()
                                      - me.enqueued_at) * 1000.0
                    _registry.counter(SERVING_RIDER_EXPIRED).inc()
                    return self._finish(me)
                rem = None
                if me.scope is not None:
                    r = me.scope.remaining_ms()
                    rem = None if r is None else max(r / 1000.0, 0.0005)
                self._cond.wait(rem)
                if q.leader is None and not me.done and me.queued:
                    # leader promotion: the previous leader took its
                    # batch and left; the first queued waiter to wake
                    # leads the next one
                    q.leader = me
        # lock dropped — run the fused dispatch on this (leader) thread
        try:
            self._run_batch(batch, dispatch, schema)
        finally:
            with self._cond:
                self._cond.notify_all()
        return self._finish(me)

    @property
    def queued(self) -> int:
        with self._cond:
            return sum(q.size for q in self._queues.values())

    # -- internals --------------------------------------------------------
    def _collect(self, q, leader, window_ms, max_batch, quantum):
        """Leader linger: wait out the fuse window (bounded by the
        leader's own remaining deadline margin) or a full batch, then
        assemble.  Lock held throughout (waits release it)."""
        deadline = leader.enqueued_at + window_ms / 1000.0
        if leader.scope is not None:
            r = leader.scope.remaining_ms()
            if r is not None:
                deadline = min(deadline,
                               time.perf_counter() + r / 1000.0)
        while q.size < max_batch:
            w = deadline - time.perf_counter()
            if w <= 0:
                break
            self._cond.wait(w)
        return self._assemble(q, leader, max_batch, quantum)

    def _assemble(self, q, leader, max_batch, quantum):
        """Deficit-weighted round-robin batch assembly: the leader is
        force-included first, then each tenant in rotation earns
        ``quantum`` window-credits per pass and dequeues that many
        requests — a flooding tenant drains one quantum per pass while
        every other tenant's head-of-line request rides the same batch.
        Idle tenants carry no credit (deficit resets when their queue
        empties, classic DRR)."""
        batch = [leader]
        self._unlink(q, leader)
        while q.size > 0 and len(batch) < max_batch:
            for tenant in list(q.rr):
                dq = q.tenants.get(tenant)
                if dq is None or not dq:
                    continue
                q.deficit[tenant] = q.deficit.get(tenant, 0) + quantum
                while dq and q.deficit[tenant] > 0 \
                        and len(batch) < max_batch:
                    m = dq.popleft()
                    m.queued = False
                    q.size -= 1
                    q.deficit[tenant] -= 1
                    if m.scope is not None and m.scope.poll():
                        # expired while queued: drop before dispatch
                        m.done, m.timed_out = True, True
                        m.coalesce_ms = (time.perf_counter()
                                         - m.enqueued_at) * 1000.0
                        _registry.counter(SERVING_RIDER_EXPIRED).inc()
                        continue
                    batch.append(m)
                if not dq:
                    q.deficit[tenant] = 0
                    del q.tenants[tenant]
                    q.rr.remove(tenant)
                if len(batch) >= max_batch:
                    break
        # rotate so the same tenant is not always served first
        if q.rr:
            q.rr.append(q.rr.pop(0))
        return batch

    def _unlink(self, q, m):
        if not m.queued:
            return
        m.queued = False
        dq = q.tenants.get(m.tenant)
        if dq is not None:
            try:
                dq.remove(m)
                q.size -= 1
            except ValueError:
                pass
            if not dq:
                q.deficit[m.tenant] = 0
                del q.tenants[m.tenant]
                q.rr.remove(m.tenant)

    def _run_batch(self, batch, dispatch, schema):
        """Execute one fused batch (leader's thread, no scheduler lock).
        Sets every member's positions/error/timed_out and ``done``; the
        caller notifies waiters afterwards.  A dispatch error reaches
        every member unchanged."""
        pending = [m for m in batch if not m.done]
        first_round = True
        while pending:
            margin = None
            for m in pending:
                if m.scope is not None:
                    r = m.scope.remaining_ms()
                    if r is not None:
                        margin = r if margin is None else min(margin, r)
            windows = [m.window for m in pending]
            t0 = time.perf_counter()
            if first_round:
                for m in pending:
                    m.coalesce_ms = (t0 - m.enqueued_at) * 1000.0
                    _registry.timer(SERVING_COALESCE_MS).update(
                        m.coalesce_ms)
                first_round = False
            try:
                with obs_span("serving.fuse", schema=schema,
                              batch=len(pending),
                              windows=len(windows)) as sp:
                    if margin is not None:
                        # the batch runs under its members' minimum
                        # remaining margin, in partial mode: expiry stops
                        # the scan at a yield point — it never raises out
                        # of a shared dispatch.  A margin already spent (a
                        # leader that expired while it lingered) is a
                        # scope expired from the start, not one without a
                        # deadline.
                        bscope = CancelScope(margin, True)
                        if bscope._deadline_t is None:
                            bscope._deadline_t = bscope._start_t
                        with deadline_scope(scope=bscope):
                            hits = dispatch(windows)
                        expired_mid = bscope.timed_out
                    else:
                        hits = dispatch(windows)
                        expired_mid = False
                    sp.set_attr("hits", int(sum(len(h) for h in hits)))
                    sp.set_attr("partial", bool(expired_mid))
            except BaseException as e:
                for m in pending:
                    m.error = e
                    m.done = True
                return
            round_ms = (time.perf_counter() - t0) * 1000.0
            for m in pending:
                # accumulated across re-dispatch rounds: a survivor's
                # dispatch time is every round it rode
                m.dispatch_ms += round_ms
            _registry.counter(SERVING_FUSED_BATCHES).inc()
            _registry.counter(SERVING_FUSED_REQUESTS).inc(len(pending))
            _registry.histogram(SERVING_FANIN).update(float(len(pending)))
            _registry.histogram(SERVING_BATCH_WINDOWS).update(
                float(len(windows)))
            if not expired_mid:
                for m, h in zip(pending, hits):
                    m.positions = h
                    m.done = True
                return
            # the minimum-margin member(s) expired mid-dispatch: they time
            # out (their partial hits are exact over what WAS scanned);
            # the survivors' results may lack windows that never scanned —
            # discard and re-dispatch the survivors under the new (longer)
            # minimum margin.  Each round retires at least one member.
            survivors = []
            for m, h in zip(pending, hits):
                if m.scope is not None and m.scope.poll():
                    m.timed_out = True
                    m.positions = h if m.partial else None
                    m.done = True
                    _registry.counter(SERVING_RIDER_EXPIRED).inc()
                else:
                    survivors.append(m)
            if len(survivors) == len(pending):
                # cannot happen (the batch scope's deadline is never
                # earlier than the min member deadline), but a stuck
                # loop must fail loud rather than spin
                for m in pending:
                    m.error = RuntimeError(
                        "fused batch expired with no expired member")
                    m.done = True
                return
            pending = survivors

    def _finish(self, me) -> FusedOutcome:
        if me.error is not None:
            raise me.error
        if me.timed_out:
            if me.partial:
                pos = (me.positions if me.positions is not None
                       else np.empty(0, dtype=np.int64))
                return FusedOutcome(pos, timed_out=True,
                                    coalesce_ms=round(me.coalesce_ms, 3),
                                    dispatch_ms=round(me.dispatch_ms, 3))
            raise QueryTimeout(
                "fused query deadline expired"
                + ("" if me.scope is None else
                   f" after {me.scope.elapsed_ms():.1f} ms"),
                elapsed_ms=(None if me.scope is None
                            else me.scope.elapsed_ms()))
        return FusedOutcome(me.positions, timed_out=False,
                            coalesce_ms=round(me.coalesce_ms, 3),
                            dispatch_ms=round(me.dispatch_ms, 3))
