"""LSM compaction policy for the lean generational index.

The port's copy of the JAX package's ``index/lsm.py``: the size-tiered
merge planner, the budgeted merge-one-replan loop, and the generation
lifecycle notification (``seal`` / ``merge``).  The loop stops at an
expired deadline between merges and times itself into
``lean.compaction.ms``; the JAX package's spans and fault points around
it are not ported.
"""

from __future__ import annotations

import time

from ..metrics import registry as _metrics
from ..obs.trace import span as obs_span
from ..resilience.deadline import check_cancel
from ..resilience.faults import fault_point

__all__ = ["plan_size_tiered", "compact_incremental", "merged_capacity",
           "notify_generation_event", "replace_group"]


def notify_generation_event(index, kind: str, gen_ids: list) -> None:
    """Fan a generation-lifecycle event (``"seal"`` / ``"merge"``) out
    to an index's registered ``generation_listeners``.

    Listeners drive optional build-behind work (the JAX package's
    density-pyramid jobs, which the port does not have: its indexes
    register none); a listener failure must never break the ingest or
    compaction path that fired the event, so exceptions are swallowed."""
    for listener in getattr(index, "generation_listeners", ()):
        try:
            listener(kind, list(gen_ids))
        except Exception:  # noqa: BLE001 — background hooks are best-effort
            pass


def replace_group(generations: list, group: list, merged) -> list:
    """The merge epilogue: drop the source runs and place the merged run
    at the group's OLDEST position (list order is demotion age),
    returning the new generation list."""
    i0 = min(generations.index(g) for g in group)
    dead = {id(g) for g in group}
    out = [g for g in generations if id(g) not in dead]
    out.insert(i0, merged)
    return out


def plan_size_tiered(sealed: list, tiers: tuple, size_of, factor: int
                     ) -> list[list]:
    """Size-tiered merge plan: sealed same-tier runs bucketed by size
    class (log2 of ``size_of(run)``); any bucket holding ≥ ``factor``
    runs yields oldest-first groups of ``factor``.  Repeated application
    turns N flush-sized runs into O(log N) — merged runs land in higher
    buckets and cascade.

    ``factor`` is clamped to ≥ 2: a factor-1 "group" would replace a run
    with an identical-size merged run and re-plan it forever."""
    factor = max(2, int(factor))
    groups: list = []
    for tier in tiers:
        by_size: dict[int, list] = {}
        for g in sealed:
            if g.tier != tier:
                continue
            by_size.setdefault(max(1, int(size_of(g))).bit_length(),
                               []).append(g)
        for b in sorted(by_size):
            runs = by_size[b]
            while len(runs) >= factor:
                groups.append(runs[:factor])
                runs = runs[factor:]
    return groups


def compact_incremental(plan, merge_one, budget_ms: float | None = None,
                        max_groups: int | None = None) -> int:
    """The merge-one-replan loop behind ``compact()``: each call makes
    ≥ 1 group of progress when any is eligible, then stops past
    ``budget_ms`` (wall clock) or ``max_groups`` (the opportunistic
    trigger's one-group cap).  Returns groups merged; interrupted
    compaction resumes on the next call because the plan recomputes from
    the surviving runs."""
    t0 = time.perf_counter()
    groups = plan()
    if not groups:
        # nothing eligible (the common post-append case): no timer
        # sample, or no-op calls would drive the timer's quantiles to 0
        return 0
    merged = 0
    # ONE span for the whole merge-replan loop: every index variant
    # routes through this policy, so compaction is traced here once
    with obs_span("lean.compaction") as sp:
        while True:
            # an armed fault or an expired deadline interrupts BETWEEN
            # merges, where the store is always consistent: merge_one
            # swaps a fully-built merged run in, and the next compact()
            # replans from whatever runs survive
            fault_point("compaction.merge_step")
            merge_one(groups[0])
            merged += 1
            if max_groups is not None and merged >= max_groups:
                break
            if (budget_ms is not None
                    and (time.perf_counter() - t0) * 1e3 >= budget_ms):
                break
            if check_cancel("compaction.merge_step"):
                break
            groups = plan()
            if not groups:
                break
        sp.set_attr("merged_groups", merged)
    _metrics.timer("lean.compaction.ms").update(
        (time.perf_counter() - t0) * 1e3)
    return merged


def merged_capacity(total_valid: int, total_source_cap: int,
                    gather_capacity) -> int:
    """Slot count for a merged run: the pow2 ``gather_capacity`` quantum
    when that fits inside the source runs' combined footprint, else
    exactly ``total_valid`` (padding must never make a merge GROW
    residency — slack-heavy sources release their slack)."""
    cap = gather_capacity(int(total_valid), minimum=8)
    return cap if cap <= total_source_cap else int(total_valid)
