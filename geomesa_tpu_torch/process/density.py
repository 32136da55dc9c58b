"""Density process: heatmap grids over query results (the reference's
DensityProcess / DENSITY_* query hints, process/analytic/
DensityProcess.scala + iterators/DensityScan.scala).

On a mesh-backed store, pure bbox+time queries over point schemas with a
dtg take the PUSH-DOWN path: the grid accumulates per shard through the
density kernel and the partial grids are summed
(``ShardedZ3Index.density``) — no hit ever materializes on the host, the
reference's server-side DensityScan + client-merge split.  Every other
query runs the query path: its hits are snapped to the grid on the
store's device by :func:`~geomesa_tpu_torch.ops.density.density_grid_auto`
(the density kernel on the card).  The JAX package's lean-profile
push-down is not ported (the port has no lean profile).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.density import density_grid_auto

__all__ = ["density_process"]


def _bbox_time_only(f, geom_field, dtg_field):
    """Structurally decompose a filter that is EXACTLY a conjunction of
    bbox/during constraints (the shape the push-downs can serve without a
    residual filter).  Returns ``(boxes, lo_ms, hi_ms)`` or None."""
    from ..filters.ast import And, BBox, During, _Include

    boxes, lo, hi = [], None, None

    def walk(node) -> bool:
        nonlocal lo, hi
        if isinstance(node, _Include):
            return True
        if isinstance(node, And):
            return all(walk(p) for p in node.filters)
        if isinstance(node, BBox) and node.prop == geom_field:
            boxes.append((node.xmin, node.ymin, node.xmax, node.ymax))
            return True
        if isinstance(node, During) and node.prop == dtg_field:
            if node.lo_ms is not None:
                lo = node.lo_ms if lo is None else max(lo, node.lo_ms)
            if node.hi_ms is not None:
                hi = node.hi_ms if hi is None else min(hi, node.hi_ms)
            return True
        return False

    if not walk(f):
        return None
    if not boxes:
        return [(-180.0, -90.0, 180.0, 90.0)], lo, hi
    # every collected bbox came from an AND context, so they INTERSECT
    # (the push-downs treat a box list as an OR of boxes)
    x0 = max(b[0] for b in boxes)
    y0 = max(b[1] for b in boxes)
    x1 = min(b[2] for b in boxes)
    y1 = min(b[3] for b in boxes)
    if x0 > x1 or y0 > y1:  # empty intersection
        x0 = y0 = 1.0
        x1 = y1 = 0.0
    return [(x0, y0, x1, y1)], lo, hi


def density_process(store, schema: str, query, env,
                    width: int = 256, height: int = 256,
                    weight_attr: str | None = None) -> np.ndarray:
    """Run ``query`` and accumulate matching features into a (height,
    width) weighted grid over envelope ``env`` (xmin, ymin, xmax, ymax).

    Returns float64 from the CPU path and float32 from the card's kernel,
    as the JAX package returns float64 off the TPU and float32 on it."""
    if getattr(store, "_mesh", None) is not None:
        from ..planning.planner import Query
        q = query if isinstance(query, Query) else Query.of(query)
        sft = store.get_schema(schema)
        st = store._store(schema)
        if (sft.is_points and sft.dtg_field and st.batch is not None
                and len(st.batch)):
            plan = _bbox_time_only(q.filter, sft.geom_field, sft.dtg_field)
            if plan is not None:
                boxes, lo, hi = plan
                weights = (st.batch.column(weight_attr).astype(np.float64)
                           if weight_attr else None)
                return st.z3_index().density(boxes, lo, hi, env, width,
                                             height, weights=weights)
    result = store.query_result(schema, query)
    batch = result.batch
    if len(batch) == 0:
        return np.zeros((height, width))
    dev = store.device
    x, y = (torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64),
                            device=dev) for a in batch.geom_xy())
    n = len(batch)
    w = (torch.as_tensor(np.ascontiguousarray(
            batch.column(weight_attr), dtype=np.float64), device=dev)
         if weight_attr else torch.ones(n, dtype=torch.float64, device=dev))
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    grid = density_grid_auto(x, y, w, mask, tuple(float(v) for v in env),
                             width, height)
    return grid.cpu().numpy()
