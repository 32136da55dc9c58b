"""Density process: heatmap grids over query results (the reference's
DensityProcess / DENSITY_* query hints, process/analytic/
DensityProcess.scala + iterators/DensityScan.scala).

The port runs the query path of the JAX package's ``density_process``:
the query's hits are snapped to the grid on the store's device by
:func:`~geomesa_tpu_torch.ops.density.density_grid_auto` (the density
kernel on the card).  The JAX package's push-down branch, which
accumulates per shard on a mesh or per generation on the lean profile
without materializing hits, cannot be reached in the port: it has
neither meshes nor the lean profile.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.density import density_grid_auto

__all__ = ["density_process"]


def density_process(store, schema: str, query, env,
                    width: int = 256, height: int = 256,
                    weight_attr: str | None = None) -> np.ndarray:
    """Run ``query`` and accumulate matching features into a (height,
    width) weighted grid over envelope ``env`` (xmin, ymin, xmax, ymax).

    Returns float64 from the CPU path and float32 from the card's kernel,
    as the JAX package returns float64 off the TPU and float32 on it."""
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
