"""geomesa_tpu_torch: the PyTorch/CUDA port of geomesa_tpu.

Spatio-temporal indexing of point (+ time) data with the same layout
and semantics as the JAX package: z3 and z2 keys over device-resident
sorted columns, host-side covering-range planning, one device scan per
query whose candidate mask is a hand-written CUDA kernel
(``csrc/z3_mask.cu``, ``csrc/z2_mask.cu``), an exact residual filter on
the host, and density heatmaps (``density_process``,
``TpuDataStore.density_tile``) whose histogram is a hand-written CUDA
kernel (``csrc/density_grid.cu``).

The port imports ``torch`` and numpy, never ``jax`` and nothing of
``geomesa_tpu``.  Its entry points (:class:`TpuDataStore`,
``Z3PointIndex.build``, ``Z2PointIndex.build``, ``density_process``) run
on the CUDA card unless the caller passes ``device="cpu"``.
"""

from .datastore import TpuDataStore
from .index.z2 import Z2PointIndex
from .index.z3 import Z3PointIndex
from .planning.planner import Query, QueryResult
from .process.density import density_process

__all__ = ["TpuDataStore", "Z2PointIndex", "Z3PointIndex", "Query",
           "QueryResult", "density_process"]
__version__ = "0.1.0"
