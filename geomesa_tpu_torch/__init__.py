"""geomesa_tpu_torch: the PyTorch/CUDA port of geomesa_tpu.

Spatio-temporal indexing of point + time data with the same layout and
semantics as the JAX package: z3 keys over device-resident sorted
columns, host-side covering-range planning, one device scan per query
whose candidate mask is a hand-written CUDA kernel
(``csrc/z3_mask.cu``), and an exact residual filter on the host.

The port imports ``torch`` and numpy, never ``jax`` and nothing of
``geomesa_tpu``.  Its entry points (:class:`TpuDataStore`,
``Z3PointIndex.build``) run on the CUDA card unless the caller passes
``device="cpu"``.
"""

from .datastore import TpuDataStore
from .index.z3 import Z3PointIndex
from .planning.planner import Query, QueryResult

__all__ = ["TpuDataStore", "Z3PointIndex", "Query", "QueryResult"]
__version__ = "0.1.0"
