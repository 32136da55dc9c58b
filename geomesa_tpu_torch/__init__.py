"""geomesa_tpu_torch: the PyTorch/CUDA port of geomesa_tpu.

Spatio-temporal indexing of point (+ time) data with the same layout
and semantics as the JAX package: z3 and z2 keys over device-resident
sorted columns, host-side covering-range planning, one device scan per
query whose candidate mask is a hand-written CUDA kernel
(``csrc/z3_mask.cu``, ``csrc/z2_mask.cu``), an exact residual filter on
the host, and density heatmaps (``density_process``,
``TpuDataStore.density_tile``) whose histogram is a hand-written CUDA
kernel (``csrc/density_grid.cu``).  On a device mesh
(``TpuDataStore(mesh=device_mesh())``) the indexes shard over the mesh
and ``stats`` / heatmaps push down per shard; the stats' histograms and
count-min sketches run the ``csrc/hist1d.cu`` kernel.

The port imports ``torch`` and numpy, never ``jax`` and nothing of
``geomesa_tpu``.  Its entry points (:class:`TpuDataStore`,
``Z3PointIndex.build``, ``Z2PointIndex.build``, ``ShardedZ3Index.build``,
``ShardedZ2Index.build``, ``density_process``, ``stats_process``) run on
the CUDA card unless the caller passes ``device="cpu"`` (for a mesh,
``device_mesh(devices=["cpu"] * n)``).
"""

from .datastore import TpuDataStore
from .index.z2 import Z2PointIndex
from .index.z3 import Z3PointIndex
from .parallel import (
    ShardedZ2Index, ShardedZ3Index, device_mesh, merged_stats,
    sharded_frequency_scan, sharded_stats_scan,
)
from .planning.planner import Query, QueryResult
from .process.density import density_process
from .process.stats_process import stats_process

__all__ = ["TpuDataStore", "Z2PointIndex", "Z3PointIndex", "Query",
           "QueryResult", "density_process", "stats_process",
           "device_mesh", "ShardedZ3Index", "ShardedZ2Index",
           "sharded_stats_scan", "sharded_frequency_scan", "merged_stats"]
__version__ = "0.1.0"
