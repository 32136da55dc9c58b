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
count-min sketches run the ``csrc/hist1d.cu`` kernel.  A lean-profile
schema (``geomesa.index.profile=lean``, or a first write of
``TpuDataStore.LEAN_AUTO_ROWS`` rows) is held by the tiered generational
:class:`~geomesa_tpu_torch.index.z3_lean.LeanZ3Index`: key generations on
the card (with or without their payload) or spilled to host RAM as the
budget dictates, with heatmaps, tiles and counts pushed down next to the
keys.  Polygon and line schemas run through the XZ curves' indexes —
host ``XZ3Index`` / ``XZ2Index`` on the default profile, the sharded
variants on a mesh, and the generational ``LeanXZ3Index`` /
``LeanXZ2Index`` on the lean profile — with the exact geometry predicate
as the residual re-check.  Every covering-range plan goes through the
native C++ sweep (``geomesa_tpu_torch.native``, built with ``g++`` at
first use) when it builds, and the numpy sweep otherwise.

The port imports ``torch`` and numpy, never ``jax`` and nothing of
``geomesa_tpu``.  Its entry points (:class:`TpuDataStore`,
``Z3PointIndex.build``, ``Z2PointIndex.build``, ``ShardedZ3Index.build``,
``ShardedZ2Index.build``, ``LeanZ3Index``, ``XZ3Index.build``,
``XZ2Index.build``, ``ShardedXZ3Index.build``, ``ShardedXZ2Index.build``,
``LeanXZ3Index``, ``LeanXZ2Index``, ``density_process``,
``stats_process``) run on
the CUDA card unless the caller passes ``device="cpu"`` (for a mesh,
``device_mesh(devices=["cpu"] * n)``).
"""

from .datastore import TpuDataStore
from .index.xz2 import XZ2Index
from .index.xz2_lean import LeanXZ2Index, LeanXZ3Index
from .index.xz3 import XZ3Index
from .index.z2 import Z2PointIndex
from .index.z3 import Z3PointIndex
from .index.z3_lean import LeanZ3Index
from .parallel import (
    ShardedXZ2Index, ShardedXZ3Index, ShardedZ2Index, ShardedZ3Index,
    device_mesh, merged_stats, sharded_frequency_scan, sharded_stats_scan,
)
from .planning.planner import Query, QueryResult
from .process.density import density_process
from .process.stats_process import stats_process

__all__ = ["TpuDataStore", "Z2PointIndex", "Z3PointIndex", "LeanZ3Index",
           "XZ2Index", "XZ3Index", "LeanXZ2Index", "LeanXZ3Index",
           "ShardedXZ2Index", "ShardedXZ3Index", "Query",
           "QueryResult", "density_process", "stats_process",
           "device_mesh", "ShardedZ3Index", "ShardedZ2Index",
           "sharded_stats_scan", "sharded_frequency_scan", "merged_stats"]
__version__ = "0.1.0"
