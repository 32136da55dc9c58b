"""The device mesh and what runs over it: sharded z3, z2, xz3, xz2 and
attribute indexes, the ring-parallel scan, the lean generational z3,
attribute, XZ2 and XZ3 indexes, the per-shard stats and density
push-downs, and the host-merge reducer.

One process drives every device of the mesh (``device_mesh()`` over the
card, or ``device_mesh(devices=["cpu"] * 8)`` on the CPU).  The JAX
package's multi-controller mode and Arrow reducer are not ported.
"""

from ..process.stats_process import stats_process
from .attr_lean import (
    ShardedLeanAttrIndex, ShardedLeanXZ2Index, ShardedLeanXZ3Index,
)
from .lean import ShardedLeanZ3Index
from .mesh import DeviceMesh, device_mesh, pad_to_multiple, shard_batch
from .scan import (
    ShardedZ3Index, ring_range_counts, sharded_density, sharded_range_count,
)
from .stats import merged_stats, sharded_frequency_scan, sharded_stats_scan
from .xz import ShardedXZ2Index, ShardedXZ3Index
from .z2 import ShardedZ2Index

__all__ = ["DeviceMesh", "device_mesh", "pad_to_multiple", "shard_batch",
           "ShardedZ3Index", "ShardedZ2Index", "ShardedXZ3Index",
           "ShardedXZ2Index", "ShardedLeanZ3Index", "ShardedLeanAttrIndex",
           "ShardedLeanXZ2Index", "ShardedLeanXZ3Index",
           "sharded_range_count", "ring_range_counts", "sharded_density",
           "sharded_stats_scan", "sharded_frequency_scan", "merged_stats",
           "stats_process"]
