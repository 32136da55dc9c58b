"""The device mesh and what runs over it: sharded z3 and z2 indexes, the
per-shard stats and density push-downs, and the host-merge reducer.

One process drives every device of the mesh (``device_mesh()`` over the
card, or ``device_mesh(devices=["cpu"] * 8)`` on the CPU).  The JAX
package's multi-controller mode, ring scans, Arrow reducer and sharded
attribute/xz indexes are not ported.
"""

from ..process.stats_process import stats_process
from .mesh import DeviceMesh, device_mesh, pad_to_multiple, shard_batch
from .scan import ShardedZ3Index, sharded_density, sharded_range_count
from .stats import merged_stats, sharded_frequency_scan, sharded_stats_scan
from .z2 import ShardedZ2Index

__all__ = ["DeviceMesh", "device_mesh", "pad_to_multiple", "shard_batch",
           "ShardedZ3Index", "ShardedZ2Index", "sharded_range_count",
           "sharded_density", "sharded_stats_scan",
           "sharded_frequency_scan", "merged_stats", "stats_process"]
