"""The device mesh and what runs over it: sharded z3, z2, xz3, xz2 and
attribute indexes, the ring-parallel scan, the lean generational z3,
attribute, XZ2 and XZ3 indexes, the per-shard stats and density
push-downs, and the host-merge reducer.

One process drives every device of its mesh (``device_mesh()`` over the
card, or ``device_mesh(devices=["cpu"] * 8)`` on the CPU).  Several
processes run the multi-controller mode of :mod:`.multihost`: each joins
a ``torch.distributed`` group (``initialize_distributed``), drives its
own devices (``global_device_mesh``) and feeds its own rows through the
``build_multihost`` builds and multihost stores; hit lists allgather and
device partials all-reduce.  :mod:`.rdd` partitions a store's query
result, converted files or a ``FileSystemDataStore``'s partitions into a
``SpatialRDD``.
"""

from ..process.stats_process import stats_process
from .attr_lean import (
    ShardedLeanAttrIndex, ShardedLeanXZ2Index, ShardedLeanXZ3Index,
)
from .lean import ShardedLeanZ3Index
from .mesh import DeviceMesh, device_mesh, pad_to_multiple, shard_batch
from .multihost import (
    global_device_mesh, initialize_distributed, process_count, process_index,
    shutdown_distributed,
)
from .rdd import (
    ConverterRDDProvider, FileSystemRDDProvider, SpatialRDD,
    SpatialRDDProvider, TpuStoreRDDProvider, save_rdd, spatial_rdd,
)
from .scan import (
    ShardedZ3Index, ring_range_counts, sharded_density, sharded_range_count,
)
from .stats import (
    merged_arrow, merged_stats, sharded_frequency_scan, sharded_stats_scan,
)
from .xz import ShardedXZ2Index, ShardedXZ3Index
from .z2 import ShardedZ2Index

__all__ = ["DeviceMesh", "device_mesh", "pad_to_multiple", "shard_batch",
           "ShardedZ3Index", "ShardedZ2Index", "ShardedXZ3Index",
           "ShardedXZ2Index", "ShardedLeanZ3Index", "ShardedLeanAttrIndex",
           "ShardedLeanXZ2Index", "ShardedLeanXZ3Index",
           "sharded_range_count", "ring_range_counts", "sharded_density",
           "sharded_stats_scan", "sharded_frequency_scan", "merged_stats",
           "merged_arrow",
           "stats_process", "initialize_distributed", "shutdown_distributed",
           "global_device_mesh", "process_index", "process_count",
           "SpatialRDD", "SpatialRDDProvider", "TpuStoreRDDProvider",
           "ConverterRDDProvider", "FileSystemRDDProvider", "spatial_rdd",
           "save_rdd"]
