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
``device_mesh(devices=["cpu"] * n)``).  Above the store sit the analytic
processes (``process``: kNN, proximity, tube select, route search and
the rest, with the ``SAMPLING`` / ``SAMPLE_BY`` query hints), the SQL
front end (``sql.sql_query``, ``sql.sql_join``) and the raster coverage
store (``raster.RasterStore``, whose tile stacks and mosaics are on the
card unless ``device="cpu"``).  In front of it all sit the REST app
(``web.WebApp`` / ``web.serve``: data, Arrow streams, tiles, EXPLAIN,
WCS, blobs and the mounted GeoJSON API of ``geojson``), the blob store
(``blob.GeoIndexedBlobStore``), the merged view
(``views.MergedDataStoreView``) and the command line
(``python -m geomesa_tpu_torch.cli``, which opens its catalog on the
card unless ``--device cpu`` is given).
"""

import importlib as _importlib

__version__ = "0.1.0"

#: the package's exports and the submodule each lives in: resolved at
#: first use, so importing a stdlib-only subpackage (``analysis``, the
#: gm-lint analyzer) loads neither torch nor numpy
_EXPORTS = {
    "TpuDataStore": ".datastore", "XZ2Index": ".index.xz2",
    "LeanXZ2Index": ".index.xz2_lean", "LeanXZ3Index": ".index.xz2_lean",
    "XZ3Index": ".index.xz3", "Z2PointIndex": ".index.z2",
    "Z3PointIndex": ".index.z3", "LeanZ3Index": ".index.z3_lean",
    "ShardedXZ2Index": ".parallel", "ShardedXZ3Index": ".parallel",
    "ShardedZ2Index": ".parallel", "ShardedZ3Index": ".parallel",
    "device_mesh": ".parallel", "merged_stats": ".parallel",
    "sharded_frequency_scan": ".parallel",
    "sharded_stats_scan": ".parallel",
    "Query": ".planning.planner", "QueryResult": ".planning.planner",
    "density_process": ".process.density",
    "stats_process": ".process.stats_process",
}

__all__ = ["TpuDataStore", "Z2PointIndex", "Z3PointIndex", "LeanZ3Index",
           "XZ2Index", "XZ3Index", "LeanXZ2Index", "LeanXZ3Index",
           "ShardedXZ2Index", "ShardedXZ3Index", "Query",
           "QueryResult", "density_process", "stats_process",
           "device_mesh", "ShardedZ3Index", "ShardedZ2Index",
           "sharded_stats_scan", "sharded_frequency_scan", "merged_stats"]


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(_importlib.import_module(module, __name__), name)
    globals()[name] = value
    return value
