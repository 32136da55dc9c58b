"""Partitioned distributed-analytics layer: the Spark-core analog.

The reference's geomesa-spark-core defines a SpatialRDDProvider SPI —
``rdd(conf, sc, params, query)`` returning an RDD of features whose
partitions are query range-groups, plus ``save`` writing an RDD back
(geomesa-spark/geomesa-spark-core/.../GeoMesaSpark.scala:36-69), with
providers per backend (Accumulo/HBase/FS/converter-files/GeoTools).

Here the executor fabric is the device mesh instead of a Spark cluster:
a :class:`SpatialRDD` is a list of columnar partitions (FeatureBatch
per partition — the RDD's ``Iterator[SimpleFeature]`` per split), and
providers carve partitions the same way the reference carves Hadoop
splits: per query range-group (store provider), per input file
(converter provider), or per on-disk partition (filesystem provider).
``foreach_partition`` / ``map_partitions`` run on a thread pool (the
task-executor role).

The port's copy of the JAX package's ``parallel/rdd.py``, over the port's
store, converters and ``fs/``.  The store provider orders a result by its
z2 keys with the reference's own ``np.argsort`` call on the host, so
duplicate points split into the same partitions in both packages; only a
result without point x/y columns (a non-point or geometry-less schema)
keeps its row order.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..features.batch import FeatureBatch
from ..features.feature_type import FeatureType

__all__ = ["SpatialRDD", "SpatialRDDProvider", "TpuStoreRDDProvider",
           "ConverterRDDProvider", "FileSystemRDDProvider", "spatial_rdd",
           "save_rdd"]


class SpatialRDD:
    """Partitioned feature collection (SpatialRDD analog: the RDD plus
    its schema, GeoMesaSpark.scala:59-69)."""

    def __init__(self, sft: FeatureType, partitions: list[FeatureBatch]):
        self.sft = sft
        self.partitions = [p for p in partitions if len(p)]

    @property
    def num_partitions(self) -> int:
        return len(self.partitions)

    def count(self) -> int:
        return sum(len(p) for p in self.partitions)

    def collect(self) -> FeatureBatch:
        """Gather all partitions into one batch (host concat)."""
        if not self.partitions:
            return FeatureBatch.empty(self.sft)
        out = self.partitions[0]
        for p in self.partitions[1:]:
            out = out.concat(p)
        return out

    def map_partitions(self, fn, max_workers: int = 8) -> list:
        """Apply ``fn(batch) -> value`` to every partition concurrently;
        returns the per-partition results (the mapPartitions + collect
        pattern)."""
        if not self.partitions:
            return []
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            return list(pool.map(fn, self.partitions))

    def aggregate(self, fn, reduce_fn, max_workers: int = 8):
        """map_partitions + tree reduce (the reference's scatter-gather +
        client reduce, QueryPlan.Reducer role)."""
        parts = self.map_partitions(fn, max_workers)
        if not parts:
            return None
        acc = parts[0]
        for p in parts[1:]:
            acc = reduce_fn(acc, p)
        return acc

    def to_arrow(self):
        """All partitions as a pyarrow Table (one record batch per
        partition — the interchange the reference's ArrowScan feeds)."""
        import pyarrow as pa

        from ..arrow.schema import encode_record_batch, sft_to_arrow_schema
        schema = sft_to_arrow_schema(self.sft, ())
        if not self.partitions:
            return schema.empty_table()
        dicts: dict = {}
        return pa.Table.from_batches(
            [encode_record_batch(p, schema, dicts) for p in self.partitions])


class SpatialRDDProvider:
    """SPI: can_process(params) + rdd(params, query) + save."""

    def can_process(self, params: dict) -> bool:
        raise NotImplementedError

    def rdd(self, params: dict, type_name: str, query="INCLUDE",
            num_partitions: int | None = None) -> SpatialRDD:
        raise NotImplementedError

    def save(self, rdd: SpatialRDD, params: dict, type_name: str) -> int:
        raise NotImplementedError


class TpuStoreRDDProvider(SpatialRDDProvider):
    """Partitions a TpuDataStore query result by z-shard (the reference's
    range-group partitions, AccumuloSpatialRDDProvider)."""

    def can_process(self, params: dict) -> bool:
        return "store" in params

    def rdd(self, params, type_name, query="INCLUDE",
            num_partitions: int | None = None) -> SpatialRDD:
        store = params["store"]
        sft = store.get_schema(type_name)
        batch = store.query(type_name, query)
        n = len(batch)
        if n == 0:
            return SpatialRDD(sft, [])
        k = num_partitions or min(8, max(1, n // 65536 + 1))
        # spatial-locality partitioning: order by the z-curve so each
        # partition is a contiguous key-space slab (what a range-group is)
        try:
            x, y = batch.geom_xy()
        except KeyError:   # no point x/y columns to order by
            order = np.arange(n)
        else:
            from ..curve import z2_sfc
            order = np.argsort(z2_sfc().index(x, y).cpu().numpy())
        parts = [batch.take(order[lo:lo + -(-n // k)])
                 for lo in range(0, n, -(-n // k))]
        return SpatialRDD(sft, parts)

    def save(self, rdd: SpatialRDD, params, type_name) -> int:
        store = params["store"]
        if type_name not in store.type_names:
            store.create_schema(rdd.sft)
        total = 0
        for p in rdd.partitions:
            total += store.write(type_name, p)
        return total


class ConverterRDDProvider(SpatialRDDProvider):
    """Raw files + converter config → one partition per file (the
    reference's ConverterSpatialRDDProvider)."""

    def can_process(self, params: dict) -> bool:
        return "paths" in params and "converter" in params

    def rdd(self, params, type_name, query="INCLUDE",
            num_partitions: int | None = None) -> SpatialRDD:
        from ..filters import parse_ecql
        from ..filters.evaluate import evaluate_filter
        from ..io.converters import converter_from_config

        sft = params["sft"]
        conv = converter_from_config(sft, params["converter"])
        filt = parse_ecql(query) if isinstance(query, str) else query
        parts = []
        for path in params["paths"]:
            if conv.wants_path:
                batch = conv.convert(path)
            else:
                with open(path, "rb") as f:
                    batch = conv.convert(f.read())
            if len(batch):
                mask = evaluate_filter(filt, batch)
                batch = batch.take(np.flatnonzero(mask))
            parts.append(batch)
        return SpatialRDD(sft, parts)

    def save(self, rdd, params, type_name) -> int:
        raise NotImplementedError("converter provider is read-only "
                                  "(reference behavior)")


class FileSystemRDDProvider(SpatialRDDProvider):
    """FSDS-backed: one partition per on-disk storage partition (the
    reference's FileSystemRDDProvider over parquet partitions)."""

    def can_process(self, params: dict) -> bool:
        return "fs" in params

    def rdd(self, params, type_name, query="INCLUDE",
            num_partitions: int | None = None) -> SpatialRDD:
        fs = params["fs"]
        sft = fs.get_schema(type_name)
        storage = fs._storage(type_name)
        from ..filters import parse_ecql
        from ..filters.evaluate import evaluate_filter
        filt = parse_ecql(query) if isinstance(query, str) else query
        parts = []
        for name in storage._select_partitions(filt):
            batch = storage.read_partition(name)
            if batch is None or not len(batch):
                continue
            mask = evaluate_filter(filt, batch)
            parts.append(batch.take(np.flatnonzero(mask)))
        return SpatialRDD(sft, parts)

    def save(self, rdd, params, type_name) -> int:
        fs = params["fs"]
        total = 0
        for p in rdd.partitions:
            total += fs.write(type_name, p)
        return total


_PROVIDERS = [TpuStoreRDDProvider(), ConverterRDDProvider(),
              FileSystemRDDProvider()]


def spatial_rdd(params: dict, type_name: str, query="INCLUDE",
                num_partitions: int | None = None) -> SpatialRDD:
    """GeoMesaSpark.apply analog: pick the provider that can process the
    params (ServiceLoader role) and build the RDD."""
    for p in _PROVIDERS:
        if p.can_process(params):
            return p.rdd(params, type_name, query, num_partitions)
    raise ValueError(f"no SpatialRDDProvider for params {sorted(params)}")


def save_rdd(rdd: SpatialRDD, params: dict, type_name: str) -> int:
    for p in _PROVIDERS:
        if p.can_process(params):
            return p.save(rdd, params, type_name)
    raise ValueError(f"no SpatialRDDProvider for params {sorted(params)}")
