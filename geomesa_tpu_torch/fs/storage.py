"""FileSystemDataStore: partitioned parquet storage with query pruning.

The analog of the reference's geomesa-fs module (FileSystemDataStore over
Parquet, partition schemes as the index, file-based metadata with
compaction; geomesa-fs/geomesa-fs-storage/ + geomesa-fs-datastore/).
Layout::

    root/
      <type>/
        metadata.json              schema spec + scheme config + file list
        <partition>/<file>.parquet

Queries prune partitions via the scheme, scan only the surviving files,
and evaluate the full filter per batch (there is no row index inside a
partition — matching the reference, where Parquet row-group filters do
the fine-grained work).  ``compact`` merges a partition's files into one
(FileBasedMetadata compaction + FsManageMetadataCommand analog).

The port's copy of the JAX package's ``fs/storage.py``, with the same
layout and metadata: either package opens the other's store.  The store
is a host store (numpy batches, no device); :func:`to_device_store` lifts
one schema into a :class:`~geomesa_tpu_torch.datastore.TpuDataStore` on
the card.  ``pyarrow`` is needed, as in the JAX package.
"""

from __future__ import annotations

import fnmatch
import json
import os
import threading
from functools import lru_cache
import uuid

import numpy as np

from ..features.batch import FeatureBatch
from ..features.feature_type import FeatureType, parse_spec
from ..geometry.packed import PackedGeometry
from ..filters.evaluate import evaluate_filter
from ..planning.planner import Query
from .partitions import PartitionScheme, scheme_from_config

__all__ = ["FileSystemDataStore", "to_device_store"]


def _concat(batches: list) -> FeatureBatch:
    """The batches in order as one batch, each column concatenated once
    (folding them pairwise copies the growing prefix at every step)."""
    if len(batches) == 1:
        return batches[0]
    first = batches[0]
    geoms = (PackedGeometry.concat_many([b.geoms for b in batches])
             if first.geoms is not None else None)
    return FeatureBatch(
        first.sft, {k: np.concatenate([b.columns[k] for b in batches])
                    for k in first.columns},
        np.concatenate([b.ids for b in batches]), geoms)


@lru_cache(maxsize=1)
def _scan_pool():
    """Shared scan thread pool (spawning a fresh executor per query
    would rival the IO it overlaps on small partition sets)."""
    from concurrent.futures import ThreadPoolExecutor
    return ThreadPoolExecutor(_TypeStorage.SCAN_THREADS,
                              thread_name_prefix="fsds-scan")


class _TypeStorage:
    def __init__(self, root: str, sft: FeatureType, scheme: PartitionScheme,
                 encoding: str = "parquet"):
        if encoding not in ("parquet", "orc"):
            raise ValueError(f"unsupported encoding {encoding!r}")
        self.root = root
        self.sft = sft
        self.scheme = scheme
        self.encoding = encoding
        self._lock = threading.Lock()
        self._meta_path = os.path.join(root, "metadata.json")

    # -- metadata ---------------------------------------------------------
    def _load_meta(self) -> dict:
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                return json.load(f)
        return {"spec": self.sft.spec_string(),
                "scheme": self.scheme.to_config(),
                "encoding": self.encoding, "partitions": {}}

    # -- file codec (parquet or ORC, the FSDS storage formats) ------------
    def _write_file(self, batch: FeatureBatch, path: str) -> None:
        from ..io.export import to_orc, to_parquet

        (to_orc if self.encoding == "orc" else to_parquet)(batch, path)

    def _read_file(self, path: str) -> FeatureBatch:
        from ..io.export import from_orc, from_parquet

        return (from_orc if self.encoding == "orc" else from_parquet)(
            path, self.sft)

    def _save_meta(self, meta: dict) -> None:
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(tmp, self._meta_path)

    # -- io ---------------------------------------------------------------
    def write(self, batch: FeatureBatch) -> None:
        if len(batch) == 0:
            return
        names = self.scheme.partitions_for_batch(self.sft, batch)
        # group rows by name in sorted name order, each group in row
        # order (a stable argsort of the names, over fixed-width codes
        # rather than Python string compares)
        uniq, inv = np.unique(names.astype(str), return_inverse=True)
        order = np.argsort(inv.ravel(), kind="stable")
        ends = np.cumsum(np.bincount(inv.ravel(), minlength=len(uniq)))
        with self._lock:
            meta = self._load_meta()
            if not batch.ids_explicit:
                # auto ids rebase on a per-schema monotonic counter kept
                # in the metadata: per-write 0..n-1 ids would collide
                # across writes (every partition file would restart at 0)
                base = int(meta.get("next_fid", self.count()))
                batch = FeatureBatch(
                    batch.sft, dict(batch.columns), geoms=batch.geoms,
                    ids=np.array([str(base + i) for i in range(len(batch))],
                                 dtype=object))
                meta["next_fid"] = base + len(batch)
            for part, s, e in zip(uniq.tolist(), np.r_[0, ends[:-1]], ends):
                sub = batch.take(order[s:e])
                pdir = os.path.join(self.root, part)
                os.makedirs(pdir, exist_ok=True)
                fname = f"{uuid.uuid4().hex[:12]}.{self.encoding}"
                self._write_file(sub, os.path.join(pdir, fname))
                meta["partitions"].setdefault(part, []).append(
                    {"file": fname, "count": len(sub)})
            self._save_meta(meta)

    def partitions(self) -> list:
        return sorted(self._load_meta()["partitions"])

    def partition_info(self) -> dict:
        """partition name → {"files": count, "features": count} — the
        public view of the partition metadata (CLI/manage-partitions)."""
        meta = self._load_meta()
        return {name: {"files": len(files),
                       "features": sum(f["count"] for f in files)}
                for name, files in meta["partitions"].items()}

    def count(self) -> int:
        return sum(f["count"] for files in self._load_meta()["partitions"].values()
                   for f in files)

    def _select_partitions(self, filt) -> list:
        meta = self._load_meta()
        names = sorted(meta["partitions"])
        pruned = self.scheme.partitions_for_filter(self.sft, filt)
        if pruned is None:
            return names
        keep = []
        for pat in pruned:
            if "*" in pat:
                keep.extend(n for n in names if fnmatch.fnmatch(n, pat))
            elif pat in meta["partitions"]:
                keep.append(pat)
        return sorted(set(keep))

    def read_partition(self, name: str) -> FeatureBatch | None:
        """All of one partition's files as a single batch (no filtering) —
        the per-split read used by the RDD provider."""
        meta = self._load_meta()
        entries = meta["partitions"].get(name, [])
        parts = [self._read_file(os.path.join(self.root, name, e["file"]))
                 for e in entries]
        if not parts:
            return None
        return _concat(parts)

    #: parallel partition-file readers (the AbstractBatchScan pipelined
    #: multi-threaded scan role, index/utils/AbstractBatchScan.scala —
    #: file IO + decode overlap across partitions)
    SCAN_THREADS = 8

    def query(self, query) -> FeatureBatch:
        q = query if isinstance(query, Query) else Query.of(query)
        meta = self._load_meta()
        paths = [os.path.join(self.root, part, entry["file"])
                 for part in self._select_partitions(q.filter)
                 for entry in meta["partitions"][part]]

        def scan_one(path: str):
            batch = self._read_file(path)
            mask = evaluate_filter(q.filter, batch)
            return batch.take(np.flatnonzero(mask)) if mask.any() else None

        if len(paths) > 1:
            results = list(_scan_pool().map(scan_one, paths))
        else:
            results = [scan_one(p) for p in paths]
        parts = [r for r in results if r is not None]
        if not parts:
            return FeatureBatch.empty(self.sft)
        out = _concat(parts)
        if q.max_features is not None:
            out = out.take(np.arange(min(q.max_features, len(out))))
        return out

    def compact(self, partition: str) -> int:
        """Merge a partition's files into one; returns resulting file count."""
        with self._lock:
            meta = self._load_meta()
            files = meta["partitions"].get(partition, [])
            if len(files) <= 1:
                return len(files)
            pdir = os.path.join(self.root, partition)
            merged = _concat([self._read_file(os.path.join(pdir, f["file"]))
                              for f in files])
            fname = f"{uuid.uuid4().hex[:12]}.{self.encoding}"
            self._write_file(merged, os.path.join(pdir, fname))
            for f in files:
                os.remove(os.path.join(pdir, f["file"]))
            meta["partitions"][partition] = [
                {"file": fname, "count": len(merged)}]
            self._save_meta(meta)
            return 1


class FileSystemDataStore:
    """Multi-type partitioned parquet/ORC store rooted at a directory
    (FSDS analog; geomesa-fs parquet + orc storage formats)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._types: dict[str, _TypeStorage] = {}
        self._discover()

    def _discover(self) -> None:
        for name in os.listdir(self.root):
            meta = os.path.join(self.root, name, "metadata.json")
            if os.path.exists(meta):
                with open(meta) as f:
                    m = json.load(f)
                sft = parse_spec(name, m["spec"])
                self._types[name] = _TypeStorage(
                    os.path.join(self.root, name), sft,
                    scheme_from_config(m["scheme"]),
                    encoding=m.get("encoding", "parquet"))

    def create_schema(self, name: str, spec: str,
                      scheme: PartitionScheme | dict | None = None,
                      encoding: str = "parquet") -> FeatureType:
        if name in self._types:
            raise ValueError(f"schema {name!r} already exists")
        sft = parse_spec(name, spec)
        if scheme is None:
            scheme = scheme_from_config({"scheme": "datetime"})
        elif isinstance(scheme, dict):
            scheme = scheme_from_config(scheme)
        ts = _TypeStorage(os.path.join(self.root, name), sft, scheme,
                          encoding=encoding)
        os.makedirs(ts.root, exist_ok=True)
        ts._save_meta(ts._load_meta())
        self._types[name] = ts
        return sft

    def get_schema(self, name: str) -> FeatureType:
        return self._storage(name).sft

    @property
    def type_names(self) -> list:
        return sorted(self._types)

    def _storage(self, name: str) -> _TypeStorage:
        if name not in self._types:
            raise KeyError(f"no such schema: {name!r}")
        return self._types[name]

    def write(self, name: str, data, ids=None) -> int:
        ts = self._storage(name)
        batch = (data if isinstance(data, FeatureBatch)
                 else FeatureBatch.from_dict(ts.sft, data, ids=ids))
        ts.write(batch)
        return len(batch)

    def query(self, name: str, query="INCLUDE") -> FeatureBatch:
        return self._storage(name).query(query)

    def partition_info(self, name: str) -> dict:
        """Per-partition file/feature counts (manage-partitions view)."""
        return self._storage(name).partition_info()

    def partitions(self, name: str) -> list:
        return self._storage(name).partitions()

    def count(self, name: str) -> int:
        return self._storage(name).count()

    def compact(self, name: str, partition: str | None = None) -> None:
        ts = self._storage(name)
        for part in ([partition] if partition else ts.partitions()):
            ts.compact(part)


def to_device_store(fs: "FileSystemDataStore", name: str, mesh=None,
                    catalog_dir: str | None = None, device=None):
    """Lift an FSDS schema into a (optionally mesh-backed) TpuDataStore —
    the reference's pattern of running analytics over FSDS data through
    a compute engine (geomesa-fs-spark): partitions stream in as one
    columnar batch and every device index becomes available.  ``device``
    resolves as ``TpuDataStore``'s does: the card unless the caller names
    the CPU.

    Returns the new ``TpuDataStore`` holding the schema's features.
    """
    from ..datastore import TpuDataStore

    storage = fs._storage(name)
    ds = TpuDataStore(device, mesh=mesh, catalog_dir=catalog_dir)
    ds.create_schema(name, storage.sft.spec_string())
    batches = [b for b in (storage.read_partition(p)
                           for p in fs.partitions(name)) if b is not None]
    if batches:
        ds.write(name, _concat(batches))
    return ds
