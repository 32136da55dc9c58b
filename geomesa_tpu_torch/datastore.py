"""TpuDataStore: the user-facing store facade of the port.

The analog of the reference's GeoMesaDataStore / MetadataBackedDataStore
(geomesa-index-api/.../index/geotools/GeoMesaDataStore.scala:48-431;
createSchema at MetadataBackedDataStore.scala:121): schema lifecycle,
ingest and query over host columns plus device-resident Z3 and Z2
indexes, and density heatmap tiles.

Index maintenance model: each index builds lazily on the first query
that chooses it; later writes APPEND their rows into its resident sorted
columns.  Each index owns its columns (appends write into them in place,
so two indexes never share storage).  Stats are observed on write (the
reference's StatsCombiner role) and feed the cost-based strategy decider.

What the port serves: point schemas, with or without a dtg attribute, on
the default profile, through the ``z3``, ``z2`` and ``id`` indexes, full
scans and empty plans; with ``mesh=`` (one process driving a
:func:`~geomesa_tpu_torch.parallel.device_mesh`) the indexes are their
sharded variants and ``stats`` and density push down per shard.

The LEAN (scale) profile — a schema created with
``geomesa.index.profile=lean``, or a point schema with a dtg whose first
write (without a mesh) holds ``LEAN_AUTO_ROWS`` rows or more — stores its
columns chunked (:class:`~geomesa_tpu_torch.features.lean.LeanBatch`,
implicit feature ids) and indexes them in the tiered generational
:class:`~geomesa_tpu_torch.index.z3_lean.LeanZ3Index` (plus implicit-id
lookups); heatmaps, tiles and ``Count()`` push down next to its keys.
Sealed lean generations carry density pyramids (``build_pyramids``,
or built behind every seal with ``geomesa.density.pyramid.build=seal``);
lean stores of ``geomesa.planning.estimator.min.rows`` rows or more cost
their z3 plans from the index's cell-count sketches, and a lean scan
that observes far more candidates than costed replans once.  Schemas
may name query interceptors (``geomesa.query.interceptors``), an
age-off window (``geomesa.age.off``) and z-prefixed UUID feature ids
(``geomesa.fid.strategy=z3``).
Lean stores over a mesh, lean schemas with indexed attributes or
non-point geometries, fused serving, deletes, persistence,
multi-controller meshes, visibilities and authorizations are not ported
and raise rather than degrade.
"""

from __future__ import annotations

import re
import weakref

import numpy as np

from .config import DensityProperties, PlanningProperties

from .device import resolve_device
from .features.batch import FeatureBatch, build_columns
from .features.feature_type import FeatureType, parse_spec
from .features.lean import ChunkView, LeanBatch
from .index.id import IdIndex, LeanIdIndex
from .index.pyramid import tile_env
from .index.z2 import Z2_INDEX_VERSION, Z2PointIndex
from .index.z3 import Z3_INDEX_VERSION, Z3PointIndex
from .index.z3_lean import LeanZ3Index
from .jobs import run_pyramid_build
from .parallel.scan import ShardedZ3Index
from .parallel.z2 import ShardedZ2Index
from .planning.estimator import CardinalityEstimator
from .planning.explain import Explainer
from .planning.interceptor import apply_interceptors, load_interceptors
from .planning.planner import Query, QueryPlanner, QueryResult
from .planning.strategy import FilterStrategy
from .stats.stat import BBoxStat, CountStat, EnumerationStat, MinMax, Stat, TopK
from .utils.feature_id import z3_feature_ids

__all__ = ["TpuDataStore"]


def _max_numeric_id(ids: np.ndarray) -> int:
    """Largest plain-integer feature id in ``ids`` (−1 when none).

    Explicit numeric ids must advance the auto-id counter, or later
    auto-generated ids would collide with them.  isdecimal, not isdigit:
    unicode digit characters like '²' pass isdigit but fail int parsing."""
    s = np.asarray(ids).astype(str)
    if not len(s):
        return -1
    mask = np.char.isdecimal(s) & (np.char.str_len(s) <= 18)
    if not mask.any():
        return -1
    return int(s[mask].astype(np.int64).max())


#: current key-layout version of each ported index
_CURRENT_INDEX_VERSIONS = {"z3": Z3_INDEX_VERSION, "z2": Z2_INDEX_VERSION}


class _SchemaStore:
    """Per-schema storage: the column batch + the lazily-built z3/z2/id
    indexes (z3/z2 sharded over ``mesh`` when one is given) + stats; on
    the lean profile a chunked batch + the tiered lean z3 index."""

    #: default opportunistic LSM compaction factor for the lean index:
    #: merge when ≥ F sealed same-tier same-size-class runs accumulate
    #: (``geomesa.lean.compaction.factor`` user data overrides; 0
    #: disables the opportunistic trigger — explicit compact() still
    #: works)
    LEAN_COMPACTION_FACTOR = 8

    def __init__(self, sft: FeatureType, device, mesh=None):
        self.sft = sft
        self.device = device
        self.mesh = mesh
        self.batch: FeatureBatch | LeanBatch | None = None
        self._indexes: dict = {}
        #: per-index-type build counter (the no-full-rebuild tests)
        self.build_counts: dict[str, int] = {}
        self._stats: dict[str, Stat] = {}
        #: monotonic auto feature-id counter — ids are never reused
        self.next_fid: int = 0
        #: lazily-built id set for O(m) explicit-id collision checks
        self._id_set: set | None = None
        #: lean profile (``geomesa.index.profile=lean`` user data, or
        #: switched on by a large first write, see TpuDataStore.write)
        self.lean = ((sft.user_data or {}).get(
            "geomesa.index.profile") == "lean")
        #: generation-lifecycle hook the owning datastore parks here; the
        #: lean index registers it when created, and it runs the
        #: build-behind pyramid pass on seal
        self.pyramid_trigger = None
        #: seal-triggered pyramid builds that raised (the write never
        #: fails for them) and the last such error
        self.pyramid_build_failures = 0
        self.pyramid_build_error: BaseException | None = None
        self._estimator: CardinalityEstimator | None = None
        self._init_stats()
        if self.lean:
            self._init_lean()

    @property
    def query_indices(self) -> set:
        """Indices the planner may choose (plus the full and empty plans
        every schema has): z3, z2 and id on the default profile — the JAX
        store's xz and attribute indexes are not ported — and the lean
        profile's z3 scale index and implicit-id lookups."""
        if self.lean:
            return {"z3", "id"}
        return {"z3", "z2", "id"}

    # -- lean profile ------------------------------------------------------
    def _init_lean(self) -> None:
        sft = self.sft
        if self.mesh is not None:
            raise NotImplementedError(
                "lean-profile schemas over a device mesh are not ported")
        if sft.geom_field and not sft.is_points:
            raise NotImplementedError(
                "non-point lean-profile schemas (the lean xz indexes) are "
                "not ported")
        if not (sft.is_points and sft.geom_field and sft.dtg_field):
            raise ValueError(
                "geomesa.index.profile=lean requires a point geometry "
                "plus a dtg attribute (z3 scale index)")
        # the JAX store's lean attribute tier serves these types
        lexicoded = {"int", "integer", "long", "float", "double", "date",
                     "string"}
        attrs = [a.name for a in sft.attributes
                 if a.indexed and not a.is_geometry
                 and a.name != sft.dtg_field and a.type in lexicoded]
        if attrs:
            raise NotImplementedError(
                f"lean-profile attribute indexes are not ported (indexed "
                f"attributes {attrs} on {sft.name!r})")
        self.lean = True
        self.batch = LeanBatch(sft)

    def _lean_payload(self):
        """(x, y, t) for the lean index's exact re-check — the store's own
        finalized columns (ONE host copy, shared by reference)."""
        x, y = self.batch.geom_xy()
        t = np.asarray(self.batch.column(self.sft.dtg_field), np.int64)
        return x, y, t

    def _lean_index(self) -> LeanZ3Index:
        """The live lean scale index, created by the first write (before
        the batch grows) and maintained incrementally by every write."""
        idx = self._indexes.get("z3")
        if idx is None:
            idx = LeanZ3Index(
                period=self.sft.z3_interval,
                version=_index_version(self.sft, "z3"),
                generation_slots=self._lean_user_int(
                    "geomesa.lean.generation.slots", None),
                hbm_budget_bytes=self._lean_user_int(
                    "geomesa.lean.hbm.budget", LeanZ3Index.HBM_BUDGET_BYTES),
                compaction_factor=self._lean_user_int(
                    "geomesa.lean.compaction.factor",
                    self.LEAN_COMPACTION_FACTOR),
                device=self.device)
            idx.payload_provider = self._lean_payload
            if self.pyramid_trigger is not None:
                idx.generation_listeners.append(self.pyramid_trigger)
            self._indexes["z3"] = idx
            self.build_counts["z3"] = self.build_counts.get("z3", 0) + 1
        return idx

    def _lean_user_int(self, key: str, default):
        """An integer lean knob from the schema's user data
        (``geomesa.lean.hbm.budget`` bytes, ``geomesa.lean.generation.
        slots``, ``geomesa.lean.compaction.factor``), else ``default``."""
        raw = (self.sft.user_data or {}).get(key)
        return int(raw) if raw not in (None, "") else default

    def _lean_write(self, chunk: ChunkView) -> None:
        """Streaming ingest: observe stats on the chunk, append its
        columns by reference, and push its keys into the live index —
        O(chunk) per write."""
        for s in self._stats.values():
            s.observe(chunk)
        # index BEFORE the batch grows (it is created empty)
        idx = self._lean_index()
        self.batch.append_batch(chunk)
        x, y = chunk.geom_xy(self.sft.geom_field)
        idx.append(np.asarray(x, np.float64), np.asarray(y, np.float64),
                   np.asarray(chunk.column(self.sft.dtg_field), np.int64))

    def compact_lean(self, budget_ms: float | None = None) -> dict:
        """Explicit LSM maintenance of the lean scale index (the role the
        reference delegates to Accumulo/HBase major compaction); empty for
        default-profile schemas and lean ones not yet written."""
        idx = self._indexes.get("z3") if self.lean else None
        if idx is None:
            return {}
        return {"z3": idx.compact(budget_ms=budget_ms)}

    def build_pyramids(self) -> int:
        """Build density pyramids over the lean index's sealed
        generations; the number built (0 for default-profile schemas)."""
        if not self.lean or self.batch is None:
            return 0
        return self._lean_index().build_pyramids()

    def estimator(self) -> CardinalityEstimator | None:
        """The sketch-fed cardinality estimator for the planner: lean
        stores of ``geomesa.planning.estimator.min.rows`` rows or more
        only (on a smaller store the cold per-generation folds cannot
        amortize); None elsewhere, and the decider costs from
        whole-store stats, then heuristics."""
        if not self.lean:
            return None
        rows = len(self.batch) if self.batch is not None else 0
        if rows < PlanningProperties.ESTIMATOR_MIN_ROWS.to_int():
            return None
        if self._estimator is None:
            self._estimator = CardinalityEstimator(self)
        return self._estimator

    def _init_stats(self):
        sft = self.sft
        self._stats["count"] = CountStat()
        if sft.dtg_field:
            self._stats["dtg_minmax"] = MinMax(sft.dtg_field)
        if sft.geom_field:
            # the spatial selectivity denominator: query boxes fraction
            # against the DATA extent, not the world
            self._stats[f"{sft.geom_field}_bbox"] = BBoxStat(sft.geom_field)
        for a in sft.attributes:
            if a.is_geometry or a.name == sft.dtg_field:
                continue
            if a.type in ("int", "long", "float", "double"):
                self._stats[f"{a.name}_minmax"] = MinMax(a.name)
            elif a.type == "string" and a.indexed:
                self._stats[f"{a.name}_topk"] = TopK(a.name)
                self._stats[f"{a.name}_enumeration"] = EnumerationStat(a.name)

    def write(self, batch: FeatureBatch):
        self.batch = batch if self.batch is None else self.batch.concat(batch)
        # the id index is a sorted snapshot of the ids: rebuilt lazily
        self._indexes.pop("id", None)
        for s in self._stats.values():
            s.observe(batch)
        if self._id_set is not None:
            self._id_set.update(batch.ids.astype(str).tolist())
        # incremental index maintenance (IndexAdapter.IndexWriter.write,
        # api/IndexAdapter.scala:95-106): a built index APPENDS the new
        # rows into its resident sorted columns
        z3 = self._indexes.get("z3")
        if z3 is not None:
            x, y = batch.geom_xy(self.sft.geom_field)
            z3.append(x, y, batch.column(self.sft.dtg_field))
        z2 = self._indexes.get("z2")
        if z2 is not None:
            z2.append(*batch.geom_xy(self.sft.geom_field))

    def stats_map(self) -> dict:
        return self._stats

    def merge_stat_global(self, s: Stat) -> Stat:
        """Merge one per-process stat across processes: the identity, as
        the port has one process."""
        return s

    def find_id_clash(self, ids) -> str | None:
        """First id in ``ids`` that already exists in this store's rows
        (lazy incrementally-maintained id set — O(ids), not O(store))."""
        if self.batch is None or not len(self.batch):
            return None
        if self._id_set is None:
            self._id_set = set(self.batch.ids.astype(str).tolist())
        return next((i for i in ids if i in self._id_set), None)

    def index(self, name: str):
        """Lazily-built index accessor with the JAX registry's
        applicability (index/registry.py): z3 on point schemas with a dtg
        attribute, z2 on point schemas, id on every schema; on the lean
        profile the lean z3 index and implicit-id lookups only."""
        if self.lean:
            if name == "z3":
                return self._lean_index()
            if name == "id":
                return LeanIdIndex(len(self.batch))
            raise ValueError(
                f"index {name!r} is not available on lean-profile "
                f"schema {self.sft.name!r} (z3/id only)")
        if name == "id":
            if "id" not in self._indexes:
                self._indexes["id"] = IdIndex.build(self.batch.ids)
                self.build_counts["id"] = self.build_counts.get("id", 0) + 1
            return self._indexes["id"]
        if name not in _CURRENT_INDEX_VERSIONS:
            raise NotImplementedError(f"index {name!r} is not ported")
        sft = self.sft
        enabled = sft.enabled_indices
        if enabled is not None and name not in enabled:
            raise ValueError(
                f"index {name!r} is disabled on schema {sft.name!r} "
                "(geomesa.indices.enabled)")
        if not (sft.is_points and sft.geom_field
                and (name == "z2" or sft.dtg_field)):
            raise ValueError(f"schema {sft.name!r} does not support the "
                             f"{name!r} index")
        if name not in self._indexes:
            build = self._build_z3 if name == "z3" else self._build_z2
            self._indexes[name] = build()
            self.build_counts[name] = self.build_counts.get(name, 0) + 1
        return self._indexes[name]

    def z3_index(self) -> Z3PointIndex | ShardedZ3Index:
        return self.index("z3")

    def z2_index(self) -> Z2PointIndex | ShardedZ2Index:
        return self.index("z2")

    def id_index(self) -> IdIndex | LeanIdIndex:
        return self.index("id")

    def _build_z3(self):
        x, y = self.batch.geom_xy()
        dtg = self.batch.column(self.sft.dtg_field)
        if self.mesh is not None:
            return ShardedZ3Index.build(
                x, y, dtg, period=self.sft.z3_interval, mesh=self.mesh,
                version=_index_version(self.sft, "z3"))
        return Z3PointIndex.build(
            x, y, dtg, period=self.sft.z3_interval,
            version=_index_version(self.sft, "z3"), device=self.device)

    def _build_z2(self):
        # the z2 index owns its x/y copies: the JAX store shares them with
        # z3 (immutable arrays there), but the port's appends write into
        # resident columns in place
        x, y = self.batch.geom_xy()
        if self.mesh is not None:
            return ShardedZ2Index.build(
                x, y, mesh=self.mesh, version=_index_version(self.sft, "z2"))
        return Z2PointIndex.build(
            x, y, version=_index_version(self.sft, "z2"), device=self.device)


def _index_version(sft: FeatureType, index: str) -> int:
    """The schema's key-layout version of ``index``
    (``geomesa.index.versions`` user data, e.g. ``"z3:1,z2:1"``, pins old
    layouts; only the current ones are ported)."""
    raw = (sft.user_data or {}).get("geomesa.index.versions", "")
    version = _CURRENT_INDEX_VERSIONS[index]
    if raw and raw != "current":
        for part in raw.split(","):
            name, _, v = part.strip().partition(":")
            if name == index:
                version = int(v)
    return version


class TpuDataStore:
    """In-process spatio-temporal datastore over device-resident z3 and
    z2 indexes, sharded over a device mesh when one is given, and the
    tiered lean z3 index for lean-profile schemas."""

    #: first-write row count at which a qualifying schema (points with a
    #: dtg, no mesh, auto ids) switches to the lean profile
    LEAN_AUTO_ROWS = 32_000_000

    def __init__(self, device=None, *, mesh=None, multihost: bool = False,
                 auth_provider=None, catalog_dir: str | None = None):
        """``device``: where the indexes live — the CUDA card unless the
        caller names the CPU; with no card and no explicit ``"cpu"`` this
        raises.  ``mesh``: a :class:`~geomesa_tpu_torch.parallel.mesh.
        DeviceMesh`; every index then builds its sharded variant over it
        (``device`` still places the query path's heatmap grids)."""
        if catalog_dir is not None:
            raise NotImplementedError(
                "catalog persistence and lean snapshots are not ported")
        if multihost:
            raise NotImplementedError(
                "multi-controller (multihost) stores are not ported")
        if auth_provider is not None:
            raise NotImplementedError(
                "authorizations and visibilities are not ported")
        self.device = resolve_device(device)
        self._mesh = mesh
        self._schemas: dict[str, _SchemaStore] = {}
        #: per-schema query interceptors (``geomesa.query.interceptors``
        #: and ``geomesa.age.off`` user data), loaded at create_schema
        self._interceptors: dict[str, list] = {}

    # -- schema lifecycle (MetadataBackedDataStore.createSchema etc.) ----
    def create_schema(self, sft_or_name, spec: str | None = None) -> FeatureType:
        if isinstance(sft_or_name, FeatureType):
            sft = sft_or_name
        else:
            sft = parse_spec(sft_or_name, spec)
        if not re.fullmatch(r"[A-Za-z0-9_-]+", sft.name):
            raise ValueError(
                f"invalid schema name {sft.name!r}: letters, digits, "
                "underscore and dash only")
        if sft.name in self._schemas:
            raise ValueError(f"schema {sft.name!r} already exists")
        store = _SchemaStore(sft, self.device, mesh=self._mesh)
        store.pyramid_trigger = self._pyramid_listener(sft.name)
        self._schemas[sft.name] = store
        # interceptors resolve EAGERLY: a typoed class path fails
        # create_schema, not the first query
        self._interceptors[sft.name] = load_interceptors(sft)
        return sft

    def get_schema(self, name: str) -> FeatureType:
        return self._store(name).sft

    def type_names(self) -> list[str]:
        return sorted(self._schemas)

    def _store(self, name: str) -> _SchemaStore:
        if name not in self._schemas:
            raise KeyError(f"no such schema: {name!r}")
        return self._schemas[name]

    # -- ingest -----------------------------------------------------------
    def write(self, name: str, data, ids=None, visibility: str = "",
              attribute_visibilities: dict | None = None) -> int:
        """Append features: a FeatureBatch or a dict of columns."""
        if visibility or attribute_visibilities:
            raise NotImplementedError("visibilities are not ported")
        store = self._store(name)
        sft = store.sft
        # auto-profile: only point schemas WITH a dtg, and only without a
        # mesh, flip to the lean profile, BEFORE any default-profile state
        # exists; the rest stay on the default profile at any size
        if (not store.lean and store.batch is None and self._mesh is None
                and sft.is_points and sft.geom_field
                and sft.dtg_field and not isinstance(data, FeatureBatch)
                and ids is None):
            first = next(iter(data.values()), ())
            n_first = (len(first[0]) if isinstance(first, tuple)
                       else len(first))
            if n_first >= self.LEAN_AUTO_ROWS:
                store._init_lean()
                sft.user_data["geomesa.index.profile"] = "lean"
        if store.lean:
            if ids is not None or (isinstance(data, FeatureBatch)
                                   and data.ids_explicit):
                raise ValueError(
                    "lean-profile schemas use implicit feature ids "
                    "(row number); explicit ids are not supported")
            if isinstance(data, FeatureBatch):
                chunk = ChunkView(sft, dict(data.columns), len(data))
            else:
                cols, _ = build_columns(sft, data)
                chunk = ChunkView(sft, cols,
                                  len(next(iter(cols.values()))) if cols
                                  else 0)
            store._lean_write(chunk)
            store.next_fid = len(store.batch)
            return len(chunk)
        batch = (data if isinstance(data, FeatureBatch)
                 else FeatureBatch.from_dict(store.sft, data, ids=ids))
        if not batch.ids_explicit:
            # feature ids must be unique across writes, re-based on a
            # shallow copy so the caller's batch is never mutated: with
            # ``geomesa.fid.strategy=z3`` user data, z-prefixed UUIDs
            # (Z3FeatureIdGenerator locality), else a monotonic counter,
            # never reused
            if (sft.user_data.get("geomesa.fid.strategy") == "z3"
                    and sft.is_points and sft.dtg_field):
                x, y = batch.geom_xy()
                new_ids = z3_feature_ids(x, y, batch.column(sft.dtg_field),
                                         period=sft.z3_interval)
            else:
                base = store.next_fid
                new_ids = np.array(
                    [f"{base + i}" for i in range(len(batch))],
                    dtype=object)
            batch = FeatureBatch(batch.sft, dict(batch.columns),
                                 geoms=batch.geoms, ids=new_ids)
            next_fid = store.next_fid + len(batch)
        else:
            ids_in = batch.ids.astype(str)
            uniq, counts = np.unique(ids_in, return_counts=True)
            if (counts > 1).any():
                raise ValueError(f"duplicate feature id "
                                 f"{uniq[counts > 1][0]!r} within the "
                                 "write batch")
            clash = store.find_id_clash(ids_in)
            if clash is not None:
                raise ValueError(
                    f"feature id {clash!r} already exists in schema "
                    f"{name!r} (delete it first, or use auto-generated ids)")
            next_fid = max(store.next_fid, _max_numeric_id(batch.ids) + 1)
        store.write(batch)
        store.next_fid = next_fid
        return len(batch)

    # -- query ------------------------------------------------------------
    def query(self, name: str, query="INCLUDE",
              explain: Explainer | None = None) -> FeatureBatch:
        return self.query_result(name, query, explain).batch

    def query_result(self, name: str, query="INCLUDE",
                     explain: Explainer | None = None) -> QueryResult:
        store = self._store(name)
        q = query if isinstance(query, Query) else Query.of(query)
        q = self._intercept(store.sft, q)
        if store.batch is None or len(store.batch) == 0:
            return QueryResult(FeatureBatch.empty(store.sft),
                               np.empty(0, dtype=np.int64),
                               FilterStrategy("none", 0), 0.0, 0.0)
        return QueryPlanner(store.sft, store).run(q, explain)

    def _intercept(self, sft: FeatureType, q: Query) -> Query:
        """The schema's interceptors' rewrite of ``q`` (QueryInterceptor
        SPI: age-off windows, guards that raise)."""
        return apply_interceptors(self._interceptors[sft.name], sft, q)

    # -- aggregation --------------------------------------------------------
    def stats(self, name: str, query="INCLUDE", spec: str = "Count()"):
        """Evaluate a Stat DSL over the features matching ``query`` (the
        reference's stats-count / stats-histogram surface, STATS_STRING
        hint): pushed down per shard on a mesh store where the filter and
        spec allow, else over the materialized hits (see
        :func:`~geomesa_tpu_torch.process.stats_process.stats_process`)."""
        from .process.stats_process import stats_process
        return stats_process(self, name, query, spec)

    def _hit_residency(self, store: _SchemaStore, positions: np.ndarray):
        """Per-hit shard ids, the grouping input of the mesh stats reducer:
        true residency from a built sharded index's placement segments,
        else the block split a fresh build would produce (an int).  The
        JAX package first keeps this process's slice of the hits; with one
        process every hit is local."""
        for nm in ("z3", "z2"):
            idx = store._indexes.get(nm)
            if idx is not None and getattr(idx, "_segments", None):
                return idx.shard_of_gids(positions)
        return self._mesh.size

    def density_tile(self, name: str, z: int, x: int, y: int, *,
                     tile: int = 256, query=None,
                     timeout_ms: float | None = None) -> np.ndarray:
        """One ``(tile, tile)`` float64 density grid for slippy-map tile
        ``(z, x, y)`` on the plate-carrée world grid.  With no ``query``, a
        lean schema serves the tile from its scale index's density path
        (:func:`~geomesa_tpu_torch.index.pyramid.density_tile`: a slice of
        the world sweep while ``tile·2^z`` stays at or below
        ``geomesa.density.pyramid.base``, a bbox scan beyond).  Otherwise
        the tile runs through :func:`density_process` with the tile
        envelope ANDed into the filter (CQL string).  The JAX store's
        admission token, spans and metrics are not ported; a deadline
        (``timeout_ms``) raises rather than being ignored."""
        if timeout_ms is not None:
            raise NotImplementedError(
                "density_tile deadlines (timeout_ms) are not ported")
        from .process.density import density_process
        z, x, y = int(z), int(x), int(y)
        n = 1 << z
        if not (0 <= z <= 30) or not (0 <= x < n and 0 <= y < n):
            raise ValueError(f"tile ({z}/{x}/{y}) out of range")
        store = self._store(name)
        if query is None and store.lean:
            return np.asarray(store.z3_index().density_tile(z, x, y, tile),
                              np.float64)
        env = tile_env(z, x, y)
        gf = self.get_schema(name).geom_field
        bbox = f"BBOX({gf}, {env[0]}, {env[1]}, {env[2]}, {env[3]})"
        q = bbox if query is None else f"({query}) AND {bbox}"
        return np.asarray(density_process(self, name, q, env, tile, tile),
                          np.float64)

    # -- lean maintenance ---------------------------------------------------
    def compact(self, name: str, budget_ms: float | None = None) -> dict:
        """Explicit LSM compaction of a lean schema's generational index
        (the maintenance analog of the reference's ``compact`` command):
        fold sealed same-tier sorted runs into O(log) merged runs so query
        and density fan-out stops growing with ingest history.
        ``budget_ms`` bounds the work; interrupted compaction resumes on
        the next call.  Returns ``{"z3": {"merged_groups", "generations",
        "tiers"}}`` — empty for default-profile schemas."""
        return self._store(name).compact_lean(budget_ms=budget_ms)

    def _pyramid_listener(self, name: str):
        """The generation-lifecycle hook parked on every schema store: on
        seal — when ``geomesa.density.pyramid.build`` is ``seal`` at fire
        time — run one build-behind pyramid pass.  Best-effort by
        contract: a failed build never fails the write that sealed the
        generation (queries stay exact through the sweep); each failure
        counts on the schema store, which keeps the last error."""
        # a weak reference: the hook lives on the store's own index, and a
        # strong one would make a cycle that keeps a dropped store's
        # device memory allocated until the cyclic collector runs
        ds_ref = weakref.ref(self)

        def on_event(kind: str, gen_ids: list) -> None:
            ds = ds_ref()
            if kind != "seal" or ds is None:
                return
            if str(DensityProperties.PYRAMID_BUILD.get() or "off") != "seal":
                return
            try:
                run_pyramid_build(ds, name)
            except Exception as e:  # noqa: BLE001 — build-behind is best-effort
                store = ds._store(name)
                store.pyramid_build_failures += 1
                store.pyramid_build_error = e
        return on_event

    def build_pyramids(self, name: str) -> int:
        """Build density pyramids for a lean schema's sealed z3
        generations: one whole-world multi-resolution grid stack per
        generation, cached under the compaction-invalidated partial-cache
        policy, so whole-world heatmaps and zoomed-out tiles stop
        rescanning immutable history.  Idempotent — generations that
        already have pyramids are skipped.  Returns the number built (0
        for default-profile schemas)."""
        return self._store(name).build_pyramids()

    # -- not ported ---------------------------------------------------------
    def query_windows(self, name: str, windows, **kw):
        raise NotImplementedError(
            "batched window queries (query_windows) are not ported")

    def query_fused(self, name: str, query="INCLUDE", **kw):
        raise NotImplementedError("the fused serving plane is not ported")

    def delete(self, name: str, query=None, ids=None) -> int:
        raise NotImplementedError("deletes and tombstones are not ported")
