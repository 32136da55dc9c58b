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
the default (non-lean) profile, through the ``z3`` and ``z2`` indexes,
full scans and empty plans.  The lean profile (first writes of
``LEAN_AUTO_ROWS`` rows or more to a point schema with a dtg attribute),
device meshes, visibilities and authorizations are not ported and raise
rather than degrade.
"""

from __future__ import annotations

import re

import numpy as np

from .device import resolve_device
from .features.batch import FeatureBatch
from .features.feature_type import FeatureType, parse_spec
from .index.pyramid import tile_env
from .index.z2 import Z2_INDEX_VERSION, Z2PointIndex
from .index.z3 import Z3_INDEX_VERSION, Z3PointIndex
from .planning.explain import Explainer
from .planning.planner import Query, QueryPlanner, QueryResult
from .planning.strategy import FilterStrategy
from .stats.stat import BBoxStat, CountStat, EnumerationStat, MinMax, Stat, TopK

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
    """Per-schema storage: the column batch + the lazily-built z3/z2
    indexes + stats."""

    def __init__(self, sft: FeatureType, device):
        self.sft = sft
        self.device = device
        self.batch: FeatureBatch | None = None
        self._indexes: dict = {}
        #: per-index-type build counter (the no-full-rebuild tests)
        self.build_counts: dict[str, int] = {}
        self._stats: dict[str, Stat] = {}
        #: monotonic auto feature-id counter — ids are never reused
        self.next_fid: int = 0
        #: lazily-built id set for O(m) explicit-id collision checks
        self._id_set: set | None = None
        self._init_stats()

    @property
    def query_indices(self) -> set:
        """Indices the planner may choose: the port serves z3 and z2 (plus
        the full and empty plans every schema has); the JAX store offers
        every registered index on the default profile."""
        return {"z3", "z2"}

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
        attribute, z2 on point schemas."""
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

    def z3_index(self) -> Z3PointIndex:
        return self.index("z3")

    def z2_index(self) -> Z2PointIndex:
        return self.index("z2")

    def _build_z3(self) -> Z3PointIndex:
        x, y = self.batch.geom_xy()
        dtg = self.batch.column(self.sft.dtg_field)
        return Z3PointIndex.build(
            x, y, dtg, period=self.sft.z3_interval,
            version=_index_version(self.sft, "z3"), device=self.device)

    def _build_z2(self) -> Z2PointIndex:
        # the z2 index owns its x/y copies: the JAX store shares them with
        # z3 (immutable arrays there), but the port's appends write into
        # resident columns in place
        x, y = self.batch.geom_xy()
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
    z2 indexes."""

    #: first-write row count at which the JAX store switches a qualifying
    #: schema to the lean profile, which the port does not have
    LEAN_AUTO_ROWS = 32_000_000

    def __init__(self, device=None, *, mesh=None, auth_provider=None):
        """``device``: where the indexes live — the CUDA card unless the
        caller names the CPU; with no card and no explicit ``"cpu"`` this
        raises."""
        if mesh is not None:
            raise NotImplementedError("device meshes are not ported")
        if auth_provider is not None:
            raise NotImplementedError(
                "authorizations and visibilities are not ported")
        self.device = resolve_device(device)
        self._schemas: dict[str, _SchemaStore] = {}

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
        if (sft.user_data or {}).get("geomesa.index.profile") == "lean":
            raise NotImplementedError("the lean index profile is not ported")
        self._schemas[sft.name] = _SchemaStore(sft, self.device)
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
        # the JAX store flips only point schemas WITH a dtg to the lean
        # profile; one without a dtg stays on the default profile (z2) at
        # any size
        if (store.batch is None and sft.is_points and sft.geom_field
                and sft.dtg_field and not isinstance(data, FeatureBatch)
                and ids is None):
            first = next(iter(data.values()), ())
            n_first = (len(first[0]) if isinstance(first, tuple)
                       else len(first))
            if n_first >= self.LEAN_AUTO_ROWS:
                # the JAX store flips to the lean profile here
                raise NotImplementedError(
                    f"a first write of {n_first} rows (>= "
                    f"{self.LEAN_AUTO_ROWS}) needs the lean index profile, "
                    "which is not ported")
        batch = (data if isinstance(data, FeatureBatch)
                 else FeatureBatch.from_dict(store.sft, data, ids=ids))
        if not batch.ids_explicit:
            # feature ids must be unique across writes: a monotonic
            # counter, never reused; re-based on a shallow copy so the
            # caller's batch is never mutated
            base = store.next_fid
            new_ids = np.array([f"{base + i}" for i in range(len(batch))],
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
        if store.batch is None or len(store.batch) == 0:
            return QueryResult(FeatureBatch.empty(store.sft),
                               np.empty(0, dtype=np.int64),
                               FilterStrategy("none", 0), 0.0, 0.0)
        return QueryPlanner(store.sft, store).run(q, explain)

    # -- aggregation --------------------------------------------------------
    def density_tile(self, name: str, z: int, x: int, y: int, *,
                     tile: int = 256, query=None,
                     timeout_ms: float | None = None) -> np.ndarray:
        """One ``(tile, tile)`` float64 density grid for slippy-map tile
        ``(z, x, y)`` on the plate-carrée world grid: the tile runs
        through :func:`density_process` with the tile envelope ANDed into
        the filter (CQL string).  The JAX store's lean pyramid branch,
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
        env = tile_env(z, x, y)
        gf = self.get_schema(name).geom_field
        bbox = f"BBOX({gf}, {env[0]}, {env[1]}, {env[2]}, {env[3]})"
        q = bbox if query is None else f"({query}) AND {bbox}"
        return np.asarray(density_process(self, name, q, env, tile, tile),
                          np.float64)
