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
the default profile, through the ``z3``, ``z2``, ``id`` and attribute
indexes (one per indexed attribute, tiered by z3 keys on point schemas
with a dtg, by date with only a dtg); polygon and line schemas through
the ``xz3`` (with a dtg) and ``xz2`` indexes (host numpy; kept across
writes with the appended rows as their tail, like the attribute
indexes); full scans and empty plans; with
``mesh=`` (one process driving a :func:`~geomesa_tpu_torch.parallel.
device_mesh`) the indexes are their sharded variants and ``stats`` and
density push down per shard.  Attribute indexes are KEPT across writes:
the rows appended since a build ride as unconditional candidates until
they outgrow ``TAIL_COMPACT_FRACTION`` of it, and the next query
rebuilds.

The LEAN (scale) profile — a schema created with
``geomesa.index.profile=lean``, or a point schema with a dtg whose first
write (without a mesh) holds ``LEAN_AUTO_ROWS`` rows or more — stores its
columns chunked (:class:`~geomesa_tpu_torch.features.lean.LeanBatch`,
implicit feature ids) and indexes them in the tiered generational
:class:`~geomesa_tpu_torch.index.z3_lean.LeanZ3Index` (point schemas
with a dtg) or :class:`~geomesa_tpu_torch.index.xz2_lean.LeanXZ3Index` /
:class:`~geomesa_tpu_torch.index.xz2_lean.LeanXZ2Index` (polygon and
line schemas with and without a dtg: ``lean_kind``), one
:class:`~geomesa_tpu_torch.index.attr_lean.LeanAttrIndex` per indexed
numeric, date or string attribute (which together take
``LEAN_ATTR_BUDGET_FRACTION`` of the lean device budget), plus
implicit-id lookups; heatmaps, tiles, ``Count()`` and the attribute
stats push down next to their keys.
Sealed lean generations carry density pyramids (``build_pyramids``,
or built behind every seal with ``geomesa.density.pyramid.build=seal``);
lean stores of ``geomesa.planning.estimator.min.rows`` rows or more cost
their z3 plans from the index's cell-count sketches, and a lean scan
that observes far more candidates than costed replans once.  Schemas
may name query interceptors (``geomesa.query.interceptors``), an
age-off window (``geomesa.age.off``) and z-prefixed UUID feature ids
(``geomesa.fid.strategy=z3``).
Lean stores over a mesh, fused serving, deletes, persistence,
multi-controller meshes, visibilities and authorizations are not ported
and raise rather than degrade.
"""

from __future__ import annotations

import re
import time
import weakref

import numpy as np

from .config import DensityProperties, PlanningProperties

from .device import resolve_device
from .features.batch import FeatureBatch, build_columns
from .features.feature_type import FeatureType, parse_spec
from .features.lean import ChunkView, LeanBatch
from .index.attr_lean import NUMERIC_TYPES, LeanAttrIndex
from .index.attribute import AttributeIndex
from .index.id import IdIndex, LeanIdIndex
from .index.pyramid import tile_env
from .index.xz2 import XZ2Index
from .index.xz2_lean import LeanXZ2Index, LeanXZ3Index
from .index.xz3 import XZ3Index
from .index.z2 import Z2_INDEX_VERSION, Z2PointIndex
from .index.z3 import Z3_INDEX_VERSION, Z3PointIndex
from .index.z3_lean import LeanZ3Index
from .jobs import run_pyramid_build
from .parallel.attribute import ShardedAttributeIndex
from .parallel.scan import ShardedZ3Index
from .parallel.xz import ShardedXZ2Index, ShardedXZ3Index
from .parallel.z2 import ShardedZ2Index
from .planning.estimator import CardinalityEstimator
from .planning.explain import Explainer
from .planning.interceptor import apply_interceptors, load_interceptors
from .planning.planner import Query, QueryPlanner, QueryResult
from .planning.strategy import FilterStrategy
from .stats.stat import (
    BBoxStat, CountStat, EnumerationStat, MinMax, Stat, TopK, observe_shared,
)
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


#: current key-layout version of each ported index (the JAX package's
#: table: the xz layouts have one version)
_CURRENT_INDEX_VERSIONS = {"z3": Z3_INDEX_VERSION, "z2": Z2_INDEX_VERSION,
                           "xz3": 1, "xz2": 1}


class _SchemaStore:
    """Per-schema storage: the column batch + the lazily-built z3/z2/id
    and attribute indexes (sharded over ``mesh`` when one is given) +
    stats; on the lean profile a chunked batch + the tiered lean z3 and
    attribute indexes."""

    #: share of the lean device budget given to the attribute indexes
    #: (split evenly among them); the z3 scale index keeps the rest
    LEAN_ATTR_BUDGET_FRACTION = 0.25

    #: default opportunistic LSM compaction factor for the lean index:
    #: merge when ≥ F sealed same-tier same-size-class runs accumulate
    #: (``geomesa.lean.compaction.factor`` user data overrides; 0
    #: disables the opportunistic trigger — explicit compact() still
    #: works)
    LEAN_COMPACTION_FACTOR = 8

    #: tail fraction that triggers a rebuild of a kept attribute index
    TAIL_COMPACT_FRACTION = 8  # tail > coverage/8 (12.5%)

    #: which generational scale index a lean schema rides ("z3" for
    #: points with a dtg, "xz3" / "xz2" for non-point geometries with and
    #: without a dtg); set by _init_lean
    lean_kind = "z3"

    def __init__(self, sft: FeatureType, device, mesh=None):
        self.sft = sft
        self.device = device
        self.mesh = mesh
        self.batch: FeatureBatch | LeanBatch | None = None
        self._indexes: dict = {}
        #: rows each kept (attribute) index covers — the rows appended
        #: since ride as its tail (index_tail)
        self._index_coverage: dict[str, int] = {}
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
    def query_indices(self) -> set | None:
        """Indices the planner may choose for this schema (None = every
        index): the lean profile serves its scale index (``lean_kind``),
        id (implicit-id lookups) and, for its lexicode-indexable
        attributes, the generational attribute index."""
        if not self.lean:
            return None
        out = {self.lean_kind, "id"}
        if self._lean_attr_names():
            out.add("attr")
        return out

    def _lean_attr_names(self) -> list[str]:
        """Indexed attributes the lean attribute index serves (the
        lexicode covers numerics, dates and strings — the reference's
        indexable-type set, AttributeIndexKey.scala:38-52)."""
        sft = self.sft
        return [a.name for a in sft.attributes
                if a.indexed and not a.is_geometry
                and a.name != sft.dtg_field
                and a.type in NUMERIC_TYPES | {"string"}]

    # -- lean profile ------------------------------------------------------
    def _init_lean(self) -> None:
        sft = self.sft
        if self.mesh is not None:
            raise NotImplementedError(
                "lean-profile schemas over a device mesh are not ported "
                "(ROADMAP A7)")
        if sft.is_points and sft.geom_field and sft.dtg_field:
            self.lean_kind = "z3"
        elif sft.geom_field and not sft.is_points:
            # non-point schemas ride the generational XZ tier: XZ3
            # (bin, code) when the schema has time, XZ2 otherwise
            self.lean_kind = "xz3" if sft.dtg_field else "xz2"
        else:
            raise ValueError(
                "geomesa.index.profile=lean requires a point geometry "
                "plus a dtg attribute (z3 scale index) or a non-point "
                "geometry (xz2 scale index)")
        self.lean = True
        self.batch = LeanBatch(sft)

    def _lean_payload(self):
        """(x, y, t) for the lean index's exact re-check — the store's own
        finalized columns (ONE host copy, shared by reference)."""
        x, y = self.batch.geom_xy()
        t = np.asarray(self.batch.column(self.sft.dtg_field), np.int64)
        return x, y, t

    def _lean_index(self):
        """The live lean scale index (``lean_kind``: LeanZ3Index,
        LeanXZ3Index or LeanXZ2Index), created by the first write (before
        the batch grows) and maintained incrementally by every write."""
        kind = self.lean_kind
        if kind != "z3":
            return self._lean_xz_index(kind)
        idx = self._indexes.get("z3")
        if idx is None:
            idx = LeanZ3Index(
                period=self.sft.z3_interval,
                version=_index_version(self.sft, "z3"),
                generation_slots=self._lean_user_int(
                    "geomesa.lean.generation.slots", None),
                hbm_budget_bytes=self._lean_z3_budget(),
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

    def _lean_xz_index(self, kind: str):
        """The live lean XZ index, under the same budget as the lean z3
        index (less the attribute carve-out); a late build streams the
        column store's envelopes in 2^22-row steps."""
        idx = self._indexes.get(kind)
        if idx is not None:
            return idx
        settings = dict(
            generation_slots=self._lean_user_int(
                "geomesa.lean.generation.slots", None),
            hbm_budget_bytes=self._lean_z3_budget(),
            compaction_factor=self._lean_user_int(
                "geomesa.lean.compaction.factor",
                self.LEAN_COMPACTION_FACTOR),
            device=self.device)
        n = len(self.batch)
        step = 1 << 22
        if kind == "xz2":
            idx = LeanXZ2Index(g=self.sft.xz_precision, **settings)
            if n:
                bb = self.batch.geom_bbox()
                for lo in range(0, n, step):
                    idx.append_bboxes(bb[lo:lo + step], base_gid=lo)
        else:
            idx = LeanXZ3Index(period=self.sft.z3_interval,
                               g=self.sft.xz_precision, **settings)
            if n:
                bb = self.batch.geom_bbox()
                t = self.batch.column(self.sft.dtg_field)
                for lo in range(0, n, step):
                    idx.append_bboxes(bb[lo:lo + step],
                                      np.asarray(t[lo:lo + step], np.int64),
                                      base_gid=lo)
        self._indexes[kind] = idx
        self._index_coverage[kind] = n
        self.build_counts[kind] = self.build_counts.get(kind, 0) + 1
        return idx

    def _lean_budget(self) -> int:
        """The whole lean device budget (``geomesa.lean.hbm.budget`` user
        data, bytes; default the z3 index's class default)."""
        return self._lean_user_int("geomesa.lean.hbm.budget",
                                   LeanZ3Index.HBM_BUDGET_BYTES)

    def _lean_z3_budget(self) -> int:
        """The z3 index's share: the whole lean budget less the attribute
        carve-out when the schema has lean attribute indexes."""
        if not self._lean_attr_names():
            return self._lean_budget()
        return int(self._lean_budget()
                   * (1.0 - self.LEAN_ATTR_BUDGET_FRACTION))

    def _lean_attr_index(self, attr: str) -> LeanAttrIndex:
        """The live LeanAttrIndex of one indexed attribute — maintained
        incrementally by writes; built here by streaming the column store
        in 2^22-row steps when it does not exist yet."""
        names = self._lean_attr_names()
        if attr not in names:
            raise ValueError(
                f"attribute {attr!r} is not lean-indexable on "
                f"{self.sft.name!r} (indexed numerics/dates/strings only; "
                f"have: {names})")
        key = f"attr:{attr}"
        idx = self._indexes.get(key)
        if idx is None:
            # each attribute index gets an even share of the carve-out,
            # and never less than two generations of the CLASS default
            # size (the JAX store's floor)
            budget = max(LeanAttrIndex.GENERATION_SLOTS * 20 * 2,
                         int(self._lean_budget()
                             * self.LEAN_ATTR_BUDGET_FRACTION
                             // max(1, len(names))))
            idx = LeanAttrIndex(
                attr, self.sft.attribute(attr).type,
                generation_slots=self._lean_user_int(
                    "geomesa.lean.generation.slots", None),
                hbm_budget_bytes=budget,
                compaction_factor=self._lean_user_int(
                    "geomesa.lean.compaction.factor",
                    self.LEAN_COMPACTION_FACTOR),
                device=self.device)
            n = len(self.batch)
            step = 1 << 22
            if n:
                col = self.batch.column(attr)
                dtg = (self.batch.column(self.sft.dtg_field)
                       if self.sft.dtg_field else np.zeros(n, np.int64))
                for lo in range(0, n, step):
                    idx.append(col[lo:lo + step],
                               np.asarray(dtg[lo:lo + step], np.int64),
                               base_gid=lo)
            self._indexes[key] = idx
            self._index_coverage[key] = n
            self.build_counts[key] = self.build_counts.get(key, 0) + 1
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
        # TopK and Enumeration of one attribute share one unique pass
        observe_shared(self._stats, chunk)
        prior = len(self.batch)
        # index BEFORE the batch grows (it is created empty; a late
        # attribute index streams the batch's current rows)
        idx = self._lean_index()
        attr_idx = [(a, self._lean_attr_index(a))
                    for a in self._lean_attr_names()]
        self.batch.append_batch(chunk)
        if self.lean_kind == "z3":
            x, y = chunk.geom_xy(self.sft.geom_field)
            dtg = np.asarray(chunk.column(self.sft.dtg_field), np.int64)
            idx.append(np.asarray(x, np.float64), np.asarray(y, np.float64),
                       dtg)
        else:
            dtg = (np.asarray(chunk.column(self.sft.dtg_field), np.int64)
                   if self.sft.dtg_field else np.zeros(len(chunk), np.int64))
            if self.lean_kind == "xz3":
                idx.append_bboxes(chunk.geoms.bbox, dtg, base_gid=prior)
            else:
                idx.append_bboxes(chunk.geoms.bbox, base_gid=prior)
            self._index_coverage[self.lean_kind] = len(self.batch)
        for a, ai in attr_idx:
            ai.append(chunk.column(a), dtg, base_gid=prior)
            self._index_coverage[f"attr:{a}"] = len(self.batch)

    def compact_lean(self, budget_ms: float | None = None) -> dict:
        """Explicit LSM maintenance over every live lean index (the z3
        scale index, then the attribute indexes) — the role the reference
        delegates to Accumulo/HBase major compaction.  ``budget_ms``
        carries across the indexes; each still makes ≥ 1 group of
        progress when one is eligible.  Empty for default-profile schemas
        and lean ones not yet written."""
        out: dict = {}
        if not self.lean:
            return out
        t0 = time.perf_counter()

        def remaining():
            if budget_ms is None:
                return None
            return max(0.0, budget_ms - (time.perf_counter() - t0) * 1e3)

        for key in [self.lean_kind] + [f"attr:{a}"
                                       for a in self._lean_attr_names()]:
            idx = self._indexes.get(key)
            if idx is not None:
                out[key] = idx.compact(budget_ms=remaining())
        return out

    def build_pyramids(self) -> int:
        """Build density pyramids over the lean index's sealed
        generations; the number built (0 for default-profile schemas and
        for the lean XZ indexes, which have no pyramids)."""
        if not self.lean or self.batch is None or self.lean_kind != "z3":
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
        # api/IndexAdapter.scala:95-106): z3 and z2 APPEND the new rows
        # into their resident sorted columns; attribute indexes are KEPT
        # and serve the appended rows as their tail (index_tail).  The
        # cached attribute z3-tier keys cover only the earlier rows: a
        # fresh attribute build recomputes them
        self._indexes.pop("attr-z3-keys", None)
        z3 = self._indexes.get("z3")
        if z3 is not None:
            x, y = batch.geom_xy(self.sft.geom_field)
            z3.append(x, y, batch.column(self.sft.dtg_field))
        z2 = self._indexes.get("z2")
        if z2 is not None:
            z2.append(*batch.geom_xy(self.sft.geom_field))

    def _maybe_compact(self, key: str) -> None:
        """Drop a kept index whose appended tail outgrew the lazy-scan
        budget — the next accessor call rebuilds over all rows (the
        compaction role of the reference's periodic major compaction)."""
        cov = self._index_coverage.get(key)
        if cov is None or key not in self._indexes or self.batch is None:
            return
        tail = len(self.batch) - cov
        if tail > max(4096, cov // self.TAIL_COMPACT_FRACTION):
            del self._indexes[key]
            del self._index_coverage[key]
            if key.startswith("attr:"):
                self._indexes.pop("attr-z3-keys", None)

    def index_tail(self, key: str) -> np.ndarray | None:
        """Rows appended after a kept index's build — queries union them
        into its candidate set (they are not in the index's structure;
        the residual filter keeps results exact)."""
        cov = self._index_coverage.get(key)
        if cov is None or self.batch is None:
            return None
        n = len(self.batch)
        return np.arange(cov, n, dtype=np.int64) if n > cov else None

    def _z3_tier_keys(self):
        """Host (bins, z) Z3 keys shared by every z3-tiered attribute
        index of this schema, computed by the port's curve layer on the
        host once per rebuild (cached in the index map, so writes
        invalidate it)."""
        if "attr-z3-keys" not in self._indexes:
            import torch

            from .curve.binnedtime import to_binned_time
            from .curve.sfc import z3_sfc
            dtg = np.asarray(self.batch.column(self.sft.dtg_field), np.int64)
            bins, offs = to_binned_time(dtg, self.sft.z3_interval)
            x, y = self.batch.geom_xy(self.sft.geom_field)
            z = z3_sfc(self.sft.z3_interval).index(
                torch.from_numpy(np.asarray(x, np.float64)),
                torch.from_numpy(np.asarray(y, np.float64)),
                torch.from_numpy(np.asarray(offs, np.float64))).numpy()
            self._indexes["attr-z3-keys"] = (bins, z)
        return self._indexes["attr-z3-keys"]

    def attribute_index(self, attr: str):
        """The attribute index of one indexed attribute: on the lean
        profile the generational lexicoded index; otherwise a kept host
        index (sharded on a mesh) whose secondary tier mirrors the
        reference — z3 keys when the schema has a point geometry and a
        dtg, date keys when only a dtg (AttributeIndexKeySpace
        secondary defaults)."""
        if self.lean:
            return self._lean_attr_index(attr)
        enabled = self.sft.enabled_indices
        if enabled is not None and "attr" not in enabled:
            raise ValueError(
                f"index 'attr' is disabled on schema {self.sft.name!r} "
                "(geomesa.indices.enabled)")
        key = f"attr:{attr}"
        self._maybe_compact(key)
        if key not in self._indexes:
            self._index_coverage[key] = len(self.batch)
            self.build_counts[key] = self.build_counts.get(key, 0) + 1
            sft = self.sft
            col = self.batch.column(attr)
            z3_tier = sft.dtg_field and sft.is_points and sft.geom_field
            secondary = (np.asarray(self.batch.column(sft.dtg_field),
                                    np.int64)
                         if sft.dtg_field and not z3_tier else None)
            if self.mesh is not None:
                if z3_tier:
                    bins, z = self._z3_tier_keys()
                    idx = ShardedAttributeIndex.build(
                        attr, col, mesh=self.mesh, sec_bins=bins, sec_z=z)
                else:
                    idx = ShardedAttributeIndex.build(
                        attr, col, secondary=secondary, mesh=self.mesh)
            elif z3_tier:
                bins, z = self._z3_tier_keys()
                idx = AttributeIndex.build_z3(attr, col, bins, z)
            else:
                idx = AttributeIndex.build(attr, col, secondary=secondary)
            self._indexes[key] = idx
        return self._indexes[key]

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
        attribute, z2 on point schemas, xz3 on schemas with a geometry
        and a dtg, xz2 on schemas with a geometry, id on every schema,
        ``attr`` on schemas with an indexed attribute (built per attribute
        through :meth:`attribute_index`); on the lean profile the lean
        scale index (``lean_kind``) and implicit-id lookups only.  The xz
        indexes are KEPT across writes, serving the appended rows as
        their tail (index_tail), and rebuild once the tail outgrows
        ``TAIL_COMPACT_FRACTION`` of them."""
        if self.lean:
            if name == self.lean_kind:
                return self._lean_index()
            if name == "id":
                return LeanIdIndex(len(self.batch))
            raise ValueError(
                f"index {name!r} is not available on lean-profile "
                f"schema {self.sft.name!r} ({self.lean_kind}/id only)")
        if name == "id":
            if "id" not in self._indexes:
                self._indexes["id"] = IdIndex.build(self.batch.ids)
                self.build_counts["id"] = self.build_counts.get("id", 0) + 1
            return self._indexes["id"]
        if name not in _CURRENT_INDEX_VERSIONS and name != "attr":
            raise NotImplementedError(f"index {name!r} is not ported")
        sft = self.sft
        enabled = sft.enabled_indices
        if enabled is not None and name not in enabled:
            raise ValueError(
                f"index {name!r} is disabled on schema {sft.name!r} "
                "(geomesa.indices.enabled)")
        if name == "attr":
            if not any(a.indexed for a in sft.attributes):
                raise ValueError(f"schema {sft.name!r} does not support "
                                 "the 'attr' index")
            raise ValueError("the attribute index is built per attribute — "
                             "use _SchemaStore.attribute_index(name)")
        if name in ("xz3", "xz2"):
            if not (sft.geom_field and (name == "xz2" or sft.dtg_field)):
                raise ValueError(f"schema {sft.name!r} does not support the "
                                 f"{name!r} index")
            self._maybe_compact(name)
            if name not in self._indexes:
                build = self._build_xz3 if name == "xz3" else self._build_xz2
                self._indexes[name] = build()
                self._index_coverage[name] = len(self.batch)
                self.build_counts[name] = self.build_counts.get(name, 0) + 1
            return self._indexes[name]
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

    def xz3_index(self):
        return self.index("xz3")

    def xz2_index(self):
        return self.index("xz2")

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

    def _build_xz3(self):
        # the sequence codes' resolution is the schema's
        # geomesa.xz.precision (the reference's default 12)
        dtg = self.batch.column(self.sft.dtg_field)
        if self.mesh is not None:
            return ShardedXZ3Index.build(
                self.batch.geoms, dtg, period=self.sft.z3_interval,
                g=self.sft.xz_precision, mesh=self.mesh)
        return XZ3Index.build(self.batch.geoms, dtg,
                              period=self.sft.z3_interval,
                              g=self.sft.xz_precision)

    def _build_xz2(self):
        if self.mesh is not None:
            return ShardedXZ2Index.build(
                self.batch.geoms, g=self.sft.xz_precision, mesh=self.mesh)
        return XZ2Index.build(self.batch.geoms, g=self.sft.xz_precision)


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
    z2 indexes and host xz3/xz2 indexes, sharded over a device mesh when
    one is given, and the tiered lean z3, xz and attribute indexes for
    lean-profile schemas."""

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
                chunk = ChunkView(sft, dict(data.columns), len(data),
                                  geoms=data.geoms)
            else:
                cols, geoms = build_columns(sft, data,
                                            keep_fixed_strings=True)
                n_chunk = (len(next(iter(cols.values()))) if cols
                           else len(geoms) if geoms is not None else 0)
                chunk = ChunkView(sft, cols, n_chunk, geoms=geoms)
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
        envelope ANDed into the filter (CQL string), as it does on a lean
        XZ schema, whose index has no density path.  The JAX store's
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
        if (query is None and store.lean and store.batch is not None
                and store.lean_kind == "z3"):
            return np.asarray(store._lean_index().density_tile(z, x, y, tile),
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
        the next call.  Returns ``{"z3": {...}, "attr:<name>": {...}}``,
        each ``{"merged_groups", "generations", "tiers"}`` — empty for
        default-profile schemas."""
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
