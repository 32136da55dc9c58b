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
stats push down next to their keys.  Over a mesh the lean indexes are
their sharded variants (:mod:`~geomesa_tpu_torch.parallel.lean`,
:mod:`~geomesa_tpu_torch.parallel.attr_lean`), under a per-shard budget.
Sealed lean generations carry density pyramids (``build_pyramids``,
or built behind every seal with ``geomesa.density.pyramid.build=seal``);
lean stores of ``geomesa.planning.estimator.min.rows`` rows or more cost
their z3 plans from the index's cell-count sketches, and a lean scan
that observes far more candidates than costed replans once.  Schemas
may name query interceptors (``geomesa.query.interceptors``), an
age-off window (``geomesa.age.off``) and z-prefixed UUID feature ids
(``geomesa.fid.strategy=z3``).

Deletes remove rows on the default profile and mesh (every built index
is dropped with its coverage, as row positions move, and rebuilds on the
next query) and tombstone them on the lean profile (positions stay
stable; the indexes keep serving deleted rows as candidates that every
query masks out, and the lean push-downs fall back to the materializing
paths).  Row visibilities (``write(..., visibility=)``) and attribute
visibilities (``attribute_visibilities=``) are evaluated against the
caller's authorizations (``auth_provider``) on every query, filter, stat
and bound.  Schemas pinned to the v1 key layouts
(``geomesa.index.versions=z3:1,z2:1``) key and query with the legacy
curves (``curve/legacy.py``) until ``migrate_schema``.
With ``catalog_dir`` the store keeps a metadata catalog on disk in the
JAX package's formats (a catalog either package writes, the other opens):
``{name}.schema.json`` per schema with its index versions,
``{name}.stats.json`` sketches with the auto-id counter, ``flush``'s
``{name}.parquet`` and ``{name}.vis.json`` rows and labels on the default
profile and a mesh, and a lean schema's chunked ``{name}.lean/`` parquet
snapshot (tombstones and labels included); opening the catalog reloads
every schema, and the indexes rebuild lazily on the first query.
Fused serving, multi-controller meshes,
``explain_analyze`` and ``storage_report`` are not ported and raise
rather than degrade.
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import os
import re
import shutil
import time
import weakref

import numpy as np

from .config import DensityProperties, PlanningProperties

from .device import resolve_device
from .features.batch import FeatureBatch, build_columns
from .features.feature_type import FeatureType, parse_spec
from .features.lean import ChunkView, LeanBatch
from .geometry.types import Envelope
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
from .parallel.attr_lean import (
    ShardedLeanAttrIndex, ShardedLeanXZ2Index, ShardedLeanXZ3Index,
)
from .parallel.attribute import ShardedAttributeIndex
from .parallel.lean import ShardedLeanZ3Index
from .parallel.scan import ShardedZ3Index
from .parallel.xz import ShardedXZ2Index, ShardedXZ3Index
from .parallel.z2 import ShardedZ2Index
from .planning.estimator import CardinalityEstimator
from .planning.explain import Explainer, ExplainString
from .planning.interceptor import apply_interceptors, load_interceptors
from .planning.planner import Query, QueryPlanner, QueryResult
from .planning.strategy import FilterStrategy
from .security import parse_visibility, visibility_mask
from .stats.stat import (
    BBoxStat, CountStat, EnumerationStat, Histogram, MinMax, Stat, TopK,
    observe_shared, stat_from_json,
)
from .utils.feature_id import z3_feature_ids

__all__ = ["TpuDataStore", "CatalogVersionError", "CURRENT_INDEX_VERSIONS"]

#: on-disk catalog format version (the JAX package's): v2 added the
#: per-index layout versions (v1 catalogs read as all-current), v3 changed
#: the Frequency sketch's string hashing (pre-v3 frequency tables are
#: dropped on load and rebuild on the next stats_analyze)
CATALOG_VERSION = 3


class CatalogVersionError(RuntimeError):
    """Catalog written by a NEWER framework version (the client/server
    version-mismatch handshake, GeoMesaDataStore.scala:433-500: refuse to
    run rather than corrupt data written by a newer layout), or a lean
    snapshot whose parts disagree with its manifest."""


def _check_schema_name(name: str) -> None:
    """Schema names are letters, digits, underscore and dash (the
    reference's stores restrict table-backed names the same way)."""
    if not re.fullmatch(r"[A-Za-z0-9_-]+", name):
        raise ValueError(
            f"invalid schema name {name!r}: letters, digits, "
            "underscore and dash only")


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


#: current per-index key-layout versions (the reference's Z3IndexV7-style
#: version registry); v1 of z3/z2 is the legacy semi-normalized curve
#: (curve/legacy.py)
CURRENT_INDEX_VERSIONS = {"z3": Z3_INDEX_VERSION, "z2": Z2_INDEX_VERSION,
                          "xz2": 1, "xz3": 1, "attr": 1, "id": 1}


def _parse_index_versions(user_data: dict) -> dict:
    """Per-schema overrides from user data: ``geomesa.index.versions =
    "z3:1,z2:1"`` pins listed indexes to old layouts (data imported from
    a system that wrote legacy keys); ``current`` (or nothing) keeps
    every index at its current layout."""
    versions = dict(CURRENT_INDEX_VERSIONS)
    raw = (user_data or {}).get("geomesa.index.versions", "")
    if raw and raw != "current":
        for part in raw.split(","):
            name, _, v = part.strip().partition(":")
            if name not in versions:
                raise ValueError(f"unknown index {name!r} in "
                                 "geomesa.index.versions")
            versions[name] = int(v)
    return versions


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
        #: per-index key-layout versions (``geomesa.index.versions``;
        #: migrate_schema moves them to the current layouts)
        self.index_versions: dict = _parse_index_versions(sft.user_data)
        self.batch: FeatureBatch | LeanBatch | None = None
        #: deleted-row mask (lean profile: rows are never removed and ids
        #: never reused — the delete as a mask every query applies)
        self.tombstone: np.ndarray | None = None
        #: per-feature visibility labels (object array of strings)
        self.visibilities: np.ndarray | None = None
        #: attr name → per-feature labels guarding just that attribute
        #: (the reference's attribute-level visibility)
        self.attr_visibilities: dict[str, np.ndarray] = {}
        #: per-auth-set row masks and attribute-masked batches
        self._vis_masks: dict = {}
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
        #: monotonic stats-artifact generation (persisted in ``__meta__``;
        #: decides which stats file is newest before mtime does)
        self.stats_generation: int = 0
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
        LeanXZ3Index or LeanXZ2Index, their sharded variants over a
        mesh), created by the first write (before the batch grows) and
        maintained incrementally by every write."""
        kind = self.lean_kind
        if kind != "z3":
            return self._lean_xz_index(kind)
        idx = self._indexes.get("z3")
        if idx is None:
            settings = dict(
                period=self.sft.z3_interval,
                version=self.index_versions["z3"],
                generation_slots=self._lean_user_int(
                    "geomesa.lean.generation.slots", None),
                hbm_budget_bytes=self._lean_z3_budget(),
                compaction_factor=self._lean_user_int(
                    "geomesa.lean.compaction.factor",
                    self.LEAN_COMPACTION_FACTOR))
            if self.mesh is not None:
                idx = ShardedLeanZ3Index(mesh=self.mesh, **settings)
            else:
                idx = LeanZ3Index(device=self.device, **settings)
            idx.payload_provider = self._lean_payload
            # a rebuild (after migrate_schema) streams the column store
            # in 2^22-row steps; the seal hook registers only after it,
            # so seals during the stream never recurse into the builder
            n = len(self.batch)
            if n:
                x, y = self.batch.geom_xy()
                t = self.batch.column(self.sft.dtg_field)
                step = 1 << 22
                for lo in range(0, n, step):
                    idx.append(np.asarray(x[lo:lo + step], np.float64),
                               np.asarray(y[lo:lo + step], np.float64),
                               np.asarray(t[lo:lo + step], np.int64))
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
                self.LEAN_COMPACTION_FACTOR))
        if self.mesh is not None:
            xz2_cls, xz3_cls = ShardedLeanXZ2Index, ShardedLeanXZ3Index
            settings["mesh"] = self.mesh
        else:
            xz2_cls, xz3_cls = LeanXZ2Index, LeanXZ3Index
            settings["device"] = self.device
        n = len(self.batch)
        step = 1 << 22
        if kind == "xz2":
            idx = xz2_cls(g=self.sft.xz_precision, **settings)
            if n:
                bb = self.batch.geom_bbox()
                for lo in range(0, n, step):
                    idx.append_bboxes(bb[lo:lo + step], base_gid=lo)
        else:
            idx = xz3_cls(period=self.sft.z3_interval,
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
            # size (the JAX store's floor: 24 B a slot over a mesh, whose
            # gids are int64, 20 B on one device)
            if self.mesh is not None:
                cls = ShardedLeanAttrIndex
                floor = cls.GENERATION_SLOTS * 24 * 2
                where = {"mesh": self.mesh}
            else:
                cls = LeanAttrIndex
                floor = cls.GENERATION_SLOTS * 20 * 2
                where = {"device": self.device}
            budget = max(floor, int(self._lean_budget()
                                    * self.LEAN_ATTR_BUDGET_FRACTION
                                    // max(1, len(names))))
            idx = cls(
                attr, self.sft.attribute(attr).type,
                generation_slots=self._lean_user_int(
                    "geomesa.lean.generation.slots", None),
                hbm_budget_bytes=budget,
                compaction_factor=self._lean_user_int(
                    "geomesa.lean.compaction.factor",
                    self.LEAN_COMPACTION_FACTOR), **where)
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

    def _lean_write(self, chunk: ChunkView, visibility: str = "") -> None:
        """Streaming ingest: observe stats on the chunk, append its
        columns by reference, and push its keys into the live index —
        O(chunk) per write.  Visibility labels materialize only once a
        write carries one (an object per row is real memory at lean
        scale); the tombstone grows with every write once it exists."""
        n_new = len(chunk)
        prior = len(self.batch)
        if visibility or self.visibilities is not None:
            if self.visibilities is None:
                self.visibilities = np.full(prior, "", dtype=object)
            self.visibilities = np.concatenate(
                [self.visibilities, np.full(n_new, visibility, dtype=object)])
        self._vis_masks = {}
        # TopK and Enumeration of one attribute share one unique pass
        observe_shared(self._stats, chunk)
        # index BEFORE the batch grows (a new or rebuilt index streams
        # the batch's current rows)
        idx = self._lean_index()
        attr_idx = [(a, self._lean_attr_index(a))
                    for a in self._lean_attr_names()]
        self.batch.append_batch(chunk)
        if self.tombstone is not None:
            self.tombstone = np.concatenate(
                [self.tombstone, np.zeros(n_new, dtype=bool)])
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

    def _lean_observe_masked(self, proto: Stat, mask: np.ndarray | None):
        """Fold the (masked) rows into a fresh copy of ``proto`` in 2^22-row
        slices, never materializing the full row set (the chunked
        re-observe for restricted callers and post-delete stats)."""
        fresh = proto.fresh_copy()
        n = len(self.batch)
        step = 1 << 22
        for lo in range(0, n, step):
            hi = min(lo + step, n)
            view = self.batch.slice_view(lo, hi)
            if mask is not None:
                sub = mask[lo:hi]
                if not sub.all():
                    if not sub.any():
                        continue
                    view = view.take(np.flatnonzero(sub))
            fresh.observe(view)
        return fresh

    def _numeric_histograms(self, live: np.ndarray | None) -> None:
        """32-bin range histograms of the indexed numeric attributes over
        the live rows (the stats-analyze products the cost estimator
        reads; bounds come from the data, so they exist only after a
        recompute)."""
        for a in self.sft.attributes:
            if (a.indexed and a.type in ("int", "long", "float", "double")
                    and a.name in self.batch.columns):
                col = self.batch.column(a.name)
                if len(col) and col.dtype != object:
                    sel = col if live is None else col[live]
                    if len(sel):
                        lo, hi = float(sel.min()), float(sel.max())
                        if hi > lo:
                            self._stats[f"{a.name}_histogram"] = \
                                Histogram(a.name, 32, lo, hi)

    def _lean_recompute_stats(self) -> None:
        """Chunked recompute over the LIVE rows (deletes tombstone rows
        but sketches are not invertible — the re-observe contract of
        recompute_stats, sliced to bound host memory)."""
        self._stats = {}
        self._init_stats()
        if not len(self.batch):
            return
        live = None if self.tombstone is None else ~self.tombstone
        self._numeric_histograms(live)
        for key, s in list(self._stats.items()):
            self._stats[key] = self._lean_observe_masked(s, live)

    def recompute_stats(self) -> None:
        """Rebuild every sketch from the current rows (sketches are not
        invertible, so deletes re-observe); indexed numeric attributes
        additionally get range histograms."""
        if self.lean:
            self._lean_recompute_stats()
            return
        self._stats = {}
        self._init_stats()
        if self.batch is not None and len(self.batch):
            self._numeric_histograms(None)
            for s in self._stats.values():
                s.observe(self.batch)

    def has_tombstones(self) -> bool:
        """Whether a delete tombstoned any row (lean profile): the lean
        push-downs then fall back, as they cannot see row liveness."""
        return self.tombstone is not None and bool(self.tombstone.any())

    def drop_indexes(self) -> None:
        """Forget every built index with its coverage (the cached
        attribute z3-tier keys and the id index included): after a delete
        moved the row positions, or a layout migration, a kept index or
        its tail would hand back wrong rows.  Each rebuilds on its next
        use."""
        self._indexes.clear()
        self._index_coverage.clear()

    def masked_batch(self, auths):
        """Batch with attribute-guarded values nulled for these auths —
        used for FILTERING as well as results, so a restricted caller
        cannot probe guarded values via CQL predicates.  Cached per auth
        set (at most 16 masked batches); unguarded columns share the
        original arrays."""
        if not self.attr_visibilities or self.batch is None:
            return self.batch
        key = ("attrs", frozenset(auths))
        cache = self._vis_masks
        if key not in cache:
            masked_keys = [k for k in cache
                           if isinstance(k, tuple) and k[0] == "attrs"]
            if len(masked_keys) >= 16:
                cache.pop(masked_keys[0], None)
            cols = dict(self.batch.columns)
            changed = False
            for attr, labels in self.attr_visibilities.items():
                if attr not in cols:
                    continue
                mask = visibility_mask(labels, frozenset(auths))
                if mask.all():
                    continue
                col = cols[attr]
                col = col.astype(object) if col.dtype != object else col.copy()
                col[~mask] = None
                cols[attr] = col
                changed = True
            cache[key] = (FeatureBatch(self.batch.sft, cols, self.batch.ids,
                                       self.batch.geoms)
                          if changed else self.batch)
        return cache[key]

    def vis_mask(self, auths) -> np.ndarray | None:
        """Cached per-auth-set visibility mask over all features (at most
        64 auth sets); None when every label is visible."""
        if self.visibilities is None:
            return None
        key = frozenset(auths)
        cache = self._vis_masks
        if key not in cache:
            row_keys = [k for k in cache if isinstance(k, frozenset)]
            if len(row_keys) >= 64:
                cache.pop(row_keys[0], None)
            mask = visibility_mask(self.visibilities, key)
            cache[key] = None if mask.all() else mask
        return cache[key]

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

    def write(self, batch: FeatureBatch, visibility: str = "",
              attribute_visibilities: dict | None = None):
        vis = np.full(len(batch), visibility, dtype=object)
        prior = 0 if self.batch is None else len(self.batch)
        if self.batch is None:
            self.batch = batch
            self.visibilities = vis
        else:
            self.batch = self.batch.concat(batch)
            self.visibilities = np.concatenate([self.visibilities, vis])
        # per-attribute labels: other attributes and rows pad with ""
        # (visible)
        touched = set(self.attr_visibilities) | set(
            attribute_visibilities or ())
        for attr in touched:
            col = self.attr_visibilities.get(
                attr, np.full(prior, "", dtype=object))
            label = (attribute_visibilities or {}).get(attr, "")
            self.attr_visibilities[attr] = np.concatenate(
                [col, np.full(len(batch), label, dtype=object)])
        self._vis_masks = {}
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
        if name not in CURRENT_INDEX_VERSIONS:
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
                version=self.index_versions["z3"])
        return Z3PointIndex.build(
            x, y, dtg, period=self.sft.z3_interval,
            version=self.index_versions["z3"], device=self.device)

    def _build_z2(self):
        # the z2 index owns its x/y copies: the JAX store shares them with
        # z3 (immutable arrays there), but the port's appends write into
        # resident columns in place
        x, y = self.batch.geom_xy()
        if self.mesh is not None:
            return ShardedZ2Index.build(
                x, y, mesh=self.mesh, version=self.index_versions["z2"])
        return Z2PointIndex.build(
            x, y, version=self.index_versions["z2"], device=self.device)

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


class _MaskedStoreView:
    """Delegates to a _SchemaStore but substitutes the attribute-masked
    batch (attribute-level visibility for restricted callers)."""

    def __init__(self, store: _SchemaStore, batch: FeatureBatch):
        self._store = store
        self.batch = batch

    def __getattr__(self, name):
        return getattr(self._store, name)


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
        (``device`` still places the query path's heatmap grids).
        ``auth_provider``: an :class:`~geomesa_tpu_torch.security.
        AuthorizationsProvider`; queries, stats and bounds then see only
        the rows (and attribute values) its authorizations satisfy.
        ``catalog_dir``: a metadata catalog directory (created if
        missing); every schema in it is reloaded now, with its sketches,
        the auto-id counter and any flushed rows."""
        if multihost:
            raise NotImplementedError(
                "multi-controller (multihost) stores are not ported")
        self.device = resolve_device(device)
        self._mesh = mesh
        self._auth_provider = auth_provider
        self._schemas: dict[str, _SchemaStore] = {}
        #: per-schema query interceptors (``geomesa.query.interceptors``
        #: and ``geomesa.age.off`` user data), loaded at create_schema
        self._interceptors: dict[str, list] = {}
        self._catalog_dir = catalog_dir
        self._lock_depth = 0
        if catalog_dir:
            os.makedirs(catalog_dir, exist_ok=True)
            with self._catalog_lock():
                self._check_catalog_version()
                self._load_catalog()

    # -- catalog version handshake + mutation locking ---------------------
    def _check_catalog_version(self) -> None:
        path = os.path.join(self._catalog_dir, "catalog.version")
        if os.path.exists(path):
            with open(path) as f:
                found = int(f.read().strip() or 0)
            if found > CATALOG_VERSION:
                raise CatalogVersionError(
                    f"catalog {self._catalog_dir!r} has version {found}, "
                    f"newer than this framework's {CATALOG_VERSION}; "
                    "upgrade before opening it")
            self._catalog_found_version = found
        else:
            with open(path, "w") as f:
                f.write(str(CATALOG_VERSION))
            self._catalog_found_version = CATALOG_VERSION

    @contextlib.contextmanager
    def _catalog_lock(self):
        """File lock serializing catalog reads and mutations across
        processes sharing a catalog directory (the DistributedLocking
        role, index/utils/DistributedLocking.scala).  Reentrant within
        this store (a flock on a second descriptor of the same file would
        deadlock against ourselves)."""
        if not self._catalog_dir:
            yield
            return
        if self._lock_depth > 0:
            self._lock_depth += 1
            try:
                yield
            finally:
                self._lock_depth -= 1
            return
        with open(os.path.join(self._catalog_dir, ".lock"), "w") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            self._lock_depth = 1
            try:
                yield
            finally:
                self._lock_depth = 0
                fcntl.flock(f, fcntl.LOCK_UN)

    def _catalog_path(self, name: str, suffix: str) -> str:
        return os.path.join(self._catalog_dir, f"{name}{suffix}")

    # -- schema lifecycle (MetadataBackedDataStore.createSchema etc.) ----
    def _new_store(self, sft: FeatureType) -> _SchemaStore:
        store = _SchemaStore(sft, self.device, mesh=self._mesh)
        store.pyramid_trigger = self._pyramid_listener(store)
        self._schemas[sft.name] = store
        # interceptors resolve EAGERLY: a typoed class path fails
        # create_schema (or the catalog's open), not the first query
        self._interceptors[sft.name] = load_interceptors(sft)
        return store

    def create_schema(self, sft_or_name, spec: str | None = None) -> FeatureType:
        if isinstance(sft_or_name, FeatureType):
            sft = sft_or_name
        else:
            sft = parse_spec(sft_or_name, spec)
        _check_schema_name(sft.name)
        if sft.name in self._schemas:
            raise ValueError(f"schema {sft.name!r} already exists")
        with self._catalog_lock():
            # re-check ON DISK under the lock: another process sharing
            # the catalog may have created it since we loaded
            if self._catalog_dir and os.path.exists(
                    self._catalog_path(sft.name, ".schema.json")):
                raise ValueError(
                    f"schema {sft.name!r} already exists in the catalog "
                    "(created by another process)")
            self._new_store(sft)
            self._persist_schema(sft)
        return sft

    def get_schema(self, name: str) -> FeatureType:
        return self._store(name).sft

    def update_schema(self, name: str, sft: FeatureType) -> None:
        """Replace schema metadata (the reference's updateSchema,
        MetadataBackedDataStore.scala:205 — renames and user-data
        updates).  Attributes cannot be added or removed;
        ``geomesa.index.versions=current`` migrates the layouts first.
        A rename is validated (name grammar, collisions) before any state
        changes, and the interceptors re-resolve, so a bad one fails
        here rather than at the next query."""
        store = self._store(name)
        if ([a.name for a in sft.attributes]
                != [a.name for a in store.sft.attributes]):
            raise ValueError("updateSchema cannot add/remove attributes")
        if sft.user_data.get("geomesa.index.versions") == "current":
            self.migrate_schema(name)
        with self._catalog_lock():
            # validate BEFORE mutating: a raise below would leave the
            # schema renamed in memory while the catalog says otherwise
            if sft.name != name:
                _check_schema_name(sft.name)
                # on-disk re-check under the lock, like create_schema:
                # the rename replaces target-name artifacts and must never
                # hit a live schema another process created
                if sft.name in self._schemas or (
                        self._catalog_dir and os.path.exists(
                            self._catalog_path(sft.name, ".schema.json"))):
                    raise ValueError(
                        f"cannot rename schema {name!r} to {sft.name!r}: "
                        "that schema already exists")
            store.sft = sft
            self._interceptors.pop(name, None)
            if sft.name != name:
                self._schemas[sft.name] = self._schemas.pop(name)
                if self._catalog_dir:
                    self._move_artifacts(name, sft.name)
            self._interceptors[sft.name] = load_interceptors(sft)
            self._persist_schema(sft)

    def _move_artifacts(self, name: str, target: str) -> None:
        """Move a renamed schema's catalog files: stale old-name files
        would resurrect a phantom schema on the next open, and stale
        target-name leftovers (a crashed remove of an older schema) must
        not fold into the renamed one."""
        for suffix in (".schema.json", ".parquet", ".stats.json",
                       ".vis.json"):
            old = self._catalog_path(name, suffix)
            new = self._catalog_path(target, suffix)
            if os.path.exists(old):
                os.replace(old, new)
            elif os.path.exists(new):
                # with no source to replace it, its recency in load_stats
                # would shadow the renamed schema's artifacts
                os.remove(new)
        for p in self._proc_stats_files(target):
            with contextlib.suppress(FileNotFoundError):
                os.remove(p)
        for d in self._lean_snapshot_dirs(target):
            shutil.rmtree(d, ignore_errors=True)
        for p in self._proc_stats_files(name):
            with contextlib.suppress(FileNotFoundError):
                # deleted externally between listdir and the rename
                os.replace(p, self._catalog_path(
                    target, os.path.basename(p)[len(name):]))
        for d in self._lean_snapshot_dirs(name):
            new = self._catalog_path(
                target, os.path.basename(d)[len(name):])
            # a stale non-empty target dir would fail rename(2)
            shutil.rmtree(new, ignore_errors=True)
            os.replace(d, new)

    def remove_schema(self, name: str) -> None:
        """Drop a schema with its rows, indexes and stats (no error when
        it does not exist), and its catalog files: schema, rows, labels,
        stats (per-process files too) and lean snapshots."""
        with self._catalog_lock():
            self._schemas.pop(name, None)
            self._interceptors.pop(name, None)
            if not self._catalog_dir:
                return
            for suffix in (".schema.json", ".parquet", ".stats.json",
                           ".vis.json"):
                with contextlib.suppress(FileNotFoundError):
                    os.remove(self._catalog_path(name, suffix))
            for p in self._proc_stats_files(name):
                # a concurrent prune between listdir and remove must not
                # stop the removal half-way
                with contextlib.suppress(FileNotFoundError):
                    os.remove(p)
            # a stale snapshot would resurrect the removed rows into a
            # later schema of the same name
            for d in self._lean_snapshot_dirs(name):
                shutil.rmtree(d, ignore_errors=True)

    def _lean_snapshot_dirs(self, name: str) -> list[str]:
        """Every lean snapshot dir of ``name`` in the catalog
        (``{name}.lean`` and the per-process ``{name}.lean.pN`` a JAX
        multi-controller store writes)."""
        if not self._catalog_dir or not os.path.isdir(self._catalog_dir):
            return []
        out = []
        for f in os.listdir(self._catalog_dir):
            if f == f"{name}.lean" or f.startswith(f"{name}.lean."):
                p = os.path.join(self._catalog_dir, f)
                if os.path.isdir(p):
                    out.append(p)
        return out

    def migrate_schema(self, name: str) -> dict:
        """Upgrade a schema's index layouts to the CURRENT versions (the
        reference's index-format migration): indexes rebuild from the
        column store with current key math on next use (a lean scale
        index at once, streamed), and the catalog records the new
        versions.  Returns the versions before."""
        store = self._store(name)
        old = dict(store.index_versions)
        with self._catalog_lock():
            store.index_versions = dict(CURRENT_INDEX_VERSIONS)
            # stale layouts must not serve another query
            store.drop_indexes()
            if "geomesa.index.versions" in store.sft.user_data:
                ud = dict(store.sft.user_data)
                del ud["geomesa.index.versions"]
                store.sft = FeatureType(store.sft.name, store.sft.attributes,
                                        store.sft.default_geom, ud)
            self._persist_schema(store.sft)
        return old

    @property
    def type_names(self) -> list[str]:
        return sorted(self._schemas)

    def _store(self, name: str) -> _SchemaStore:
        if name not in self._schemas:
            raise KeyError(f"no such schema: {name!r}")
        return self._schemas[name]

    # -- ingest -----------------------------------------------------------
    def write(self, name: str, data, ids=None, visibility: str = "",
              attribute_visibilities: dict | None = None) -> int:
        """Append features: a FeatureBatch or a dict of columns.

        ``visibility`` is a visibility expression (e.g. ``"admin&ops"``)
        on every feature of this write; queries made with an auth
        provider see only features whose expression their authorizations
        satisfy.  ``attribute_visibilities`` maps attribute names to
        expressions guarding just that attribute: unauthorized callers
        see the row with the guarded values nulled (default profile and
        mesh only)."""
        if visibility:
            parse_visibility(visibility)  # validate eagerly
        store = self._store(name)
        sft = store.sft
        # auto-profile: only point schemas WITH a dtg, and only without a
        # mesh, flip to the lean profile, BEFORE any default-profile state
        # exists; the rest stay on the default profile at any size
        if (not store.lean and store.batch is None and self._mesh is None
                and sft.is_points and sft.geom_field
                and sft.dtg_field and not isinstance(data, FeatureBatch)
                and ids is None and not attribute_visibilities):
            first = next(iter(data.values()), ())
            n_first = (len(first[0]) if isinstance(first, tuple)
                       else len(first))
            if n_first >= self.LEAN_AUTO_ROWS:
                store._init_lean()
                sft.user_data["geomesa.index.profile"] = "lean"
                self._persist_schema(sft)
        if store.lean:
            if attribute_visibilities:
                raise ValueError(
                    "attribute-level visibility is not supported on "
                    "lean-profile schemas (row visibility is)")
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
            store._lean_write(chunk, visibility)
            store.next_fid = len(store.batch)
            return len(chunk)
        for attr, expr in (attribute_visibilities or {}).items():
            spec = sft.attribute(attr)   # KeyError on typos
            if spec.is_geometry or attr == sft.dtg_field:
                raise ValueError(
                    "cannot set attribute visibility on geometry or the "
                    f"dtg field ({attr!r}): indexes scan them unmasked")
            if expr:
                parse_visibility(expr)
        batch = (data if isinstance(data, FeatureBatch)
                 else FeatureBatch.from_dict(store.sft, data, ids=ids))
        if not batch.ids_explicit:
            # feature ids must be unique across writes, re-based on a
            # shallow copy so the caller's batch is never mutated: with
            # ``geomesa.fid.strategy=z3`` user data, z-prefixed UUIDs
            # (Z3FeatureIdGenerator locality), else a monotonic counter,
            # never reused (not even after deletes)
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
        store.write(batch, visibility=visibility,
                    attribute_visibilities=attribute_visibilities)
        store.next_fid = next_fid
        return len(batch)

    def delete(self, name: str, ids) -> int:
        """Remove features by id (the reference's modifying writer /
        removeFeatures path); returns how many rows this call removed.
        On the lean profile the rows are TOMBSTONED: positions stay
        stable, the live indexes keep them and every query masks them
        out, and a second delete of the same ids counts 0.  Elsewhere
        the rows leave the column store, every built index is dropped
        with its coverage (row positions moved) and rebuilds on its next
        use.  Stats are recomputed from the surviving rows — sketches are
        not invertible.  Auto ids are never reused."""
        store = self._store(name)
        req = np.atleast_1d(np.asarray(ids, dtype=object))
        if store.lean:
            # duplicate ids cannot double-count: the lookup is unique'd
            rows = LeanIdIndex(len(store.batch)).query(req)
            newly = rows
            if len(rows):
                if store.tombstone is None:
                    store.tombstone = np.zeros(len(store.batch), dtype=bool)
                newly = rows[~store.tombstone[rows]]
                store.tombstone[rows] = True
            if len(newly):
                store._vis_masks = {}
                store._lean_recompute_stats()
            return int(len(newly))
        if store.batch is None or not len(store.batch):
            return 0
        drop = {str(i) for i in req}
        ids_all = store.batch.ids
        keep = np.fromiter((str(i) not in drop for i in ids_all), bool,
                           len(ids_all))
        removed = int(len(keep) - np.count_nonzero(keep))
        if removed:
            if store._id_set is not None:
                store._id_set.difference_update(
                    str(i) for i in ids_all[~keep])
            store.batch = store.batch.take(np.flatnonzero(keep))
            if store.visibilities is not None:
                store.visibilities = store.visibilities[keep]
            for attr in list(store.attr_visibilities):
                store.attr_visibilities[attr] = \
                    store.attr_visibilities[attr][keep]
            store._vis_masks = {}
            store.drop_indexes()
            store.recompute_stats()
        return removed

    # -- query ------------------------------------------------------------
    def query(self, name: str, query="INCLUDE",
              explain: Explainer | None = None) -> FeatureBatch:
        return self.query_result(name, query, explain).batch

    def query_result(self, name: str, query="INCLUDE",
                     explain: Explainer | None = None) -> QueryResult:
        return self._query_result_ex(name, query, explain)[0]

    def _query_result_ex(self, name: str, query="INCLUDE",
                         explain: Explainer | None = None,
                         materialize: bool = True):
        """The shared query executor: returns ``(result, eval_store)``,
        the store (possibly attribute-masked for this caller) whose batch
        the residual filter ran over, so a caller that skips the result
        batch (``materialize=False``) gathers its columns from it.

        Rows this caller may not see — a failed visibility, a lean
        tombstone — are masked out before sort and ``max_features``, so
        the limit fills from visible rows; attribute-guarded values are
        nulled for the filter as well as the result."""
        store = self._store(name)
        q = query if isinstance(query, Query) else Query.of(query)
        q = self._intercept(store.sft, q)
        if store.batch is None or len(store.batch) == 0:
            result = QueryResult(FeatureBatch.empty(store.sft),
                                 np.empty(0, dtype=np.int64),
                                 FilterStrategy("none", 0), 0.0, 0.0)
            return result, store
        allowed = None
        eval_store = store
        if self._auth_provider is not None:
            auths = self._auth_provider.get_authorizations()
            allowed = store.vis_mask(auths)
            masked = store.masked_batch(auths)
            if masked is not store.batch:
                eval_store = _MaskedStoreView(store, masked)
        if store.tombstone is not None:
            live = ~store.tombstone
            allowed = live if allowed is None else (allowed & live)
        result = QueryPlanner(store.sft, eval_store).run(
            q, explain, allowed=allowed, materialize=materialize)
        return result, eval_store

    def _hit_columns(self, name: str, query):
        """The hits of ``query`` as a column batch (ids are not minted on
        the lean profile: an id-free view of the hit rows).  The
        materializing stat and heatmap paths read their columns from
        it."""
        result, eval_store = self._query_result_ex(name, query,
                                                   materialize=False)
        batch = eval_store.batch
        pos = result.positions
        if batch is None or not len(pos):
            return result, FeatureBatch.empty(self._store(name).sft)
        if isinstance(batch, LeanBatch):
            return result, batch.take_view(pos)
        return result, batch.take(pos)

    def explain(self, name: str, query="INCLUDE") -> str:
        """The query's plan as text (the reference's explainQuery): the
        planner's trace of strategy options, costs and the chosen
        index."""
        ex = ExplainString()
        self.query_result(name, query, ex)
        return str(ex)

    def explain_analyze(self, name: str, query="INCLUDE"):
        raise NotImplementedError(
            "explain_analyze (traced actuals) is not ported: it needs the "
            "observability layer (ROADMAP A8)")

    def storage_report(self) -> dict:
        raise NotImplementedError(
            "storage_report is not ported: it needs the observability "
            "layer's resource accounting (ROADMAP A8)")

    def _intercept(self, sft: FeatureType, q: Query) -> Query:
        """The schema's interceptors' rewrite of ``q`` (QueryInterceptor
        SPI: age-off windows, guards that raise); loaded here when an
        update's failed resolution left none."""
        if sft.name not in self._interceptors:
            self._interceptors[sft.name] = load_interceptors(sft)
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

    def stats_analyze(self, name: str) -> int:
        """Recompute a schema's sketches from its stored rows and persist
        them to the catalog, if any (the reference's stats-analyze /
        StatsRunner); returns the observed feature count."""
        store = self._store(name)
        store.recompute_stats()
        self.persist_stats(name)
        return 0 if store.batch is None else len(store.batch)

    def _restricted_mask(self, store: _SchemaStore) -> np.ndarray | None:
        """Visibility mask when this caller cannot see every row (stats
        are observed over ALL writes, so restricted callers must not read
        them directly — that would leak counts, values and extents of
        hidden rows)."""
        if self._auth_provider is None or store.batch is None:
            return None
        return store.vis_mask(self._auth_provider.get_authorizations())

    def _effective_mask(self, store: _SchemaStore,
                        only_if_restricted: bool = False):
        """Restricted-visibility mask combined with lean tombstones — the
        rows this caller can see.  With ``only_if_restricted`` the
        tombstones ride along only when a visibility restriction exists:
        the store's sketches already exclude deleted rows (delete-time
        recompute), so an unrestricted caller never pays the re-observe
        path for tombstones alone."""
        mask = self._restricted_mask(store)
        tomb = store.tombstone
        if tomb is None or (only_if_restricted and mask is None):
            return mask
        live = ~tomb
        return live if mask is None else (mask & live)

    def get_count(self, name: str, query=None) -> int:
        """Features of the schema this caller can see (or matching
        ``query``): the hit count of a query, the effective mask's sum,
        or the count sketch."""
        store = self._store(name)
        if query is not None:
            return len(self.query_result(name, query).positions)
        mask = self._effective_mask(store)
        if mask is not None:
            return int(mask.sum())
        return store.stats_map()["count"].count

    def get_bounds(self, name: str):
        """The spatial extent (an ``Envelope``) of the rows this caller
        can see, or None.  On the lean profile it is the running extent,
        or under a mask the x/y columns' extent over the visible rows
        (never the per-feature bbox materialization)."""
        store = self._store(name)
        if store.batch is None or len(store.batch) == 0:
            return None
        mask = self._effective_mask(store)
        if store.lean:
            if mask is None:
                env = store.batch.envelope
                pairs = (np.array([env]) if env is not None
                         else np.empty((0, 4)))
            else:
                x, y = store.batch.geom_xy()
                pairs = (np.array([[x[mask].min(), y[mask].min(),
                                    x[mask].max(), y[mask].max()]])
                         if mask.any() else np.empty((0, 4)))
            bb = pairs
        else:
            bb = store.batch.geom_bbox()
            if mask is not None:
                bb = bb[mask] if mask.any() else bb[:0]
        if not len(bb):
            return None
        return Envelope(float(bb[:, 0].min()), float(bb[:, 1].min()),
                        float(bb[:, 2].max()), float(bb[:, 3].max()))

    def _attr_guarded(self, store: _SchemaStore, attr: str) -> bool:
        """True when this caller cannot see every value of ``attr``."""
        if (self._auth_provider is None
                or attr not in store.attr_visibilities):
            return False
        return not visibility_mask(
            store.attr_visibilities[attr],
            self._auth_provider.get_authorizations()).all()

    def get_attribute_bounds(self, name: str, attr: str):
        """``(min, max)`` of an attribute over the rows this caller can
        see, or None (also when a value of it is guarded from the
        caller)."""
        store = self._store(name)
        if self._attr_guarded(store, attr):
            return None
        mask = self._effective_mask(store, only_if_restricted=True)
        if mask is not None:
            col = store.batch.column(attr)[mask]
            if not len(col):
                return None
            return col.min(), col.max()
        mm = store.stats_map().get(f"{attr}_minmax")
        return None if mm is None or mm.is_empty else mm.bounds

    def stat(self, name: str, key: str) -> Stat | None:
        """One of the schema's sketches (``count``, ``dtg_minmax``,
        ``<attr>_minmax``, ...).  For a restricted caller it is observed
        again over the visible rows, so hidden values cannot leak; None
        when its attribute is guarded from the caller."""
        store = self._store(name)
        stats = store.stats_map()
        attr = getattr(stats.get(key), "attr", None)
        if attr and self._attr_guarded(store, attr):
            return None
        mask = self._effective_mask(store, only_if_restricted=True)
        s = stats.get(key)
        if mask is None or s is None:
            return s
        if store.lean:
            return store._lean_observe_masked(s, mask)
        fresh = s.fresh_copy()
        fresh.observe(store.batch.take(np.flatnonzero(mask)))
        return fresh

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
        XZ schema, whose index has no density path, on a lean store with
        tombstones, and under an auth provider: the exact tile over the
        rows the caller sees.  The JAX store's
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
        if (query is None and self._auth_provider is None and store.lean
                and not store.has_tombstones() and store.batch is not None
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

    def _pyramid_listener(self, store: _SchemaStore):
        """The generation-lifecycle hook parked on every schema store: on
        seal — when ``geomesa.density.pyramid.build`` is ``seal`` at fire
        time — run one build-behind pyramid pass over the schema under
        its name at that time (a rename keeps the hook working).
        Best-effort by contract: a failed build never fails the write
        that sealed the generation (queries stay exact through the
        sweep); each failure counts on the schema store, which keeps the
        last error."""
        # weak references: the hook lives on the store's own index, and a
        # strong one would make a cycle that keeps a dropped store's
        # device memory allocated until the cyclic collector runs
        ds_ref = weakref.ref(self)
        store_ref = weakref.ref(store)

        def on_event(kind: str, gen_ids: list) -> None:
            ds, st = ds_ref(), store_ref()
            if kind != "seal" or ds is None or st is None:
                return
            if str(DensityProperties.PYRAMID_BUILD.get() or "off") != "seal":
                return
            try:
                run_pyramid_build(ds, st.sft.name)
            except Exception as e:  # noqa: BLE001 — build-behind is best-effort
                st.pyramid_build_failures += 1
                st.pyramid_build_error = e
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

    # -- metadata catalog persistence -------------------------------------
    def _persist_schema(self, sft: FeatureType) -> None:
        if not self._catalog_dir:
            return
        store = self._schemas.get(sft.name)
        versions = (store.index_versions if store is not None
                    else dict(CURRENT_INDEX_VERSIONS))
        with open(self._catalog_path(sft.name, ".schema.json"), "w") as f:
            json.dump({"name": sft.name, "spec": sft.spec_string(),
                       "index_versions": versions,
                       "updated": time.time()}, f)

    def _proc_stats_files(self, name: str) -> list[str]:
        """Per-process stats files (``{name}.pN.stats.json``, written by
        a JAX multi-controller store) in the catalog — the one definition
        of that naming, which rename, remove and the merge share."""
        if not self._catalog_dir or not os.path.isdir(self._catalog_dir):
            return []
        pat = re.compile(re.escape(name) + r"\.p\d+\.stats\.json")
        return sorted(os.path.join(self._catalog_dir, f)
                      for f in os.listdir(self._catalog_dir)
                      if pat.fullmatch(f))

    def persist_stats(self, name: str) -> None:
        """Write the schema's sketches and ``__meta__`` (the auto-id
        counter and a stats generation) to ``{name}.stats.json``: to a tmp
        file first, then swapped in, so a crash never leaves the counter
        missing (ids would be reused); then the per-process files it
        supersedes are pruned, except those whose ``.lean.pN`` row
        snapshot still exists (their sketches were never merged)."""
        if not self._catalog_dir:
            return
        store = self._store(name)
        with self._catalog_lock():
            path = self._catalog_path(name, ".stats.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                store.stats_generation += 1
                f.write(json.dumps({"__meta__": {
                                        "next_fid": store.next_fid,
                                        "generation": store.stats_generation},
                                    **{k: st.to_json()
                                       for k, st in store._stats.items()}}))
            os.replace(tmp, path)
            for p in self._proc_stats_files(name):
                tag = os.path.basename(p).rsplit(
                    ".stats.json", 1)[0].rsplit(".p", 1)[1]
                if os.path.isdir(self._catalog_path(name, f".lean.p{tag}")):
                    continue
                with contextlib.suppress(FileNotFoundError):
                    os.remove(p)   # a concurrent persist pruned it

    def load_stats(self, name: str) -> None:
        """Reload persisted sketches and the auto-id counter.  The newest
        artifact family wins, by the ``__meta__`` generation, then mtime
        (a stale shared file must not shadow newer per-process files or
        the reverse, or the counter would regress and reuse deleted ids);
        per-process files merge; ``next_fid`` takes the max over every
        artifact, whichever wins."""
        if not self._catalog_dir:
            return
        store = self._store(name)
        with self._catalog_lock():
            self._load_stats_locked(name, store)

    def _load_stats_locked(self, name: str, store: _SchemaStore) -> None:
        shared = self._catalog_path(name, ".stats.json")
        procs = self._proc_stats_files(name)

        def mtime(p):
            try:
                return os.path.getmtime(p)
            except OSError:
                return -1.0

        # every artifact parses once: the arbitration and the merge share
        # these dicts
        parsed: dict[str, dict] = {}
        for p in {shared, *procs}:
            try:
                with open(p) as f:
                    parsed[p] = json.load(f)
            except (OSError, ValueError):
                pass   # absent, or pruned by a concurrent persist

        def recency(p):
            """(generation, mtime): the ``__meta__`` counter decides when
            present; mtime only orders artifacts written without it."""
            gen = ((parsed.get(p) or {}).get("__meta__")
                   or {}).get("generation", -1)
            return (int(gen), mtime(p))

        sources: list = []
        live_procs = [p for p in procs if p in parsed]
        if live_procs and max(map(recency, live_procs)) > recency(shared):
            sources = [(p, True) for p in live_procs]
        elif shared in parsed:
            sources = [(shared, True)]
        chosen = {p for p, _ in sources}
        sources += [(p, False) for p in parsed if p not in chosen]
        if not sources:
            return
        drop_freq = self._catalog_found_version < 3
        merged: dict = {}
        poisoned: set = set()
        for path, with_sketches in sources:
            raw = dict(parsed[path])
            meta = raw.pop("__meta__", None)   # absent in older catalogs
            if meta is not None:
                store.next_fid = max(store.next_fid,
                                     int(meta.get("next_fid", 0)))
                store.stats_generation = max(
                    store.stats_generation, int(meta.get("generation", 0)))
            if not with_sketches:
                continue
            if drop_freq:
                # pre-v3 Frequency tables hashed strings the old way:
                # read with today's hash they answer from the wrong
                # buckets (rebuilt by the next stats_analyze)
                raw = {k: v for k, v in raw.items()
                       if v.get("kind") != "frequency"}
            for k, v in raw.items():
                if k in poisoned:
                    continue
                st = stat_from_json(v)
                if k not in merged:
                    merged[k] = st
                    continue
                try:
                    merged[k] = merged[k].merge(st)
                except ValueError:
                    # per-process sketches can be incompatible (histograms
                    # binned over each process's own bounds): a dropped
                    # sketch beats an unopenable catalog
                    merged.pop(k, None)
                    poisoned.add(k)
        if merged:
            # re-seed every default sketch the merge dropped or an older
            # artifact never carried: code reads _stats["count"] directly
            for k, st in store._stats.items():
                merged.setdefault(k, st)
            store._stats = merged

    def flush(self, name: str) -> None:
        """Persist the schema's rows under the catalog: ``{name}.parquet``
        (the JAX package's export layout) with ``{name}.vis.json``, the
        row and attribute labels dictionary-encoded, on the default
        profile and a mesh; a chunked snapshot on the lean profile
        (:meth:`_flush_lean`); then the stats.  No-op without a catalog
        or rows."""
        if not self._catalog_dir:
            return
        store = self._store(name)
        if store.batch is None:
            return
        if store.lean:
            self._flush_lean(name, store)
            return
        from .io.export import to_parquet
        to_parquet(store.batch, self._catalog_path(name, ".parquet"))
        if store.visibilities is not None or store.attr_visibilities:
            # dictionary-encoded: labels are low-cardinality
            payload: dict = {}
            if store.visibilities is not None:
                uniq, codes = np.unique(store.visibilities.astype(str),
                                        return_inverse=True)
                payload["labels"] = uniq.tolist()
                payload["codes"] = codes.tolist()
            if store.attr_visibilities:
                attrs = {}
                for attr, col in store.attr_visibilities.items():
                    u, c = np.unique(col.astype(str), return_inverse=True)
                    attrs[attr] = {"labels": u.tolist(),
                                   "codes": c.tolist()}
                payload["attributes"] = attrs
            with open(self._catalog_path(name, ".vis.json"), "w") as f:
                # json.dumps, not json.dump: the same text through the C
                # encoder (json.dump encodes in Python, a row code at a
                # time)
                f.write(json.dumps(payload))
        self.persist_stats(name)

    #: rows per lean snapshot part — bounds the host working set of a
    #: flush or reload to one part's columns, never the dataset
    LEAN_PART_ROWS = 1 << 22

    def _lean_dir(self, name: str) -> str:
        """Snapshot directory of a lean schema (one process: no per-process
        ``.pN`` suffix, which the JAX package's multi-controller stores
        add)."""
        return self._catalog_path(name, ".lean")

    def _flush_lean(self, name: str, store: _SchemaStore) -> None:
        """Chunked parquet snapshot of a lean schema: ``LEAN_PART_ROWS``
        row parts (no ids: lean ids are implicit row numbers) plus a
        manifest, so peak host memory is one part.  Per-row state rides
        in the parts as reserved columns: ``__tombstone__``, ``__vis__``
        (codes into the manifest's sorted labels) and, for non-point
        schemas, ``__wkb__`` (the per-feature bbox column is derived and
        left out).

        Crash-safe: parts carry a per-flush stamp, the manifest is swapped
        in (tmp + ``os.replace``) LAST, and only then are the prior
        flush's parts deleted — a crash at any point leaves the previous
        manifest with its parts intact."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        from .geometry.wkb import wkb_encode
        d = self._lean_dir(name)
        os.makedirs(d, exist_ok=True)
        mpath = os.path.join(d, "manifest.json")
        stamp = 0
        if os.path.exists(mpath):
            with open(mpath) as f:
                stamp = int(json.load(f).get("stamp", 0)) + 1
        n = len(store.batch)
        step = self.LEAN_PART_ROWS
        vis_labels = None
        if store.visibilities is not None:
            # the label set per slice: a str copy of the whole column
            # would break the one-part memory bound
            slice_labels = [
                np.unique(store.visibilities[lo:min(lo + step, n)]
                          .astype(str)) for lo in range(0, n, step)]
            vis_labels = (np.unique(np.concatenate(slice_labels))
                          if slice_labels else np.empty(0, dtype=str))
        bbox_col = (f"{store.sft.geom_field}_bbox"
                    if store.batch.geoms is not None else None)
        parts = []
        for i, lo in enumerate(range(0, n, step)):
            hi = min(lo + step, n)
            view = store.batch.slice_view(lo, hi)
            cols = {k: pa.array(np.asarray(v))
                    for k, v in view.columns.items() if k != bbox_col}
            if bbox_col is not None:
                gpart = store.batch.geoms.take(np.arange(lo, hi))
                cols["__wkb__"] = pa.array(
                    [wkb_encode(gpart.geometry(j)) for j in range(hi - lo)],
                    type=pa.binary())
            if store.tombstone is not None:
                cols["__tombstone__"] = pa.array(store.tombstone[lo:hi])
            if vis_labels is not None:
                cols["__vis__"] = pa.array(np.searchsorted(
                    vis_labels,
                    store.visibilities[lo:hi].astype(str)).astype(np.int32))
            fname = f"part-{stamp:06d}-{i:05d}.parquet"
            pq.write_table(pa.table(cols), os.path.join(d, fname))
            parts.append(fname)
        manifest: dict = {
            "n": n, "parts": parts, "stamp": stamp,
            "envelope": (list(store.batch.envelope)
                         if store.batch.envelope else None),
            "id_prefix": "",
            "has_tombstones": store.tombstone is not None,
        }
        if vis_labels is not None:
            manifest["vis_labels"] = vis_labels.tolist()
        tmp = mpath + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, mpath)        # the commit point
        live = set(parts)
        for f in os.listdir(d):       # the prior flush's parts, orphaned
            if f.startswith("part-") and f not in live:
                os.remove(os.path.join(d, f))
        self.persist_stats(name)

    def _load_lean(self, name: str) -> None:
        """Restore a lean snapshot into the schema's fresh store: append
        each part's columns by reference, restore the envelope, tombstones
        and labels, and leave the indexes to the lazy streaming build of
        ``_lean_index``, ``_lean_xz_index`` and ``_lean_attr_index`` (the
        store has none yet; the first query or write streams the rows
        through the live append path)."""
        import pyarrow.parquet as pq
        store = self._schemas[name]
        d = self._lean_dir(name)
        mpath = os.path.join(d, "manifest.json")
        if not os.path.exists(mpath):
            return
        with open(mpath) as f:
            manifest = json.load(f)
        tomb_parts: list = []
        vis_parts: list = []
        vis_labels = (np.asarray(manifest["vis_labels"], dtype=object)
                      if manifest.get("vis_labels") is not None else None)
        for fname in manifest["parts"]:
            table = pq.read_table(os.path.join(d, fname))
            cols = {c: table.column(c).to_numpy(zero_copy_only=False)
                    for c in table.column_names}
            if manifest.get("has_tombstones"):
                tomb_parts.append(cols.pop("__tombstone__").astype(bool))
            if vis_labels is not None:
                vis_parts.append(
                    vis_labels[cols.pop("__vis__").astype(np.int64)])
            geoms = None
            if "__wkb__" in cols:
                from .geometry.packed import pack_geometries
                from .geometry.wkb import wkb_decode
                geoms = pack_geometries(
                    [wkb_decode(b) for b in cols.pop("__wkb__")])
                # the derived per-feature bbox column (later writes carry
                # it, and every chunk's column set must agree)
                cols[f"{store.sft.geom_field}_bbox"] = geoms.bbox
            if table.num_rows:
                store.batch.append_batch(
                    ChunkView(store.sft, cols, table.num_rows, geoms=geoms))
        if len(store.batch) != manifest["n"]:
            raise CatalogVersionError(
                f"lean snapshot {d} is inconsistent: manifest says "
                f"{manifest['n']} rows, parts hold {len(store.batch)}")
        if manifest.get("envelope"):
            store.batch.envelope = tuple(manifest["envelope"])
        if tomb_parts:
            store.tombstone = np.concatenate(tomb_parts)
        if vis_parts:
            store.visibilities = np.concatenate(vis_parts)

    def _load_data(self, name: str) -> None:
        store = self._schemas[name]
        if store.lean:
            # sketches and the id counter from the stats file; rows from
            # the chunked snapshot when one was flushed
            self.load_stats(name)
            self._load_lean(name)
            return
        path = self._catalog_path(name, ".parquet")
        if os.path.exists(path):
            from .io.export import from_parquet
            store.batch = from_parquet(path, store.sft)
            store.next_fid = _max_numeric_id(store.batch.ids) + 1
            vis_path = self._catalog_path(name, ".vis.json")
            if os.path.exists(vis_path):
                with open(vis_path) as f:
                    enc = json.load(f)
                if "labels" in enc:
                    labels = np.asarray(enc["labels"], dtype=object)
                    store.visibilities = labels[np.asarray(enc["codes"], int)]
                else:
                    store.visibilities = np.full(len(store.batch), "",
                                                 dtype=object)
                for attr, e in enc.get("attributes", {}).items():
                    lbl = np.asarray(e["labels"], dtype=object)
                    store.attr_visibilities[attr] = lbl[
                        np.asarray(e["codes"], int)]
            else:
                store.visibilities = np.full(len(store.batch), "",
                                             dtype=object)
        # persisted sketches and the id counter load whether or not rows
        # were flushed (ids are never reused)
        self.load_stats(name)
        # observe the rows when no stats were persisted
        if (store.batch is not None and len(store.batch)
                and store._stats["count"].count == 0):
            for st in store._stats.values():
                st.observe(store.batch)

    def _load_catalog(self) -> None:
        for fn in os.listdir(self._catalog_dir):
            if not fn.endswith(".schema.json"):
                continue
            try:
                with open(os.path.join(self._catalog_dir, fn)) as f:
                    meta = json.load(f)
            except FileNotFoundError:
                continue   # removed by another process mid-listing
            sft = parse_spec(meta["name"], meta["spec"])
            store = self._new_store(sft)
            # recorded layout versions win over the spec's; v1 catalogs
            # (before versioning) were written with today's layouts
            if "index_versions" in meta:
                store.index_versions = {
                    **CURRENT_INDEX_VERSIONS,
                    **{k: int(v) for k, v in meta["index_versions"].items()}}
            self._load_data(sft.name)

    # -- not ported ---------------------------------------------------------
    def query_windows(self, name: str, windows, **kw):
        raise NotImplementedError(
            "batched window queries (query_windows) are not ported")

    def query_fused(self, name: str, query="INCLUDE", **kw):
        raise NotImplementedError("the fused serving plane is not ported")
