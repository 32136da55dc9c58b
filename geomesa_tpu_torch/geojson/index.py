"""Schemaless GeoJSON document store with spatial/temporal indexing.

The analog of the reference's GeoJsonIndex / GeoJsonGtIndex
(geomesa-geojson/geomesa-geojson-api/.../GeoJsonIndex.scala:13-93,
GeoJsonGtIndex.scala): stores raw GeoJSON Feature documents without a
schema, indexes their geometry (point fast path or packed extents — the
``points`` flag), optionally a date json-path, and answers mongo-style
queries (query.py).  Unlike the reference — which stores the document in
a kryo-serialized 'json' attribute and rewrites json-path queries into
GeoTools filters — documents here live as parsed dicts on the host while
geometry/date live as device-friendly columns; spatial predicates are
evaluated vectorized over the columnar batch, property predicates walk
the docs.  The port's copy of the JAX package's ``geojson/index.py``:
documents and their point columns stay on the host, as there.
"""

from __future__ import annotations

import json

import numpy as np

from ..features.batch import FeatureBatch
from ..features.feature_type import parse_spec
from .query import GeoJsonQuery, json_path_get, parse_geojson_query

__all__ = ["GeoJsonIndex"]


def _parse_dtg(v) -> int:
    """json date value → epoch millis (ints pass through)."""
    if v is None:
        return 0
    if isinstance(v, (int, float)):
        return int(v)
    from datetime import datetime, timezone
    s = str(v).replace("Z", "+00:00")
    dt = datetime.fromisoformat(s)
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return int(dt.timestamp() * 1000)


class _GjStore:
    def __init__(self, name: str, id_path: str | None, dtg_path: str | None,
                 points: bool):
        self.name = name
        self.id_path = id_path
        self.dtg_path = dtg_path
        self.points = points
        geom_type = "Point" if points else "Geometry"
        spec = (f"dtg:Date,*geom:{geom_type}" if dtg_path
                else f"*geom:{geom_type}")
        self.sft = parse_spec(name, spec)
        self.docs: list[dict] = []
        self.ids: list[str] = []
        self._pos: dict[str, int] = {}
        self._auto_id = 0                         # monotonic, survives deletes
        self._batch: FeatureBatch | None = None   # lazily rebuilt

    def invalidate(self):
        self._batch = None

    def batch(self) -> FeatureBatch:
        if self._batch is None:
            from .query import geojson_to_geometry
            geoms = [geojson_to_geometry(d["geometry"]) for d in self.docs]
            data: dict = {"geom": geoms}
            if self.dtg_path:
                data["dtg"] = np.asarray(
                    [_parse_dtg(json_path_get(d, self.dtg_path))
                     for d in self.docs], dtype=np.int64)
            self._batch = FeatureBatch.from_dict(
                self.sft, data, ids=np.asarray(self.ids, dtype=object))
        return self._batch


class GeoJsonIndex:
    """Named schemaless GeoJSON indices (GeoJsonIndex.scala API)."""

    def __init__(self):
        self._stores: dict[str, _GjStore] = {}

    # -- index lifecycle ---------------------------------------------------
    def create_index(self, name: str, id_path: str | None = None,
                     dtg_path: str | None = None, points: bool = False):
        if name in self._stores:
            raise ValueError(f"index {name!r} already exists")
        self._stores[name] = _GjStore(name, id_path, dtg_path, points)

    def delete_index(self, name: str):
        self._stores.pop(name, None)

    @property
    def index_names(self) -> list[str]:
        return sorted(self._stores)

    def _store(self, name: str) -> _GjStore:
        if name not in self._stores:
            raise KeyError(f"no such index: {name!r}")
        return self._stores[name]

    # -- writes ------------------------------------------------------------
    @staticmethod
    def _features_of(geojson) -> list[dict]:
        doc = json.loads(geojson) if isinstance(geojson, str) else geojson
        if doc.get("type") == "FeatureCollection":
            return list(doc.get("features", []))
        if doc.get("type") == "Feature":
            return [doc]
        raise ValueError("expected GeoJSON Feature or FeatureCollection")

    def add(self, name: str, geojson) -> list[str]:
        """Add Feature/FeatureCollection; returns the assigned ids.

        All-or-nothing: every feature is validated (geometry present,
        id fresh and unique) before any mutation — the write-path
        atomicity contract (reference: IndexAdapter.scala:99-105
        all-or-nothing conversion before any mutation)."""
        store = self._store(name)
        feats = self._features_of(geojson)
        out = []
        auto = store._auto_id
        seen = set()
        for f in feats:
            if f.get("geometry") is None:
                raise ValueError("feature without geometry")
            fid = (json_path_get(f, store.id_path) if store.id_path
                   else f.get("id"))
            if fid is None:
                fid = str(auto)
                auto += 1
            fid = str(fid)
            if fid in store._pos or fid in seen:
                raise ValueError(f"feature id {fid!r} already exists "
                                 "(use update)")
            seen.add(fid)
            out.append(fid)
        store._auto_id = auto
        for fid, f in zip(out, feats):
            store._pos[fid] = len(store.ids)
            store.ids.append(fid)
            store.docs.append(f)
        store.invalidate()
        return out

    def update(self, name: str, geojson, ids: list[str] | None = None):
        """Replace existing features, matched by explicit ids or by the
        index's id json-path (GeoJsonIndex.scala:43-58)."""
        store = self._store(name)
        feats = self._features_of(geojson)
        if ids is None:
            if not store.id_path:
                raise ValueError(
                    "update without ids requires an index id json-path")
            ids = [str(json_path_get(f, store.id_path)) for f in feats]
        if len(ids) != len(feats):
            raise ValueError("ids and features length mismatch")
        # validate all ids before mutating anything (all-or-nothing)
        for fid, f in zip(ids, feats):
            if fid not in store._pos:
                raise KeyError(f"no such feature: {fid!r}")
            if f.get("geometry") is None:
                raise ValueError("feature without geometry")
        for fid, f in zip(ids, feats):
            store.docs[store._pos[fid]] = f
        store.invalidate()

    def delete(self, name: str, ids) -> int:
        store = self._store(name)
        if isinstance(ids, str):
            ids = [ids]
        drop = {i for i in map(str, ids) if i in store._pos}
        if not drop:
            return 0
        keep = [i for i, fid in enumerate(store.ids) if fid not in drop]
        store.docs = [store.docs[i] for i in keep]
        store.ids = [store.ids[i] for i in keep]
        store._pos = {fid: i for i, fid in enumerate(store.ids)}
        store.invalidate()
        return len(drop)

    # -- reads -------------------------------------------------------------
    def get(self, name: str, ids) -> list[dict]:
        store = self._store(name)
        if isinstance(ids, str):
            ids = [ids]
        return [store.docs[store._pos[i]] for i in map(str, ids)
                if i in store._pos]

    def query(self, name: str, query=None,
              transform: dict[str, str] | None = None) -> list[dict]:
        """Run a mongo-style query; returns matching feature documents.

        ``transform`` projects each result to ``{key: json_path_get(doc,
        path)}`` (the reference's query transform, GeoJsonIndex.scala:92).
        """
        store = self._store(name)
        if not store.docs:
            return []
        q = (query if isinstance(query, GeoJsonQuery)
             else parse_geojson_query(query))
        docs = np.asarray(store.docs, dtype=object)
        mask = q.mask(docs, store.batch())
        hits = [store.docs[i] for i in np.flatnonzero(mask)]
        if transform:
            hits = [{k: json_path_get(d, p) for k, p in transform.items()}
                    for d in hits]
        return hits
