"""Geo-indexed blob store.

The analog of the reference's geomesa-blobstore
(geomesa-blobstore-api/.../BlobStore.java:19-55 put/get/deleteBlob/
deleteBlobStore, GeoMesaIndexedBlobStore.java, blob SFT per
GeoMesaBlobStoreSFT.scala:14-32): binary payloads stored by id alongside
an indexed feature (filename, storeId, geometry, dtg) so blobs are
discoverable by spatio-temporal query.  File handlers (the reference's
BlobStoreFileHandler SPI — WKT/EXIF/GDAL handlers extracting a geometry
from the file) are the pluggable ``handler`` callables here.

The port's copy of the JAX package's ``blob.py``: the payloads stay on
the host, and the blob schema lives in a port :class:`TpuDataStore` (a
new one on the card unless the caller passes ``store``); its geometry
column takes the XZ indexes, as in the JAX package.
"""

from __future__ import annotations

import os
import re
import uuid

import numpy as np

from .datastore import TpuDataStore
from .features.feature_type import parse_spec

__all__ = ["GeoIndexedBlobStore", "wkt_handler"]

BLOB_SFT_SPEC = ("filename:String,storeId:String:index=true,dtg:Date,"
                 "*geom:Geometry")

_ID_RE = re.compile(r"^[A-Za-z0-9._-]+$")


def _safe_id(bid: str) -> bool:
    """Ids become file names under blob_dir — reject path separators and
    dot-runs so a caller-supplied id can never escape the directory."""
    return bool(_ID_RE.match(bid)) and ".." not in bid


def wkt_handler(data: bytes, params: dict):
    """The WKTFileHandler analog: geometry from params['wkt']."""
    from .geometry.wkt import geometry_from_wkt
    if "wkt" not in params:
        return None
    return geometry_from_wkt(params["wkt"])


class GeoIndexedBlobStore:
    """Blobs indexed by geometry+time over a TpuDataStore.

    Payload bytes live in host storage (a directory when ``blob_dir`` is
    given, else in-memory) — the role of the reference's Accumulo blob
    table; the feature index provides query-by-extent.
    """

    def __init__(self, store: TpuDataStore | None = None,
                 blob_dir: str | None = None, type_name: str = "blob"):
        self.store = store if store is not None else TpuDataStore()
        self.type_name = type_name
        self.blob_dir = blob_dir
        if blob_dir:
            os.makedirs(blob_dir, exist_ok=True)
        self._blobs: dict[str, tuple[str, bytes]] = {}
        if type_name not in self.store.type_names:
            self.store.create_schema(parse_spec(type_name, BLOB_SFT_SPEC))

    # -- writes ------------------------------------------------------------
    def put(self, data: bytes, *, geometry=None, dtg: int = 0,
            filename: str = "", blob_id: str | None = None,
            handler=None, params: dict | None = None) -> str:
        """Store a blob; returns its id.

        Geometry comes either explicitly or from a ``handler(data,
        params)`` callable (the FileHandler SPI role).
        """
        if geometry is None and handler is not None:
            geometry = handler(data, params or {})
        if geometry is None:
            raise ValueError("no geometry: pass geometry= or a handler")
        if blob_id is not None and not _safe_id(blob_id):
            raise ValueError(f"invalid blob id {blob_id!r}")
        bid = blob_id or uuid.uuid4().hex
        self._store_bytes(bid, filename, data)
        self.store.write(self.type_name, {
            "filename": np.asarray([filename], dtype=object),
            "storeId": np.asarray([bid], dtype=object),
            "dtg": np.asarray([int(dtg)], dtype=np.int64),
            "geom": [geometry],
        }, ids=np.asarray([bid], dtype=object))
        return bid

    def _store_bytes(self, bid: str, filename: str, data: bytes):
        if self.blob_dir:
            with open(os.path.join(self.blob_dir, bid), "wb") as f:
                f.write(data)
            with open(os.path.join(self.blob_dir, bid + ".name"), "w") as f:
                f.write(filename)
        else:
            self._blobs[bid] = (filename, data)

    # -- reads -------------------------------------------------------------
    def get(self, blob_id: str):
        """Returns (bytes, filename) or None."""
        if not _safe_id(blob_id):
            return None
        if self.blob_dir:
            path = os.path.join(self.blob_dir, blob_id)
            if not os.path.exists(path):
                return None
            with open(path, "rb") as f:
                data = f.read()
            name_path = path + ".name"
            filename = ""
            if os.path.exists(name_path):
                with open(name_path) as f:
                    filename = f.read()
            return data, filename
        hit = self._blobs.get(blob_id)
        return None if hit is None else (hit[1], hit[0])

    def query_ids(self, query="INCLUDE") -> list[str]:
        """Spatio-temporal search over the blob index; returns blob ids
        (the reference's pattern: query the feature store, fetch blobs by
        the returned storeId attribute)."""
        batch = self.store.query(self.type_name, query)
        return list(batch.column("storeId"))

    # -- deletes -----------------------------------------------------------
    def delete_blob(self, blob_id: str):
        if not _safe_id(blob_id):
            return
        self.store.delete(self.type_name, [blob_id])
        if self.blob_dir:
            for suffix in ("", ".name"):
                p = os.path.join(self.blob_dir, blob_id + suffix)
                if os.path.exists(p):
                    os.remove(p)
        else:
            self._blobs.pop(blob_id, None)

    def delete_blob_store(self):
        for bid in list(self.query_ids()):
            self.delete_blob(bid)
        self.store.remove_schema(self.type_name)
