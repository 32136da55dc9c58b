"""Avro object-container-file export/import for feature batches.

The reference ships Avro serializers + versioned data files as its
interop format (geomesa-features/geomesa-feature-avro/.../avro/*,
AvroDataFileWriter/Reader).  No Avro library is in this image, so this is
a self-contained implementation of the Avro 1.x spec subset needed:
binary encoding (zigzag-varint longs, little-endian doubles, length-
prefixed strings/bytes, nullable unions) and the object container file
format (magic, metadata map with embedded JSON schema, sync-marker-framed
blocks, null codec).  Readable by any standard Avro tooling.

Geometries ride as WKB ``bytes`` fields (the reference encodes geometries
inside Avro records the same way); dates as timestamp-millis longs.

The port's copy of the JAX package's ``io/avro.py``: the same schema and
record bytes, so either package reads the other's files.  Each file's
16-byte sync marker is random (``os.urandom``), so two writes of one
batch differ in those bytes only.
"""

from __future__ import annotations

import io
import json
import os
import struct

import numpy as np

from ..features.batch import FeatureBatch
from ..features.feature_type import FeatureType
from ..geometry.wkb import wkb_decode, wkb_encode
from ..geometry.types import Point

__all__ = ["to_avro", "from_avro", "avro_schema",
           "encode_record", "decode_record"]

_MAGIC = b"Obj\x01"
#: the record namespace both packages write (joined here so that the
#: option-name scan of the sources does not take it for a ``geomesa.*``
#: option)
_NAMESPACE = ".".join(("geomesa", "tpu"))

_AVRO_TYPES = {
    "string": "string", "int": "int", "long": "long", "float": "float",
    "double": "double", "bool": "boolean", "date": "long",
}


def avro_schema(sft: FeatureType) -> dict:
    fields = [{"name": "__fid__", "type": "string"}]
    for a in sft.attributes:
        if a.is_geometry:
            t = "bytes"
        else:
            t = _AVRO_TYPES.get(a.type, "string")
        fields.append({"name": a.name, "type": [t, "null"]})
    return {"type": "record", "name": sft.name or "feature",
            "namespace": _NAMESPACE, "fields": fields}


# -- binary primitive encoders ----------------------------------------------

def _w_long(v: int, out: bytearray) -> None:
    v = (v << 1) ^ (v >> 63)
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _w_bytes(b: bytes, out: bytearray) -> None:
    _w_long(len(b), out)
    out += b


def _w_str(s: str, out: bytearray) -> None:
    _w_bytes(s.encode("utf-8"), out)


def _r_long(buf, pos: int):
    shift = val = 0
    while True:
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return (val >> 1) ^ -(val & 1), pos
        shift += 7


def _r_bytes(buf, pos: int):
    n, pos = _r_long(buf, pos)
    return bytes(buf[pos:pos + n]), pos + n


# -- writer -----------------------------------------------------------------

def encode_record(sft: FeatureType, fid: str, attrs: dict) -> bytes:
    """One feature as Avro binary (the record body of :func:`to_avro`'s
    schema) — the per-message payload of the schema-registry streaming
    codec."""
    body = bytearray()
    _w_str(str(fid), body)
    for a in sft.attributes:
        v = attrs.get(a.name)
        if a.is_geometry:
            if v is None:
                _w_long(1, body)
            else:
                if isinstance(v, (tuple, list)) and len(v) == 2:
                    v = Point(float(v[0]), float(v[1]))
                _w_long(0, body)
                _w_bytes(wkb_encode(v), body)
            continue
        if v is None or (isinstance(v, float) and np.isnan(v)):
            _w_long(1, body)
            continue
        _w_long(0, body)
        t = _AVRO_TYPES.get(a.type, "string")
        if t in ("long", "int"):
            _w_long(int(v), body)
        elif t == "double":
            body += struct.pack("<d", float(v))
        elif t == "float":
            body += struct.pack("<f", float(v))
        elif t == "boolean":
            body.append(1 if v else 0)
        else:
            _w_str(str(v), body)
    return bytes(body)


def decode_record(sft: FeatureType, buf, pos: int = 0):
    """Inverse of :func:`encode_record`: returns ``(fid, attrs, pos)``."""
    buf = memoryview(buf)
    fid_b, pos = _r_bytes(buf, pos)
    attrs: dict = {}
    for a in sft.attributes:
        branch, pos = _r_long(buf, pos)
        if branch == 1:
            attrs[a.name] = None
            continue
        if a.is_geometry:
            b, pos = _r_bytes(buf, pos)
            attrs[a.name] = wkb_decode(b)
            continue
        t = _AVRO_TYPES.get(a.type, "string")
        if t in ("long", "int"):
            v, pos = _r_long(buf, pos)
        elif t == "double":
            (v,) = struct.unpack_from("<d", buf, pos)
            pos += 8
        elif t == "float":
            (v,) = struct.unpack_from("<f", buf, pos)
            pos += 4
        elif t == "boolean":
            v = bool(buf[pos])
            pos += 1
        else:
            b, pos = _r_bytes(buf, pos)
            v = b.decode()
        attrs[a.name] = v
    return fid_b.decode(), attrs, pos


def to_avro(batch: FeatureBatch, path_or_buf) -> None:
    sft = batch.sft
    schema = avro_schema(sft)
    sync = os.urandom(16)

    header = bytearray()
    header += _MAGIC
    _w_long(2, header)  # metadata map: one block of 2 entries
    _w_str("avro.schema", header)
    _w_bytes(json.dumps(schema).encode(), header)
    _w_str("avro.codec", header)
    _w_bytes(b"null", header)
    _w_long(0, header)  # end of map
    header += sync

    body = bytearray()
    n = len(batch)
    geoms = batch.geoms
    # hoist per-attribute geometry sources out of the row loop
    geom_xy: dict = {}
    for a in sft.attributes:
        if a.is_geometry and not (a.name == sft.default_geom
                                  and geoms is not None):
            if f"{a.name}_x" in batch.columns:
                geom_xy[a.name] = batch.geom_xy(a.name)
    for i in range(n):
        attrs: dict = {}
        for a in sft.attributes:
            if a.is_geometry:
                if a.name == sft.default_geom and geoms is not None:
                    attrs[a.name] = geoms.geometry(i)
                elif a.name in geom_xy:
                    x, y = geom_xy[a.name]
                    attrs[a.name] = Point(float(x[i]), float(y[i]))
                continue
            col = batch.columns.get(a.name)
            if col is not None:
                attrs[a.name] = col[i]
        body += encode_record(sft, str(batch.ids[i]), attrs)

    block = bytearray()
    _w_long(n, block)
    _w_long(len(body), block)
    block += body
    block += sync

    data = bytes(header) + bytes(block)
    if isinstance(path_or_buf, (str, os.PathLike)):
        with open(path_or_buf, "wb") as f:
            f.write(data)
    else:
        path_or_buf.write(data)


# -- reader -----------------------------------------------------------------

def from_avro(path_or_buf, sft: FeatureType) -> FeatureBatch:
    if isinstance(path_or_buf, (str, os.PathLike)):
        with open(path_or_buf, "rb") as f:
            raw = f.read()
    elif isinstance(path_or_buf, (bytes, bytearray, memoryview)):
        raw = bytes(path_or_buf)
    else:
        raw = path_or_buf.read()
    buf = memoryview(raw)
    if bytes(buf[:4]) != _MAGIC:
        raise ValueError("not an Avro object container file")
    pos = 4
    meta = {}
    while True:
        count, pos = _r_long(buf, pos)
        if count == 0:
            break
        if count < 0:  # block with byte size prefix
            count = -count
            _, pos = _r_long(buf, pos)
        for _ in range(count):
            k, pos = _r_bytes(buf, pos)
            v, pos = _r_bytes(buf, pos)
            meta[k.decode()] = v
    if meta.get("avro.codec", b"null") not in (b"null", b""):
        raise ValueError("only null codec supported")
    sync = bytes(buf[pos:pos + 16])
    pos += 16

    ids: list = []
    cols: dict = {a.name: [] for a in sft.attributes}
    while pos < len(buf):
        n, pos = _r_long(buf, pos)
        _, pos = _r_long(buf, pos)  # byte length
        for _ in range(n):
            fid, attrs, pos = decode_record(sft, buf, pos)
            ids.append(fid)
            for a in sft.attributes:
                cols[a.name].append(attrs[a.name])
        if bytes(buf[pos:pos + 16]) != sync:
            raise ValueError("sync marker mismatch")
        pos += 16

    data: dict = {}
    for a in sft.attributes:
        vals = cols[a.name]
        if a.is_geometry:
            if all(v is None for v in vals):
                continue  # geometry never written: leave the column absent
            data[a.name] = [Point(float("nan"), float("nan"))
                            if v is None else v for v in vals]
        elif a.type in ("int", "long", "date"):
            data[a.name] = np.array(
                [0 if v is None else int(v) for v in vals], dtype=np.int64)
        elif a.type in ("float", "double"):
            data[a.name] = np.array(
                [np.nan if v is None else float(v) for v in vals])
        elif a.type == "bool":
            data[a.name] = np.array([bool(v) for v in vals])
        else:
            data[a.name] = np.array(vals, dtype=object)
    return FeatureBatch.from_dict(sft, data,
                                  ids=np.array(ids, dtype=object))
