"""WKB and TWKB geometry codecs (the port's copy of the JAX package's
``geometry/wkb.py``; the bytes are equal for every geometry kind).

The reference serializes geometries as WKB (well-known binary) and TWKB
(tiny WKB: varint-delta-encoded, precision-scaled) inside its kryo row
values (geomesa-features/.../serialization/WkbSerialization.scala,
TwkbSerialization.scala, VarIntEncoding.scala).  Host-side codecs here:
interchange with PostGIS/GeoTools tooling (WKB) and compact storage/wire
format (TWKB, typically 3-5× smaller for tracks).
"""

from __future__ import annotations

import struct

import numpy as np

from .types import (
    Geometry, LineString, MultiLineString, MultiPoint, MultiPolygon, Point,
    Polygon,
)

__all__ = ["wkb_encode", "wkb_decode", "twkb_encode", "twkb_decode"]

_WKB_TYPES = {
    "Point": 1, "LineString": 2, "Polygon": 3,
    "MultiPoint": 4, "MultiLineString": 5, "MultiPolygon": 6,
}


# ---------------------------------------------------------------------------
# WKB (little-endian, 2-D)
# ---------------------------------------------------------------------------

def wkb_encode(geom: Geometry) -> bytes:
    out = bytearray()
    _wkb_write(geom, out)
    return bytes(out)


def _wkb_write(geom: Geometry, out: bytearray) -> None:
    out.append(1)  # little endian
    t = _WKB_TYPES[geom.geom_type]
    out += struct.pack("<I", t)
    if isinstance(geom, Point):
        out += struct.pack("<dd", geom.x, geom.y)
    elif isinstance(geom, LineString):
        _wkb_coords(geom.coords, out)
    elif isinstance(geom, Polygon):
        rings = [geom.shell, *geom.holes]
        out += struct.pack("<I", len(rings))
        for r in rings:
            _wkb_coords(r, out)
    elif isinstance(geom, MultiPoint):
        out += struct.pack("<I", len(geom.coords))
        for x, y in geom.coords:
            _wkb_write(Point(float(x), float(y)), out)
    elif isinstance(geom, MultiLineString):
        out += struct.pack("<I", len(geom.lines))
        for l in geom.lines:
            _wkb_write(l, out)
    elif isinstance(geom, MultiPolygon):
        out += struct.pack("<I", len(geom.polygons))
        for p in geom.polygons:
            _wkb_write(p, out)
    else:  # pragma: no cover
        raise ValueError(f"cannot WKB-encode {geom.geom_type}")


def _wkb_coords(coords: np.ndarray, out: bytearray) -> None:
    out += struct.pack("<I", len(coords))
    out += np.asarray(coords, dtype="<f8").tobytes()


def wkb_decode(raw: bytes) -> Geometry:
    geom, _ = _wkb_read(memoryview(raw), 0)
    return geom


def _wkb_read(buf: memoryview, pos: int):
    little = buf[pos] == 1
    pos += 1
    fmt = "<I" if little else ">I"
    (t,) = struct.unpack_from(fmt, buf, pos)
    pos += 4
    # EWKB (PostGIS) flag bits + ISO WKB 1000/2000/3000 dimension offsets
    has_z = bool(t & 0x80000000)
    has_m = bool(t & 0x40000000)
    if t & 0x20000000:  # SRID present: consume (and discard) the 4-byte SRID
        pos += 4
    t &= 0x1FFFFFFF
    if t >= 1000:
        iso_dim = t // 1000
        has_z = has_z or iso_dim in (1, 3)
        has_m = has_m or iso_dim in (2, 3)
        t %= 1000
    ndim = 2 + has_z + has_m
    dfmt = "<" if little else ">"
    if t == 1:
        vals = struct.unpack_from(dfmt + "d" * ndim, buf, pos)
        return Point(vals[0], vals[1]), pos + 8 * ndim
    if t == 2:
        coords, pos = _wkb_read_coords(buf, pos, little, ndim)
        return LineString(coords), pos
    if t == 3:
        (n,) = struct.unpack_from(fmt, buf, pos)
        pos += 4
        rings = []
        for _ in range(n):
            r, pos = _wkb_read_coords(buf, pos, little, ndim)
            rings.append(r)
        return Polygon(rings[0], tuple(rings[1:])), pos
    if t in (4, 5, 6):
        (n,) = struct.unpack_from(fmt, buf, pos)
        pos += 4
        parts = []
        for _ in range(n):
            g, pos = _wkb_read(buf, pos)
            parts.append(g)
        if t == 4:
            return MultiPoint(np.array([[g.x, g.y] for g in parts])), pos
        if t == 5:
            return MultiLineString(tuple(parts)), pos
        return MultiPolygon(tuple(parts)), pos
    raise ValueError(f"unsupported WKB type {t}")


def _wkb_read_coords(buf: memoryview, pos: int, little: bool, ndim: int = 2):
    fmt = "<I" if little else ">I"
    (n,) = struct.unpack_from(fmt, buf, pos)
    pos += 4
    dt = "<f8" if little else ">f8"
    size = 8 * ndim * n
    coords = np.frombuffer(buf[pos:pos + size], dtype=dt).reshape(n, ndim)
    return coords[:, :2].astype(np.float64), pos + size


# ---------------------------------------------------------------------------
# TWKB (precision-scaled zigzag varint deltas)
# ---------------------------------------------------------------------------

def _zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63)


def _unzigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _varint(v: int, out: bytearray) -> None:
    v &= 0xFFFFFFFFFFFFFFFF
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(buf, pos: int):
    shift = 0
    val = 0
    while True:
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7


class _TwkbWriter:
    def __init__(self, precision: int):
        self.scale = 10 ** precision
        self.out = bytearray()
        self.last = [0, 0]

    def header(self, wkb_type: int, precision: int) -> None:
        self.out.append(((_zigzag(precision) & 0x0F) << 4) | wkb_type)
        self.out.append(0)  # no metadata extras

    def coords(self, coords: np.ndarray, count_prefix: bool = True) -> None:
        q = np.round(np.asarray(coords, dtype=np.float64) * self.scale
                     ).astype(np.int64)
        if count_prefix:
            _varint(len(q), self.out)
        for x, y in q:
            _varint(_zigzag(int(x) - self.last[0]), self.out)
            _varint(_zigzag(int(y) - self.last[1]), self.out)
            self.last = [int(x), int(y)]


def twkb_encode(geom: Geometry, precision: int = 7) -> bytes:
    if not -8 <= precision <= 7:  # zigzag(precision) must fit the header nibble
        raise ValueError(f"TWKB precision must be in [-8, 7], got {precision}")
    w = _TwkbWriter(precision)
    t = _WKB_TYPES[geom.geom_type]
    w.header(t, precision)
    if isinstance(geom, Point):
        w.coords(np.array([[geom.x, geom.y]]), count_prefix=False)
    elif isinstance(geom, LineString):
        w.coords(geom.coords)
    elif isinstance(geom, MultiPoint):
        w.coords(geom.coords)
    elif isinstance(geom, Polygon):
        _varint(1 + len(geom.holes), w.out)
        for r in [geom.shell, *geom.holes]:
            w.coords(r)
    elif isinstance(geom, MultiLineString):
        _varint(len(geom.lines), w.out)
        for l in geom.lines:
            w.coords(l.coords)
    elif isinstance(geom, MultiPolygon):
        _varint(len(geom.polygons), w.out)
        for p in geom.polygons:
            _varint(1 + len(p.holes), w.out)
            for r in [p.shell, *p.holes]:
                w.coords(r)
    else:  # pragma: no cover
        raise ValueError(f"cannot TWKB-encode {geom.geom_type}")
    return bytes(w.out)


class _TwkbReader:
    def __init__(self, raw: bytes):
        self.buf = raw
        self.pos = 0
        self.last = [0, 0]
        head = raw[0]
        self.type = head & 0x0F
        self.precision = _unzigzag(head >> 4)
        self.scale = 10 ** self.precision
        self.pos = 2  # skip header + metadata byte

    def varint(self) -> int:
        v, self.pos = _read_varint(self.buf, self.pos)
        return v

    def coords(self, n: int | None = None) -> np.ndarray:
        if n is None:
            n = self.varint()
        out = np.empty((n, 2), dtype=np.float64)
        for i in range(n):
            self.last[0] += _unzigzag(self.varint())
            self.last[1] += _unzigzag(self.varint())
            out[i, 0] = self.last[0] / self.scale
            out[i, 1] = self.last[1] / self.scale
        return out


def twkb_decode(raw: bytes) -> Geometry:
    r = _TwkbReader(raw)
    t = r.type
    if t == 1:
        c = r.coords(1)
        return Point(float(c[0, 0]), float(c[0, 1]))
    if t == 2:
        return LineString(r.coords())
    if t == 3:
        rings = [r.coords() for _ in range(r.varint())]
        return Polygon(rings[0], tuple(rings[1:]))
    if t == 4:
        return MultiPoint(r.coords())
    if t == 5:
        return MultiLineString(tuple(LineString(r.coords())
                                     for _ in range(r.varint())))
    if t == 6:
        polys = []
        for _ in range(r.varint()):
            rings = [r.coords() for _ in range(r.varint())]
            polys.append(Polygon(rings[0], tuple(rings[1:])))
        return MultiPolygon(tuple(polys))
    raise ValueError(f"unsupported TWKB type {t}")
