"""Additional converter input formats: XML, fixed-width, Avro, JDBC,
Shapefile, OSM.

The reference ships one Maven module per format (geomesa-convert/
geomesa-convert-{xml,fixedwidth,avro,jdbc,shp,osm}); each parses its
input into per-record values and feeds the shared transform pipeline.
Here every format parses the WHOLE input into columns up front (the
columnar shape the device wants), then the shared
:class:`~geomesa_tpu_torch.io.converters.Converter` pipeline applies vectorized
transform expressions.

All parsers are self-contained (stdlib xml/sqlite3/struct) — no external
format libraries.  The port's copy of the JAX package's ``io/formats.py``;
the converters register into :mod:`.converters`' type table.
"""

from __future__ import annotations

import struct
import xml.etree.ElementTree as ET

import numpy as np

from ..features.batch import FeatureBatch
from .converters import Converter, EvaluationContext

__all__ = [
    "XmlConverter", "FixedWidthConverter", "AvroConverter",
    "JdbcConverter", "ShapefileConverter", "OsmConverter",
    "read_shapefile",
]


class XmlConverter(Converter):
    """XML documents → columns (geomesa-convert-xml analog).

    Config: ``feature-path`` names the repeating feature element (matched
    by tag anywhere in the document); raw column references are relative
    paths — ``a/b`` for nested element text, ``@attr`` for an attribute,
    ``a/@attr`` for a child's attribute.
    """

    def raw_columns(self, source) -> dict:
        if isinstance(source, bytes):
            source = source.decode()
        root = ET.fromstring(source)
        tag = self.config.get("feature-path", "feature")
        elems = [e for e in root.iter() if _local(e.tag) == tag]
        paths = self.referenced_paths()
        cols: dict = {}
        for p in paths:
            cols[p] = np.asarray([_xml_get(e, p) for e in elems], dtype=object)
        if not cols:
            # no fields configured: expose child-element text columns
            keys: set = set()
            for e in elems:
                keys.update(_local(c.tag) for c in e)
            for k in keys:
                cols[k] = np.asarray([_xml_get(e, k) for e in elems],
                                     dtype=object)
        return cols


def _local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _xml_get(elem, path: str):
    cur = elem
    parts = path.split("/")
    for i, part in enumerate(parts):
        if part.startswith("@"):
            return cur.get(part[1:])
        nxt = None
        for c in cur:
            if _local(c.tag) == part:
                nxt = c
                break
        if nxt is None:
            return None
        cur = nxt
    text = cur.text
    return text.strip() if text else text


class FixedWidthConverter(Converter):
    """Fixed-width text lines → columns (geomesa-convert-fixedwidth
    analog: each field carries ``start``/``width`` byte offsets)."""

    def raw_columns(self, source) -> dict:
        if isinstance(source, bytes):
            source = source.decode()
        skip = int(self.config.get("options", {}).get("skip-lines", 0))
        lines = [ln for ln in source.splitlines() if ln.strip()][skip:]
        cols: dict = {"0": np.asarray(lines, dtype=object)}
        for f in self.config.get("fields", []):
            if "start" in f and "width" in f:
                s, w = int(f["start"]), int(f["width"])
                cols[f["name"]] = np.asarray(
                    [ln[s:s + w].strip() for ln in lines], dtype=object)
        return cols


class AvroConverter(Converter):
    """Avro object-container files → batch, via the framework's own
    container codec (io/avro.py; geomesa-convert-avro analog)."""

    def raw_columns(self, source) -> dict:
        from .avro import from_avro

        batch = from_avro(source, self.sft)
        cols = dict(batch.columns)
        cols["id"] = batch.ids
        # expose the default geometry as an object column so transforms can
        # reference it (point batches only carry the x/y fast-path columns)
        # — but only when a transform actually references it: the per-row
        # object materialization is pure overhead otherwise
        gname = self.sft.default_geom
        if gname is not None and gname in self.referenced_paths():
            if batch.geoms is not None:
                cols[gname] = np.asarray(
                    [batch.geoms.geometry(i) for i in range(len(batch.geoms))],
                    dtype=object)
            elif f"{gname}_x" in cols:
                from ..geometry.types import Point
                cols[gname] = np.asarray(
                    [Point(float(x), float(y)) for x, y in
                     zip(cols[f"{gname}_x"], cols[f"{gname}_y"])],
                    dtype=object)
        return cols

    def convert(self, source, ec: EvaluationContext | None = None) -> FeatureBatch:
        if not self.fields:
            # no transforms: the file IS the batch
            from .avro import from_avro

            ec = ec if ec is not None else EvaluationContext()
            batch = from_avro(source, self.sft)
            ec.success += len(batch)
            return batch
        return super().convert(source, ec)


class JdbcConverter(Converter):
    """SQL query results → columns (geomesa-convert-jdbc analog), via
    stdlib sqlite3.  ``source`` is a database path or an open connection;
    config ``query`` selects the rows.  Raw columns are result columns by
    name and by position (``$1`` = first selected column, matching the
    reference's positional refs)."""

    wants_path = True

    def raw_columns(self, source) -> dict:
        import sqlite3

        own = False
        if isinstance(source, (str, bytes)):
            conn = sqlite3.connect(source)
            own = True
        else:
            conn = source
        try:
            cur = conn.execute(self.config["query"])
            names = [d[0] for d in cur.description]
            rows = cur.fetchall()
        finally:
            if own:
                conn.close()
        cols: dict = {}
        for i, name in enumerate(names):
            arr = np.asarray([r[i] for r in rows], dtype=object)
            cols[name] = arr
            cols[str(i + 1)] = arr
        return cols


# -- shapefile ---------------------------------------------------------------

def read_shapefile(shp_path: str, dbf_path: str | None = None):
    """Minimal ESRI shapefile reader: (geometries, attribute columns).

    Supports shape types 0 (null), 1 (point), 3 (polyline), 5 (polygon),
    8 (multipoint) — the types the reference's shp converter ingests.
    Polygon parts: first ring is the shell, subsequent rings holes.
    """
    from ..geometry.types import LineString, MultiLineString, MultiPoint, Point, Polygon

    with open(shp_path, "rb") as f:
        data = f.read()
    if struct.unpack(">i", data[:4])[0] != 9994:
        raise ValueError(f"{shp_path!r} is not a shapefile")
    geoms: list = []
    pos = 100
    while pos < len(data):
        _, content_words = struct.unpack(">ii", data[pos:pos + 8])
        pos += 8
        rec_end = pos + content_words * 2
        (stype,) = struct.unpack("<i", data[pos:pos + 4])
        if stype == 0:
            geoms.append(None)
        elif stype == 1:
            x, y = struct.unpack("<dd", data[pos + 4:pos + 20])
            geoms.append(Point(x, y))
        elif stype in (3, 5):
            nparts, npoints = struct.unpack("<ii", data[pos + 36:pos + 44])
            parts = struct.unpack(f"<{nparts}i", data[pos + 44:pos + 44 + 4 * nparts])
            pts_off = pos + 44 + 4 * nparts
            pts = np.frombuffer(
                data, dtype="<f8", count=2 * npoints, offset=pts_off
            ).reshape(npoints, 2)
            rings = [pts[parts[i]:(parts[i + 1] if i + 1 < nparts else npoints)]
                     for i in range(nparts)]
            if stype == 5:
                geoms.append(Polygon(rings[0], tuple(rings[1:])))
            elif nparts == 1:
                geoms.append(LineString(rings[0]))
            else:
                geoms.append(MultiLineString(tuple(LineString(r) for r in rings)))
        elif stype == 8:
            (npoints,) = struct.unpack("<i", data[pos + 36:pos + 40])
            pts = np.frombuffer(data, dtype="<f8", count=2 * npoints,
                                offset=pos + 40).reshape(npoints, 2)
            geoms.append(MultiPoint(pts))
        else:
            raise ValueError(f"unsupported shape type {stype}")
        pos = rec_end

    attrs: dict = {}
    if dbf_path is None:
        guess = shp_path[:-4] + ".dbf" if shp_path.endswith(".shp") else None
        import os
        dbf_path = guess if guess and os.path.exists(guess) else None
    if dbf_path:
        attrs = _read_dbf(dbf_path)
    return geoms, attrs


def _read_dbf(path: str) -> dict:
    with open(path, "rb") as f:
        data = f.read()
    nrec, hdr_size, rec_size = struct.unpack("<ihh", data[4:12])
    fields = []
    pos = 32
    while pos < hdr_size - 1 and data[pos] != 0x0D:
        name = data[pos:pos + 11].split(b"\x00")[0].decode("latin-1")
        ftype = chr(data[pos + 11])
        length = data[pos + 16]
        decimals = data[pos + 17]
        fields.append((name, ftype, length, decimals))
        pos += 32
    cols: dict = {name: [] for name, *_ in fields}
    pos = hdr_size
    for _ in range(nrec):
        if pos + rec_size > len(data) or data[pos:pos + 1] == b"\x1a":
            break
        rec = data[pos:pos + rec_size]
        off = 1  # deletion flag
        for name, ftype, length, decimals in fields:
            raw = rec[off:off + length].decode("latin-1").strip()
            off += length
            if ftype in ("N", "F"):
                if not raw:
                    cols[name].append(None)
                elif decimals or ftype == "F" or "." in raw:
                    try:
                        cols[name].append(float(raw))
                    except ValueError:  # dBASE pads overflow with asterisks
                        cols[name].append(None)
                else:
                    try:
                        cols[name].append(int(raw))
                    except ValueError:
                        cols[name].append(None)
            elif ftype == "L":
                cols[name].append(raw.upper() in ("T", "Y"))
            else:
                cols[name].append(raw or None)
        pos += rec_size
    return {k: np.asarray(v, dtype=object) for k, v in cols.items()}


class ShapefileConverter(Converter):
    """Shapefiles → columns: ``geometry`` plus the DBF attribute columns
    (geomesa-convert-shp analog)."""

    wants_path = True

    def raw_columns(self, source) -> dict:
        geoms, attrs = read_shapefile(source, self.config.get("dbf"))
        # null shapes (type 0) are legal records; drop them (with their
        # attribute rows) rather than crash the whole batch in packing
        keep = [i for i, g in enumerate(geoms) if g is not None]
        if len(keep) != len(geoms):
            geoms = [geoms[i] for i in keep]
            attrs = {k: v[keep] for k, v in attrs.items()}
        cols = {"geometry": np.asarray(geoms, dtype=object)}
        cols.update(attrs)
        return cols


class OsmConverter(Converter):
    """OpenStreetMap XML nodes → columns (geomesa-convert-osm analog):
    ``id``/``lon``/``lat`` plus one column per referenced tag key."""

    def raw_columns(self, source) -> dict:
        if isinstance(source, bytes):
            source = source.decode()
        root = ET.fromstring(source)
        nodes = [e for e in root.iter() if _local(e.tag) == "node"]
        ids = np.asarray([n.get("id") for n in nodes], dtype=object)
        lon = np.asarray([float(n.get("lon", "nan")) for n in nodes])
        lat = np.asarray([float(n.get("lat", "nan")) for n in nodes])
        cols: dict = {"id": ids, "lon": lon, "lat": lat}
        # one pass: per-node tag dict, then one column per distinct key
        tags = [{t.get("k"): t.get("v") for t in n if _local(t.tag) == "tag"}
                for n in nodes]
        # tag keys must not clobber the core node columns (real imports
        # contain nodes tagged e.g. k="lat")
        tag_keys = (set().union(*tags) if tags else set()) - set(cols)
        for k in tag_keys:
            cols[k] = np.asarray([d.get(k) for d in tags], dtype=object)
        return cols
