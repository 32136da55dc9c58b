"""Export formats: Arrow, Parquet, ORC, CSV, GeoJSON, GML, a Leaflet map
and shapefiles.

The port's copy of the JAX package's ``io/export.py``, with the same file
layout: the schema metadata keys ``geomesa_tpu.sft`` and
``geomesa_tpu.name``, the ``__fid__`` column, the ``<geom>_x``/``<geom>_y``
fast-path columns beside the geometry as WKT (``POINT (x y)`` for points),
dates as ``timestamp[ms]``.  A file either package writes, the other
reads; the text formats (CSV, GeoJSON, GML, Leaflet) and the shapefile
trio are the same bytes.  ``pyarrow`` is imported by the calls that need
it, as in the JAX package.
"""

from __future__ import annotations

import json

import numpy as np

from ..features.batch import FeatureBatch
from ..features.feature_type import FeatureType, parse_spec
from ..geometry.wkt import geometry_from_wkt, geometry_to_wkt

__all__ = ["to_arrow", "to_parquet", "from_parquet", "to_orc", "from_orc",
           "to_csv", "to_geojson", "to_gml", "to_leaflet", "to_shapefile"]


def _geom_wkt_column(batch: FeatureBatch) -> np.ndarray | None:
    name = batch.sft.default_geom
    if name is None:
        return None
    if batch.geoms is not None:
        return np.asarray(
            [geometry_to_wkt(batch.geoms.geometry(i)) for i in range(len(batch))],
            dtype=object)
    x, y = batch.geom_xy()
    return np.asarray([f"POINT ({a} {b})" for a, b in zip(x, y)], dtype=object)


def to_arrow(batch: FeatureBatch):
    """FeatureBatch → pyarrow.Table (dates as timestamp[ms], geometry as
    WKT plus x/y fast-path columns for points)."""
    import pyarrow as pa

    arrays, names = [], []
    arrays.append(pa.array(batch.ids.astype(str)))
    names.append("__fid__")
    for attr in batch.sft.attributes:
        if attr.is_geometry:
            if f"{attr.name}_x" in batch.columns:
                arrays.append(pa.array(batch.columns[f"{attr.name}_x"]))
                names.append(f"{attr.name}_x")
                arrays.append(pa.array(batch.columns[f"{attr.name}_y"]))
                names.append(f"{attr.name}_y")
            if attr.name == batch.sft.default_geom:
                arrays.append(pa.array(_geom_wkt_column(batch)))
                names.append(attr.name)
            elif f"{attr.name}_bbox" in batch.columns:
                # secondary non-point geometries are carried at bbox
                # resolution (the batch packs vertices only for the
                # default geometry)
                bb = batch.columns[f"{attr.name}_bbox"]
                for j, part in enumerate(("xmin", "ymin", "xmax", "ymax")):
                    arrays.append(pa.array(bb[:, j]))
                    names.append(f"{attr.name}_bbox_{part}")
        elif attr.name in batch.columns:
            col = batch.columns[attr.name]
            if attr.type == "date":
                arrays.append(pa.array(col).cast(pa.timestamp("ms")))
            else:
                arrays.append(pa.array(col))
            names.append(attr.name)
    table = pa.table(dict(zip(names, arrays)))
    return table.replace_schema_metadata(
        {"geomesa_tpu.sft": batch.sft.spec_string(),
         "geomesa_tpu.name": batch.sft.name})


def to_parquet(batch: FeatureBatch, path: str) -> None:
    import pyarrow.parquet as pq

    pq.write_table(to_arrow(batch), path)


def from_parquet(path: str, sft: FeatureType | None = None) -> FeatureBatch:
    """A parquet file back into a FeatureBatch; without ``sft`` the schema
    comes from the file's ``geomesa_tpu.sft`` metadata."""
    import pyarrow.parquet as pq

    table = pq.read_table(path)
    meta = table.schema.metadata or {}
    if sft is None:
        spec = meta.get(b"geomesa_tpu.sft")
        name = meta.get(b"geomesa_tpu.name", b"imported")
        if spec is None:
            raise ValueError("parquet file lacks geomesa_tpu schema metadata; pass sft")
        sft = parse_spec(name.decode(), spec.decode())
    return _table_to_batch(table, sft)


def to_orc(batch: FeatureBatch, path: str) -> None:
    """ORC export (the FSDS ORC storage format).  ORC carries no arrow
    schema metadata, so reading back needs the schema."""
    import pyarrow as pa
    import pyarrow.orc as orc

    table = to_arrow(batch)
    # ORC timestamps do not round-trip epoch millis: dates go as int64
    # (the reader casts date columns to int64 anyway)
    for i, f in enumerate(table.schema):
        if pa.types.is_timestamp(f.type):
            table = table.set_column(
                i, f.name, table.column(i).cast("int64"))
    orc.write_table(table, path)


def from_orc(path: str, sft: FeatureType) -> FeatureBatch:
    import pyarrow.orc as orc

    return _table_to_batch(orc.ORCFile(path).read(), sft)


def _table_to_batch(table, sft: FeatureType) -> FeatureBatch:
    data: dict = {}
    cols = {c: table.column(c) for c in table.column_names}
    extra_bbox: dict = {}
    for attr in sft.attributes:
        if attr.is_geometry:
            if attr.type == "point" and f"{attr.name}_x" in cols:
                data[attr.name] = (
                    cols[f"{attr.name}_x"].to_numpy(),
                    cols[f"{attr.name}_y"].to_numpy(),
                )
            elif attr.name in cols:
                wkt = cols[attr.name].to_numpy(zero_copy_only=False)
                data[attr.name] = [geometry_from_wkt(w) for w in wkt]
            elif f"{attr.name}_bbox_xmin" in cols:
                extra_bbox[f"{attr.name}_bbox"] = np.stack(
                    [cols[f"{attr.name}_bbox_{p}"].to_numpy()
                     for p in ("xmin", "ymin", "xmax", "ymax")], axis=1)
        elif attr.name in cols:
            col = cols[attr.name]
            if attr.type == "date":
                data[attr.name] = col.cast("int64").to_numpy()
            else:
                data[attr.name] = col.to_numpy(zero_copy_only=False)
    ids = (cols["__fid__"].to_numpy(zero_copy_only=False)
           if "__fid__" in cols else None)
    batch = FeatureBatch.from_dict(sft, data, ids=ids)
    batch.columns.update(extra_bbox)
    return batch


def to_csv(batch: FeatureBatch) -> str:
    """CSV export with WKT geometry (tools/export CSV format analog)."""
    import csv as _csv
    import io as _io

    out = _io.StringIO()
    w = _csv.writer(out)
    header = ["id"] + [a.name for a in batch.sft.attributes]
    w.writerow(header)
    wkt = _geom_wkt_column(batch)
    n = len(batch)
    cols = []
    for a in batch.sft.attributes:
        if a.is_geometry and a.name == batch.sft.default_geom:
            cols.append(wkt)
        elif a.name not in batch.columns:
            cols.append(np.full(n, "", dtype=object))
        elif a.type == "date":
            cols.append(np.datetime_as_string(
                batch.columns[a.name].astype("M8[ms]"), unit="ms"))
        else:
            cols.append(batch.columns[a.name])
    for i in range(n):
        w.writerow([batch.ids[i]] + [c[i] for c in cols])
    return out.getvalue()


def to_geojson(batch: FeatureBatch) -> str:
    """GeoJSON FeatureCollection export."""
    feats = []
    name = batch.sft.default_geom
    n = len(batch)
    for i in range(n):
        if batch.geoms is not None:
            g = batch.geoms.geometry(i)
            geom = _geom_to_geojson(g)
        else:
            x, y = batch.geom_xy()
            geom = {"type": "Point", "coordinates": [float(x[i]), float(y[i])]}
        props = {}
        for a in batch.sft.attributes:
            if a.is_geometry or a.name not in batch.columns:
                continue
            v = batch.columns[a.name][i]
            if a.type == "date":
                v = str(np.datetime64(int(v), "ms")) + "Z"
            elif hasattr(v, "item"):
                v = v.item()
            props[a.name] = v
        feats.append({"type": "Feature", "id": str(batch.ids[i]),
                      "geometry": geom, "properties": props})
    return json.dumps({"type": "FeatureCollection", "features": feats})


def _geom_to_geojson(g):
    from ..geometry.geojson import geometry_to_geojson
    return geometry_to_geojson(g)


def to_gml(batch: FeatureBatch, *, srs: str = "urn:ogc:def:crs:EPSG::4326") -> str:
    """GML 3 FeatureCollection export (tools/export GML format analog,
    tools/export/formats/GmlExporter.scala in the reference).

    Coordinates are emitted lon lat (EPSG:4326 axis order follows the
    reference's GML2 srsName convention of x y)."""
    from xml.sax.saxutils import escape, quoteattr

    ns = ("xmlns:gml=\"http://www.opengis.net/gml\" "
          "xmlns:geomesa=\"http://geomesa.org\"")
    name = batch.sft.name
    out = ["<?xml version=\"1.0\" encoding=\"UTF-8\"?>",
           f"<gml:FeatureCollection {ns}>"]

    def pos_list(coords):
        return " ".join(f"{c[0]:.10g} {c[1]:.10g}" for c in coords)

    def gml_geom(g) -> str:
        from ..geometry.types import (
            LineString, MultiLineString, MultiPoint, MultiPolygon, Point, Polygon,
        )
        if isinstance(g, Point):
            return (f"<gml:Point srsName=\"{srs}\"><gml:pos>{g.x:.10g} "
                    f"{g.y:.10g}</gml:pos></gml:Point>")
        if isinstance(g, LineString):
            return (f"<gml:LineString srsName=\"{srs}\"><gml:posList>"
                    f"{pos_list(g.coords)}</gml:posList></gml:LineString>")
        if isinstance(g, Polygon):
            rings = (f"<gml:exterior><gml:LinearRing><gml:posList>"
                     f"{pos_list(g.shell)}</gml:posList></gml:LinearRing>"
                     f"</gml:exterior>")
            for h in g.holes:
                rings += (f"<gml:interior><gml:LinearRing><gml:posList>"
                          f"{pos_list(h)}</gml:posList></gml:LinearRing>"
                          f"</gml:interior>")
            return f"<gml:Polygon srsName=\"{srs}\">{rings}</gml:Polygon>"
        if isinstance(g, MultiPoint):
            members = "".join(
                f"<gml:pointMember>{gml_geom(Point(c[0], c[1]))}</gml:pointMember>"
                for c in g.coords)
            return f"<gml:MultiPoint srsName=\"{srs}\">{members}</gml:MultiPoint>"
        if isinstance(g, MultiLineString):
            members = "".join(
                f"<gml:lineStringMember>{gml_geom(l)}</gml:lineStringMember>"
                for l in g.lines)
            return f"<gml:MultiLineString srsName=\"{srs}\">{members}</gml:MultiLineString>"
        if isinstance(g, MultiPolygon):
            members = "".join(
                f"<gml:polygonMember>{gml_geom(p)}</gml:polygonMember>"
                for p in g.polygons)
            return f"<gml:MultiPolygon srsName=\"{srs}\">{members}</gml:MultiPolygon>"
        raise ValueError(g)

    from ..geometry.types import Point as _Pt

    gname = batch.sft.default_geom
    x = y = None
    if batch.geoms is None and gname is not None:
        x, y = batch.geom_xy()
    for i in range(len(batch)):
        out.append("<gml:featureMember>")
        out.append(f"<geomesa:{name} gml:id={quoteattr(str(batch.ids[i]))}>")
        for a in batch.sft.attributes:
            if a.is_geometry:
                if a.name != gname:
                    continue
                g = batch.geoms.geometry(i) if batch.geoms is not None \
                    else _Pt(float(x[i]), float(y[i]))
                out.append(f"<geomesa:{a.name}>{gml_geom(g)}</geomesa:{a.name}>")
            elif a.name in batch.columns:
                v = batch.columns[a.name][i]
                if v is None:
                    continue
                if a.type == "date":
                    v = str(np.datetime64(int(v), "ms")) + "Z"
                out.append(f"<geomesa:{a.name}>{escape(str(v))}</geomesa:{a.name}>")
        out.append(f"</geomesa:{name}>")
        out.append("</gml:featureMember>")
    out.append("</gml:FeatureCollection>")
    return "\n".join(out)


_LEAFLET_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"/><title>{title}</title>
<link rel="stylesheet" href="https://unpkg.com/leaflet@1.9.4/dist/leaflet.css"/>
<script src="https://unpkg.com/leaflet@1.9.4/dist/leaflet.js"></script>
<style>html,body,#map{{height:100%;margin:0}}</style></head>
<body><div id="map"></div><script>
var map = L.map('map');
L.tileLayer('https://{{s}}.tile.openstreetmap.org/{{z}}/{{x}}/{{y}}.png',
  {{attribution: '&copy; OpenStreetMap contributors'}}).addTo(map);
var data = {geojson};
var layer = L.geoJSON(data, {{
  pointToLayer: function (f, latlng) {{
    return L.circleMarker(latlng, {{radius: 4}});
  }}
}}).addTo(map);
var b = layer.getBounds();
if (b.isValid()) {{ map.fitBounds(b); }} else {{ map.setView([0, 0], 2); }}
</script></body></html>
"""


def to_leaflet(batch: FeatureBatch, *, title: str | None = None) -> str:
    """Standalone Leaflet HTML map of the batch (the reference's
    LeafletMapExporter, tools/export/formats/LeafletMapExporter.scala, and
    the geomesa-jupyter Leaflet helper)."""
    from xml.sax.saxutils import escape

    # '<' must not appear raw inside the inline <script> (a string value
    # containing '</script>' would terminate the block / inject markup)
    geojson = to_geojson(batch).replace("<", "\\u003c")
    return _LEAFLET_PAGE.format(
        title=escape(title or batch.sft.name), geojson=geojson)


def to_shapefile(batch: FeatureBatch, path: str) -> None:
    """Write an ESRI shapefile trio (.shp/.shx/.dbf) — the export half of
    the reference's shp support (tools/export/formats/ShapefileExporter).

    Geometry types map to shape types 1 (point), 3 (polyline),
    5 (polygon), 8 (multipoint); one file holds ONE shape type (the
    format's rule), chosen from the first geometry.  Attributes land in
    the DBF as character/numeric fields (strings truncate at 254 bytes,
    the format's limit); ``path`` may omit the .shp suffix.
    """
    import struct

    from ..geometry.types import (
        LineString, MultiLineString, MultiPoint, Point, Polygon,
    )

    base = path[:-4] if path.endswith(".shp") else path
    n = len(batch)
    if batch.geoms is not None:
        geoms = [batch.geoms.geometry(i) for i in range(n)]
    else:  # point fast path: x/y columns
        gx, gy = batch.geom_xy()
        geoms = [Point(float(a), float(b)) for a, b in zip(gx, gy)]
    first = geoms[0] if geoms else Point(0, 0)
    if isinstance(first, Point):
        stype = 1
    elif isinstance(first, (LineString, MultiLineString)):
        stype = 3
    elif isinstance(first, Polygon):
        stype = 5
    elif isinstance(first, MultiPoint):
        stype = 8
    else:
        raise ValueError(f"unsupported shapefile geometry "
                         f"{first.geom_type}")

    def rec_body(g) -> bytes:
        if stype == 1:
            if not isinstance(g, Point):
                raise ValueError("mixed geometry types in one shapefile")
            return struct.pack("<idd", 1, g.x, g.y)
        if stype == 8:
            pts = g.coords
            env = g.envelope
            return (struct.pack("<i4di", 8, env.xmin, env.ymin,
                                env.xmax, env.ymax, len(pts))
                    + pts.astype("<f8").tobytes())
        # polyline / polygon: parts + points
        if stype == 3:
            rings = ([g.coords] if isinstance(g, LineString)
                     else [l.coords for l in g.lines])
        else:
            def closed(r):
                r = np.asarray(r, float)
                return (r if len(r) and np.array_equal(r[0], r[-1])
                        else np.vstack([r, r[:1]]))
            rings = [closed(g.shell)] + [closed(h) for h in g.holes]
        env = g.envelope
        parts, off = [], 0
        for r in rings:
            parts.append(off)
            off += len(r)
        pts = np.vstack(rings)
        return (struct.pack("<i4dii", stype, env.xmin, env.ymin,
                            env.xmax, env.ymax, len(rings), len(pts))
                + struct.pack(f"<{len(parts)}i", *parts)
                + pts.astype("<f8").tobytes())

    bodies = [rec_body(g) for g in geoms]
    if geoms:
        gxmin = min(g.envelope.xmin for g in geoms)
        gymin = min(g.envelope.ymin for g in geoms)
        gxmax = max(g.envelope.xmax for g in geoms)
        gymax = max(g.envelope.ymax for g in geoms)
    else:
        gxmin = gymin = gxmax = gymax = 0.0

    def header(file_words: int) -> bytes:
        return (struct.pack(">i5i i", 9994, 0, 0, 0, 0, 0, file_words)
                + struct.pack("<ii4d4d", 1000, stype,
                              gxmin, gymin, gxmax, gymax, 0, 0, 0, 0))

    shp_words = 50 + sum((8 + len(b)) // 2 for b in bodies)
    with open(base + ".shp", "wb") as f:
        f.write(header(shp_words))
        for i, b in enumerate(bodies):
            f.write(struct.pack(">ii", i + 1, len(b) // 2))
            f.write(b)
    with open(base + ".shx", "wb") as f:
        f.write(header(50 + 4 * len(bodies)))
        off = 50
        for b in bodies:
            f.write(struct.pack(">ii", off, len(b) // 2))
            off += (8 + len(b)) // 2

    # DBF: non-geometry attributes as C (string) / N (numeric) fields
    attrs = [a for a in batch.sft.attributes if not a.is_geometry]
    fields = []
    for a in attrs:
        col = batch.column(a.name)
        if a.type in ("int", "long", "date"):
            fields.append((a.name[:10], b"N", 19, 0, col))
        elif a.type in ("float", "double"):
            fields.append((a.name[:10], b"N", 24, 10, col))
        else:
            width = min(254, max([1] + [len(str(v)) for v in col]))
            fields.append((a.name[:10], b"C", width, 0, col))
    rec_len = 1 + sum(w for _, _, w, _, _ in fields)
    with open(base + ".dbf", "wb") as f:
        f.write(struct.pack("<B3BIHH20x", 3, 26, 7, 30, n,
                            32 + 32 * len(fields) + 1, rec_len))
        for name, kind, width, dec, _ in fields:
            f.write(struct.pack("<11s c IBB 14x",
                                name.encode("ascii", "replace"), kind,
                                0, width, dec))
        f.write(b"\r")
        for i in range(n):
            f.write(b" ")
            for name, kind, width, dec, col in fields:
                v = col[i]
                if kind == b"N":
                    s = (f"{float(v):.{dec}f}" if dec
                         else str(int(v))).rjust(width)[:width]
                else:
                    s = str(v if v is not None else "").ljust(width)[:width]
                f.write(s.encode("utf-8", "replace")[:width].ljust(width))
        f.write(b"\x1a")
