"""Port parity: the converter input formats (``io/formats.py``: XML,
fixed-width, Avro, JDBC, shapefile, OSM), the Avro container codec
(``io/avro.py``) and the GML and Leaflet exports, through
geomesa_tpu_torch against geomesa_tpu on the same inputs.

Case for case the JAX oracle ``tests/test_formats.py``: each format's
batch (ids, columns, packed geometries) and counters equal; GML and
Leaflet pages the same text; each package reads the other's Avro file,
and two files of one batch are the same bytes once the 16-byte sync
marker (random, ``os.urandom``) is masked."""

import sqlite3
import struct
import types
import xml.etree.ElementTree as ET

import numpy as np
import pytest

import geomesa_tpu.datastore as jds
import geomesa_tpu.features.batch as jbatch
import geomesa_tpu.features.feature_type as jft
import geomesa_tpu.filters.ast as jast
import geomesa_tpu.filters.evaluate as jeval
import geomesa_tpu.geometry.types as jtypes
import geomesa_tpu.io.avro as javro
import geomesa_tpu.io.converters as jconv
import geomesa_tpu.io.export as jexport
import geomesa_tpu.io.formats as jformats
import geomesa_tpu_torch.datastore as tds
import geomesa_tpu_torch.features.batch as tbatch
import geomesa_tpu_torch.features.feature_type as tft
import geomesa_tpu_torch.filters.ast as tast
import geomesa_tpu_torch.filters.evaluate as teval
import geomesa_tpu_torch.geometry.types as ttypes
import geomesa_tpu_torch.io.avro as tavro
import geomesa_tpu_torch.io.converters as tconv
import geomesa_tpu_torch.io.export as texport
import geomesa_tpu_torch.io.formats as tformats

from test_torch_io_converters import _same, _same_batch

J = types.SimpleNamespace(ft=jft, batch=jbatch, conv=jconv, formats=jformats,
                          avro=javro, types=jtypes, export=jexport)
T = types.SimpleNamespace(ft=tft, batch=tbatch, conv=tconv, formats=tformats,
                          avro=tavro, types=ttypes, export=texport)

OBS = "name:String,value:Int,dtg:Date,*geom:Point"

XML = """<doc>
  <feature station="A"><name>alpha</name><v>3</v>
    <pos><lon>1.5</lon><lat>50.5</lat></pos>
    <when>2018-01-01T00:00:00Z</when></feature>
  <feature station="B"><name>beta</name><v>4</v>
    <pos><lon>2.5</lon><lat>51.5</lat></pos>
    <when>2018-01-02T00:00:00Z</when></feature>
  <other><feature station="C"><name>gamma</name><v>5</v>
    <pos><lon>-2.5</lon><lat>-51.5</lat></pos>
    <when>2018-01-03T00:00:00Z</when></feature></other>
</doc>"""

OSM = """<osm version="0.6">
  <node id="101" lat="50.5" lon="1.5">
    <tag k="amenity" v="cafe"/><tag k="name" v="First"/></node>
  <node id="102" lat="51.5" lon="2.5">
    <tag k="name" v="Second"/><tag k="lat" v="clobber"/></node>
  <way id="7"><nd ref="101"/></way>
</osm>"""

CASES = {
    "xml": (OBS, {
        "type": "xml", "feature-path": "feature", "id-field": "$@station",
        "fields": [
            {"name": "name", "transform": "$name"},
            {"name": "value", "transform": "toint($v)"},
            {"name": "dtg", "transform": "isodate($when)"},
            {"name": "geom",
             "transform": "point(todouble($pos/lon), todouble($pos/lat))"}]},
        XML),
    "xml-no-fields": ("name:String,v:String", {"type": "xml"}, XML),
    "xml-bytes": (OBS, {
        "type": "xml", "feature-path": "feature",
        "fields": [{"name": "name", "transform": "$name"},
                   {"name": "geom", "transform":
                    "point(todouble($pos/lon), todouble($missing/lat))"}]},
        XML.encode()),
    "fixed-width": (OBS, {
        "type": "fixed-width",
        "fields": [
            {"name": "name", "start": 0, "width": 6},
            {"name": "value", "start": 6, "width": 3,
             "transform": "toint($value)"},
            {"name": "geom", "start": 0, "width": 0,
             "transform": "point(todouble($x), todouble($y))"},
            {"name": "x", "start": 10, "width": 4},
            {"name": "y", "start": 15, "width": 5}]},
        "alpha 003 1.50 50.50\nbeta  004 2.50 51.50\n"),
    "fixed-width-skip": (OBS, {
        "type": "fixed-width", "options": {"skip-lines": 1},
        "fields": [{"name": "name", "transform": "trim($0)"},
                   {"name": "value", "start": 6, "width": 3,
                    "transform": "toint($value)"}]},
        "header line\n\nalpha 003\nbeta  0x4\n"),
    "osm": ("name:String,amenity:String,*geom:Point", {
        "type": "osm", "id-field": "$id",
        "fields": [{"name": "name"}, {"name": "amenity"},
                   {"name": "geom", "transform": "point($lon, $lat)"}]},
        OSM),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_format_converter_matches_reference(case):
    spec, config, source = CASES[case]
    out = []
    for ns in (J, T):
        ec = ns.conv.EvaluationContext()
        batch = ns.conv.converter_from_config(
            ns.ft.parse_spec("obs", spec), config).convert(source, ec)
        out.append((batch, (ec.success, ec.failure, ec.errors)))
    (jb, jec), (tb, tec) = out
    _same_batch(tb, jb)
    assert tec == jec
    if case == "xml":
        assert list(tb.ids) == ["A", "B", "C"]
        np.testing.assert_allclose(tb.geom_xy()[0], [1.5, 2.5, -2.5])
    if case == "osm":
        assert list(tb.ids) == ["101", "102"]
        assert list(tb.column("name")) == ["First", "Second"]


def test_jdbc_converter_matches_reference(tmp_path):
    db = str(tmp_path / "obs.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE obs (name TEXT, value INT, t INT, x REAL, "
                 "y REAL)")
    conn.executemany("INSERT INTO obs VALUES (?,?,?,?,?)",
                     [("a", 1, 1000, 1.0, 10.0), ("b", 2, 2000, 2.0, 20.0),
                      ("c", None, 3000, 3.0, 30.0)])
    conn.commit()
    config = {
        "type": "jdbc",
        "query": "SELECT name, value, t, x, y FROM obs ORDER BY name",
        "fields": [
            {"name": "name"},
            {"name": "value", "transform": "toint($2)"},
            {"name": "dtg", "transform": "millistodate($t)"},
            {"name": "geom", "transform": "point(todouble($x), todouble($y))"}]}
    out = []
    for ns in (J, T):
        conv = ns.conv.converter_from_config(ns.ft.parse_spec("obs", OBS),
                                             config)
        assert conv.wants_path
        ec = ns.conv.EvaluationContext()
        # from a path, and from an open connection the caller keeps
        out.append((conv.convert(db, ec), conv.convert(conn),
                    (ec.success, ec.failure, ec.errors)))
    conn.close()
    for j, t in zip(*out):
        if isinstance(j, tuple):
            assert t == j
        else:
            _same_batch(t, j)
    assert out[1][2][:2] == (2, 1)


def _write_test_shapefile(path, geoms_points, dbf_rows):
    """A hand-rolled point .shp and its .dbf (test_formats.py's)."""
    recs = b""
    for i, (x, y) in enumerate(geoms_points):
        content = struct.pack("<i", 1) + struct.pack("<dd", x, y)
        recs += struct.pack(">ii", i + 1, len(content) // 2) + content
    total_words = (100 + len(recs)) // 2
    hdr = struct.pack(">i", 9994) + b"\x00" * 20 + struct.pack(
        ">i", total_words)
    hdr += struct.pack("<ii", 1000, 1)
    hdr += struct.pack("<8d", 0, 0, 0, 0, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(hdr + recs)
    fields = [("name", "C", 8, 0), ("v", "N", 4, 0), ("f", "N", 6, 2),
              ("ok", "L", 1, 0)]
    hdr_size = 32 + 32 * len(fields) + 1
    rec_size = 1 + 8 + 4 + 6 + 1
    out = bytearray()
    out += bytes([3, 118, 1, 1]) + struct.pack("<ihh", len(dbf_rows),
                                               hdr_size, rec_size)
    out += b"\x00" * 20
    for name, t, ln, dec in fields:
        out += name.encode().ljust(11, b"\x00") + t.encode()
        out += b"\x00" * 4 + bytes([ln, dec]) + b"\x00" * 14
    out += b"\x0d"
    for name, v, f, ok in dbf_rows:
        out += (b" " + name.encode().ljust(8)[:8] + str(v).rjust(4).encode()
                + f.rjust(6).encode() + ok.encode())
    with open(str(path)[:-4] + ".dbf", "wb") as f:
        f.write(bytes(out))


def test_shapefile_reader_and_converter_match_reference(tmp_path):
    shp = str(tmp_path / "pts.shp")
    _write_test_shapefile(shp, [(1.0, 10.0), (2.0, 20.0), (3.0, 30.0)],
                          [("a", 1, "1.50", "T"), ("b", "", "******", "N"),
                           ("c", "x", "", "y")])
    tg, ta = tformats.read_shapefile(shp)
    jg, ja = jformats.read_shapefile(shp)
    assert [repr(g) for g in tg] == [repr(g) for g in jg]
    assert sorted(ta) == sorted(ja)
    for k in ja:
        _same(ta[k], ja[k])
    assert list(ta["name"]) == ["a", "b", "c"] and list(ta["v"])[0] == 1
    config = {"type": "shp",
              "fields": [{"name": "name"},
                         {"name": "v", "transform": "toint($v)"},
                         {"name": "geom", "transform": "$geometry"}]}
    out = [ns.conv.converter_from_config(
        ns.ft.parse_spec("pts", "name:String,v:Int,*geom:Point"),
        config).convert(shp) for ns in (J, T)]
    _same_batch(out[1], out[0])
    with open(tmp_path / "not.shp", "wb") as f:
        f.write(b"\x00" * 100)
    for ns in (J, T):
        with pytest.raises(ValueError, match="not a shapefile"):
            ns.formats.read_shapefile(str(tmp_path / "not.shp"))


def test_shapefile_null_shapes_match_reference(tmp_path):
    def rec(num, content):
        return struct.pack(">ii", num, len(content) // 2) + content

    body = (rec(1, struct.pack("<i dd", 1, 3.0, 4.0))
            + rec(2, struct.pack("<i", 0))
            + rec(3, struct.pack("<i dd", 1, 5.0, 6.0)))
    header = struct.pack(">i", 9994) + b"\x00" * 20 + struct.pack(
        ">i", (100 + len(body)) // 2) + struct.pack("<ii", 1000, 1) \
        + b"\x00" * 64
    path = tmp_path / "t.shp"
    path.write_bytes(header + body)
    out = []
    for ns in (J, T):
        conv = ns.formats.ShapefileConverter(
            ns.ft.parse_spec("shp", "*geom:Point"),
            {"type": "shp",
             "fields": [{"name": "geom", "transform": "$geometry"}]})
        out.append(conv.convert(str(path)))
    _same_batch(out[1], out[0])
    np.testing.assert_allclose(out[1].geom_xy()[0], [3.0, 5.0])


# -- Avro --------------------------------------------------------------------

AVRO_SPEC = ("name:String,value:Int,big:Long,f:Float,d:Double,ok:Bool,"
             "dtg:Date,*geom:Point")


def _avro_batch(ns):
    return ns.batch.FeatureBatch.from_dict(
        ns.ft.parse_spec("obs", AVRO_SPEC), {
            "name": np.array(["a", None, "ünï"], dtype=object),
            "value": np.array([1, -2, 3], dtype=np.int32),
            "big": np.array([1 << 40, -(1 << 50), 0], dtype=np.int64),
            "f": np.array([1.5, np.nan, -2.25], dtype=np.float32),
            "d": np.array([0.1, -1e300, np.nan]),
            "ok": np.array([True, False, True]),
            "dtg": np.array([1000, 2000, -5], dtype=np.int64),
            "geom": (np.array([1.0, 2.0, -179.5]),
                     np.array([10.0, 20.0, 89.5]))},
        ids=["f1", "f2", "f3"])


def _poly_avro_batch(ns):
    t = ns.types
    return ns.batch.FeatureBatch.from_dict(
        ns.ft.parse_spec("areas", "name:String,*geom:Polygon"),
        {"name": np.array(["p", "q"], dtype=object),
         "geom": [t.Polygon([(0, 0), (4, 0), (4, 4), (0, 0)]),
                  t.Polygon([(1, 1), (2, 1), (2, 2), (1, 1)])]},
        ids=["a1", "a2"])


def _masked(raw: bytes) -> bytes:
    """The file with its sync marker (its last 16 bytes, also written
    after the header) zeroed."""
    return raw.replace(raw[-16:], b"\x00" * 16)


@pytest.mark.parametrize("make", [_avro_batch, _poly_avro_batch],
                         ids=["points", "polygons"])
def test_avro_files_cross_read_and_bytes_equal(make, tmp_path):
    tp, jp = str(tmp_path / "t.avro"), str(tmp_path / "j.avro")
    tb, jb = make(T), make(J)
    tavro.to_avro(tb, tp)
    javro.to_avro(jb, jp)
    traw, jraw = open(tp, "rb").read(), open(jp, "rb").read()
    assert traw != jraw        # each file has its own random sync marker
    assert _masked(traw) == _masked(jraw)
    assert tavro.avro_schema(tb.sft) == javro.avro_schema(jb.sft)
    # each package reads the other's file as it reads its own
    _same_batch(tavro.from_avro(jp, tb.sft), javro.from_avro(jp, jb.sft))
    _same_batch(tavro.from_avro(traw, tb.sft), javro.from_avro(tp, jb.sft))
    with open(jp, "rb") as f:
        _same_batch(tavro.from_avro(f, tb.sft), javro.from_avro(jraw, jb.sft))
    # the streaming codec's record bytes
    attrs = {"name": "x", "value": 7, "geom": (1.0, 2.0), "d": None}
    trec = tavro.encode_record(tb.sft, "id", attrs)
    assert trec == javro.encode_record(jb.sft, "id", attrs)
    assert repr(tavro.decode_record(tb.sft, trec)) == \
        repr(javro.decode_record(jb.sft, trec))


def test_avro_rejects_bad_files_alike(tmp_path):
    sft = {"jax": jft.parse_spec("obs", AVRO_SPEC),
           "port": tft.parse_spec("obs", AVRO_SPEC)}
    good = tmp_path / "g.avro"
    tavro.to_avro(_avro_batch(T), str(good))
    raw = good.read_bytes()
    for bad in (b"nope" + raw[4:], raw[:-1] + bytes([raw[-1] ^ 1]),
                raw.replace(b"avro.codec\x08null", b"avro.codec\x08zstd")):
        errs = []
        for key, mod in (("jax", javro), ("port", tavro)):
            with pytest.raises(ValueError) as e:
                mod.from_avro(bad, sft[key])
            errs.append(str(e.value))
        assert errs[0] == errs[1]


@pytest.mark.parametrize("fields", [False, True], ids=["whole", "fields"])
def test_avro_converter_matches_reference(fields, tmp_path):
    path = str(tmp_path / "obs.avro")
    javro.to_avro(_avro_batch(J), path)
    config = {"type": "avro"}
    if fields:
        config.update({"id-field": "concat('x-', $id)", "fields": [
            {"name": "name", "transform": "$name"},
            {"name": "value", "transform": "add($value, 1)"},
            {"name": "geom", "transform": "$geom"}]})
    out = []
    for ns in (J, T):
        ec = ns.conv.EvaluationContext()
        batch = ns.conv.converter_from_config(
            ns.ft.parse_spec("obs", AVRO_SPEC), config).convert(path, ec)
        out.append((batch, (ec.success, ec.failure, ec.errors)))
    _same_batch(out[1][0], out[0][0])
    assert out[1][1] == out[0][1] and out[1][1][0] == 3


# -- GML and Leaflet -----------------------------------------------------------

def _obs_batch(ns):
    return ns.batch.FeatureBatch.from_dict(ns.ft.parse_spec("obs", OBS), {
        "name": np.array(["a", "<b>", None], dtype=object),
        "value": np.array([1, 2, 3], dtype=np.int32),
        "dtg": np.array([1000, 2000, 3000], dtype=np.int64),
        "geom": (np.array([1.0, 2.0, 1 / 3]), np.array([10.0, 20.0, -5.5]))},
        ids=["f1", "f2", "f&3"])


def _shapes_batch(ns):
    t = ns.types
    shell = np.array([[0, 0], [4, 0], [4, 4], [0, 4], [0, 0]], dtype=float)
    hole = np.array([[1, 1], [2, 1], [2, 2], [1, 2], [1, 1]], dtype=float)
    line = np.array([(0.0, 0.0), (1.0, 2.0)])
    geoms = [t.Polygon(shell, (hole,)), t.LineString(line),
             t.MultiPoint(np.array([(0.0, 0.0), (1.0, 2.0)])),
             t.MultiLineString((t.LineString(line), t.LineString(line + 1))),
             t.MultiPolygon((t.Polygon(shell), t.Polygon(hole))),
             t.Point(3.0, 4.0)]
    return ns.batch.FeatureBatch.from_dict(
        ns.ft.parse_spec("shapes", "name:String,*geom:Geometry"),
        {"name": np.array(list("abcdef"), dtype=object), "geom": geoms})


@pytest.mark.parametrize("make", [_obs_batch, _shapes_batch],
                         ids=["points", "shapes"])
def test_gml_and_leaflet_equal_reference(make):
    tb, jb = make(T), make(J)
    gml = texport.to_gml(tb)
    assert gml == jexport.to_gml(jb)
    assert texport.to_gml(tb, srs="EPSG:3857") == \
        jexport.to_gml(jb, srs="EPSG:3857")
    root = ET.fromstring(gml)   # well-formed
    ns = {"gml": "http://www.opengis.net/gml",
          "geomesa": "http://geomesa.org"}
    members = root.findall("gml:featureMember", ns)
    assert len(members) == len(tb)
    html = texport.to_leaflet(tb)
    assert html == jexport.to_leaflet(jb)
    assert texport.to_leaflet(tb, title="a <t>") == \
        jexport.to_leaflet(jb, title="a <t>")
    assert "leaflet" in html and '"FeatureCollection"' in html
    if make is _obs_batch:
        assert members[0].find(".//gml:pos", ns).text == "1 10"
        assert members[1].find(".//geomesa:name", ns).text == "<b>"
        assert "</script>" not in html.split("var data = ")[1].split(
            ";\n")[0]


def test_in_filter_mixed_type_values_alike():
    """test_formats.py's mixed-type IN list, in both packages."""
    masks = []
    for ds_mod, ast_mod, ev in ((jds, jast, jeval), (tds, tast, teval)):
        ds = (ds_mod.TpuDataStore() if ds_mod is jds
              else ds_mod.TpuDataStore(device="cpu"))
        ds.create_schema("mix", "v:Int,*geom:Point")
        ds.write("mix", {"v": np.arange(10),
                         "geom": (np.zeros(10), np.zeros(10))})
        masks.append(ev.evaluate_filter(ast_mod.In("v", (1, 2, 3, 4, "a")),
                                        ds._store("mix").batch))
    np.testing.assert_array_equal(masks[1], masks[0])
    assert masks[1].sum() == 4 and masks[1][1] and masks[1][4]
