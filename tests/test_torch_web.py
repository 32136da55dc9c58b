"""Port parity: the REST front end (``geomesa_tpu_torch/web/``) against
geomesa_tpu's ``web/`` — every case of ``tests/test_web.py`` and the
``/query``, ``/api/data`` and ``/explain`` hardening of
``test_zz_arrow_stream.py``, the SLO routes of ``test_zz_slo.py`` and the
bounded server of ``test_zz_resilience.py``, each run through a JAX
``WebApp`` and a port ``WebApp`` over stores holding the same seeded rows
(the port's on ``device="cpu"``).

Held equal: status lines, ``Content-Type``, the presence of
``Content-Length`` and ``Retry-After``, and the bodies byte for byte
(GeoJSON, CSV and GML exports, schema and stats JSON, Arrow IPC streams,
PNG tiles, WCS XML and ``npy`` mosaics) — except where a body carries
times or trace ids (audit events, metric dumps, traces, SLO reports),
where the keys and every field not a time are compared.  Float grids are
equal (unit weights); the JSON grids are compared with ``rtol=1e-5`` as
``tests/test_pallas_kernels.py`` does where a weighted sum could round
apart.  The observability routes (``/metrics.prom``, ``/traces``,
``/debug/*``, ``/explain``, ``/tiles``) are in
``test_torch_web_obs.py``.
"""

import gc
import io
import json
from urllib.parse import quote

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")

from geomesa_tpu import config as jcfg  # noqa: E402
from geomesa_tpu.audit import InMemoryAuditWriter as JAudit  # noqa: E402
from geomesa_tpu.blob import GeoIndexedBlobStore as JBlob  # noqa: E402
from geomesa_tpu.datastore import TpuDataStore as JStore  # noqa: E402
from geomesa_tpu.metrics import registry as jregistry  # noqa: E402
from geomesa_tpu.obs import slo_plane as jslo  # noqa: E402
from geomesa_tpu.raster import RasterStore as JRaster  # noqa: E402
from geomesa_tpu.resilience import admission_gate as jgate  # noqa: E402
from geomesa_tpu.resilience.faults import FaultInjected as JFault  # noqa: E402
from geomesa_tpu.security import StaticAuthorizationsProvider as JAuth  # noqa: E402
from geomesa_tpu.web import WebApp as JWeb  # noqa: E402
from geomesa_tpu.web import wsgi as jwsgi  # noqa: E402
from geomesa_tpu_torch import config as tcfg  # noqa: E402
from geomesa_tpu_torch.audit import InMemoryAuditWriter as TAudit  # noqa: E402
from geomesa_tpu_torch.blob import GeoIndexedBlobStore as TBlob  # noqa: E402
from geomesa_tpu_torch.datastore import TpuDataStore as TStore  # noqa: E402
from geomesa_tpu_torch.metrics import registry as tregistry  # noqa: E402
from geomesa_tpu_torch.obs import slo_plane as tslo  # noqa: E402
from geomesa_tpu_torch.raster import RasterStore as TRaster  # noqa: E402
from geomesa_tpu_torch.resilience import admission_gate as tgate  # noqa: E402
from geomesa_tpu_torch.resilience.faults import FaultInjected as TFault  # noqa: E402
from geomesa_tpu_torch.security import StaticAuthorizationsProvider as TAuth  # noqa: E402
from geomesa_tpu_torch.web import WebApp as TWeb  # noqa: E402
from geomesa_tpu_torch.web import wsgi as twsgi  # noqa: E402

MS_2018 = 1514764800000
DAY = 86_400_000
SPEC = "name:String:index=true,age:Int,dtg:Date,*geom:Point"
BBOX = "BBOX(geom,-10,40,0,50)"
ECQL = ("BBOX(geom,-8,41,2,49) AND dtg DURING "
        "2018-01-02T00:00:00Z/2018-01-06T00:00:00Z")


def _rows(n=200, seed=7):
    rng = np.random.default_rng(seed)
    return {
        "name": np.asarray([f"n{i % 5}" for i in range(n)], dtype=object),
        "age": rng.integers(0, 90, n),
        "dtg": rng.integers(MS_2018, MS_2018 + 7 * DAY, n),
        "geom": (rng.uniform(-10, 10, n), rng.uniform(40, 50, n)),
    }


def _set(name, value):
    jcfg.set_property(name, value)
    tcfg.set_property(name, value)


def _clear(name):
    jcfg.clear_property(name)
    tcfg.clear_property(name)


def call(app, method, path, body=None, headers=None):
    """Invoke a WSGI app directly: ``(status, headers, raw body)``."""
    raw = (body if isinstance(body, bytes)
           else json.dumps(body).encode() if body is not None else b"")
    cap = {}

    def start_response(status, hdrs):
        cap["status"] = int(status.split()[0])
        cap["headers"] = dict(hdrs)

    qs = ""
    if "?" in path:
        path, qs = path.split("?", 1)
    environ = {"REQUEST_METHOD": method, "PATH_INFO": path,
               "QUERY_STRING": qs, "CONTENT_LENGTH": str(len(raw)),
               "wsgi.input": io.BytesIO(raw)}
    environ.update(headers or {})
    out = b"".join(app(environ, start_response))
    return cap["status"], cap["headers"], out


def parsed(resp):
    status, headers, out = resp
    ctype = headers.get("Content-Type", "")
    return status, (json.loads(out) if "json" in ctype and out
                    else out.decode() if ctype.startswith("text") else out)


def same(jr, tr, body=True):
    """Equal status, content type, length/retry headers, and (unless
    ``body`` is False) equal bytes."""
    assert tr[0] == jr[0], (tr, jr)
    for h in ("Content-Type", "Retry-After"):
        assert tr[1].get(h) == jr[1].get(h), h
    assert ("Content-Length" in tr[1]) == ("Content-Length" in jr[1])
    if body:
        assert tr[2] == jr[2], (tr[2][:400], jr[2][:400])
    return jr


class Pair:
    """One JAX and one port WebApp over the same requests."""

    def __init__(self, japp, tapp):
        self.j, self.t = japp, tapp

    def both(self, method, path, body=None, headers=None):
        return (call(self.j, method, path, body, headers),
                call(self.t, method, path, body, headers))

    def same(self, method, path, body=None, headers=None, check_body=True):
        jr, tr = self.both(method, path, body, headers)
        same(jr, tr, check_body)
        return jr, tr


def _pts_pair(**kw):
    ja, ta = JAudit(), TAudit()
    jds = JStore(audit_writer=ja, user="tester")
    tds = TStore(device="cpu", audit_writer=ta, user="tester")
    for ds in (jds, tds):
        ds.create_schema("pts", SPEC)
        ds.write("pts", _rows())
    return Pair(JWeb(jds, audit_writer=ja, **kw.get("j", {})),
                TWeb(tds, audit_writer=ta, **kw.get("t", {})))


@pytest.fixture
def app():
    return _pts_pair()


# -- tests/test_web.py -------------------------------------------------------

@pytest.mark.parametrize("path", ["/api/version", "/api/schemas",
                                  "/api/schemas/pts", "/api/schemas/nope"])
def test_version_and_schemas(app, path):
    jr, _ = app.same("GET", path)
    status, body = parsed(jr)
    if path == "/api/version":
        assert status == 200 and body["framework"] == "geomesa-tpu"
    elif path == "/api/schemas":
        assert body == ["pts"]
    elif path == "/api/schemas/pts":
        assert body["dtg"] == "dtg"
        assert any(a["default"] for a in body["attributes"])
    else:
        assert status == 404


def test_schema_create_delete(app):
    spec = {"name": "t2", "spec": "a:Int,*geom:Point"}
    assert parsed(app.same("POST", "/api/schemas", spec)[0])[0] == 201
    assert parsed(app.same("POST", "/api/schemas", spec)[0])[0] == 400
    assert parsed(app.same("DELETE", "/api/schemas/t2")[0])[0] == 204
    assert parsed(app.same("GET", "/api/schemas")[0])[1] == ["pts"]


@pytest.mark.parametrize("path,status", [
    (f"/api/data/pts?cql={BBOX}", 200),
    (f"/api/data/pts?cql={quote(ECQL)}", 200),
    ("/api/data/pts?format=csv&max=5", 200),
    (f"/api/data/pts?cql={BBOX}&format=gml", 200),
    (f"/api/data/pts?cql={quote(ECQL)}&format=csv", 200),
    ("/api/data/pts?format=nope", 400),
    ("/api/data/missing", 404),
    ("/api/data/pts?cql=name%20LIKE", 400),
    ("/api/data/pts?cql=%3D%3D%3D", 400),
])
def test_data_query(app, path, status):
    jr, _ = app.same("GET", path)
    assert jr[0] == status
    if "format=csv&max=5" in path:
        assert len(jr[2].decode().strip().splitlines()) == 6
    elif status == 200 and "format" not in path:
        body = json.loads(jr[2])
        assert body["type"] == "FeatureCollection"
        assert 0 < len(body["features"]) < 200
    elif status == 400 and "cql" in path:
        assert b"parse error" in jr[2].lower()


def test_data_ingest(app):
    fc = {"type": "FeatureCollection", "features": [
        {"type": "Feature", "id": f"new{i}",
         "geometry": {"type": "Point", "coordinates": [100.0 + i, 0.5]},
         "properties": {"name": "added", "age": 33, "dtg": MS_2018}}
        for i in range(3)]}
    jr, _ = app.same("POST", "/api/data/pts", fc)
    assert parsed(jr)[1]["ingested"] == 3
    jr, _ = app.same("GET", "/api/data/pts?cql=name='added'")
    assert {f["id"] for f in parsed(jr)[1]["features"]} == \
        {"new0", "new1", "new2"}
    # a collection without ids takes the stores' next auto ids
    fc2 = {"type": "FeatureCollection", "features": [
        {"type": "Feature",
         "geometry": {"type": "Point", "coordinates": [5.0, 45.0]},
         "properties": {"name": "auto", "age": 1, "dtg": MS_2018}}]}
    app.same("POST", "/api/data/pts", fc2)
    app.same("GET", "/api/data/pts?cql=name='auto'")
    assert parsed(app.same("POST", "/api/data/pts", {"x": 1})[0])[0] == 400


@pytest.mark.parametrize("path,status", [
    ("/api/stats/pts/count", 200),
    (f"/api/stats/pts/count?cql={BBOX}", 200),
    ("/api/stats/pts/bounds", 200),
    ("/api/stats/pts/minmax?attribute=age", 200),
    ("/api/stats/pts/minmax?attribute=dtg", 200),
    ("/api/stats/pts/histogram?attribute=age&bins=10", 200),
    ("/api/stats/pts/topk?attribute=name", 200),
    ("/api/stats/pts/topk?attribute=age", 404),
    ("/api/stats/pts/minmax", 400),
    ("/api/stats/pts/nope?attribute=age", 404),
])
def test_stats_endpoints(app, path, status):
    jr, _ = app.same("GET", path)
    assert jr[0] == status
    body = parsed(jr)[1]
    if path == "/api/stats/pts/count":
        assert body["count"] == 200
    elif "count?cql" in path:
        assert 0 < body["count"] < 200
    elif "bounds" in path:
        b = body["bounds"]
        assert -10 <= b["minx"] <= b["maxx"] <= 10
    elif "minmax?attribute=age" in path:
        assert 0 <= body["bounds"][0] <= body["bounds"][1] < 90
    elif "histogram" in path:
        assert sum(body["counts"]) == 200


def _audit_view(events):
    return [{k: v for k, v in e.items()
             if k not in ("date", "timestamp", "plan_time_ms", "scan_time_ms",
                          "trace_id")} for e in events]


def test_audit_and_metrics(app):
    app.same("GET", f"/api/data/pts?cql={BBOX}")
    jr, tr = app.same("GET", "/api/audit/pts", check_body=False)
    je, te = parsed(jr)[1], parsed(tr)[1]
    assert len(je) >= 1 and je[-1]["user"] == "tester"
    assert je[-1]["hits"] > 0
    assert _audit_view(te) == _audit_view(je)
    assert all(e["trace_id"] for e in te)
    jr, tr = app.same("GET", "/api/audit/pts?since=notafloat")
    assert jr[0] == 400
    jr, tr = app.same("GET", "/api/metrics", check_body=False)
    jsnap, tsnap = parsed(jr)[1], parsed(tr)[1]
    web = sorted(k for k in jsnap if k.startswith("web."))
    assert web and sorted(k for k in tsnap if k.startswith("web.")) == web
    # an app with no queryable audit writer answers 404 in both
    pair = Pair(JWeb(JStore()), TWeb(TStore(device="cpu")))
    assert pair.same("GET", "/api/audit/pts")[0][0] == 404


@pytest.mark.parametrize("method,path", [
    ("GET", "/api/nope"), ("GET", "/"), ("PUT", "/api/schemas"),
    ("PUT", "/api/schemas/pts"), ("DELETE", "/api/data/pts"),
    ("POST", "/api/stats/pts/count"), ("POST", "/api/audit/pts"),
])
def test_unknown_route(app, method, path):
    jr, _ = app.same(method, path)
    assert jr[0] in (404, 405)


@pytest.mark.parametrize("path,status", [
    ("/api/data/pts?max=abc", 400),
    ("/api/stats/pts/histogram?attribute=age&bins=x", 400),
    ("/api/audit/pts?since=notafloat", 400),
    ("/api/stats/pts/histogram?attribute=name", 400),
    ("/api/stats/pts/histogram?attribute=nope", 404),
])
def test_bad_params_return_400(app, path, status):
    assert app.same("GET", path)[0][0] == status


def _vis_pair():
    stores = []
    for cls, auth in ((JStore, JAuth), (TStore, TAuth)):
        kw = {} if cls is JStore else {"device": "cpu"}
        ds = cls(auth_provider=auth(["user"]), **kw)
        ds.create_schema("v", "age:Int,dtg:Date,*geom:Point")
        ds.write("v", {"age": np.asarray([10, 20]), "dtg": np.asarray([0, 0]),
                       "geom": (np.zeros(2), np.zeros(2))}, visibility="user")
        ds.write("v", {"age": np.asarray([1000]), "dtg": np.asarray([0]),
                       "geom": (np.zeros(1), np.zeros(1))},
                 visibility="admin")
        stores.append(ds)
    return Pair(JWeb(stores[0]), TWeb(stores[1]))


@pytest.mark.parametrize("path", [
    "/api/stats/v/histogram?attribute=age&bins=4",
    "/api/stats/v/count", "/api/stats/v/minmax?attribute=age",
    "/api/data/v?format=csv"])
def test_histogram_respects_visibility(path):
    pair = _vis_pair()
    jr, _ = pair.same("GET", path)
    assert jr[0] == 200
    if "histogram" in path:
        body = parsed(jr)[1]
        assert sum(body["counts"]) == 2 and body["hi"] <= 20.0


def test_blob_rest_roundtrip(tmp_path):
    pair = Pair(JWeb(JStore(), blob=JBlob(blob_dir=str(tmp_path / "jb"))),
                TWeb(TStore(device="cpu"),
                     blob=TBlob(TStore(device="cpu"),
                                blob_dir=str(tmp_path / "tb"))))
    post = "/api/blob?wkt=POINT%20(10%2020)&filename=f.bin&dtg=0"
    jr, tr = pair.same("POST", post, b"\x01payload", check_body=False)
    assert jr[0] == 201
    jid, tid = json.loads(jr[2])["id"], json.loads(tr[2])["id"]
    jr, tr = pair.both("GET", f"/api/blob/{jid}")
    jr2, tr2 = pair.both("GET", f"/api/blob/{tid}")
    same(jr, tr2)
    assert jr[2] == b"\x01payload"
    assert jr[1]["Content-Type"] == "application/octet-stream"
    assert tr[0] == jr2[0] == 404        # each store holds only its own id
    jq, tq = pair.both("GET", "/api/blob?cql=BBOX(geom,5,15,15,25)")
    same(jq, tq, body=False)
    assert json.loads(jq[2])["ids"] == [jid]
    assert json.loads(tq[2])["ids"] == [tid]
    jq, tq = pair.same("GET", "/api/blob?cql=BBOX(geom,50,15,55,25)")
    assert json.loads(jq[2])["ids"] == []
    assert call(pair.j, "DELETE", f"/api/blob/{jid}")[0] == 204
    assert call(pair.t, "DELETE", f"/api/blob/{tid}")[0] == 204
    jr, tr = (call(pair.j, "GET", f"/api/blob/{jid}"),
              call(pair.t, "GET", f"/api/blob/{tid}"))
    same(jr, tr, body=False)            # the bodies name each store's id
    assert jr[0] == 404
    for method, path, body in (("POST", "/api/blob?wkt=POINT%20(1%202)",
                                b""),
                               ("POST", "/api/blob", b"x"),
                               ("PUT", "/api/blob", b""),
                               ("PUT", "/api/blob/abc", b"")):
        assert pair.same(method, path, body)[0][0] in (400, 405)
    # no blob store configured: 404 in both
    bare = Pair(JWeb(JStore()), TWeb(TStore(device="cpu")))
    assert bare.same("GET", "/api/blob")[0][0] == 404


def test_attribute_level_visibility():
    got = []
    for cls, auth in ((JStore, JAuth), (TStore, TAuth)):
        kw = {} if cls is JStore else {"device": "cpu"}
        ds = cls(auth_provider=auth(["user"]), **kw)
        ds.create_schema("av", "name:String,ssn:String,dtg:Date,*geom:Point")
        ds.write("av", {"name": np.asarray(["a", "b"], dtype=object),
                        "ssn": np.asarray(["111", "222"], dtype=object),
                        "dtg": np.zeros(2, np.int64),
                        "geom": (np.zeros(2), np.zeros(2))},
                 attribute_visibilities={"ssn": "admin"})
        web = (JWeb if cls is JStore else TWeb)(ds)
        low = call(web, "GET", "/api/data/av?format=csv")
        q = ds.query("av")
        ds._auth_provider = auth(["admin"])
        high = call(web, "GET", "/api/data/av?format=csv")
        got.append((list(q.column("name")), list(q.column("ssn")),
                    list(ds.query("av").column("ssn")), low, high))
    (jn, js, jh, jlow, jhigh), (tn, ts, th, tlow, thigh) = got
    assert jn == tn == ["a", "b"]
    assert js == ts == [None, None]       # guarded attribute nulled
    assert jh == th == ["111", "222"]     # privileged caller sees values
    same(jlow, tlow)
    same(jhigh, thigh)
    assert b"111" not in tlow[2] and b"111" in thigh[2]


def _wcs_pair():
    stores = []
    for cls, kw in ((JRaster, {}), (TRaster, {"device": "cpu"})):
        rs = cls("dem", **kw)
        rs.put(np.arange(64, dtype=np.float64).reshape(8, 8), (0, 0, 8, 8))
        rs.put(np.ones((8, 8)) * 5.0, (8, 0, 16, 8))
        stores.append(rs)
    return Pair(JWeb(JStore(), raster={"dem": stores[0]}),
                TWeb(TStore(device="cpu"), raster={"dem": stores[1]}))


@pytest.mark.parametrize("path,status", [
    ("/wcs?request=GetCapabilities", 200),
    ("/wcs", 200),
    ("/wcs?request=DescribeCoverage&coverage=dem", 200),
    ("/wcs?request=GetCoverage&coverage=dem&bbox=0,0,16,8&width=16"
     "&height=8&format=png", 200),
    ("/wcs?request=GetCoverage&coverage=dem&bbox=0,0,16,8&width=16"
     "&height=8&format=npy", 200),
    ("/wcs?request=GetCoverage&coverage=dem&bbox=-4,-2,20,10&width=48"
     "&height=24&format=npy", 200),
    ("/wcs?request=GetCoverage&width=32&height=16&format=arraybuffer", 200),
    ("/wcs?request=GetCoverage&coverage=dem&format=tiff", 400),
    ("/wcs?request=Frobnicate&coverage=dem", 400),
    ("/wcs?request=GetCoverage&coverage=nope", 404),
    ("/wcs?request=GetCoverage&coverage=dem&width=x", 400),
])
def test_wcs_endpoints(path, status):
    pair = _wcs_pair()
    jr, tr = pair.same("GET", path)
    assert jr[0] == status
    if "GetCapabilities" in path:
        assert b"<name>dem</name>" in jr[2]
    if "DescribeCoverage" in path:
        assert b"lonLatEnvelope" in jr[2] and b"resolutions" in jr[2]
    if "format=png" in path:
        assert jr[1]["Content-Type"] == "image/png"
        assert jr[2].startswith(b"\x89PNG")
    if "bbox=0,0,16,8" in path and "npy" in path:
        grid = np.load(io.BytesIO(tr[2]))
        assert grid.shape == (8, 16)
        np.testing.assert_allclose(grid[:, 8:], 5.0)


def test_wcs_without_coverages_is_404():
    pair = Pair(JWeb(JStore()), TWeb(TStore(device="cpu")))
    assert pair.same("GET", "/wcs?request=GetCapabilities")[0][0] == 404


# -- /query, /api/data and /explain hardening (test_zz_arrow_stream.py) ------

ARROW_ROWS = 6000


@pytest.fixture(scope="module")
def evt():
    rng = np.random.default_rng(11)
    rows = {"name": np.array(["ais", "gdelt", "osm"], dtype=object)[
                rng.integers(0, 3, ARROW_ROWS)],
            "score": rng.uniform(0, 100, ARROW_ROWS),
            "dtg": rng.integers(MS_2018, MS_2018 + 14 * DAY, ARROW_ROWS),
            "geom": (rng.uniform(-75, -73, ARROW_ROWS),
                     rng.uniform(40, 42, ARROW_ROWS))}
    jds, tds = JStore(user="arrow-test"), TStore(device="cpu",
                                                  user="arrow-test")
    for ds in (jds, tds):
        ds.create_schema("evt", "name:String,score:Double,dtg:Date,"
                                "*geom:Point")
        ds.write("evt", rows)
    return Pair(JWeb(jds), TWeb(tds))


EVT_Q = quote("BBOX(geom,-74.5,40.5,-73.5,41.5) AND dtg DURING "
              "2018-01-02T00:00:00Z/2018-01-09T00:00:00Z")


@pytest.mark.parametrize("qs", [
    f"schema=evt&cql={EVT_Q}&chunk_rows=512",
    f"schema=evt&cql={EVT_Q}",
    "schema=evt&dicts=name&chunk_rows=65536",
    "schema=evt&dicts=none&chunk_rows=65536",
    "schema=evt&cql=BBOX(geom,-74.5,40.5,-73.5,41.5)&max=100",
    "schema=evt&timeout_ms=60000",
    "schema=evt&cql=BBOX(geom,10,10,11,11)",
])
def test_query_endpoint_streams_arrow(evt, qs):
    jr, tr = evt.same("GET", f"/query?{qs}")
    assert jr[0] == 200
    assert jr[1]["Content-Type"] == "application/vnd.apache.arrow.stream"
    assert "Content-Length" not in tr[1]        # chunked: length unknown
    table = pa.ipc.open_stream(io.BytesIO(tr[2])).read_all()
    if "dicts=name" in qs:
        assert isinstance(table.schema.field("name").type, pa.DictionaryType)
    if "dicts=none" in qs:
        assert table.schema.field("name").type == pa.utf8()
    if "max=100" in qs:
        assert table.num_rows == 100


def test_query_endpoint_stream_buffer_cap(evt):
    """With a tiny flush threshold the body is produced in many chunks,
    one a batch, in both packages."""
    _set("geomesa.arrow.stream.buffer.bytes", 1)
    try:
        chunks = []
        for app in (evt.j, evt.t):
            cap = {}
            environ = {"REQUEST_METHOD": "GET", "PATH_INFO": "/query",
                       "QUERY_STRING": "schema=evt&chunk_rows=1024",
                       "CONTENT_LENGTH": "0", "wsgi.input": io.BytesIO(b"")}
            chunks.append(list(app(environ, lambda s, h: cap.update(s=s))))
            assert cap["s"].startswith("200")
    finally:
        _clear("geomesa.arrow.stream.buffer.bytes")
    assert len(chunks[1]) == len(chunks[0]) > 3
    assert b"".join(chunks[1]) == b"".join(chunks[0])
    table = pa.ipc.open_stream(io.BytesIO(b"".join(chunks[1]))).read_all()
    assert table.num_rows == ARROW_ROWS


@pytest.mark.parametrize("path,status", [
    ("/query?schema=evt&cql=BBOX(geom,", 400),
    ("/query", 400),
    ("/query?schema=nope", 404),
    ("/query?schema=evt&format=csv", 400),
    ("/query?schema=evt&chunk_rows=0", 400),
    ("/query?schema=evt&chunk_rows=abc", 400),
    ("/query?schema=evt&dicts=nope", 400),
    ("/query?schema=evt&timeout_ms=0", 400),
    ("/query?schema=evt&partial=maybe", 400),
    ("/api/data/evt?cql=name%20LIKE", 400),
    ("/api/data/evt?cql=%3D%3D%3D", 400),
    ("/explain?sql=SELEKT%20*%20FROM%20evt", 400),
    ("/explain?schema=evt&cql=BBOX(geom,", 400),
])
def test_query_endpoint_strict_400s(evt, path, status):
    jr, _ = evt.same("GET", path)
    assert jr[0] == status
    if "BBOX(geom," in path or "LIKE" in path or "SELEKT" in path:
        assert b"parse error" in jr[2].lower()


def test_query_stream_accepts_timeout_params(evt):
    jr, tr = evt.same("GET", "/query?schema=evt&timeout_ms=60000")
    assert pa.ipc.open_stream(tr[2]).read_all().num_rows == ARROW_ROWS
    # an expired partial stream: fewer (possibly zero) rows, a valid EOS
    for app in (evt.j, evt.t):
        status, _, blob = call(app, "GET",
                               "/query?schema=evt&timeout_ms=1&partial=1")
        assert status == 200
        assert pa.ipc.open_stream(blob).read_all().num_rows <= ARROW_ROWS
    gc.collect()
    assert jgate.inflight == 0 and tgate.inflight == 0


# -- the bounded server and the resilience mapping (test_zz_resilience.py) ---

@pytest.mark.parametrize("mod", [jwsgi, twsgi], ids=["jax", "port"])
def test_bounded_app_sheds_503_on_saturation(mod):
    def app(environ, start_response):
        start_response("200 OK", [("Content-Type", "text/plain")])
        return [b"ok"]

    bounded = mod.BoundedApp(app, max_concurrent=1)
    bounded._sem.acquire()        # one request in flight
    seen = []
    body = bounded({}, lambda s, h: seen.append((s, h)))
    assert seen[0][0].startswith("503")
    assert ("Retry-After", "1") in seen[0][1]
    shed = b"".join(body)
    assert json.loads(shed)["error"]
    bounded._sem.release()
    seen.clear()
    assert b"".join(bounded({}, lambda s, h: seen.append((s, h)))) == b"ok"
    assert seen[0][0].startswith("200")
    assert bounded._sem.acquire(blocking=False)   # the slot came back
    bounded._sem.release()
    # the shed body is the JAX package's, byte for byte
    ref = jwsgi.BoundedApp(app, max_concurrent=1)
    ref._sem.acquire()
    assert b"".join(ref({}, lambda s, h: None)) == shed


def test_router_maps_backpressure_and_timeout():
    from geomesa_tpu import resilience as jres
    from geomesa_tpu_torch import resilience as tres

    out = []
    for mod, res in ((jwsgi, jres), (twsgi, tres)):
        def shed(method, params, environ, _res=res):
            raise _res.Backpressure("too busy", retry_after_s=2.0)

        def slow(method, params, environ, _res=res):
            raise _res.QueryTimeout("deadline", elapsed_ms=10.0)

        def boom(method, params, environ):
            raise RuntimeError("device lost")

        def missing(method, params, environ):
            raise KeyError("k")

        router = mod.Router([(r"^/shed$", shed), (r"^/slow$", slow),
                             (r"^/boom$", boom), (r"^/missing$", missing)])
        got = []
        for path in ("/shed", "/slow", "/boom", "/missing", "/none"):
            seen = []
            body = router.dispatch({"PATH_INFO": path},
                                   lambda s, h: seen.append((s, h)))
            got.append((seen[0][0], seen[0][1], b"".join(body)))
        out.append(got)
    assert out[1] == out[0]
    assert out[0][0][0].startswith("503")
    assert ("Retry-After", "2") in out[0][0][1]
    assert out[0][1][0].startswith("504")
    assert out[0][2][0].startswith("500")      # never a 200
    assert out[0][3][0].startswith("404")


@pytest.mark.parametrize("name,value,status", [
    ("int", "7", 7), ("int", "x", 400), ("float", "2.5", 2.5),
    ("float", "nan?", 400), ("bool", "on", True), ("bool", "off", False),
    ("bool", "ture", 400), ("bool", None, False)])
def test_param_helpers(name, value, status):
    got = []
    for mod in (jwsgi, twsgi):
        fn = getattr(mod, f"{name}_param")
        params = {} if value is None else {"p": value}
        try:
            got.append(fn(params, "p"))
        except mod.HttpError as e:
            got.append((e.status, e.message))
    assert got[1] == got[0]
    assert (got[0][0] if isinstance(got[0], tuple) else got[0]) == status


def test_chaos_killed_web_drain_counts_abort_and_releases_token():
    rows = {"dtg": np.full(400, MS_2018 + DAY),
            "geom": (np.linspace(-9, 9, 400), np.linspace(41, 49, 400))}
    counts = []
    for Store, Web, reg, gate, Fault, kw in (
            (JStore, JWeb, jregistry, jgate, JFault, {}),
            (TStore, TWeb, tregistry, tgate, TFault, {"device": "cpu"})):
        ds = Store(**kw)
        ds.create_schema("rz_c4", "dtg:Date,*geom:Point")
        ds.write("rz_c4", rows)
        app = Web(ds)
        _set("geomesa.resilience.admission.max.concurrent", 2)
        _set("geomesa.resilience.fault.points", "arrow.flush:1=error")
        try:
            before = reg.counter("web.stream_aborted").count
            body = app({"PATH_INFO": "/query", "REQUEST_METHOD": "GET",
                        "QUERY_STRING": "schema=rz_c4"}, lambda s, h: None)
            with pytest.raises(Fault):
                for _ in body:
                    pass
            del body
            gc.collect()
            counts.append(reg.counter("web.stream_aborted").count - before)
            assert gate.inflight == 0
        finally:
            _clear("geomesa.resilience.fault.points")
            _clear("geomesa.resilience.admission.max.concurrent")
        assert len(ds.query_result(
            "rz_c4", "BBOX(geom,-10,40,10,50)").positions) == 400
    assert counts == [1, 1]


# -- the SLO feed and routes (test_zz_slo.py) -------------------------------

@pytest.fixture
def slo_app():
    for n in ("geomesa.slo.enabled", "geomesa.obs.scrape.min.interval.ms"):
        _clear(n)
    jslo.reset()
    tslo.reset()
    yield _pts_pair()
    _clear("geomesa.obs.scrape.min.interval.ms")
    jslo.reset()
    tslo.reset()


def test_real_query_trace_attributes_and_report(slo_app):
    jr, tr = slo_app.same("GET", "/api/data/pts?cql=BBOX(geom,-10,40,10,50)",
                          headers={"HTTP_X_TENANT": "acme"})
    assert jr[0] == 200
    for plane, reg in ((jslo, jregistry), (tslo, tregistry)):
        rep = plane.report()
        assert rep["enabled"] is True
        assert rep["classes"]["query"]["objective"]["latency_ms"] == 250.0
        snap = reg.snapshot()
        assert snap.get("slo.query.requests", {}).get("count", 0) >= 1
        assert [k for k in snap if k.startswith("slo.query.stage.")]
        # the web middleware fed the endpoint RED family
        assert snap.get("slo.web.data.requests", {}).get("count", 0) >= 1
    assert sorted(tslo.report()["classes"]) == \
        sorted(jslo.report()["classes"])


@pytest.mark.parametrize("method,path,status", [
    ("GET", "/debug/slo", 200), ("POST", "/debug/slo", 405),
    ("GET", "/debug/alerts", 200), ("GET", "/debug/alerts?limit=0", 200),
    ("GET", "/debug/alerts?limit=-1", 400),
    ("GET", "/debug/alerts?limit=zap", 400),
    ("GET", "/debug/alerts?class=bogus", 400),
    ("GET", "/debug/alerts?class=query", 200),
    ("POST", "/debug/alerts", 405)])
def test_debug_slo_and_alerts_routes(slo_app, method, path, status):
    jr, tr = slo_app.same(method, path, check_body=False)
    assert jr[0] == status
    if path.startswith("/debug/alerts") and status == 200:
        assert tr[2] == jr[2]                     # {"alerts": []} in both
    if "bogus" in path:
        assert tr[2] == jr[2] and b"bogus" in jr[2]
    if path == "/debug/slo" and status == 200:
        jb, tb = json.loads(jr[2]), json.loads(tr[2])
        assert "classes" in tb and "alerts_active" in tb
        assert sorted(tb) == sorted(jb)


@pytest.mark.parametrize("path,cls", [
    ("/query", "query"), ("/api/data/x", "data"), ("/api/stats/x", "stats"),
    ("/tiles/1/0/0", "tiles"), ("/metrics.prom", "metrics"),
    ("/api/metrics", "metrics"), ("/api/metrics.prom", "metrics"),
    ("/traces/abc", "traces"), ("/debug/heat", "debug"),
    ("/explain", "explain"), ("/api/version", "api"), ("/wcs", "other")])
def test_endpoint_class(path, cls):
    from geomesa_tpu.web.app import _endpoint_class as j
    from geomesa_tpu_torch.web.app import _endpoint_class as t
    assert t(path) == j(path) == cls


def test_png_and_jsonable_helpers():
    from geomesa_tpu.web.app import _jsonable as jj
    from geomesa_tpu.web.app import _png_gray as jp
    from geomesa_tpu_torch.web.app import _jsonable as tj
    from geomesa_tpu_torch.web.app import _png_gray as tp
    rng = np.random.default_rng(3)
    for g in (rng.uniform(0, 9, (5, 7)), np.zeros((3, 3)),
              np.array([[np.nan, 1.0], [2.0, np.nan]])):
        assert tp(g) == jp(g)
    for v in (np.int64(4), np.float32(0.5), 3, "s", None,
              np.datetime64("2018-01-01")):
        assert tj(v) == jj(v)
