"""Port parity: the observability and map routes of the REST front end
(``/metrics.prom``, ``/traces``, ``/debug/heat``, ``/debug/storage``,
``/debug/jobs``, ``/explain``, ``/tiles``) against geomesa_tpu's — the web
cases of ``tests/test_zz_obs.py``, ``test_zz_heat_obs.py``,
``test_zz_resource_obs.py``, ``test_zz_slo.py`` and ``test_pyramid.py``,
run through a JAX ``WebApp`` and a port ``WebApp`` over lean stores of the
same seeded, time-partitioned rows (four 4,096-slot generations, pyramids
built; the port's on ``device="cpu"``).

Held equal byte for byte: every 4xx body, the tiles (JSON grids and PNG)
and ``/debug/jobs`` filters.  Bodies that carry times, trace ids or
temperatures are held equal in their keys and in every count (hits,
matched rows, generations, ranks of the generations a query touched);
each package's ``/metrics.prom`` parses line by line under the JAX test's
grammar and carries the same families for the store.  The JAX store's
write traces carry a ``write.device`` span the port does not have
(ROADMAP C), so trace comparisons leave it out.
"""

import io
import json
import re
from urllib.parse import quote

import numpy as np
import pytest

from geomesa_tpu import config as jcfg
from geomesa_tpu.datastore import TpuDataStore as JStore
from geomesa_tpu.jobs import run_compaction as j_compact
from geomesa_tpu.metrics import registry as jregistry
from geomesa_tpu.obs import compile_count as j_compiles
from geomesa_tpu.obs import slo_plane as jslo
from geomesa_tpu.obs import tracer as jtracer
from geomesa_tpu.web import WebApp as JWeb
from geomesa_tpu_torch import config as tcfg
from geomesa_tpu_torch.datastore import TpuDataStore as TStore
from geomesa_tpu_torch.jobs import run_compaction as t_compact
from geomesa_tpu_torch.metrics import registry as tregistry
from geomesa_tpu_torch.obs import compile_count as t_compiles
from geomesa_tpu_torch.obs import slo_plane as tslo
from geomesa_tpu_torch.obs import tracer as ttracer
from geomesa_tpu_torch.web import WebApp as TWeb

MS = 1514764800000
DAY = 86_400_000
SLOTS = 4096
HOT_Q = ("BBOX(geom,-75,40,-73,42) AND dtg DURING "
         "2018-01-08T00:00:00Z/2018-01-10T00:00:00Z")
WORLD = (-180.0, -90.0, 180.0, 90.0)

_PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r"(\{(quantile=\"[0-9.]+\"|le=\"(\+Inf|[0-9.e+-]+)\")\})? -?[0-9]"
    r"[0-9.e+-]*"
    r"( # \{trace_id=\"[0-9a-f]+\"\} -?[0-9][0-9.e+-]*)?$")


def _rows():
    rng = np.random.default_rng(11)
    out = []
    for i in range(4):
        lo = MS + 3 * i * DAY
        out.append({"score": rng.uniform(0, 100, SLOTS),
                    "dtg": rng.integers(lo, lo + 3 * DAY, SLOTS),
                    "geom": (rng.uniform(-75, -73, SLOTS),
                             rng.uniform(40, 42, SLOTS))})
    return out


def _lean_store(cls, name, **kw):
    ds = cls(user="web-obs", **kw)
    ds.create_schema(name, "score:Double,dtg:Date,*geom:Point;"
                           "geomesa.index.profile=lean,"
                           f"geomesa.lean.generation.slots={SLOTS},"
                           "geomesa.lean.compaction.factor=0")
    for part in _rows():
        ds.write(name, part)
    return ds


def call(app, method, path):
    cap = {}

    def sr(status, headers):
        cap["status"] = int(status.split()[0])
        cap["headers"] = dict(headers)

    qs = ""
    if "?" in path:
        path, qs = path.split("?", 1)
    body = b"".join(app({
        "REQUEST_METHOD": method, "PATH_INFO": path, "QUERY_STRING": qs,
        "CONTENT_LENGTH": "0", "wsgi.input": io.BytesIO(b"")}, sr))
    return cap["status"], cap["headers"], body


class Pair:
    def __init__(self, j, t):
        self.j, self.t = j, t

    def both(self, method, path):
        jr, tr = call(self.j, method, path), call(self.t, method, path)
        assert tr[0] == jr[0], (path, tr, jr)
        assert tr[1].get("Content-Type") == jr[1].get("Content-Type")
        if jr[0] >= 400:
            assert tr[2] == jr[2], (path, tr[2], jr[2])
        return jr, tr

    def json(self, path):
        jr, tr = self.both("GET", path)
        return jr[0], json.loads(jr[2]), json.loads(tr[2])


@pytest.fixture(scope="module")
def stores():
    j = _lean_store(JStore, "hevt")
    t = _lean_store(TStore, "hevt", device="cpu")
    for ds in (j, t):
        ds.build_pyramids("hevt")
        for _ in range(3):
            ds.query("hevt", HOT_Q)
    return j, t


@pytest.fixture
def app(stores):
    return Pair(JWeb(stores[0]), TWeb(stores[1]))


def _prom_families(text):
    return {line.split("{")[0].split(" ")[0]
            for line in text.splitlines() if not line.startswith("#")}


# -- test_zz_obs.py ----------------------------------------------------------

def test_prometheus_exposition_parses(app, stores):
    import math
    jregistry.timer("obs.test.empty_ms")
    tregistry.timer("obs.test.empty_ms")
    for ds in stores:
        ds.query("hevt", HOT_Q)
    jr, tr = app.both("GET", "/metrics.prom")
    assert jr[0] == 200 and jr[1]["Content-Type"].startswith("text/plain")
    for body in (jr[2].decode(), tr[2].decode()):
        for line in body.strip().splitlines():
            if line.startswith("#"):
                assert re.match(r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* "
                                r"(counter|summary|gauge|histogram)$",
                                line), line
            else:
                assert _PROM_LINE.match(line), line
                assert math.isfinite(float(line.split()[-1])), line
        assert 'geomesa_query_hevt_scan_ms{quantile="0.5"}' in body
        assert 'geomesa_query_hevt_scan_ms{quantile="0.99"}' in body
        assert "geomesa_query_hevt_count_total" in body
        assert "geomesa_obs_test_empty_ms_count 0" in body
        # the storage and heat walks ran inside the scrape
        assert "# TYPE geomesa_storage_total_device_bytes gauge" in body
        assert "geomesa_storage_hevt_z3_device_bytes" in body
        assert "geomesa_heat_hevt_z3_temperature" in body.replace(".", "_")
    store_fams = {f for f in _prom_families(jr[2].decode())
                  if "_hevt_" in f and "compile" not in f}
    assert store_fams <= _prom_families(tr[2].decode())
    # a non-multihost store serves ?mesh=1 as its own registry
    jm, tm = app.both("GET", "/metrics.prom?mesh=1")
    assert jm[0] == 200 and b"geomesa_query_hevt_count_total" in tm[2]


def test_traces_endpoints_roundtrip(app, stores):
    tids = []
    for ds, tr in zip(stores, (jtracer, ttracer)):
        got = ds.query_result("hevt", HOT_Q)
        tids.append((tr.ring.traces()[-1].trace_id, len(got.positions)))
    (jt, jhits), (tt, thits) = tids
    assert jhits == thits > 0
    jr, tr = call(app.j, "GET", f"/traces/{jt}"), \
        call(app.t, "GET", f"/traces/{tt}")
    assert jr[0] == tr[0] == 200
    full = [json.loads(jr[2]), json.loads(tr[2])]
    assert full[0]["trace_id"] == jt and full[1]["trace_id"] == tt
    names = [{s["name"] for s in f["spans"]} - {"write.device"}
             for f in full]
    assert names[1] == names[0]
    assert {"query", "query.plan", "query.post_filter"} <= names[1]
    for f in full:
        root = [s for s in f["spans"] if s["parent_id"] is None][0]
        assert root["attributes"]["hits"] == thits
    status, jb, tb = app.json("/traces")
    assert status == 200 and any(s["trace_id"] == tt for s in tb)
    app.both("GET", "/traces/deadbeef")
    status, jb, tb = app.json("/traces?slow=1")
    assert isinstance(jb, list) and isinstance(tb, list)


# -- test_zz_heat_obs.py -----------------------------------------------------

def _heat_rows(rep):
    return [r for r in rep["generations"] if r["schema"] == "hevt"]


def test_debug_heat_endpoint_and_paging(app):
    status, jb, tb = app.json("/debug/heat")
    assert status == 200 and sorted(tb) == sorted(jb)
    jrows, trows = _heat_rows(jb), _heat_rows(tb)
    assert len(trows) == len(jrows) == 4
    for rows in (jrows, trows):
        assert rows == sorted(rows, key=lambda r: r["rank"])
    assert [sorted(r) for r in trows] == [sorted(r) for r in jrows]
    # the time-partitioned queries touched the same generations alike
    key = ("index", "scans", "hits", "rows_matched", "tier")
    view = [sorted((tuple(r.get(k) for k in key) for r in rows), key=str)
            for rows in (jrows, trows)]
    assert view[1] == view[0]
    jr, tr = app.both("GET", "/metrics.prom")
    for text in (jr[2].decode(), tr[2].decode()):
        assert "geomesa_heat_hevt_z3_temperature" in text.replace(".", "_")
    status, jb, tb = app.json("/debug/heat?limit=2")
    assert len(jb["generations"]) == len(tb["generations"]) == 2
    for bad in ("/debug/heat?limit=nope", "/debug/heat?limit=-1",
                "/debug/heat?limit=2.5"):
        assert app.both("GET", bad)[0][0] == 400


def test_debug_jobs_endpoint_and_filters():
    j = _lean_store(JStore, "webjobs")
    t = _lean_store(TStore, "webjobs", device="cpu")
    j_compact(j, "webjobs")
    t_compact(t, "webjobs")
    app = Pair(JWeb(j), TWeb(t))
    status, jb, tb = app.json("/debug/jobs?kind=compaction")
    assert status == 200
    for jobs in (jb["jobs"], tb["jobs"]):
        assert jobs and jobs[0]["kind"] == "compaction"
        assert jobs[0]["state"] == "succeeded" and jobs[0]["phases"]
    assert [p["name"] for p in tb["jobs"][0]["phases"]] == \
        [p["name"] for p in jb["jobs"][0]["phases"]]
    assert sorted(tb["jobs"][0]) == sorted(jb["jobs"][0])
    status, jb, tb = app.json("/debug/jobs?limit=1")
    assert len(jb["jobs"]) == len(tb["jobs"]) == 1
    status, jb, tb = app.json("/debug/jobs?kind=nope")
    assert jb == tb == {"jobs": []}
    for bad in ("/debug/jobs?state=exploded", "/debug/jobs?limit=zz",
                "/debug/jobs?limit=-2"):
        assert app.both("GET", bad)[0][0] == 400
    assert app.both("POST", "/debug/jobs")[0][0] == 405


def test_traces_paging_and_param_400s(app, stores):
    for ds in stores:
        for _ in range(4):
            ds.query("hevt", "BBOX(geom,-75,40,-73,42)")
    for web in (app.j, app.t):
        status, _, body = call(web, "GET", "/traces")
        full = json.loads(body)
        assert status == 200 and len(full) >= 4
        status, _, body = call(web, "GET", "/traces?limit=2")
        page = json.loads(body)
        assert len(page) == 2
        # newest last: the page is the tail of the full list
        assert [t["trace_id"] for t in page] == \
            [t["trace_id"] for t in full[-2:]]
        status, _, body = call(web, "GET", "/traces?limit=0")
        assert json.loads(body) == []
    for bad in ("/traces?limit=abc", "/traces?limit=-5",
                "/traces?slow=maybe", "/traces?schema="):
        assert app.both("GET", bad)[0][0] == 400, bad


def test_debug_storage_audit_param(app):
    status, jb, tb = app.json("/debug/storage")
    assert status == 200 and "reconciliation" in tb
    assert sorted(tb) == sorted(jb)
    assert tb["reconciliation"]["within_tolerance"]
    assert tb["totals"]["device_bytes"] > 0
    status, jb, tb = app.json("/debug/storage?audit=0")
    assert "reconciliation" not in tb and sorted(tb) == sorted(jb)
    assert app.both("GET", "/debug/storage?audit=banana")[0][0] == 400


# -- test_zz_resource_obs.py -------------------------------------------------

def test_planned_query_estimate_scraped(app, stores):
    for ds in stores:
        ds.query("hevt", HOT_Q)
    jr, tr = app.both("GET", "/metrics.prom")
    for body in (jr[2], tr[2]):
        assert b'geomesa_plan_estimate_ratio{quantile="0.5"}' in body


@pytest.mark.parametrize("path,status", [
    (f"/explain?schema=hevt&cql={quote(HOT_Q)}", 200),
    ("/explain?schema=hevt&format=text", 200),
    (f"/explain?schema=hevt&cql={quote(HOT_Q)}&format=text", 200),
    ("/explain", 400),
    ("/explain?schema=nope", 404),
    ("/explain?schema=hevt&cql=BBOX((", 400),
    ("/explain?sql=SELEKT%201", 400),
])
def test_explain_endpoint(app, path, status):
    jr, tr = app.both("GET", path)
    assert jr[0] == status
    if status != 200:
        return
    if "format=text" in path:
        assert tr[1]["Content-Type"].startswith("text/plain")
        for text in (jr[2].decode(), tr[2].decode()):
            assert "EXPLAIN ANALYZE schema:hevt" in text
            assert "Plan narration:" in text and "Estimate audit" in text
        return
    jb, tb = json.loads(jr[2]), json.loads(tr[2])
    assert sorted(tb) == sorted(jb)
    for out in (jb, tb):
        assert out["summary"]["estimate_rows"] > 0
        assert out["plans"][0]["name"] == "query"
    for k in ("strategy", "actual_matched", "actual_scanned"):
        assert tb["summary"][k] == jb["summary"][k], k
    assert tb["summary"]["actual_matched"] > 0


@pytest.mark.parametrize("sql", [
    "SELECT count(*) FROM hevt WHERE score > 50",
    f"SELECT count(*) FROM hevt WHERE {HOT_Q}",
])
def test_explain_endpoint_sql(app, sql):
    status, jb, tb = app.json(f"/explain?sql={quote(sql)}")
    assert status == 200
    assert jb["target"] == tb["target"] == "sql"
    assert tb["plans"] and len(tb["plans"]) == len(jb["plans"])
    assert [p["name"] for p in tb["plans"]] == \
        [p["name"] for p in jb["plans"]]


# -- test_zz_slo.py ----------------------------------------------------------

@pytest.fixture
def slo_clean():
    for n in ("geomesa.obs.scrape.min.interval.ms",):
        jcfg.clear_property(n)
        tcfg.clear_property(n)
    jslo.reset()
    tslo.reset()
    yield
    for n in ("geomesa.obs.scrape.min.interval.ms",):
        jcfg.clear_property(n)
        tcfg.clear_property(n)
    jslo.reset()
    tslo.reset()


def test_exemplar_joins_metrics_prom_to_traces(app, slo_clean):
    for web, tr in ((app.j, jtracer), (app.t, ttracer)):
        status, _, _ = call(web, "GET",
                            "/api/data/hevt?cql=BBOX(geom,-75,40,-74,41)"
                            "&format=csv")
        assert status == 200
        status, _, body = call(web, "GET", "/metrics.prom")
        text = body.decode()
        assert "geomesa_slo_query_burn_5m" in text
        assert "geomesa_slo_query_burn_1h" in text
        ids = re.findall(
            r'geomesa_slo_query_latency_ms_bucket\{le="[^"]+"\} \d+ '
            r'# \{trace_id="([0-9a-f]+)"\}', text)
        resolved = [i for i in ids if tr.find(i) is not None]
        assert resolved, "no exemplar trace_id resolves in the tracer"
        status, _, body = call(web, "GET", f"/traces/{resolved[0]}")
        assert status == 200 and json.loads(body)["trace_id"] == resolved[0]


def test_traces_schema_filter(app, slo_clean):
    """The port's ``/traces?schema=`` keeps only traces whose root
    recorded the schema.  The JAX test of the same name depends on what
    the process-wide trace ring holds when it runs and fails in some
    full-suite runs, so the JAX side is held only to what both share: the
    400 on a blank schema and an empty page for an unknown one."""
    status, _, _ = call(app.t, "GET",
                        "/api/data/hevt?cql=BBOX(geom,-75,40,-74,41)")
    assert status == 200
    status, _, body = call(app.t, "GET", "/traces?schema=hevt")
    page = json.loads(body)
    assert status == 200 and page
    assert all(t["attributes"].get("schema") == "hevt" for t in page)
    status, jb, tb = app.json("/traces?schema=nope")
    assert jb == tb == []
    assert app.both("GET", "/traces?schema=")[0][0] == 400


def test_scrape_cache_serves_identical_body(app, slo_clean):
    for cfg, web, reg in ((jcfg, app.j, jregistry),
                          (tcfg, app.t, tregistry)):
        cfg.set_property("geomesa.obs.scrape.min.interval.ms", 60_000.0)
        c0 = reg.counter("obs.scrape.cached").count
        first = call(web, "GET", "/metrics.prom")
        second = call(web, "GET", "/metrics.prom")
        assert first[0] == second[0] == 200
        assert second[2] == first[2]           # the cached body
        assert reg.counter("obs.scrape.cached").count == c0 + 1
        assert reg.timer("obs.scrape.ms").count >= 1


# -- test_pyramid.py (/tiles) ------------------------------------------------

def _brute_grid(x, y, sel, env, w, h):
    g = np.zeros((h, w))
    gx = np.clip(((x[sel] - env[0]) / (env[2] - env[0]) * w).astype(int),
                 0, w - 1)
    gy = np.clip(((y[sel] - env[1]) / (env[3] - env[1]) * h).astype(int),
                 0, h - 1)
    np.add.at(g, (gy, gx), 1.0)
    return g


def _xy():
    parts = _rows()
    return (np.concatenate([p["geom"][0] for p in parts]),
            np.concatenate([p["geom"][1] for p in parts]))


@pytest.mark.parametrize("path", [
    "/tiles/0/0/0?schema=hevt",
    "/tiles/0/0/0?schema=hevt&format=png",
    "/tiles/1/0/1?schema=hevt&tile=64",
    "/tiles/4/4/6?schema=hevt&format=png&tile=32",
    "/tiles/9/105/192?schema=hevt&tile=16",
])
def test_tiles_endpoint_serves_json_and_png(app, path):
    jr, tr = app.both("GET", path)
    assert jr[0] == 200
    assert tr[2] == jr[2]
    if "png" in path:
        assert jr[1]["Content-Type"] == "image/png"
        assert tr[2][:8] == b"\x89PNG\r\n\x1a\n"
        return
    body = json.loads(tr[2])
    if path == "/tiles/0/0/0?schema=hevt":
        x, y = _xy()
        assert body["z"] == 0 and body["tile"] == 256
        np.testing.assert_array_equal(
            np.asarray(body["grid"]),
            _brute_grid(x, y, np.ones(len(x), bool), WORLD, 256, 256))
        assert body["total"] == len(x)


def test_tiles_endpoint_cql_filter_and_timeout_param(app):
    x, y = _xy()
    cql = "BBOX(geom, -75, 40, -74, 41)"
    path = f"/tiles/0/0/0?schema=hevt&cql={cql}&timeout_ms=60000"
    jr, tr = app.both("GET", path)
    assert jr[0] == 200 and tr[2] == jr[2]
    m = (x >= -75) & (x <= -74) & (y >= 40) & (y <= 41)
    assert json.loads(tr[2])["total"] == int(m.sum())
    np.testing.assert_allclose(np.asarray(json.loads(tr[2])["grid"]),
                               np.asarray(json.loads(jr[2])["grid"]),
                               rtol=1e-5)


@pytest.mark.parametrize("method,path,status", [
    ("GET", "/tiles/abc/0/0?schema=hevt", 400),
    ("GET", "/tiles/0/0/0.5?schema=hevt", 400),
    ("GET", "/tiles/0/0/0", 400),
    ("GET", "/tiles/0/0/0?schema=nope", 404),
    ("GET", "/tiles/1/2/0?schema=hevt", 400),
    ("GET", "/tiles/-1/0/0?schema=hevt", 400),
    ("GET", "/tiles/31/0/0?schema=hevt", 400),
    ("GET", "/tiles/0/0/0?schema=hevt&cql=NOT%20CQL(", 400),
    ("GET", "/tiles/0/0/0?schema=hevt&format=gif", 400),
    ("GET", "/tiles/0/0/0?schema=hevt&tile=0", 400),
    ("GET", "/tiles/0/0/0?schema=hevt&tile=9999", 400),
    ("GET", "/tiles/0/0/0?schema=hevt&timeout_ms=x", 400),
    ("POST", "/tiles/0/0/0?schema=hevt", 405),
])
def test_tiles_endpoint_request_hardening(app, method, path, status):
    assert app.both(method, path)[0][0] == status


def test_warm_tile_serving_is_recompile_free(app):
    for web in (app.j, app.t):
        for tx, ty in ((0, 0), (0, 1), (1, 0), (1, 1)):
            call(web, "GET", f"/tiles/1/{tx}/{ty}?schema=hevt")
    before = (j_compiles(), t_compiles())
    for tx, ty in ((0, 0), (0, 1), (1, 0), (1, 1)):
        assert app.both("GET", f"/tiles/1/{tx}/{ty}?schema=hevt")[0][0] == 200
    assert (j_compiles(), t_compiles()) == before
