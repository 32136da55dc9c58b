"""Port parity: the schemaless GeoJSON API (``geomesa_tpu_torch/geojson/``)
against geomesa_tpu's — every case of ``tests/test_geojson.py`` run
through a JAX and a port ``GeoJsonIndex`` / ``GeoJsonApp`` on the same
documents, with equal results (documents, ids, errors, status lines and
bodies) — and the json-path property repair of the port's
``filters/evaluate.py:_prop_column``: ``"$.attr.path"`` on a json-typed
attribute answers with the JAX store's hits (equality, ordering with
``None`` and mixed entries, a bracketed first segment, malformed rows)."""

import io
import json
from urllib.parse import quote

import numpy as np
import pytest

from geomesa_tpu.datastore import TpuDataStore as JStore
from geomesa_tpu.filters.evaluate import _prop_column as j_prop
from geomesa_tpu.geojson import GeoJsonApp as JApp
from geomesa_tpu.geojson import GeoJsonIndex as JIndex
from geomesa_tpu.geojson.query import json_path_get as j_path
from geomesa_tpu.geojson.query import parse_geojson_query as j_parse
from geomesa_tpu.web import WebApp as JWeb
from geomesa_tpu_torch.datastore import TpuDataStore as TStore
from geomesa_tpu_torch.filters.evaluate import _prop_column as t_prop
from geomesa_tpu_torch.geojson import GeoJsonApp as TApp
from geomesa_tpu_torch.geojson import GeoJsonIndex as TIndex
from geomesa_tpu_torch.geojson.query import json_path_get as t_path
from geomesa_tpu_torch.geojson.query import parse_geojson_query as t_parse
from geomesa_tpu_torch.web import WebApp as TWeb


def feat(fid, x, y, props=None, geom=None):
    return {"type": "Feature", "id": fid,
            "geometry": geom or {"type": "Point", "coordinates": [x, y]},
            "properties": props or {}}


def _idx(cls):
    gj = cls()
    gj.create_index("test", dtg_path="$.properties.dtg", points=True)
    gj.add("test", {"type": "FeatureCollection", "features": [
        feat("0", 30, 10, {"name": "n0", "score": 1,
                           "dtg": "2018-01-01T00:00:00Z"}),
        feat("1", 31, 10, {"name": "n1", "score": 5,
                           "dtg": "2018-01-02T00:00:00Z"}),
        feat("2", 32, 10, {"name": "n2", "score": 9,
                           "dtg": "2018-01-03T00:00:00Z",
                           "nested": {"tag": "x"}}),
    ]})
    return gj


@pytest.fixture
def idx():
    return _idx(JIndex), _idx(TIndex)


def both(pair, fn):
    """``fn(index)`` on the JAX and the port index: equal results, or the
    same exception type and message."""
    out = []
    for gj in pair:
        try:
            out.append(("ok", fn(gj)))
        except Exception as e:  # noqa: BLE001 — compared below
            out.append(("err", type(e).__name__, str(e)))
    assert out[1] == out[0]
    return out[0][1] if out[0][0] == "ok" else out[0]


def ids(feats):
    return [f["id"] for f in feats]


@pytest.mark.parametrize("path,want", [
    ("$.id", "z"), ("a.b[2].c", 7), ("$.properties.a.b[0]", 1),
    ("missing", None), ("$properties.a.b[1]", 2), ("a.b[9]", None),
    ("a.b[x]", None), ("$.id[0]", "z"), ("$.properties.a.b[2].c.d", None)])
def test_json_path_get(path, want):
    d = {"properties": {"a": {"b": [1, 2, {"c": 7}]}}, "id": "z"}
    assert t_path(d, path) == j_path(d, path)
    assert t_path(d, path) == want


def test_add_get_delete(idx):
    assert both(idx, lambda g: g.get("test", "1"))[0]["properties"][
        "name"] == "n1"
    assert both(idx, lambda g: g.get("test", ["0", "2"]))[0]["id"] == "0"
    assert both(idx, lambda g: g.delete("test", "1")) == 1
    assert both(idx, lambda g: g.get("test", "1")) == []
    assert len(both(idx, lambda g: g.query("test", "{}"))) == 2
    assert both(idx, lambda g: g.delete("test", ["nope"])) == 0
    both(idx, lambda g: g.query("missing", "{}"))


def test_add_assigns_and_rejects_dup_ids(idx):
    assert both(idx, lambda g: g.add("test", feat("99", 0, 0,
                                                  {"dtg": 0}))) == ["99"]
    err = both(idx, lambda g: g.add("test", feat("99", 0, 0, {"dtg": 0})))
    assert err[:2] == ("err", "ValueError")
    err = both(idx, lambda g: g.add("test", {"type": "Point"}))
    assert err[1] == "ValueError"


@pytest.mark.parametrize("q,want", [
    ('{"name": "n1"}', ["1"]),
    ('{"score": {"$gte": 5}}', ["1", "2"]),
    ('{"score": {"$lt": 5}}', ["0"]),
    ('{"score": {"$gt": 0}, "name": "n2"}', ["2"]),
    ('{"$.properties.nested.tag": "x"}', ["2"]),
    ('{"name": {"$gt": 3}}', []),
    ("", ["0", "1", "2"]),
])
def test_query_equality_and_compare(idx, q, want):
    assert ids(both(idx, lambda g: g.query("test", q))) == want


@pytest.mark.parametrize("q,want", [
    ('{"geometry": {"$bbox": [30.5, 9, 32.5, 11]}}', ["1", "2"]),
    ('{"geometry": {"$intersects": {"$geometry": '
     '{"type": "Point", "coordinates": [30, 10]}}}}', ["0"]),
    ('{"geometry": {"$within": {"$geometry": {"type": "Polygon", '
     '"coordinates": [[[29,9],[31.5,9],[31.5,11],[29,11],[29,9]]]}}}}',
     ["0", "1"]),
    ('{"geometry": {"$dwithin": {"$geometry": '
     '{"type": "Point", "coordinates": [30, 10]}, '
     '"$dist": 120, "$unit": "kilometers"}}}', ["0", "1"]),
    ('{"geometry": {"$contains": {"$geometry": '
     '{"type": "Point", "coordinates": [31, 10]}}}}', ["1"]),
])
def test_query_spatial(idx, q, want):
    assert ids(both(idx, lambda g: g.query("test", q))) == want


@pytest.mark.parametrize("q", [
    '{"geometry": {"$dwithin": {"$geometry": {"type": "Point", '
    '"coordinates": [30, 10]}, "$dist": 1, "$unit": "parsecs"}}}',
    '{"score": {"$ne": 1}}', '{"$or": {"a": 1}}', '[1, 2]',
    '{"score": {}}'])
def test_query_errors_match(idx, q):
    assert both(idx, lambda g: g.query("test", q))[0] == "err"


@pytest.mark.parametrize("q,want", [
    ('{"$or": [{"name": "n0"}, {"name": "n2"}]}', ["0", "2"]),
    ('{"$or": [{"geometry": {"$bbox": [31.5, 9, 33, 11]}}, '
     '{"score": {"$lt": 2}}]}', ["0", "2"]),
])
def test_query_or_and_combined(idx, q, want):
    assert ids(both(idx, lambda g: g.query("test", q))) == want


def test_query_transform(idx):
    out = both(idx, lambda g: g.query("test", '{"score": {"$gt": 4}}',
                                      transform={"n": "name", "fid": "$.id"}))
    assert out == [{"n": "n1", "fid": "1"}, {"n": "n2", "fid": "2"}]


def test_spatial_conjuncts_match():
    q = ('{"geometry": {"$bbox": [0, 0, 1, 1]}, "name": "a", '
         '"$or": [{"geometry": {"$bbox": [2, 2, 3, 3]}}]}')
    assert repr(t_parse(q).spatial_conjuncts()) == \
        repr(j_parse(q).spatial_conjuncts())


def test_update_via_id_path():
    pair = (JIndex(), TIndex())
    both(pair, lambda g: g.create_index("u", id_path="$.properties.pk"))
    both(pair, lambda g: g.add("u", feat(None, 1, 1, {"pk": "a", "v": 1})))
    both(pair, lambda g: g.update("u", feat(None, 2, 2, {"pk": "a", "v": 2})))
    assert both(pair, lambda g: g.get("u", "a"))[0]["properties"]["v"] == 2
    err = both(pair, lambda g: g.update("u", feat(None, 3, 3, {"pk": "no"})))
    assert err[1] == "KeyError"
    both(pair, lambda g: g.update("u", feat(None, 3, 3, {"pk": "a"}),
                                  ids=["a", "b"]))
    both(pair, lambda g: g.create_index("u"))
    both(pair, lambda g: g.create_index("plain"))
    assert both(pair, lambda g: g.update("plain", feat("x", 0, 0)))[0] == "err"


def test_non_point_extents_index():
    pair = (JIndex(), TIndex())
    poly = {"type": "Polygon",
            "coordinates": [[[0, 0], [4, 0], [4, 4], [0, 4], [0, 0]]]}
    both(pair, lambda g: g.create_index("polys"))
    both(pair, lambda g: g.add("polys", feat("p", 0, 0, {}, geom=poly)))
    both(pair, lambda g: g.add("polys", feat(
        "q", 0, 0, {}, geom={"type": "Point", "coordinates": [10, 10]})))
    hits = both(pair, lambda g: g.query(
        "polys", '{"geometry": {"$bbox": [1, 1, 2, 2]}}'))
    assert ids(hits) == ["p"]
    hits = both(pair, lambda g: g.query(
        "polys", '{"geometry": {"$intersects": {"$geometry": '
                 '{"type": "Point", "coordinates": [10, 10]}}}}'))
    assert ids(hits) == ["q"]


def wsgi(app, method, path, body=None):
    raw = json.dumps(body).encode() if body is not None else b""
    cap = {}

    def sr(status, headers):
        cap["status"] = status
        cap["headers"] = dict(headers)

    qs = ""
    if "?" in path:
        path, qs = path.split("?", 1)
    out = b"".join(app({
        "REQUEST_METHOD": method, "PATH_INFO": path, "QUERY_STRING": qs,
        "CONTENT_LENGTH": str(len(raw)), "wsgi.input": io.BytesIO(raw),
    }, sr))
    return cap["status"], cap["headers"].get("Content-Type"), out


def test_servlet_roundtrip():
    apps = (JApp(), TApp())
    q = quote(json.dumps({"geometry": {"$bbox": [0, 0, 10, 10]}}))
    tr = quote(json.dumps({"k": "kind"}))
    steps = [("POST", "/geojson/index/t?points=true", None, 201),
             ("POST", "/geojson/index/t/features",
              feat("f1", 5, 5, {"kind": "a"}), 201),
             ("PUT", "/geojson/index/t/features",
              feat("f1", 6, 6, {"kind": "b"}), 400),
             ("GET", "/geojson/index/t/features/f1", None, 200),
             ("GET", f"/geojson/index/t/query?q={q}", None, 200),
             ("GET", f"/geojson/index/t/query?q={q}&transform={tr}", None,
              200),
             ("GET", "/geojson/index/t/query?q=%7Bbad", None, 400),
             ("GET", "/geojson/index/nope/query", None, 404),
             ("POST", "/geojson/index/t", None, 400),
             ("PATCH", "/geojson/index/t", None, 405),
             ("DELETE", "/geojson/index/t/features/f1", None, 204),
             ("DELETE", "/geojson/index/t/features/f1", None, 404),
             ("GET", "/geojson/index/t/features/f1", None, 404),
             ("GET", "/geojson/index", None, 200),
             ("POST", "/geojson/index", None, 405),
             ("GET", "/geojson/nothing", None, 404),
             ("DELETE", "/geojson/index/t", None, 204)]
    for method, path, body, status in steps:
        got = [wsgi(app, method, path, body) for app in apps]
        assert got[1] == got[0], (method, path, got)
        assert int(got[0][0].split()[0]) == status, (method, path, got)
    assert json.loads(wsgi(apps[1], "GET", "/geojson/index")[2]) == []


def test_servlet_mounted_under_webapp():
    apps = (JWeb(JStore(), geojson=JIndex()),
            TWeb(TStore(device="cpu"), geojson=TIndex()))
    for method, path in (("POST", "/geojson/index/m"),
                         ("GET", "/geojson/index"),
                         ("GET", "/api/schemas")):
        got = [wsgi(app, method, path) for app in apps]
        assert got[1] == got[0]
    assert json.loads(wsgi(apps[1], "GET", "/geojson/index")[2]) == ["m"]
    # an app passed in is mounted as it is
    mounted = TWeb(TStore(device="cpu"), geojson=TApp(TIndex()))
    assert wsgi(mounted, "POST", "/geojson/index/k")[0].startswith("201")


def test_mongo_range_idiom_multiple_ops(idx):
    hits = both(idx, lambda g: g.query("test",
                                       '{"score": {"$gte": 5, "$lt": 9}}'))
    assert ids(hits) == ["1"]


def test_add_is_atomic(idx):
    both(idx, lambda g: g.query(
        "test", '{"geometry": {"$bbox": [0, 0, 60, 60]}}'))  # cache batch
    bad = {"type": "FeatureCollection", "features": [
        feat("ok1", 1, 1, {"dtg": 0}),
        {"type": "Feature", "id": "broken", "geometry": None,
         "properties": {}}]}
    assert both(idx, lambda g: g.add("test", bad))[1] == "ValueError"
    assert both(idx, lambda g: g.get("test", "ok1")) == []
    hits = both(idx, lambda g: g.query(
        "test", '{"geometry": {"$bbox": [29, 9, 33, 11]}}'))
    assert len(hits) == 3


def test_auto_ids_survive_delete():
    pair = (JIndex(), TIndex())
    both(pair, lambda g: g.create_index("auto"))
    a, b = (both(pair, lambda g, i=i: g.add("auto", feat(None, i, i)))[0]
            for i in range(2))
    both(pair, lambda g: g.delete("auto", a))
    c = both(pair, lambda g: g.add("auto", feat(None, 5, 5)))[0]
    assert c not in (a, b)
    assert len(both(pair, lambda g: g.query("auto", "{}"))) == 2


def test_point_documents_at_scale():
    """A few thousand seeded point documents with a nested property: the
    spatial, property and combined queries of both packages agree with
    a Python oracle over the documents."""
    rng = np.random.default_rng(5)
    n = 3000
    xs, ys = rng.uniform(-20, 20, n), rng.uniform(-10, 10, n)
    kinds = rng.integers(0, 7, n)
    fc = {"type": "FeatureCollection", "features": [
        feat(f"d{i}", float(xs[i]), float(ys[i]),
             {"meta": {"kind": int(kinds[i])}, "dtg": int(i)})
        for i in range(n)]}
    pair = (JIndex(), TIndex())
    both(pair, lambda g: g.create_index("docs", dtg_path="$.properties.dtg",
                                        points=True))
    both(pair, lambda g: g.add("docs", fc))
    box = (-5.0, -3.0, 7.5, 4.0)
    inbox = (xs >= box[0]) & (xs <= box[2]) & (ys >= box[1]) & (ys <= box[3])
    cases = [
        ({"geometry": {"$bbox": list(box)}}, inbox),
        ({"$.properties.meta.kind": 3}, kinds == 3),
        ({"geometry": {"$bbox": list(box)},
          "$.properties.meta.kind": {"$gte": 5}}, inbox & (kinds >= 5)),
    ]
    for q, want in cases:
        hits = both(pair, lambda g: g.query("docs", json.dumps(q)))
        assert ids(hits) == [f"d{i}" for i in np.flatnonzero(want)]


# -- the json-path property repair (filters/evaluate.py:_prop_column) --------

def _store_pair(name, spec, data):
    out = []
    for cls, kw in ((JStore, {}), (TStore, {"device": "cpu"})):
        ds = cls(**kw)
        ds.create_schema(name, spec)
        ds.write(name, data)
        out.append(ds)
    return out


JSON_DOCS = ['{"user": {"age": 30, "name": "ann"}, "tags": ["a", "b"]}',
             '{"user": {"age": 10, "name": "bob"}}',
             '{"user": {"name": "cat"}}',
             '{"user": {"age": "old", "name": "dan"}}',
             '{bad', '', None]


@pytest.mark.parametrize("cql,n", [
    ('"$.attrs.user.age" > 18', 1),
    ('"$.attrs.user.age" <= 30', 2),
    ("\"$.attrs.user.name\" = 'cat'", 1),
    ("\"$.attrs.tags[0]\" = 'a'", 1),
    ('"$.attrs.nope.deep" > 0', 0),
    ('"$.attrs.user.age" = 30', 1),
    ('"$.attrs.user.age" <> 30', 2),
    ("\"$.attrs.user.age\" > 'a'", 1),
    ("\"$.attrs.user.name\" LIKE 'c%'", 1),
    ("\"$.attrs.user.name\" IN ('ann', 'dan')", 2),
    # IS NULL tests the attribute column, not the path: no row is null
    ('"$.attrs.user.age" IS NULL', 0),
    ('"$.attrs.tags" IS NULL', 0),
])
def test_json_path_attribute_queries(cql, n):
    data = {"attrs": np.asarray(JSON_DOCS, dtype=object),
            "dtg": np.zeros(len(JSON_DOCS), dtype=np.int64),
            "geom": (np.zeros(len(JSON_DOCS)), np.zeros(len(JSON_DOCS)))}
    jds, tds = _store_pair("j", "attrs:Json,dtg:Date,*geom:Point", data)
    got = []
    for ds in (jds, tds):
        try:
            got.append(sorted(ds.query("j", cql).ids.tolist()))
        except Exception as e:  # noqa: BLE001 — compared below
            got.append((type(e).__name__, str(e)))
    assert got[1] == got[0]
    assert len(got[1]) == n


@pytest.mark.parametrize("cql,n", [
    ("\"$.props[0].name\" = 'first'", 1),
    ("\"$.props[1].name\" = 'second'", 1),
    ("\"$.props[2].name\" = 'second'", 0),
    ("\"$.props[0]\" IS NULL", 0),
])
def test_json_path_bracket_first_segment(cql, n):
    data = {"props": np.asarray(
        ['[{"name": "first"}, {"name": "second"}]', '[]'], dtype=object),
        "dtg": np.zeros(2, dtype=np.int64),
        "geom": (np.zeros(2), np.zeros(2))}
    jds, tds = _store_pair("ja", "props:Json,dtg:Date,*geom:Point", data)
    got = [sorted(ds.query("ja", cql).ids.tolist()) for ds in (jds, tds)]
    assert got[1] == got[0] and len(got[1]) == n


def test_json_path_malformed_and_none_semantics():
    data = {"attrs": np.asarray(['{"a": 30}', '{bad', '{}'], dtype=object),
            "name": np.asarray(["x", None, "Nellie"], dtype=object),
            "dtg": np.zeros(3, dtype=np.int64),
            "geom": (np.zeros(3), np.zeros(3))}
    jds, tds = _store_pair("jm", "attrs:Json,name:String,dtg:Date,"
                                 "*geom:Point", data)
    for cql, n in (('"$.attrs.a" = 30', 1), ('"$.attrs.a" <> 30', 0),
                   ("name LIKE 'N%'", 1)):
        got = [len(ds.query("jm", cql)) for ds in (jds, tds)]
        assert got == [n, n], cql


@pytest.mark.parametrize("prop", ["$.attrs", "$.attrs.user",
                                  "$.attrs.user.age", "$.attrs.tags[1]",
                                  "$.attrs[0]", "name"])
def test_prop_column_matches(prop):
    from geomesa_tpu.features.batch import FeatureBatch as JB
    from geomesa_tpu.features.feature_type import parse_spec as jspec
    from geomesa_tpu_torch.features.batch import FeatureBatch as TB
    from geomesa_tpu_torch.features.feature_type import parse_spec as tspec
    spec = "attrs:Json,name:String,*geom:Point"
    data = {"attrs": np.asarray(JSON_DOCS, dtype=object),
            "name": np.asarray([f"n{i}" for i in range(len(JSON_DOCS))],
                               dtype=object),
            "geom": (np.zeros(len(JSON_DOCS)), np.zeros(len(JSON_DOCS)))}
    got = []
    for fn, fb, sp in ((j_prop, JB, jspec), (t_prop, TB, tspec)):
        try:
            col = fn(fb.from_dict(sp("p", spec), data), prop)
            got.append((col.dtype, col.tolist()))
        except Exception as e:  # noqa: BLE001 — compared below
            got.append((type(e).__name__, str(e)))
    assert got[1] == got[0]
