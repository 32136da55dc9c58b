"""Port parity: the geo-indexed blob store (``geomesa_tpu_torch/blob.py``)
and the merged datastore view (``geomesa_tpu_torch/views.py``) against
geomesa_tpu's — the blob half of ``tests/test_blob_native.py``, the id
path-traversal case of ``test_ageoff_memory.py`` and
``test_crs.py::test_merged_view_propagates_crs``, with the view's union,
scope filters, sort, limit and count held equal on seeded stores (the
port's on ``device="cpu"``).  Blob ids are random (uuid4) in both
packages, so blobs are compared by their payloads and query answers by
the payloads behind the ids."""

import numpy as np
import pytest

from geomesa_tpu.blob import GeoIndexedBlobStore as JBlob
from geomesa_tpu.blob import wkt_handler as j_wkt
from geomesa_tpu.datastore import TpuDataStore as JStore
from geomesa_tpu.filters import parse_ecql as j_ecql
from geomesa_tpu.geometry.types import Point as JPoint
from geomesa_tpu.planning.planner import Query as JQuery
from geomesa_tpu.views import MergedDataStoreView as JView
from geomesa_tpu_torch.blob import GeoIndexedBlobStore as TBlob
from geomesa_tpu_torch.blob import wkt_handler as t_wkt
from geomesa_tpu_torch.datastore import TpuDataStore as TStore
from geomesa_tpu_torch.filters import parse_ecql as t_ecql
from geomesa_tpu_torch.geometry.types import Point as TPoint
from geomesa_tpu_torch.planning.planner import Query as TQuery
from geomesa_tpu_torch.views import MergedDataStoreView as TView

MS_2018 = 1514764800000
DAY = 86_400_000

J = {"blob": JBlob, "wkt": j_wkt, "point": JPoint}
T = {"blob": lambda **kw: TBlob(TStore(device="cpu"), **kw), "wkt": t_wkt,
     "point": TPoint}


def _payloads(bs, ids):
    return sorted(bs.get(i)[0] for i in ids)


# -- the blob half of tests/test_blob_native.py -------------------------------

@pytest.mark.parametrize("pkg", [J, T], ids=["jax", "port"])
def test_put_get_roundtrip(pkg):
    bs = pkg["blob"]()
    bid = bs.put(b"payload-bytes", geometry=pkg["point"](10.0, 20.0),
                 dtg=MS_2018, filename="a.bin")
    assert bs.get(bid) == (b"payload-bytes", "a.bin")
    assert bs.get("missing") is None
    named = bs.put(b"n", geometry=pkg["point"](0, 0), blob_id="my-id.1")
    assert named == "my-id.1" and bs.get(named) == (b"n", "")


def test_spatial_query_and_delete():
    got = []
    for pkg in (J, T):
        bs = pkg["blob"]()
        east = bs.put(b"east", geometry=pkg["point"](10, 0), dtg=MS_2018)
        west = bs.put(b"west", geometry=pkg["point"](-10, 0), dtg=MS_2018)
        hit = bs.query_ids("BBOX(geom, 5, -5, 15, 5)")
        assert hit == [east]
        bs.delete_blob(east)
        assert bs.get(east) is None
        assert bs.query_ids() == [west]
        got.append((_payloads(bs, bs.query_ids()), bs.store.get_count(
            "blob")))
    assert got[1] == got[0] == ([b"west"], 1)


def test_wkt_handler():
    got = []
    for pkg in (J, T):
        bs = pkg["blob"]()
        bid = bs.put(b"x", handler=pkg["wkt"],
                     params={"wkt": "POINT (3 4)"}, dtg=MS_2018)
        assert bs.query_ids("BBOX(geom, 2, 3, 4, 5)") == [bid]
        with pytest.raises(ValueError) as e:
            bs.put(b"nogeom", handler=pkg["wkt"], params={})
        got.append(str(e.value))
        assert pkg["wkt"](b"", {}) is None
    assert got[1] == got[0]


@pytest.mark.parametrize("pkg", [J, T], ids=["jax", "port"])
def test_file_backed(tmp_path, pkg):
    bs = pkg["blob"](blob_dir=str(tmp_path / "blobs"))
    bid = bs.put(b"on-disk", geometry=pkg["point"](0, 0), filename="f.txt")
    assert bs.get(bid) == (b"on-disk", "f.txt")
    assert sorted(p.name for p in (tmp_path / "blobs").iterdir()) == \
        sorted([bid, bid + ".name"])
    bs.delete_blob(bid)
    assert bs.get(bid) is None
    assert list((tmp_path / "blobs").iterdir()) == []


@pytest.mark.parametrize("pkg", [J, T], ids=["jax", "port"])
def test_delete_blob_store(pkg):
    bs = pkg["blob"]()
    bs.put(b"a", geometry=pkg["point"](0, 0))
    bs.put(b"b", geometry=pkg["point"](1, 1))
    bs.delete_blob_store()
    assert "blob" not in bs.store.type_names


@pytest.mark.parametrize("pkg", [J, T], ids=["jax", "port"])
def test_blob_id_path_traversal_rejected(tmp_path, pkg):
    bs = pkg["blob"](blob_dir=str(tmp_path / "b"))
    with pytest.raises(ValueError):
        bs.put(b"x", geometry=pkg["point"](0, 0), blob_id="../escape")
    assert bs.get("../../etc/passwd") is None
    bs.delete_blob("../../etc/passwd")  # no-op, no exception


def test_blob_store_over_a_given_store():
    """A blob store over an existing store and a custom type name; the
    port's store keeps its own device, and no second store is made."""
    tds = TStore(device="cpu")
    bs = TBlob(tds, type_name="docs")
    assert bs.store is tds and "docs" in tds.type_names
    jbs = JBlob(JStore(), type_name="docs")
    assert tds.get_schema("docs").spec_string() == \
        jbs.store.get_schema("docs").spec_string()


def test_blob_query_at_scale():
    """A few hundred blobs at seeded points: every box query answers the
    same payloads in both packages, equal to a numpy box test."""
    rng = np.random.default_rng(12)
    n = 300
    xs, ys = rng.uniform(-50, 50, n), rng.uniform(-30, 30, n)
    stores = []
    for pkg in (J, T):
        bs = pkg["blob"]()
        for i in range(n):
            bs.put(f"b{i}".encode(), geometry=pkg["point"](xs[i], ys[i]),
                   dtg=MS_2018 + i)
        stores.append(bs)
    for box in ((-10, -10, 10, 10), (20, -30, 50, 0), (-50, -30, 50, 30)):
        want = sorted(f"b{i}".encode() for i in np.flatnonzero(
            (xs >= box[0]) & (xs <= box[2]) & (ys >= box[1])
            & (ys <= box[3])))
        cql = f"BBOX(geom, {box[0]}, {box[1]}, {box[2]}, {box[3]})"
        for bs in stores:
            assert _payloads(bs, bs.query_ids(cql)) == want


# -- views.py ----------------------------------------------------------------

def test_merged_view_propagates_crs():
    got = []
    for Store, View, ecql, Query, kw in (
            (JStore, JView, j_ecql, JQuery, {}),
            (TStore, TView, t_ecql, TQuery, {"device": "cpu"})):
        ds = Store(**kw)
        ds.create_schema("pts2", "name:String,*geom:Point")
        ds.write("pts2", {"name": ["a"], "geom": ([90.0], [45.0])})
        view = View([ds], filters=[ecql("INCLUDE")])
        out = view.query("pts2", Query.of("INCLUDE", crs="EPSG:3857"))
        x, y = out.geom_xy()
        assert abs(x[0]) > 1e6  # mercator meters, not degrees
        got.append((float(x[0]), float(y[0])))
    assert got[1] == got[0]


def _view_stores(Store, kw):
    rng = np.random.default_rng(21)
    out = []
    for k in range(2):
        n = 300 + 100 * k
        ds = Store(**kw)
        ds.create_schema("evt", "name:String,score:Double,dtg:Date,"
                                "*geom:Point")
        ds.write("evt", {
            "name": np.asarray([f"s{k}_{i % 7}" for i in range(n)],
                               dtype=object),
            "score": rng.uniform(0, 100, n),
            "dtg": rng.integers(MS_2018, MS_2018 + 10 * DAY, n),
            "geom": (rng.uniform(-20, 20, n), rng.uniform(-10, 10, n))},
            ids=np.asarray([f"k{k}-{i}" for i in range(n)], dtype=object))
        out.append(ds)
    return out


@pytest.mark.parametrize("q,scoped", [
    ("INCLUDE", False),
    ("BBOX(geom, -5, -5, 10, 5)", False),
    ("BBOX(geom, -5, -5, 10, 5) AND dtg DURING "
     "2018-01-02T00:00:00Z/2018-01-06T00:00:00Z", True),
    ("score > 50", True),
    ("BBOX(geom, 30, 30, 40, 40)", True),
])
def test_merged_view_union_and_scopes(q, scoped):
    views = []
    for Store, View, ecql, kw in ((JStore, JView, j_ecql, {}),
                                  (TStore, TView, t_ecql, {"device": "cpu"})):
        stores = _view_stores(Store, kw)
        filters = ([ecql("BBOX(geom, -20, -10, 0, 10)"),
                    ecql("score < 70")] if scoped else None)
        views.append((View(stores, filters=filters), stores, ecql))
    got = []
    for view, stores, ecql in views:
        out = view.query("evt", q)
        got.append((out.ids.tolist(), out.column("score").tolist(),
                    view.count("evt", q)))
    assert got[1] == got[0]
    # the union of the stores' own answers under their scopes
    stores, ecql = views[1][1], views[1][2]
    want = []
    for ds, scope in zip(stores, ("BBOX(geom, -20, -10, 0, 10)",
                                  "score < 70")):
        qq = f"({q}) AND {scope}" if scoped else q
        want += ds.query("evt", qq).ids.tolist()
    assert got[1][0] == want


@pytest.mark.parametrize("kw", [
    {"sort_by": "score"}, {"sort_by": "score", "sort_desc": True},
    {"max_features": 25}, {"sort_by": "dtg", "max_features": 10}])
def test_merged_view_sort_and_limit(kw):
    got = []
    for Store, View, Query, skw in ((JStore, JView, JQuery, {}),
                                    (TStore, TView, TQuery,
                                     {"device": "cpu"})):
        view = View(_view_stores(Store, skw))
        out = view.query("evt", Query.of("BBOX(geom, -10, -8, 15, 8)", **kw))
        got.append((out.ids.tolist(), out.column("dtg").tolist()))
    assert got[1] == got[0]


def test_merged_view_edges():
    for Store, View, ecql, kw in ((JStore, JView, j_ecql, {}),
                                  (TStore, TView, t_ecql, {"device": "cpu"})):
        with pytest.raises(ValueError):
            View([])
        stores = _view_stores(Store, kw)
        with pytest.raises(ValueError):
            View(stores, filters=[ecql("INCLUDE")])
        view = View(stores)
        empty = view.query("evt", "BBOX(geom, 100, 60, 110, 70)")
        assert len(empty) == 0 and empty.sft.name == "evt"
        assert view.get_schema("evt").spec_string() == \
            stores[0].get_schema("evt").spec_string()
        assert view.count("evt") == 700
