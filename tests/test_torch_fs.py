"""Port parity: the geometry and file formats persistence rides on, and
the partitioned FileSystemDataStore, through geomesa_tpu_torch against
geomesa_tpu on the same seeded rows.

Held equal: WKB and TWKB bytes for every geometry kind (and the decoded
coordinates); the Arrow table, Parquet file and ORC rows ``to_arrow``,
``to_parquet`` and ``to_orc`` write, each read back by the other
package's ``from_parquet`` / ``from_orc``; partition names of the z2,
datetime (every step), attribute and composite schemes, string for
string, and their pruning; the FileSystemDataStore's partitions, counts,
auto ids, pruned queries, compaction, ORC encoding and rediscovery, each
store opened by the other package; and ``to_device_store`` against
``fs.query``, on one device and on a 2-shard CPU mesh."""

import os
import struct

import numpy as np
import pyarrow.parquet as pq
import pytest

from geomesa_tpu.datastore import TpuDataStore as JaxStore
from geomesa_tpu.features.batch import FeatureBatch as JBatch
from geomesa_tpu.features.feature_type import parse_spec as j_parse_spec
from geomesa_tpu.filters.ecql import parse_ecql as j_parse_ecql
from geomesa_tpu.fs import FileSystemDataStore as JaxFS
from geomesa_tpu.fs import scheme_from_config as j_scheme
from geomesa_tpu.geometry import types as jt
from geomesa_tpu.geometry import wkb as jwkb
from geomesa_tpu.io import export as jexport
from geomesa_tpu_torch import device_mesh
from geomesa_tpu_torch.features.batch import FeatureBatch
from geomesa_tpu_torch.features.feature_type import parse_spec
from geomesa_tpu_torch.filters import parse_ecql
from geomesa_tpu_torch.fs import (
    FileSystemDataStore, scheme_from_config, to_device_store,
)
from geomesa_tpu_torch.geometry import types as tt
from geomesa_tpu_torch.geometry import wkb
from geomesa_tpu_torch.io import export

MS = 1514764800000
DAY = 86_400_000
SPEC = "name:String,v:Int,score:Double,dtg:Date,*geom:Point"
QUERY = ("BBOX(geom,-74.8,40.2,-74.2,40.8) AND "
         "dtg DURING 2018-01-02T00:00:00Z/2018-01-05T00:00:00Z")


def _geoms(types):
    """One of each geometry kind (holes and multi-parts included)."""
    ring = [(0.0, 0.0), (4.5, 0.0), (4.5, 3.25), (0.0, 3.25)]
    hole = [(1.0, 1.0), (2.0, 1.0), (2.0, 2.0), (1.0, 2.0)]
    line = np.array([(-1.5, 2.0), (3.0, -4.125), (7.25, 8.0)])
    return [
        types.Point(-74.0123456789, 40.75),
        types.LineString(line),
        types.Polygon(ring, (hole,)),
        types.MultiPoint(np.array([(1.0, 2.0), (-3.5, 4.0)])),
        types.MultiLineString((types.LineString(line),
                               types.LineString(line[::-1] + 0.5))),
        types.MultiPolygon((types.Polygon(ring),
                            types.Polygon([(x + 10, y) for x, y in ring]))),
    ]


@pytest.mark.parametrize("i", range(6))
def test_wkb_and_twkb_bytes_equal(i):
    jg, tg = _geoms(jt)[i], _geoms(tt)[i]
    assert tg.geom_type == jg.geom_type
    raw = wkb.wkb_encode(tg)
    assert raw == jwkb.wkb_encode(jg)
    for precision in (7, 3, -1):
        assert wkb.twkb_encode(tg, precision) == \
            jwkb.twkb_encode(jg, precision)
    back = wkb.wkb_decode(raw)
    assert wkb.wkb_encode(back) == raw
    assert back.envelope.as_tuple() == jwkb.wkb_decode(raw).envelope \
        .as_tuple()
    t = wkb.twkb_encode(tg, 7)
    assert wkb.twkb_encode(wkb.twkb_decode(t), 7) == t


def test_wkb_decode_variants_and_errors():
    """EWKB with an SRID, ISO Z and big-endian input decode alike; an
    out-of-range TWKB precision raises in both packages."""
    ewkb = bytes([1]) + struct.pack("<I", 0x20000001) + \
        struct.pack("<I", 4326) + struct.pack("<dd", 1.5, 2.5)
    iso_z = bytes([1]) + struct.pack("<I", 1001) + \
        struct.pack("<ddd", 1.0, 2.0, 3.0)
    big = bytes([0]) + struct.pack(">I", 2) + struct.pack(">I", 2) + \
        struct.pack(">dddd", 0.0, 1.0, 2.0, 3.0)
    for raw in (ewkb, iso_z, big):
        assert wkb.wkb_encode(wkb.wkb_decode(raw)) == \
            jwkb.wkb_encode(jwkb.wkb_decode(raw))
    for mod, types in ((wkb, tt), (jwkb, jt)):
        with pytest.raises(ValueError, match="precision"):
            mod.twkb_encode(types.Point(0.0, 0.0), 8)


def _rows(n, seed=5, days=10):
    rng = np.random.default_rng(seed)
    return {"name": rng.choice(np.array(["n0", "n1", None, "x y"], object),
                               n),
            "v": rng.integers(-50, 50, n).astype(np.int32),
            "score": rng.uniform(-1e6, 1e6, n),
            "dtg": rng.integers(MS, MS + days * DAY, n),
            "geom": (rng.uniform(-75, -74, n), rng.uniform(40, 41, n))}


def _batches(rows, ids=None):
    return (JBatch.from_dict(j_parse_spec("ev", SPEC), rows, ids=ids),
            FeatureBatch.from_dict(parse_spec("ev", SPEC), rows, ids=ids))


def _same_batch(got, want):
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.ids.astype(str), want.ids.astype(str))
    assert sorted(got.columns) == sorted(want.columns)
    for k, col in want.columns.items():
        np.testing.assert_array_equal(got.columns[k], col)


def test_export_formats_cross_read(tmp_path):
    jb, tb = _batches(_rows(500), ids=[f"f{i}" for i in range(500)])
    assert export.to_arrow(tb).equals(jexport.to_arrow(jb),
                                      check_metadata=True)
    pj, pt = str(tmp_path / "j.parquet"), str(tmp_path / "t.parquet")
    jexport.to_parquet(jb, pj)
    export.to_parquet(tb, pt)
    assert pq.read_table(pt).equals(pq.read_table(pj), check_metadata=True)
    # each package reads the other's file, with and without the schema
    _same_batch(export.from_parquet(pj), jexport.from_parquet(pj))
    _same_batch(jexport.from_parquet(pt), jexport.from_parquet(pj))
    oj, ot = str(tmp_path / "j.orc"), str(tmp_path / "t.orc")
    jexport.to_orc(jb, oj)
    export.to_orc(tb, ot)
    _same_batch(export.from_orc(oj, parse_spec("ev", SPEC)),
                jexport.from_orc(oj, j_parse_spec("ev", SPEC)))
    _same_batch(jexport.from_orc(ot, j_parse_spec("ev", SPEC)),
                jexport.from_orc(oj, j_parse_spec("ev", SPEC)))
    # polygons ride as WKT
    spec = "kind:String,*geom:Polygon"
    polys = [g for g in _geoms(tt) if g.geom_type == "Polygon"] * 3
    jpolys = [g for g in _geoms(jt) if g.geom_type == "Polygon"] * 3
    tpb = FeatureBatch.from_dict(parse_spec("p", spec),
                                 {"kind": ["a"] * 3, "geom": polys})
    jpb = JBatch.from_dict(j_parse_spec("p", spec),
                           {"kind": ["a"] * 3, "geom": jpolys})
    assert export.to_arrow(tpb).equals(jexport.to_arrow(jpb),
                                       check_metadata=True)


SCHEMES = [{"scheme": "z2", "z2-resolution": 4},
           {"scheme": "z2", "z2-resolution": 8},
           {"scheme": "datetime", "datetime-step": "daily"},
           {"scheme": "datetime", "datetime-step": "weekly"},
           {"scheme": "datetime", "datetime-step": "monthly"},
           {"scheme": "datetime", "datetime-step": "hourly"},
           {"scheme": "attribute", "partitioned-attribute": "name"},
           {"scheme": "composite",
            "schemes": [{"scheme": "datetime", "datetime-step": "daily"},
                        {"scheme": "attribute",
                         "partitioned-attribute": "name"}]}]
FILTERS = ["BBOX(geom,-74.6,40.1,-74.2,40.9)",
           "dtg DURING 2018-01-02T00:00:00Z/2018-01-05T00:00:00Z",
           "name = 'n1'", "name IN ('n0', 'x y')",
           QUERY + " AND name = 'n0'", "INCLUDE",
           "dtg DURING 2019-01-02T00:00:00Z/2019-01-01T00:00:00Z"]


@pytest.mark.parametrize("cfg", SCHEMES, ids=lambda c: "-".join(
    str(v) for v in c.values() if not isinstance(v, list)))
def test_partition_names_equal(cfg):
    rows = _rows(4_000, days=400)
    # day and hour edges, and the epoch's neighbours
    rows["dtg"][:6] = [MS - 1, MS, MS + DAY - 1, MS + 3_600_000 - 1, 0, -1]
    jb, tb = _batches(rows)
    js, ts = j_scheme(cfg), scheme_from_config(cfg)
    assert ts.to_config() == js.to_config() == cfg
    if cfg.get("partitioned-attribute") or "schemes" in cfg:
        ok = np.array([n is not None for n in rows["name"]])
        jb, tb = jb.take(np.flatnonzero(ok)), tb.take(np.flatnonzero(ok))
    got = ts.partitions_for_batch(tb.sft, tb)
    want = js.partitions_for_batch(jb.sft, jb)
    assert got.dtype == want.dtype == object
    assert got.tolist() == want.tolist()
    for ecql in FILTERS:
        assert ts.partitions_for_filter(tb.sft, parse_ecql(ecql)) == \
            js.partitions_for_filter(jb.sft, j_parse_ecql(ecql)), ecql


def test_datetime_names_every_unit_against_the_row_format():
    """The per-unit formatting equals the JAX package's per-row strftime
    on contiguous and on sparse (the sorted fallback) time ranges."""
    rng = np.random.default_rng(11)
    for step in ("daily", "weekly", "monthly", "hourly"):
        cfg = {"scheme": "datetime", "datetime-step": step}
        for span in (40 * DAY, 200 * 365 * DAY):
            rows = _rows(300)
            rows["dtg"] = np.sort(rng.integers(MS - span // 2,
                                               MS + span // 2, 300))
            jb, tb = _batches(rows)
            assert (scheme_from_config(cfg).partitions_for_batch(
                tb.sft, tb).tolist()
                == j_scheme(cfg).partitions_for_batch(jb.sft, jb).tolist())


def _fs_pair(tmp_path, encoding="parquet", writes=4, n=400):
    out = []
    for side, cls in (("jax", JaxFS), ("torch", FileSystemDataStore)):
        fs = cls(str(tmp_path / side))
        fs.create_schema("ev", SPEC, {"scheme": "datetime",
                                      "datetime-step": "daily"},
                         encoding=encoding)
        for w in range(writes):
            fs.write("ev", _rows(n, seed=w))
        out.append(fs)
    return out


def _same_fs(got, want, queries=(QUERY, "INCLUDE", "name = 'n1'")):
    assert got.type_names == want.type_names == ["ev"]
    assert got.partitions("ev") == want.partitions("ev")
    assert got.partition_info("ev") == want.partition_info("ev")
    assert got.count("ev") == want.count("ev")
    for q in queries:
        a, b = want.query("ev", q), got.query("ev", q)
        order_a, order_b = np.argsort(a.ids.astype(np.int64)), \
            np.argsort(b.ids.astype(np.int64))
        _same_batch(b.take(order_b), a.take(order_a))


@pytest.mark.parametrize("encoding", ["parquet", "orc"])
def test_fs_store_write_prune_compact_rediscover(tmp_path, encoding):
    jfs, tfs = _fs_pair(tmp_path, encoding)
    _same_fs(tfs, jfs)
    meta = tfs._storage("ev")._load_meta()
    assert meta["next_fid"] == 1600 and meta["encoding"] == encoding
    files = [f for fs in meta["partitions"].values() for f in fs]
    assert all(f["file"].endswith("." + encoding) for f in files)
    # the pruned query reads only the over-covered window's days
    st = tfs._storage("ev")
    assert st._select_partitions(parse_ecql(QUERY)) == [
        "2018/01/01", "2018/01/02", "2018/01/03", "2018/01/04",
        "2018/01/05", "2018/01/06"]
    # each package rediscovers the other's store and reads it alike
    _same_fs(JaxFS(str(tmp_path / "torch")), jfs)
    _same_fs(FileSystemDataStore(str(tmp_path / "jax")), jfs)
    tfs.compact("ev")
    jfs.compact("ev")
    assert all(len(f) == 1 for f in
               tfs._storage("ev")._load_meta()["partitions"].values())
    _same_fs(tfs, jfs)
    _same_fs(JaxFS(str(tmp_path / "torch")), jfs)
    # auto ids continue from the metadata counter after a rediscovery
    again = FileSystemDataStore(str(tmp_path / "torch"))
    again.write("ev", _rows(3, seed=9))
    assert again._storage("ev")._load_meta()["next_fid"] == 1603


def test_fs_empty_write_and_empty_result(tmp_path):
    fs = FileSystemDataStore(str(tmp_path))
    fs.create_schema("ev", SPEC)
    fs.write("ev", {"name": np.empty(0, dtype=object),
                    "v": np.empty(0, np.int32), "score": np.empty(0),
                    "dtg": np.empty(0, dtype=np.int64),
                    "geom": (np.empty(0), np.empty(0))})
    out = fs.query("ev", "name = 'nothing'")
    assert len(out) == 0 and out.columns["dtg"].dtype == np.int64
    fs.write("ev", _rows(10))
    assert len(out.concat(fs.query("ev"))) == 10


@pytest.mark.parametrize("mesh", [False, True])
def test_to_device_store(tmp_path, mesh):
    """FSDS partitions lift into the port's store and answer through its
    indexes as ``fs.query`` and the JAX package's lift do."""
    jfs, tfs = _fs_pair(tmp_path, writes=2, n=1500)
    kw = {"mesh": device_mesh(devices=["cpu"] * 2)} if mesh else {}
    ds = to_device_store(tfs, "ev", device="cpu", **kw)
    ref = JaxStore()
    ref.create_schema("ev", SPEC)
    ref.write("ev", jfs.query("ev", "INCLUDE"))
    assert ds.get_count("ev") == 3000
    for q, index in ((QUERY, "z3"), ("BBOX(geom,-74.6,40.1,-74.2,40.9)",
                                     "z2")):
        got = ds.query_result("ev", q)
        assert got.strategy.index == index
        want = tfs.query("ev", q)
        assert sorted(got.batch.ids.tolist()) == sorted(want.ids.tolist())
        assert sorted(got.batch.ids.tolist()) == \
            sorted(ref.query("ev", q).ids.tolist())
    # a catalog given to the lift keeps the lifted rows after a flush
    cat = str(tmp_path / "cat")
    lifted = to_device_store(tfs, "ev", device="cpu", catalog_dir=cat)
    lifted.flush("ev")
    assert os.path.exists(os.path.join(cat, "ev.parquet"))
    assert JaxStore(cat).get_count("ev") == 3000


def test_to_device_store_wants_a_card_or_cpu(tmp_path, monkeypatch):
    """With no device named the lift resolves to the card, as the store
    does: without one it raises rather than falling back."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tfs = FileSystemDataStore(str(tmp_path))
    tfs.create_schema("ev", SPEC)
    with pytest.raises(RuntimeError):
        to_device_store(tfs, "ev")
