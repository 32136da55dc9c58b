"""Port parity: the metadata catalog through geomesa_tpu_torch's store
against geomesa_tpu's — the version handshake and the catalog lock,
schema files with their index versions, stats persistence (the
``__meta__`` id counter and generation, per-process files merged on a
single-controller open, poisoned merges dropped and defaults re-seeded,
pre-v3 Frequency tables dropped), ``flush`` and the reopen of default and
mesh stores (2 CPU shards in the port, the suite's 8-device virtual mesh
in the JAX package) with row and attribute labels, and the catalog
branches of ``update_schema``, ``remove_schema``, ``migrate_schema`` and
``stats_analyze``.

Held equal: the files both packages write for the same operations (the
parquet schema with its metadata and the table, the stats and label JSON
key for key, ``schema.json`` but for ``updated``); a catalog either
package writes, opened by the other — positions, ids, counts, stats JSON,
bounds, what a restricted caller sees, and the next auto id; and the
frozen JAX fixture ``tests/data/catalog_v1`` (read from a copy)."""

import json
import os
import shutil

import numpy as np
import pyarrow.parquet as pq
import pytest

from geomesa_tpu.datastore import CatalogVersionError as JaxVersionError
from geomesa_tpu.datastore import TpuDataStore as JaxStore
from geomesa_tpu.features.feature_type import parse_spec as j_parse_spec
from geomesa_tpu.parallel import device_mesh as jax_mesh
from geomesa_tpu.security import StaticAuthorizationsProvider as JaxAuth
from geomesa_tpu.stats.stat import Frequency as JaxFrequency
from geomesa_tpu.stats.stat import Histogram as JaxHistogram
from geomesa_tpu_torch import TpuDataStore, device_mesh
from geomesa_tpu_torch.datastore import (
    CATALOG_VERSION, CURRENT_INDEX_VERSIONS, CatalogVersionError,
)
from geomesa_tpu_torch.features.feature_type import parse_spec

MS = 1514764800000
DAY = 86_400_000
N = 3_000
SPEC = "name:String:index=true,ssn:String,v:Int,dtg:Date,*geom:Point"
QUERIES = [
    "BBOX(geom, -74.5, 40.5, -73.5, 41.5) AND dtg DURING "
    "2018-01-03T00:00:00Z/2018-01-10T00:00:00Z",
    "BBOX(geom, -74.2, 40.2, -73.9, 41.7)",
    "name = 'rare'",
    "ssn = 'S1'",
    "IN ('3', '5', '2999', '4000')",
    "INCLUDE",
]
FIXTURE = os.path.join(os.path.dirname(__file__), "data", "catalog_v1")


def _open(side: str, d: str, profile: str = "default", auths=None):
    kw = {}
    if auths is not None:
        kw["auth_provider"] = (JaxAuth if side == "jax" else
                               _port_auth())(set(auths))
    if profile == "mesh":
        kw["mesh"] = (jax_mesh() if side == "jax"
                      else device_mesh(devices=["cpu"] * 2))
    if side == "jax":
        return JaxStore(d, **kw)
    return TpuDataStore(device="cpu", catalog_dir=d, **kw)


def _port_auth():
    from geomesa_tpu_torch.security import StaticAuthorizationsProvider
    return StaticAuthorizationsProvider


def _rows(lo: int, hi: int):
    rng = np.random.default_rng(3)
    rows = {"name": rng.choice(np.array(["a", "b", "rare"], object), N,
                               p=[.6, .39, .01]),
            "ssn": rng.choice(np.array(["S1", "S2"], object), N),
            "v": rng.integers(0, 100, N).astype(np.int32),
            "dtg": rng.integers(MS, MS + 20 * DAY, N),
            "geom": (rng.uniform(-75, -73, N), rng.uniform(40, 42, N))}
    return {k: ((v[0][lo:hi], v[1][lo:hi]) if k == "geom" else v[lo:hi])
            for k, v in rows.items()}


def _fill(side: str, d: str, profile: str):
    """Labelled writes (an attribute guard on ``ssn``), a delete, flush."""
    ds = _open(side, d, profile, auths=("user",))
    ds.create_schema("s", SPEC)
    ds.write("s", _rows(0, N // 2), visibility="user")
    ds.write("s", _rows(N // 2, N), visibility="admin",
             attribute_visibilities={"ssn": "admin"})
    assert ds.delete("s", ["3", "5", "2999"]) == 3
    ds.flush("s")
    return ds


def _env(e):
    return None if e is None else e.as_tuple()


def _same_reads(got, want):
    for ecql in QUERIES:
        a, b = want.query_result("s", ecql), got.query_result("s", ecql)
        assert b.strategy.index == a.strategy.index, ecql
        np.testing.assert_array_equal(b.positions, a.positions)
        np.testing.assert_array_equal(b.batch.ids.astype(str),
                                      a.batch.ids.astype(str))
        for col in ("name", "ssn", "v"):
            np.testing.assert_array_equal(b.batch.column(col),
                                          a.batch.column(col))
    assert got.get_count("s") == want.get_count("s")
    assert _env(got.get_bounds("s")) == _env(want.get_bounds("s"))
    for key in ("count", "dtg_minmax", "v_minmax", "geom_bbox",
                "name_topk", "name_enumeration"):
        a, b = want.stat("s", key), got.stat("s", key)
        assert (a is None) == (b is None), key
        if a is not None:
            assert b.to_json() == a.to_json(), key
    assert got._store("s").next_fid == want._store("s").next_fid


def _json(path: str):
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("profile", ["default", "mesh"])
def test_flush_files_and_cross_open(tmp_path, profile):
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    _fill("jax", dj, profile)
    _fill("torch", dt, profile)
    a = pq.read_table(os.path.join(dj, "s.parquet"))
    b = pq.read_table(os.path.join(dt, "s.parquet"))
    assert b.schema.equals(a.schema, check_metadata=True)
    assert b.equals(a)
    for suffix in (".stats.json", ".vis.json"):
        assert _json(os.path.join(dt, "s" + suffix)) == \
            _json(os.path.join(dj, "s" + suffix))
    sj, st = (_json(os.path.join(d, "s.schema.json")) for d in (dj, dt))
    assert {k: v for k, v in st.items() if k != "updated"} == \
        {k: v for k, v in sj.items() if k != "updated"}
    assert open(os.path.join(dt, "catalog.version")).read() == \
        str(CATALOG_VERSION) == open(os.path.join(dj,
                                                  "catalog.version")).read()
    for auths in (("user",), ("user", "admin")):
        ref = _open("jax", dj, profile, auths)
        _same_reads(_open("torch", dj, profile, auths), ref)
        _same_reads(_open("jax", dt, profile, auths), ref)
    # ids are never reused across the reopen: the next auto id follows
    # the highest ever issued, the deleted 2999 included
    for side in ("jax", "torch"):
        ds = _open(side, dj, profile)
        ds.write("s", _rows(0, 1))
        assert ds.query("s", "IN ('3000')").ids.tolist() == ["3000"]


def test_mesh_stats_after_reopen(tmp_path):
    """A mesh store reopened from a catalog answers stats pushed down per
    shard like the JAX one."""
    d = str(tmp_path / "cat")
    _fill("torch", d, "default")
    spec = "Count();MinMax(v);Histogram(v,16,0,100)"
    q = QUERIES[0]
    got = _open("torch", d, "mesh").stats("s", q, spec)
    want = _open("jax", d, "mesh").stats("s", q, spec)
    assert got.to_json() == want.to_json()


def test_catalog_persistence(tmp_path):
    d = str(tmp_path)
    ds = TpuDataStore(device="cpu", catalog_dir=d)
    ds.create_schema("s1", "a:Int,dtg:Date,*geom:Point")
    ds.write("s1", {"a": [1], "dtg": [MS],
                    "geom": (np.r_[0.0], np.r_[0.0])})
    ds.persist_stats("s1")
    for ds2 in (TpuDataStore(device="cpu", catalog_dir=d), JaxStore(d)):
        assert ds2.type_names == ["s1"]
        assert ds2.get_schema("s1").dtg_field == "dtg"
        ds2.load_stats("s1")
        assert ds2._store("s1")._stats["count"].count == 1
        assert ds2._store("s1").next_fid == 1


def test_catalog_version_handshake_and_lock(tmp_path):
    d = str(tmp_path / "cat")
    ds = TpuDataStore(device="cpu", catalog_dir=d)
    ds.create_schema("t", "v:Int,*geom:Point")
    # the lock is reentrant: nested catalog mutations do not deadlock
    with ds._catalog_lock():
        ds.remove_schema("t")
        ds.create_schema("t", "v:Int,*geom:Point")
    assert TpuDataStore(device="cpu", catalog_dir=d).type_names == ["t"]
    # another process created the schema since this store loaded
    other = JaxStore(d)
    other.create_schema("u", "v:Int,*geom:Point")
    with pytest.raises(ValueError, match="another process"):
        ds.create_schema("u", "v:Int,*geom:Point")
    with open(os.path.join(d, "catalog.version"), "w") as f:
        f.write("999")
    with pytest.raises(CatalogVersionError, match="newer"):
        TpuDataStore(device="cpu", catalog_dir=d)
    with pytest.raises(JaxVersionError):
        JaxStore(d)
    # multi-controller stores still raise
    with pytest.raises(NotImplementedError, match="multihost"):
        TpuDataStore(device="cpu", catalog_dir=d, multihost=True)


def test_back_compat_catalog_fixture(tmp_path):
    """The frozen v1 catalog the JAX package wrote opens in the port and
    answers as it does in the JAX package."""
    d = str(tmp_path / "catalog_v1")
    shutil.copytree(FIXTURE, d, ignore=shutil.ignore_patterns(".lock"))
    ds, ref = TpuDataStore(device="cpu", catalog_dir=d), JaxStore(d)
    assert ds.type_names == ["legacy"]
    assert ds.get_count("legacy") == 500
    q = "BBOX(geom, -10, 40, 0, 50) AND name = 'n1'"
    got, want = ds.query("legacy", q), ref.query("legacy", q)
    x, _ = got.geom_xy()
    assert len(got) > 0 and (x <= 0).all()
    assert set(got.column("name")) == {"n1"}
    assert got.ids.tolist() == want.ids.tolist()
    assert ds._store("legacy").index_versions == CURRENT_INDEX_VERSIONS
    for key in ("count", "dtg_minmax", "name_topk", "v_minmax"):
        assert ds.stat("legacy", key).to_json() == \
            ref.stat("legacy", key).to_json()
    assert ds._store("legacy").next_fid == ref._store("legacy").next_fid


def test_update_schema_rename_moves_catalog_files(tmp_path):
    d = str(tmp_path / "cat")
    ds = TpuDataStore(device="cpu", catalog_dir=d)
    ds.create_schema("old", "v:Int,dtg:Date,*geom:Point")
    ds.write("old", {"v": np.arange(5), "dtg": np.zeros(5, np.int64),
                     "geom": (np.zeros(5), np.zeros(5))},
             visibility="user")
    ds.flush("old")
    # stale target-name leftovers (a crashed remove of an older schema)
    with open(os.path.join(d, "new.p3.stats.json"), "w") as f:
        json.dump({"count": {"kind": "count", "count": 99}}, f)
    os.makedirs(os.path.join(d, "new.lean"))
    # a target that exists on disk (another process) is refused
    JaxStore(d).create_schema("taken", "v:Int,dtg:Date,*geom:Point")
    with pytest.raises(ValueError, match="already exists"):
        ds.update_schema("old", parse_spec("taken",
                                           "v:Int,dtg:Date,*geom:Point"))
    assert ds.type_names == ["old"]
    ds.update_schema("old", parse_spec("new", "v:Int,dtg:Date,*geom:Point"))
    assert sorted(f for f in os.listdir(d) if f.startswith(("old", "new"))) \
        == ["new.parquet", "new.schema.json", "new.stats.json",
            "new.vis.json"]
    for ds2 in (TpuDataStore(device="cpu", catalog_dir=d), JaxStore(d)):
        assert ds2.type_names == ["new", "taken"]
        assert ds2.get_count("new") == 5
        assert ds2.stat("new", "count").count == 5


def test_remove_schema_clears_catalog_files(tmp_path):
    d = str(tmp_path / "cat")
    ds = TpuDataStore(device="cpu", catalog_dir=d)
    ds.create_schema("s", SPEC)
    ds.write("s", _rows(0, 10), visibility="user")
    ds.flush("s")
    with open(os.path.join(d, "s.p0.stats.json"), "w") as f:
        json.dump({}, f)
    ds.remove_schema("s")
    assert sorted(os.listdir(d)) == [".lock", "catalog.version"]
    assert TpuDataStore(device="cpu", catalog_dir=d).type_names == []


def _stats_catalog(tmp_path, version: int = CATALOG_VERSION):
    """A flushed catalog plus per-process stats files newer than the
    shared one (their generations higher): one whose histograms of ``v``
    cannot merge, one carrying a Frequency table."""
    d = str(tmp_path / "cat")
    ds = TpuDataStore(device="cpu", catalog_dir=d)
    ds.create_schema("s", SPEC)
    ds.write("s", _rows(0, N))
    ds.flush("s")
    shared = _json(os.path.join(d, "s.stats.json"))
    freq = JaxFrequency("name", depth=4, width=64)
    for i, (lo, hi) in enumerate(((0.0, 50.0), (10.0, 100.0))):
        per = dict(shared)
        per["__meta__"] = {"next_fid": 5000 + i, "generation": 7}
        per["v_histogram"] = JaxHistogram("v", 8, lo, hi).to_json()
        per["name_frequency"] = freq.to_json()
        with open(os.path.join(d, f"s.p{i}.stats.json"), "w") as f:
            json.dump(per, f)
    with open(os.path.join(d, "catalog.version"), "w") as f:
        f.write(str(version))
    return d


@pytest.mark.parametrize("version", [2, CATALOG_VERSION])
def test_load_stats_merges_per_process_files(tmp_path, version):
    d = _stats_catalog(tmp_path, version)
    got, want = TpuDataStore(device="cpu", catalog_dir=d), JaxStore(d)
    gs, ws = got._store("s"), want._store("s")
    assert sorted(gs._stats) == sorted(ws._stats)
    assert "v_histogram" not in gs._stats            # poisoned, dropped
    assert ("name_frequency" in gs._stats) == (version >= 3)
    for k in ws._stats:
        assert gs._stats[k].to_json() == ws._stats[k].to_json(), k
    assert gs._stats["count"].count == 2 * N          # merged p0 + p1
    assert gs.next_fid == ws.next_fid == 5001
    assert gs.stats_generation == ws.stats_generation == 7
    # a single-controller persist retires the per-process family, but
    # never a file whose row snapshot still exists
    os.makedirs(os.path.join(d, "s.lean.p1"))
    got.persist_stats("s")
    assert sorted(f for f in os.listdir(d) if f.endswith(".stats.json")) \
        == ["s.p1.stats.json", "s.stats.json"]
    assert _json(os.path.join(d, "s.stats.json"))["__meta__"] == \
        {"next_fid": 5001, "generation": 8}


def test_stats_analyze_and_migrate_persist(tmp_path):
    d = str(tmp_path / "cat")
    ds = TpuDataStore(device="cpu", catalog_dir=d)
    ds.create_schema("ev", SPEC + ";geomesa.index.versions='z3:1,z2:1'")
    ds.write("ev", _rows(0, N))
    assert _json(os.path.join(d, "ev.schema.json"))[
        "index_versions"]["z3"] == 1
    assert not os.path.exists(os.path.join(d, "ev.stats.json"))
    assert ds.stats_analyze("ev") == N
    assert _json(os.path.join(d, "ev.stats.json"))["count"]["count"] == N
    for side in ("jax", "torch"):
        # the analyzed sketches survive a reopen with no rows flushed
        ds2 = _open(side, d)
        assert ds2._store("ev").index_versions["z3"] == 1
        assert ds2.stat("ev", "count").count == N
        assert ds2._store("ev").next_fid == N
    ds.flush("ev")
    got = _open("torch", d).query_result("ev", QUERIES[0])
    want = _open("jax", d).query_result("ev", QUERIES[0])
    np.testing.assert_array_equal(got.positions, want.positions)
    assert _open("torch", d)._store("ev").z3_index().version == 1
    assert ds.migrate_schema("ev")["z3"] == 1
    meta = _json(os.path.join(d, "ev.schema.json"))
    assert meta["index_versions"] == CURRENT_INDEX_VERSIONS
    assert "geomesa.index.versions" not in meta["spec"]
    assert JaxStore(d)._store("ev").index_versions["z3"] == 2


def test_pre_versioning_catalog_defaults_to_current(tmp_path):
    """A v1-era catalog entry (no index_versions key) reads as the
    current layouts — what the first writer wrote."""
    d = str(tmp_path / "cat")
    ds = JaxStore(d)
    ds.create_schema("ev", "name:String,dtg:Date,*geom:Point")
    ds.write("ev", {k: v for k, v in _rows(0, N).items()
                    if k in ("name", "dtg", "geom")})
    ds.flush("ev")
    path = os.path.join(d, "ev.schema.json")
    meta = _json(path)
    del meta["index_versions"]
    with open(path, "w") as f:
        json.dump(meta, f)
    with open(os.path.join(d, "catalog.version"), "w") as f:
        f.write("1")
    got = _open("torch", d)
    assert got._store("ev").index_versions == CURRENT_INDEX_VERSIONS
    np.testing.assert_array_equal(
        got.query_result("ev", QUERIES[0]).positions,
        _open("jax", d).query_result("ev", QUERIES[0]).positions)


def test_interceptors_resolve_at_open(tmp_path):
    """A catalog whose interceptor chain no longer imports fails at open
    in both packages, where the operator is looking."""
    d = str(tmp_path / "cat")
    ds = TpuDataStore(device="cpu", catalog_dir=d)
    ds.create_schema("s", "v:Int,*geom:Point")
    path = os.path.join(d, "s.schema.json")
    meta = _json(path)
    meta["spec"] += ";geomesa.query.interceptors='no.such.Interceptor'"
    with open(path, "w") as f:
        json.dump(meta, f)
    for side in ("jax", "torch"):
        with pytest.raises((ImportError, ValueError)):
            _open(side, d)
    # the JAX spec grammar reads the catalog the port wrote
    assert j_parse_spec("s", meta["spec"]).user_data[
        "geomesa.query.interceptors"] == "no.such.Interceptor"
