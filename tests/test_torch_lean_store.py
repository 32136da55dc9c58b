"""Port parity: the lean (scale) profile inside the store facade of
geomesa_tpu_torch against geomesa_tpu's ``TpuDataStore`` — the same
schema, seeded rows and filters through both stores, at 2^12-slot
generations under a budget that leaves all three tiers (full, keys,
host).

Held equal: positions, strategy names and implicit feature ids of ECQL
queries, heatmaps pushed down next to the keys (exactly) and weighted
ones through the query path (rtol 1e-5), tiles, ``stats`` (Count pushed
down and materialized, MinMax materialized), compaction, and the
first-write switch to the lean profile.  Every lean feature the port
leaves out raises ``NotImplementedError``.
"""

import numpy as np
import pytest

from geomesa_tpu.datastore import TpuDataStore as JaxStore
from geomesa_tpu.parallel import device_mesh as jax_mesh
from geomesa_tpu.geometry.types import Polygon as JaxPolygon
from geomesa_tpu.process.density import density_process as jax_density
from geomesa_tpu_torch import TpuDataStore, density_process, device_mesh
from geomesa_tpu_torch.features.lean import LeanBatch
from geomesa_tpu_torch.geometry.types import Polygon
from geomesa_tpu_torch.index.z3_lean import LeanZ3Index

MS_2018 = 1514764800000
DAY = 86_400_000
SLOTS = 1 << 12
N = 30_000
#: one full and three keys generations beside the sentinel charges
BUDGET = SLOTS * (40 + 16 + 40) + SLOTS * 16 * 3
SPEC = ("actor:String,score:Double,dtg:Date,*geom:Point;"
        "geomesa.index.profile=lean,"
        f"geomesa.lean.generation.slots={SLOTS},"
        f"geomesa.lean.hbm.budget={BUDGET},"
        "geomesa.lean.compaction.factor=0")
BOX = (-74.5, 40.5, -73.5, 41.5)
ENV = (-75.0, 40.0, -73.0, 42.0)
WORLD = (-180.0, -90.0, 180.0, 90.0)


def _chunks(seed=17, n=N, step=9_000):
    rng = np.random.default_rng(seed)
    for s in range(0, n, step):
        m = min(step, n - s)
        yield {"actor": rng.choice(["a", "b", "c"], m).astype(object),
               "score": rng.uniform(0, 100, m),
               "dtg": rng.integers(MS_2018, MS_2018 + 40 * DAY, m),
               "geom": (rng.uniform(-75, -73, m), rng.uniform(40, 42, m))}


@pytest.fixture(scope="module")
def stores():
    jds, tds = JaxStore(), TpuDataStore(device="cpu")
    for ds in (jds, tds):
        ds.create_schema("evt", SPEC)
    for chunk in _chunks():   # chunked writes straddle generations
        jds.write("evt", chunk)
        tds.write("evt", chunk)
    return jds, tds


def test_lean_profile_active(stores):
    jds, tds = stores
    st = tds._store("evt")
    assert st.lean and isinstance(st.batch, LeanBatch)
    idx = st.index("z3")
    assert isinstance(idx, LeanZ3Index)
    # one index across all chunked writes (incremental appends)
    assert st.build_counts == {"z3": 1}
    jidx = jds._store("evt").index("z3")
    assert idx.tier_counts() == jidx.tier_counts() == {
        "full": 1, "keys": 3, "host": 4}
    assert idx.device_bytes() == jidx.device_bytes()
    assert [(g.n, g.base, g.tier) for g in idx.generations] == [
        (g.n, g.base, g.tier) for g in jidx.generations]


ECQL = [
    "BBOX(geom,-74.5,40.5,-73.5,41.5) AND dtg DURING "
    "2018-01-03T00:00:00Z/2018-01-10T00:00:00Z",
    "BBOX(geom,-74.5,40.5,-73.5,41.5) AND actor = 'a' AND score > 50",
    "BBOX(geom,-74.2,40.8,-73.9,41.1)",              # spatial only -> z3
    "BBOX(geom,-74.9,40.1,-74.6,40.4) OR BBOX(geom,-73.4,41.6,-73.1,41.9)",
    "BBOX(geom,-74.5,40.5,-73.5,41.5) AND (dtg DURING "
    "2018-01-02T00:00:00Z/2018-01-04T00:00:00Z OR dtg DURING "
    "2018-02-01T00:00:00Z/2018-02-03T00:00:00Z)",
    "actor = 'b' AND score < 10",                     # no index -> full
    "IN ('123','999999999','007','xyz')",             # implicit ids
    "IN ('5','6','29999') AND score > -1",
    "INCLUDE",
    "EXCLUDE",
]


@pytest.mark.parametrize("ecql", ECQL)
def test_ecql_positions_strategy_and_ids(stores, ecql):
    jds, tds = stores
    got = tds.query_result("evt", ecql)
    want = jds.query_result("evt", ecql)
    assert got.strategy.index == want.strategy.index
    np.testing.assert_array_equal(got.positions, want.positions)
    assert list(got.batch.ids) == list(want.batch.ids)
    assert list(got.batch.ids[:3]) == [str(int(p))
                                       for p in got.positions[:3]]


def test_sort_limit_projection(stores):
    from geomesa_tpu.planning.planner import Query as JQuery
    from geomesa_tpu_torch import Query
    jds, tds = stores
    kw = dict(properties=["actor", "score"], sort_by="score",
              sort_desc=True, max_features=10)
    got = tds.query("evt", Query.of(f"BBOX(geom,{','.join(map(str, BOX))})",
                                    **kw))
    want = jds.query("evt", JQuery.of(
        f"BBOX(geom,{','.join(map(str, BOX))})", **kw))
    assert set(got.columns) == {"actor", "score"}
    np.testing.assert_array_equal(got.column("score"), want.column("score"))
    assert list(got.ids) == list(want.ids)


HEATMAPS = [
    ("INCLUDE", WORLD, 64, 64),
    ("INCLUDE", ENV, 50, 30),
    (f"BBOX(geom,{','.join(map(str, BOX))}) AND dtg DURING "
     "2018-01-03T00:00:00Z/2018-01-10T00:00:00Z", BOX, 64, 48),
    (f"BBOX(geom,{','.join(map(str, BOX))})", ENV, 32, 32),
]


@pytest.mark.parametrize("h", range(len(HEATMAPS)))
def test_heatmaps_pushed_down_and_weighted(stores, h):
    jds, tds = stores
    q, env, w, hgt = HEATMAPS[h]
    got = density_process(tds, "evt", q, env, w, hgt)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(
        got, np.asarray(jax_density(jds, "evt", q, env, w, hgt), np.float64))
    got = density_process(tds, "evt", q, env, w, hgt, weight_attr="score")
    want = np.asarray(jax_density(jds, "evt", q, env, w, hgt,
                                  weight_attr="score"), np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.0)


def test_tiles(stores):
    jds, tds = stores
    for z, x, y in [(0, 0, 0), (1, 0, 0), (3, 2, 2)]:
        np.testing.assert_array_equal(
            tds.density_tile("evt", z, x, y, tile=64),
            np.asarray(jds.density_tile("evt", z, x, y, tile=64),
                       np.float64))
    q = "actor = 'a'"   # a filtered tile runs the query path
    np.testing.assert_array_equal(
        tds.density_tile("evt", 1, 0, 0, tile=32, query=q),
        np.asarray(jds.density_tile("evt", 1, 0, 0, tile=32, query=q),
                   np.float64))


@pytest.mark.parametrize("query,spec", [
    ("INCLUDE", "Count()"),                                # pushed down
    (f"BBOX(geom,{','.join(map(str, WORLD))})", "Count()"),  # pushed down
    (HEATMAPS[2][0], "Count()"),          # cell tiers present: materialized
    (f"BBOX(geom,{','.join(map(str, BOX))})", "MinMax(score)"),
    ("INCLUDE", "Count();MinMax(dtg)"),
])
def test_stats(stores, query, spec):
    jds, tds = stores
    got = tds.stats("evt", query, spec)
    want = jds.stats("evt", query, spec)
    assert got.to_json() == want.to_json()


def test_compact_store():
    """Explicit store compaction folds the four host runs alike on both
    sides (opportunistic compaction off), and answers stay equal."""
    jds, tds = JaxStore(), TpuDataStore(device="cpu")
    for ds in (jds, tds):
        ds.create_schema("evt", SPEC)
    for chunk in _chunks(seed=5):
        jds.write("evt", chunk)
        tds.write("evt", chunk)
    res = tds.compact("evt")
    assert res == jds.compact("evt")
    assert res["z3"]["generations"] == 5
    assert tds._store("evt").index("z3").compactions == 1
    for ecql in ECQL[:3]:
        np.testing.assert_array_equal(
            tds.query_result("evt", ecql).positions,
            jds.query_result("evt", ecql).positions)
    np.testing.assert_array_equal(
        density_process(tds, "evt", "INCLUDE", WORLD, 32, 32),
        np.asarray(jax_density(jds, "evt", "INCLUDE", WORLD, 32, 32)))


def test_auto_switch_on_first_write(monkeypatch):
    monkeypatch.setattr(JaxStore, "LEAN_AUTO_ROWS", 5_000)
    monkeypatch.setattr(TpuDataStore, "LEAN_AUTO_ROWS", 5_000)
    rng = np.random.default_rng(3)
    m = 6_000
    big = {"dtg": rng.integers(MS_2018, MS_2018 + DAY, m),
           "geom": (rng.uniform(-75, -73, m), rng.uniform(40, 42, m))}
    small = {"dtg": np.full(10, MS_2018),
             "geom": (np.zeros(10), np.zeros(10))}
    jds, tds = JaxStore(), TpuDataStore(device="cpu")
    for ds in (jds, tds):
        ds.create_schema("auto", "dtg:Date,*geom:Point")
        ds.create_schema("small", "dtg:Date,*geom:Point")
        ds.write("auto", big)
        ds.write("small", small)
        st = ds._store("auto")
        assert st.lean
        assert st.sft.user_data.get("geomesa.index.profile") == "lean"
        assert not ds._store("small").lean
    q = "BBOX(geom,-74.5,40.5,-73.5,41.5)"
    got, want = tds.query_result("auto", q), jds.query_result("auto", q)
    assert got.strategy.index == want.strategy.index == "z3"
    np.testing.assert_array_equal(got.positions, want.positions)
    # a mesh store never switches (lean over a mesh is not ported)
    mds = TpuDataStore(device="cpu", mesh=device_mesh(devices=["cpu"]))
    mds.create_schema("auto", "dtg:Date,*geom:Point")
    mds.write("auto", big)
    assert not mds._store("auto").lean


def test_default_profile_id_strategy():
    jds, tds = JaxStore(), TpuDataStore(device="cpu")
    chunk = next(_chunks(seed=9, n=3_000))
    for ds in (jds, tds):
        ds.create_schema("plain", "actor:String,score:Double,dtg:Date,"
                                  "*geom:Point")
        ds.write("plain", chunk)
        ds.write("plain", chunk)
    for ecql in ("IN ('12','4000','nope')", "IN ('7') AND actor = 'a'"):
        got, want = tds.query_result("plain", ecql), jds.query_result(
            "plain", ecql)
        assert got.strategy.index == want.strategy.index == "id"
        np.testing.assert_array_equal(got.positions, want.positions)


def test_lean_rejections(stores):
    _, tds = stores
    one = {"actor": np.array(["x"], object), "score": np.array([1.0]),
           "dtg": np.array([MS_2018]),
           "geom": (np.array([-74.0]), np.array([41.0]))}
    with pytest.raises(ValueError, match="implicit feature ids"):
        tds.write("evt", one, ids=["custom"])
    with pytest.raises(ValueError, match="z3/id only"):
        tds._store("evt").index("z2")
    with pytest.raises(AttributeError, match="implicit ids"):
        _ = tds._store("evt").batch.ids
    with pytest.raises(ValueError, match="point geometry"):
        tds.create_schema("bad", "v:Int,dtg:Date;"
                                 "geomesa.index.profile=lean")


def test_left_out_features_raise(stores, tmp_path):
    jds, tds = stores
    lean = ";geomesa.index.profile=lean"
    # lean schemas over a mesh are served since the sharded lean slice
    # (tests/test_torch_lean_sharded.py, test_torch_attr_lean_sharded.py):
    # a one-shard mesh store answers as the JAX one does
    attr_spec = "name:String:index=true,dtg:Date,*geom:Point" + lean
    rows = {"name": np.array(["x", "y", "x"], object),
            "dtg": np.array([MS_2018, MS_2018 + DAY, MS_2018 + 2 * DAY]),
            "geom": (np.array([-74.0, -74.2, 10.0]),
                     np.array([41.0, 41.1, 10.0]))}
    mds = TpuDataStore(device="cpu", mesh=device_mesh(devices=["cpu"]))
    jms = JaxStore(mesh=jax_mesh(1))
    for ds in (mds, jms):
        ds.create_schema("m", "dtg:Date,*geom:Point" + lean)
        ds.create_schema("attr", attr_spec)
        ds.write("m", {k: v for k, v in rows.items() if k != "name"})
        ds.write("attr", rows)
    for name, q in (("m", "BBOX(geom,-75,40,-73,42)"),
                    ("attr", "name = 'x'"),
                    ("attr", "name = 'x' AND BBOX(geom,-75,40,-73,42)")):
        a, b = mds.query_result(name, q), jms.query_result(name, q)
        assert b.strategy.index == a.strategy.index
        assert list(b.positions) == list(a.positions)
    tds.create_schema("attr", attr_spec)
    assert tds._store("attr").query_indices == {"z3", "id", "attr"}
    # non-point lean schemas ride the lean XZ indexes: both stores answer
    # alike
    poly_spec = "v:Int,*poly:Polygon" + lean
    ring = [(0, 0), (1, 0), (1, 1), (0, 1)]
    for ds, poly_cls in ((jds, JaxPolygon), (tds, Polygon)):
        ds.create_schema("poly", poly_spec)
        ds.write("poly", {"v": np.arange(3), "poly": [
            poly_cls([(x + i, y) for x, y in ring]) for i in range(3)]})
    for q in ("BBOX(poly, 0.5, 0.5, 1.5, 0.7)", "v = 2", "IN ('1')"):
        a, b = jds.query_result("poly", q), tds.query_result("poly", q)
        assert b.strategy.index == a.strategy.index
        assert list(b.positions) == list(a.positions)
    assert (tds._store("poly").lean_kind == jds._store("poly").lean_kind
            == "xz2")
    # pyramids and the cell-count fold are ported: they answer as the
    # JAX store does
    assert tds.build_pyramids("evt") == jds.build_pyramids("evt")
    assert (tds._store("evt").index("z3").z3_cell_counts(8)
            == jds._store("evt").index("z3").z3_cell_counts(8))
    # batched windows and the fused plane are served since the serving
    # slice: both stores answer alike (INCLUDE bypasses fusion)
    windows = [([BOX], None, None), ([BOX], MS_2018, MS_2018 + 5 * DAY)]
    for a, b in zip(tds.query_windows("evt", windows),
                    jds.query_windows("evt", windows)):
        assert list(a) == list(b)
    for q in ("INCLUDE", f"BBOX(geom, {', '.join(map(str, BOX))})"):
        a, b = tds.query_fused("evt", q), jds.query_fused("evt", q)
        assert a.strategy.index == b.strategy.index
        assert list(a.positions) == list(b.positions)
    # catalogs are served since the persistence slice: the lean polygon
    # schema flushes, and the JAX store reopens it with the same answers
    cat = str(tmp_path / "catalog")
    pds = TpuDataStore(device="cpu", catalog_dir=cat)
    pds.create_schema("poly", poly_spec)
    pds.write("poly", {"v": np.arange(3), "poly": [
        Polygon([(x + i, y) for x, y in ring]) for i in range(3)]})
    pds.flush("poly")
    for q in ("BBOX(poly, 0.5, 0.5, 1.5, 0.7)", "v = 2", "IN ('1')"):
        a = JaxStore(cat).query_result("poly", q)
        b = TpuDataStore(device="cpu", catalog_dir=cat).query_result(
            "poly", q)
        assert b.strategy.index == a.strategy.index
        assert list(b.positions) == list(a.positions) == list(
            jds.query_result("poly", q).positions)
    # deletes and visibilities are served since the lifecycle slice
    # (tests/test_torch_delete.py, tests/test_torch_security.py), the
    # observability-backed reports since the observability slice
    # (tests/test_torch_explain_analyze.py, tests/test_torch_resource.py)
    assert tds.explain_analyze("evt", "INCLUDE").summary["hits"] == len(
        tds._store("evt").batch)
    assert tds.storage_report()["reconciliation"]["within_tolerance"]


# -- lean schemas over a mesh (the JAX package's tests/test_lean_store.py
# mesh tests) ---------------------------------------------------------------
def _mesh_rows(seed, n):
    rng = np.random.default_rng(seed)
    return {"name": rng.choice(["a", "b", "c"], n).astype(object),
            "score": rng.uniform(0, 100, n),
            "dtg": rng.integers(MS_2018, MS_2018 + 14 * DAY, n),
            "geom": (rng.uniform(-75, -73, n), rng.uniform(40, 42, n))}


@pytest.mark.parametrize("n_shards", [2, 8])
def test_lean_store_over_mesh(n_shards, monkeypatch):
    """The sharded lean z3 index serves the store facade: the same answers
    as the JAX mesh store and the single-device lean store, before and
    after a delete."""
    from geomesa_tpu.parallel.attr_lean import ShardedLeanAttrIndex as JA
    from geomesa_tpu_torch.parallel import (
        ShardedLeanAttrIndex, ShardedLeanZ3Index,
    )
    monkeypatch.setattr(ShardedLeanAttrIndex, "GENERATION_SLOTS",
                        JA.GENERATION_SLOTS)
    data = _mesh_rows(29, 20_000)
    spec = ("name:String:index=true,score:Double,dtg:Date,*geom:Point;"
            "geomesa.index.profile=lean")
    ds = TpuDataStore(device="cpu",
                      mesh=device_mesh(devices=["cpu"] * n_shards))
    jds = JaxStore(mesh=jax_mesh(n_shards))
    plain = TpuDataStore(device="cpu")
    for s in (ds, jds, plain):
        s.create_schema("evt", spec)
        s.write("evt", data)
    idx = ds._store("evt").index("z3")
    assert isinstance(idx, ShardedLeanZ3Index)
    jidx = jds._store("evt").index("z3")
    assert idx.tier_counts() == jidx.tier_counts()
    assert idx.dispatch_count == jidx.dispatch_count
    ecqls = ("BBOX(geom,-74.5,40.5,-73.5,41.5) AND dtg DURING "
             "2018-01-03T00:00:00Z/2018-01-10T00:00:00Z",
             "BBOX(geom,-74.5,40.5,-73.5,41.5) AND name = 'a'",
             "BBOX(geom,-75,40,-73,42)")
    for ecql in ecqls:
        a = ds.query_result("evt", ecql)
        b = jds.query_result("evt", ecql)
        assert a.strategy.index == b.strategy.index
        np.testing.assert_array_equal(a.positions, b.positions)
        np.testing.assert_array_equal(
            np.sort(a.positions),
            np.sort(plain.query_result("evt", ecql).positions))
    # batched windows (the JAX store's query_windows rides the same
    # index call)
    wins = [([BOX], MS_2018 + 2 * DAY, MS_2018 + 9 * DAY),
            ([(-74.2, 40.1, -73.1, 41.2)], None, None)]
    for hm, hj in zip(idx.query_many(wins), jds.query_windows("evt", wins)):
        np.testing.assert_array_equal(hm, np.sort(hj))
    assert ds.delete("evt", ["7", "9"]) == jds.delete("evt", ["7", "9"]) == 2
    a = ds.query_result("evt", "BBOX(geom,-75,40,-73,42)")
    b = jds.query_result("evt", "BBOX(geom,-75,40,-73,42)")
    np.testing.assert_array_equal(a.positions, b.positions)
    assert 7 not in a.positions and 9 not in a.positions


def test_tight_budget_never_allocates_doomed_payload():
    """Under a budget too small for any full-tier generation, rollovers
    create keys-tier generations directly — the same tiers the JAX index
    picks."""
    from geomesa_tpu.parallel.lean import ShardedLeanZ3Index as JaxSharded
    from geomesa_tpu_torch.parallel import lean as plean
    requested = []
    orig = plean._ShardedGen.__init__

    def spy(self, mesh, slots, tier="keys"):
        requested.append(tier)
        orig(self, mesh, slots, tier=tier)

    rng = np.random.default_rng(3)
    m = 40_000
    rows = (rng.uniform(-75, -73, m), rng.uniform(40, 42, m),
            rng.integers(MS_2018, MS_2018 + 14 * DAY, m))
    kw = dict(period="week", generation_slots=1 << 10,
              hbm_budget_bytes=(1 << 10) * 20 * 3)
    plean._ShardedGen.__init__ = spy
    try:
        idx = plean.ShardedLeanZ3Index(
            mesh=device_mesh(devices=["cpu"] * 8), **kw)
        idx.append(*rows)
    finally:
        plean._ShardedGen.__init__ = orig
    assert len(requested) >= 3
    assert "full" not in requested
    ref = JaxSharded(mesh=jax_mesh(8), **kw)
    ref.append(*rows)
    assert [g.tier for g in idx.generations] == [
        g.tier for g in ref.generations]


def test_mesh_lean_snapshot_roundtrip(tmp_path, monkeypatch):
    """A mesh lean store flushes the same chunked snapshot as one device;
    the reopened store (either package's) rebuilds its sharded index by
    streaming the restored parts and answers alike, tombstones
    included."""
    from geomesa_tpu.parallel.lean import ShardedLeanZ3Index as JaxSharded
    from geomesa_tpu_torch.parallel import ShardedLeanZ3Index
    monkeypatch.setattr(ShardedLeanZ3Index, "GENERATION_SLOTS", 1 << 13)
    monkeypatch.setattr(JaxSharded, "GENERATION_SLOTS", 1 << 13)
    rng = np.random.default_rng(31)
    n = 30_000
    x = rng.uniform(-75, -73, n)
    y = rng.uniform(40, 42, n)
    t = rng.integers(MS_2018, MS_2018 + 14 * DAY, n)
    spec = "score:Double,dtg:Date,*geom:Point;geomesa.index.profile=lean"
    q = "BBOX(geom,-74.5,40.5,-73.5,41.5)"
    inside = int(np.flatnonzero((x >= -74.5) & (x <= -73.5)
                                & (y >= 40.5) & (y <= 41.5))[0])
    cats = {}
    for pkg in ("port", "jax"):
        cat = str(tmp_path / pkg)
        ds = (TpuDataStore(device="cpu", catalog_dir=cat,
                           mesh=device_mesh(devices=["cpu"] * 2))
              if pkg == "port" else JaxStore(cat, mesh=jax_mesh(2)))
        ds.create_schema("evt", spec)
        ds.write("evt", {"score": rng.uniform(0, 100, n) * 0 + 1.0,
                         "dtg": t, "geom": (x, y)})
        ds.delete("evt", ["3"])
        ds.flush("evt")
        ds.delete("evt", [str(inside)])
        ds.flush("evt")
        cats[pkg] = cat
    want = np.flatnonzero((x >= -74.5) & (x <= -73.5)
                          & (y >= 40.5) & (y <= 41.5))
    want = want[(want != 3) & (want != inside)]
    for writer, cat in cats.items():
        for reader in ("port", "jax"):
            ds2 = (TpuDataStore(device="cpu", catalog_dir=cat,
                                mesh=device_mesh(devices=["cpu"] * 2))
                   if reader == "port" else JaxStore(cat, mesh=jax_mesh(2)))
            st2 = ds2._store("evt")
            assert len(st2.batch) == n
            assert st2.tombstone[3] and st2.tombstone[inside]
            got = ds2.query_result("evt", q)
            assert type(st2.index("z3")).__name__ == "ShardedLeanZ3Index"
            np.testing.assert_array_equal(np.sort(got.positions), want,
                                          err_msg=f"{writer}->{reader}")
