"""Port parity: ShardedLeanAttrIndex, ShardedLeanXZ2Index and
ShardedLeanXZ3Index of geomesa_tpu_torch on 2- and 8-shard CPU meshes
against geomesa_tpu's on the suite's virtual CPU mesh of the same size,
and lean stores over a mesh against both packages' single-device lean
stores.

Held equal, bit for bit: candidate and hit positions, the tier of every
generation, consumed slots and ``dispatch_count`` deltas, compaction,
the attribute sketch push-down's integer stats (float sums within rtol
1e-9).  The suite's conftest sets the JAX ``ShardedLeanAttrIndex``
class default to 2^13 slots (and ``LeanAttrIndex`` to 2^16), which sets
the stores' per-index budget floors; the port's class defaults are set
to the same in the store tests.  The mirrored oracles are the JAX
package's tests/test_lean_attr.py::test_sharded_lean_attr_matches_single_
chip and ::test_sharded_lean_attr_budget_spills_oracle_exact,
test_zz_lean_compaction.py::test_sharded_attr_append_reuses_padded_region,
test_lean_xz2.py::test_sharded_lean_xz2_matches_single_chip and
::TestLeanXZ3::test_mesh_variant_matches.
"""

import numpy as np
import pytest

from geomesa_tpu.datastore import TpuDataStore as JaxStore
from geomesa_tpu.geometry.types import Polygon as JaxPolygon
from geomesa_tpu.parallel import device_mesh as jax_mesh
from geomesa_tpu.parallel.attr_lean import (
    ShardedLeanAttrIndex as JaxAttr,
)
from geomesa_tpu.process.stats_process import stats_process as jax_stats
from geomesa_tpu_torch import TpuDataStore, device_mesh
from geomesa_tpu_torch.geometry.types import Polygon
from geomesa_tpu_torch.index.attr_lean import LeanAttrIndex
from geomesa_tpu_torch.parallel import (
    ShardedLeanAttrIndex, ShardedLeanXZ2Index, ShardedLeanXZ3Index,
    stats_process,
)

MS = 1514764800000
DAY = 86_400_000


@pytest.fixture
def class_slots(monkeypatch):
    """The port's class defaults at the suite's JAX values (the stores'
    attribute budget floors and XZ generation sizes derive from them)."""
    monkeypatch.setattr(ShardedLeanAttrIndex, "GENERATION_SLOTS",
                        JaxAttr.GENERATION_SLOTS)
    from geomesa_tpu.index.attr_lean import LeanAttrIndex as JaxLeanAttr
    monkeypatch.setattr(LeanAttrIndex, "GENERATION_SLOTS",
                        JaxLeanAttr.GENERATION_SLOTS)


def _names(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.choice(np.array(["a", "b", "c", "rare"], object), n,
                       p=[.5, .3, .19, .01]),
            rng.integers(MS, MS + 14 * DAY, n))


def _attr_pair(n_shards, names, dtg, step, **kw):
    port = ShardedLeanAttrIndex(
        "name", "string", mesh=device_mesh(devices=["cpu"] * n_shards), **kw)
    ref = JaxAttr("name", "string", mesh=jax_mesh(n_shards), **kw)
    for lo in range(0, len(names), step):
        sl = slice(lo, lo + step)
        port.append(names[sl], dtg[sl], base_gid=lo)
        ref.append(names[sl], dtg[sl], base_gid=lo)
    return port, ref


def _same_layout(port, ref):
    assert len(port) == len(ref)
    assert port.tier_counts() == ref.tier_counts()
    assert ([(g.tier, g.n_slots, g.slots, g.gen_id)
             for g in port.generations]
            == [(g.tier, g.n_slots, g.slots, g.gen_id)
                for g in ref.generations])
    assert port.device_bytes() == ref.device_bytes()
    assert port.host_key_bytes() == ref.host_key_bytes()
    assert port.dispatch_count == ref.dispatch_count


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_lean_attr_budget_spills_oracle_exact(n_shards):
    """Per-shard budget pressure spills generations to host; the stacked
    composite bisection still answers exactly, as the JAX index does."""
    names, dtg = _names(31, 60_000)
    slots = 1 << 10
    port, ref = _attr_pair(n_shards, names, dtg, 9_000,
                           generation_slots=slots,
                           hbm_budget_bytes=3 * slots * 24)
    _same_layout(port, ref)
    assert port.tier_counts()["host"] >= 1
    w = (MS + 2 * DAY, MS + 5 * DAY)
    queries = [
        (lambda i: i.query_equals("rare"), names == "rare"),
        (lambda i: i.query_equals("a", sec_window=w),
         (names == "a") & (dtg >= w[0]) & (dtg <= w[1])),
        (lambda i: i.query_in(["b", "rare"]), np.isin(names, ["b", "rare"])),
        (lambda i: i.query_prefix("ra"), names == "rare"),
        (lambda i: i.query_range("b", "c"), np.isin(names, ["b", "c"])),
    ]
    for q, want in queries:
        got = q(port)
        np.testing.assert_array_equal(got, q(ref))
        np.testing.assert_array_equal(got, np.flatnonzero(want))
        assert port.dispatch_count == ref.dispatch_count
    assert port.compact() == ref.compact()
    _same_layout(port, ref)
    np.testing.assert_array_equal(port.query_equals("rare"),
                                  np.flatnonzero(names == "rare"))


def test_sharded_attr_append_reuses_padded_region():
    """Ten 3-row steps consume 3 slots each (fill tracking), so all 30
    rows pack into one 64-slot generation — the JAX index's fix of the
    old m_pad slot burn."""
    vals = np.arange(30, dtype=np.int64)
    port = ShardedLeanAttrIndex("v", "int",
                                mesh=device_mesh(devices=["cpu"] * 8),
                                generation_slots=64)
    ref = JaxAttr("v", "int", mesh=jax_mesh(8), generation_slots=64)
    for i in range(10):
        sl = slice(3 * i, 3 * i + 3)
        port.append(vals[sl], np.full(3, MS), base_gid=3 * i)
        ref.append(vals[sl], np.full(3, MS), base_gid=3 * i)
    assert len(port.generations) == 1
    assert port.generations[-1].n_slots == 30
    _same_layout(port, ref)
    for probe in (0, 13, 29):
        np.testing.assert_array_equal(port.query_equals(probe),
                                      np.array([probe]))


def test_sharded_sketch_scan_matches_jax():
    """The attribute sketch fold (the estimator's and the stats
    push-down's source) over device and spilled runs."""
    from geomesa_tpu.stats.sketch import SketchFold as JaxFold
    from geomesa_tpu_torch.stats.sketch import SketchFold
    rng = np.random.default_rng(5)
    n = 20_000
    vals = rng.integers(0, 500, n)
    dtg = rng.integers(MS, MS + 14 * DAY, n)
    slots = 1 << 10
    port = ShardedLeanAttrIndex("v", "long",
                                mesh=device_mesh(devices=["cpu"] * 2),
                                generation_slots=slots,
                                hbm_budget_bytes=4 * slots * 24)
    ref = JaxAttr("v", "long", mesh=jax_mesh(2), generation_slots=slots,
                  hbm_budget_bytes=4 * slots * 24)
    for lo in range(0, n, 3_000):
        port.append(vals[lo:lo + 3_000], dtg[lo:lo + 3_000], base_gid=lo)
        ref.append(vals[lo:lo + 3_000], dtg[lo:lo + 3_000], base_gid=lo)
    assert port.tier_counts() == ref.tier_counts()
    assert port.tier_counts()["host"] >= 1
    for kw in (dict(slo=MS + DAY, shi=MS + 9 * DAY, bins=16, hlo=0.0,
                    hhi=500.0),
               dict(depth=3, width=64),
               dict(slo=MS, shi=MS + 7 * DAY, want_values=True)):
        a = port.sketch_scan(SketchFold(**kw))
        b = ref.sketch_scan(JaxFold(**kw))
        assert a.values == b.values
        assert (a.count, a.kmin, a.kmax) == (b.count, b.kmin, b.kmax)
        np.testing.assert_allclose(a.vsum, b.vsum, rtol=1e-9)
        np.testing.assert_allclose(a.vsumsq, b.vsumsq, rtol=1e-9)
        for x, y in ((a.hist, b.hist), (a.cms, b.cms)):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, np.asarray(y))
        assert port.dispatch_count == ref.dispatch_count
    sel = (dtg >= MS + DAY) & (dtg <= MS + 9 * DAY)
    assert port.sketch_scan(SketchFold(slo=MS + DAY, shi=MS + 9 * DAY, bins=16,
                                       hlo=0.0, hhi=500.0)).count == sel.sum()


def test_sharded_lean_attr_store_matches_single_chip(class_slots):
    """A lean store over a mesh answers every attribute query shape as the
    JAX mesh store and the port's single-device store do."""
    rng = np.random.default_rng(23)
    n = 40_000
    data = {
        "name": rng.choice(np.array(["alpha", "beta", "gamma", "rare"],
                                    object), n, p=[.5, .3, .19, .01]),
        "score": rng.uniform(0, 100, n),
        "dtg": rng.integers(MS, MS + 14 * DAY, n),
        "geom": (rng.uniform(-75, -73, n), rng.uniform(40, 42, n))}
    spec = ("name:String:index=true,score:Double:index=true,dtg:Date,"
            "*geom:Point;geomesa.index.profile=lean")
    ds = TpuDataStore(device="cpu", mesh=device_mesh(devices=["cpu"] * 8))
    jds = JaxStore(mesh=jax_mesh(8))
    plain = TpuDataStore(device="cpu")
    for s in (ds, jds, plain):
        s.create_schema("evt", spec)
    for lo in range(0, n, 15_000):
        chunk = {k: (v[lo:lo + 15_000] if k != "geom"
                     else (v[0][lo:lo + 15_000], v[1][lo:lo + 15_000]))
                 for k, v in data.items()}
        for s in (ds, jds, plain):
            s.write("evt", chunk)
    st = ds._store("evt")
    assert isinstance(st.attribute_index("name"), ShardedLeanAttrIndex)
    for a in ("name", "score"):
        p, j = st.attribute_index(a), jds._store("evt").attribute_index(a)
        assert p.hbm_budget_bytes == j.hbm_budget_bytes
        _same_layout(p, j)
    for ecql in ("name = 'rare'",
                 "name = 'rare' AND BBOX(geom, -75, 40, -73, 42)",
                 "name IN ('rare', 'gamma')",
                 "score > 99.5",
                 "name LIKE 'be%'",
                 "name = 'alpha' AND dtg DURING "
                 "2018-01-02T00:00:00Z/2018-01-03T00:00:00Z"):
        a = ds.query_result("evt", ecql)
        b = jds.query_result("evt", ecql)
        c = plain.query_result("evt", ecql)
        assert a.strategy.index == b.strategy.index
        np.testing.assert_array_equal(np.sort(a.positions),
                                      np.sort(b.positions))
        np.testing.assert_array_equal(np.sort(a.positions),
                                      np.sort(c.positions))
    assert ds.query_result("evt", "name = 'rare'").strategy.index.startswith(
        "attr:")
    # the attribute stats push down over the sharded runs
    for spec_ in ("MinMax(score);Count()", "Histogram(score,10,0,100)",
                  "Enumeration(name)"):
        got = stats_process(ds, "evt", "INCLUDE", spec_)
        want = jax_stats(jds, "evt", "INCLUDE", spec_)
        assert got.to_json() == want.to_json(), spec_
    assert ds.compact("evt") == jds.compact("evt")


def _polys(seed, n, t=False):
    rng = np.random.default_rng(seed)
    cx = rng.uniform(-170, 170, n)
    cy = rng.uniform(-80, 80, n)
    w = rng.uniform(0.001, 0.05, n)
    ts = rng.integers(MS, MS + 14 * DAY, n)
    kind = rng.choice(np.array(["road", "building", "park"], object), n)

    def geoms(cls):
        return [cls([(a - d, b - d), (a + d, b - d), (a + d, b + d),
                     (a - d, b + d)]) for a, b, d in zip(cx, cy, w)]
    return cx, cy, w, ts, kind, geoms


def test_sharded_lean_xz2_matches_single_chip(class_slots):
    n = 20_000
    cx, cy, w, _, kind, geoms = _polys(31, n)
    spec = ("kind:String:index=true,*geom:Polygon;"
            "geomesa.index.profile=lean")
    dsm = TpuDataStore(device="cpu", mesh=device_mesh(devices=["cpu"] * 2))
    jdm = JaxStore(mesh=jax_mesh(2))
    plain = TpuDataStore(device="cpu")
    pg, jg = geoms(Polygon), geoms(JaxPolygon)
    for s in (dsm, jdm, plain):
        s.create_schema("osm", spec)
    for lo in range(0, n, 10_000):
        for s, g in ((dsm, pg), (jdm, jg), (plain, pg)):
            s.write("osm", {"kind": kind[lo:lo + 10_000],
                            "geom": g[lo:lo + 10_000]})
    idx = dsm._store("osm").index("xz2")
    assert isinstance(idx, ShardedLeanXZ2Index)
    _same_layout(idx._core, jdm._store("osm").index("xz2")._core)
    for q in ("INTERSECTS(geom, POLYGON((-80 30, -60 30, -60 50, "
              "-80 50, -80 30)))",
              "BBOX(geom, 0, 0, 20, 20)",
              "kind = 'park'"):
        a = dsm.query_result("osm", q)
        b = jdm.query_result("osm", q)
        c = plain.query_result("osm", q)
        assert a.strategy.index == b.strategy.index
        np.testing.assert_array_equal(np.sort(a.positions),
                                      np.sort(b.positions))
        np.testing.assert_array_equal(np.sort(a.positions),
                                      np.sort(c.positions))


def test_sharded_lean_xz3_mesh_variant_matches(class_slots):
    n = 30_000
    cx, cy, w, t, _, geoms = _polys(37, n, t=True)
    kind = np.random.default_rng(1).choice(
        np.array(["a", "b", "rare"], object), n, p=[.6, .39, .01])
    spec = ("kind:String:index=true,dtg:Date,*geom:Polygon;"
            "geomesa.index.profile=lean")
    dsm = TpuDataStore(device="cpu", mesh=device_mesh(devices=["cpu"] * 8))
    jdm = JaxStore(mesh=jax_mesh(8))
    pg, jg = geoms(Polygon), geoms(JaxPolygon)
    for s in (dsm, jdm):
        s.create_schema("osm", spec)
    for lo in range(0, n, 10_000):
        for s, g in ((dsm, pg), (jdm, jg)):
            s.write("osm", {"kind": kind[lo:lo + 10_000],
                            "dtg": t[lo:lo + 10_000],
                            "geom": g[lo:lo + 10_000]})
    idx = dsm._store("osm").index("xz3")
    assert isinstance(idx, ShardedLeanXZ3Index)
    _same_layout(idx._core, jdm._store("osm").index("xz3")._core)
    lo, hi = MS + 2 * DAY, MS + 9 * DAY
    q = ("INTERSECTS(geom, POLYGON((-80 30, -60 30, -60 50, "
         "-80 50, -80 30))) AND dtg DURING "
         "2018-01-03T00:00:00Z/2018-01-10T00:00:00Z")
    r = dsm.query_result("osm", q)
    assert r.strategy.index == "xz3"
    want = np.flatnonzero((cx + w >= -80) & (cx - w <= -60)
                          & (cy + w >= 30) & (cy - w <= 50)
                          & (t >= lo) & (t <= hi))
    np.testing.assert_array_equal(np.sort(r.positions), want)
    np.testing.assert_array_equal(
        np.sort(r.positions), np.sort(jdm.query_result("osm", q).positions))
    for q in ("kind = 'rare'", "kind = 'rare' AND dtg DURING "
              "2018-01-03T00:00:00Z/2018-01-10T00:00:00Z"):
        a, b = dsm.query_result("osm", q), jdm.query_result("osm", q)
        assert a.strategy.index == b.strategy.index
        np.testing.assert_array_equal(np.sort(a.positions),
                                      np.sort(b.positions))
    assert dsm.compact("osm") == jdm.compact("osm")


def test_sharded_xz3_core_is_the_facade():
    """``LeanXZ3Index(core=...)`` rides a sharded core: the facade's
    surface (length, tiers, compaction) is the core's."""
    mesh = device_mesh(devices=["cpu"] * 2)
    idx = ShardedLeanXZ3Index(period="week", mesh=mesh,
                              generation_slots=1 << 8)
    assert isinstance(idx._core, ShardedLeanAttrIndex)
    rng = np.random.default_rng(2)
    bb = np.stack([rng.uniform(0, 1, 1000)] * 2
                  + [rng.uniform(1, 2, 1000)] * 2, axis=1)
    idx.append_bboxes(bb, rng.integers(MS, MS + DAY, 1000))
    assert len(idx) == 1000 and idx.tier_counts()["device"] >= 2
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        ShardedLeanAttrIndex("v", "int", mesh=mesh, multihost=True)
