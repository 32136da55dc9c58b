"""Port parity: the default-profile and mesh attribute indexes of
geomesa_tpu_torch against geomesa_tpu — ``AttributeIndex`` (untiered,
date tier, z3 tier) and ``ShardedAttributeIndex`` on the same seeded
columns, and the store's attribute strategies (strategy, cost, cost
source and positions) on the default profile and on an 8-shard mesh,
including the kept index's appended tail and its rebuild."""

import numpy as np
import pytest
import torch

from geomesa_tpu.curve import to_binned_time as jax_binned
from geomesa_tpu.curve.binnedtime import TimePeriod as JaxPeriod
from geomesa_tpu.curve.sfc import z3_sfc as jax_z3_sfc
from geomesa_tpu.datastore import TpuDataStore as JaxStore
from geomesa_tpu.index.attribute import AttributeIndex as JaxAttr
from geomesa_tpu.index.z3 import plan_z3_query as jax_plan
from geomesa_tpu.parallel import device_mesh as jax_mesh
from geomesa_tpu.parallel.attribute import (
    ShardedAttributeIndex as JaxSharded,
)
from geomesa_tpu_torch import TpuDataStore, device_mesh
from geomesa_tpu_torch.curve.binnedtime import TimePeriod, to_binned_time
from geomesa_tpu_torch.curve.sfc import z3_sfc
from geomesa_tpu_torch.index.attribute import AttributeIndex
from geomesa_tpu_torch.index.z3 import plan_z3_query
from geomesa_tpu_torch.parallel.attribute import ShardedAttributeIndex

MS = 1514764800000
DAY = 86_400_000


@pytest.fixture(scope="module")
def cols():
    rng = np.random.default_rng(42)
    n = 20_000
    name = rng.choice(["a", "b", "c", "d", "e"], n).astype(object)
    return {"name": name, "score": rng.integers(0, 50, n).astype(np.float64),
            "dtg": rng.integers(MS, MS + 30 * DAY, n),
            "x": rng.uniform(-75, -73, n), "y": rng.uniform(40, 42, n)}


def _z3_keys(c):
    bins, offs = to_binned_time(c["dtg"], TimePeriod.WEEK)
    z = z3_sfc(TimePeriod.WEEK).index(
        torch.from_numpy(c["x"]), torch.from_numpy(c["y"]),
        torch.from_numpy(offs.astype(np.float64))).numpy()
    return bins, z


def test_z3_tier_keys_equal_reference(cols):
    bins, z = _z3_keys(cols)
    jb, jo = jax_binned(cols["dtg"], JaxPeriod.WEEK)
    jz = jax_z3_sfc(JaxPeriod.WEEK).index(cols["x"], cols["y"],
                                          jo.astype(np.float64), xp=np)
    np.testing.assert_array_equal(bins, jb)
    np.testing.assert_array_equal(z, np.asarray(jz, np.int64))


@pytest.mark.parametrize("tier", ["none", "date", "z3"])
@pytest.mark.parametrize("attr", ["name", "score"])
def test_build_layout_matches_reference(cols, tier, attr):
    if tier == "z3":
        bins, z = _z3_keys(cols)
        got = AttributeIndex.build_z3(attr, cols[attr], bins, z)
        want = JaxAttr.build_z3(attr, cols[attr], bins, z)
        np.testing.assert_array_equal(got.sec_bins, want.sec_bins)
        np.testing.assert_array_equal(got.sec_z, want.sec_z)
    else:
        sec = cols["dtg"] if tier == "date" else None
        got = AttributeIndex.build(attr, cols[attr], secondary=sec)
        want = JaxAttr.build(attr, cols[attr], secondary=sec)
        if sec is not None:
            np.testing.assert_array_equal(got.secondary, want.secondary)
    np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.pos, want.pos)


WINDOWS = [None, (MS + 5 * DAY, MS + 9 * DAY), (None, MS + 2 * DAY),
           (MS + 25 * DAY, None), (MS + 40 * DAY, MS + 50 * DAY)]


@pytest.mark.parametrize("window", WINDOWS)
def test_date_tier_queries_match_reference(cols, window):
    got = AttributeIndex.build("name", cols["name"], secondary=cols["dtg"])
    want = JaxAttr.build("name", cols["name"], secondary=cols["dtg"])
    for v in ("c", "zz"):
        np.testing.assert_array_equal(got.query_equals(v, window),
                                      want.query_equals(v, window))
    np.testing.assert_array_equal(got.query_in(["a", "e", "q"], window),
                                  want.query_in(["a", "e", "q"], window))
    np.testing.assert_array_equal(got.query_in([], window),
                                  want.query_in([], window))


@pytest.mark.parametrize("box,lo,hi", [
    ((-180.0, -90.0, 180.0, 90.0), MS + 2 * DAY, MS + 4 * DAY),
    ((-74.5, 40.5, -73.5, 41.5), MS + 5 * DAY, MS + 12 * DAY),
    ((-74.01, 40.99, -73.99, 41.01), MS, MS + 30 * DAY),
])
def test_z3_tier_queries_match_reference(cols, box, lo, hi):
    bins, z = _z3_keys(cols)
    got = AttributeIndex.build_z3("name", cols["name"], bins, z)
    want = JaxAttr.build_z3("name", cols["name"], bins, z)
    plan = plan_z3_query([box], lo, hi, TimePeriod.WEEK, 256)
    jplan = jax_plan([box], lo, hi, JaxPeriod.WEEK, 256)
    ranges = (plan.rbin, plan.rzlo, plan.rzhi)
    np.testing.assert_array_equal(ranges[0], jplan.rbin)
    np.testing.assert_array_equal(ranges[1], jplan.rzlo)
    g = got.query_equals("c", None, ranges)
    np.testing.assert_array_equal(g, want.query_equals("c", None, ranges))
    assert len(g) <= (cols["name"] == "c").sum()
    np.testing.assert_array_equal(got.query_in(["a", "d"], None, ranges),
                                  want.query_in(["a", "d"], None, ranges))


@pytest.mark.parametrize("args", [
    ("b", "d", True, True), ("b", "d", False, False), (None, "b", True, False),
    ("c", None, False, True), ("e", "a", True, True)])
def test_range_and_prefix_match_reference(cols, args):
    got = AttributeIndex.build("name", cols["name"])
    want = JaxAttr.build("name", cols["name"])
    np.testing.assert_array_equal(got.query_range(*args),
                                  want.query_range(*args))
    np.testing.assert_array_equal(got.query_prefix(args[1] or "a"),
                                  want.query_prefix(args[1] or "a"))
    num, jnum = (cls.build("score", cols["score"])
                 for cls in (AttributeIndex, JaxAttr))
    lo, hi = 10.0, 20.0
    np.testing.assert_array_equal(num.query_range(lo, hi, *args[2:]),
                                  jnum.query_range(lo, hi, *args[2:]))
    with pytest.raises(TypeError):
        num.query_prefix("1")


@pytest.mark.parametrize("tier", ["none", "date", "z3"])
def test_sharded_index_matches_reference(cols, tier):
    """ShardedAttributeIndex on an 8-shard CPU mesh against the JAX index
    on the 8-device virtual mesh: the same candidates for every query
    kind, tier-refined for point lookups."""
    kw = {}
    if tier == "z3":
        kw = dict(zip(("sec_bins", "sec_z"), _z3_keys(cols)))
    elif tier == "date":
        kw = {"secondary": cols["dtg"]}
    got = ShardedAttributeIndex.build(
        "name", cols["name"], mesh=device_mesh(devices=["cpu"] * 8), **kw)
    want = JaxSharded.build("name", cols["name"], mesh=jax_mesh(), **kw)
    assert got.tier == want.tier == tier
    plan = plan_z3_query([(-74.5, 40.5, -73.5, 41.5)], MS + 5 * DAY,
                         MS + 12 * DAY, TimePeriod.WEEK, 256)
    ranges = (plan.rbin, plan.rzlo, plan.rzhi)
    window = (MS + 3 * DAY, MS + 6 * DAY)
    for q in (lambda i: i.query_equals("c"),
              lambda i: i.query_equals("c", window, ranges),
              lambda i: i.query_equals("nope", window),
              lambda i: i.query_in(["a", "d", "x"], window, ranges),
              lambda i: i.query_range("b", "d", True, False),
              lambda i: i.query_range("f", None),
              lambda i: i.query_prefix("b")):
        np.testing.assert_array_equal(q(got), q(want))
    if tier == "z3":
        narrowed = got.query_equals("c", z3_ranges=ranges)
        assert 0 < len(narrowed) < (cols["name"] == "c").sum() * 0.9


# -- the default-profile store (test_attribute_tier.py's queries) ---------
SPEC = "name:String:index=true,score:Double:index=true,dtg:Date,*geom:Point"
ECQL = [
    "name = 'c' AND dtg DURING 2018-01-03T00:00:00Z/2018-01-05T00:00:00Z",
    "name = 'b' AND BBOX(geom, -5, -5, 5, 5) AND dtg DURING "
    "2018-01-02T00:00:00Z/2018-01-06T00:00:00Z",
    "name = 'c'",
    "name IN ('a', 'e') AND dtg AFTER 2018-01-20T00:00:00Z",
    "name LIKE 'd%'",
    "name > 'c'",
    "score BETWEEN 10 AND 12",
    "score >= 48 AND BBOX(geom, -5, -5, 5, 5)",
    "name = 'a' AND BBOX(geom, -0.1, -0.1, 0.1, 0.1)",
    "name = 'c' OR name = 'zz'",
]


def _rows(seed, n):
    rng = np.random.default_rng(seed)
    return {"name": rng.choice(["a", "b", "c", "d", "e"], n).astype(object),
            "score": rng.integers(0, 50, n).astype(np.float64),
            "dtg": rng.integers(MS, MS + 30 * DAY, n),
            "geom": (rng.uniform(-10, 10, n), rng.uniform(-10, 10, n))}


@pytest.fixture(scope="module")
def stores():
    tds, jds = TpuDataStore(device="cpu"), JaxStore()
    for ds in (tds, jds):
        ds.create_schema("tiered", SPEC)
        ds.create_schema("dated", "name:String:index=true,dtg:Date")
        ds.write("tiered", _rows(7, 20_000))
        r = _rows(8, 5_000)
        ds.write("dated", {"name": r["name"], "dtg": r["dtg"]})
    return tds, jds


def _same(tds, jds, schema, ecql):
    got, want = (ds.query_result(schema, ecql) for ds in (tds, jds))
    assert (got.strategy.index, got.strategy.source) == \
        (want.strategy.index, want.strategy.source)
    assert got.strategy.cost == want.strategy.cost
    np.testing.assert_array_equal(got.positions, want.positions)
    return got


@pytest.mark.parametrize("ecql", ECQL)
def test_store_attr_strategies_match_reference(stores, ecql):
    tds, jds = stores
    _same(tds, jds, "tiered", ecql)


def test_store_picks_the_tiers(stores):
    tds, jds = stores
    got = _same(tds, jds, "tiered", ECQL[1])
    assert got.strategy.index == "attr:name" and got.strategy.geometries
    st = tds._store("tiered")
    assert st.attribute_index("name").sec_z is not None
    assert st.query_indices is None
    dated = _same(tds, jds, "dated", "name = 'b' AND dtg DURING "
                  "2018-01-03T00:00:00Z/2018-01-09T00:00:00Z")
    assert dated.strategy.index == "attr:name"
    assert tds._store("dated").attribute_index("name").secondary is not None


def test_kept_index_tail_and_rebuild():
    """Writes keep a built attribute index: the appended rows ride as its
    tail, and once the tail outgrows an eighth of the index the next
    query rebuilds it (``_maybe_compact``) — both stores alike."""
    tds, jds = TpuDataStore(device="cpu"), JaxStore()
    ecql = ECQL[0]
    for ds in (tds, jds):
        ds.create_schema("t", SPEC)
        ds.write("t", _rows(1, 20_000))
        ds.query_result("t", ecql)
        ds.write("t", _rows(2, 2_000))
    st = tds._store("t")
    np.testing.assert_array_equal(st.index_tail("attr:name"),
                                  np.arange(20_000, 22_000))
    assert "attr-z3-keys" not in st._indexes
    _same(tds, jds, "t", ecql)
    assert st.build_counts["attr:name"] == 1
    for ds in (tds, jds):
        ds.write("t", _rows(3, 5_000))
    _same(tds, jds, "t", ecql)
    assert st.build_counts["attr:name"] == 2
    assert st.index_tail("attr:name") is None
    assert st.build_counts == jds._store("t").build_counts


def test_forced_attr_hint_and_disabled_index(stores):
    from geomesa_tpu.planning.planner import Query as JaxQuery
    from geomesa_tpu_torch import Query
    tds, jds = stores
    ecql = ECQL[1]
    got = tds.query_result("tiered", Query.of(ecql,
                                              hints={"QUERY_INDEX": "attr"}))
    want = jds.query_result("tiered", JaxQuery.of(
        ecql, hints={"QUERY_INDEX": "attr"}))
    assert got.strategy.index == want.strategy.index == "attr:name"
    np.testing.assert_array_equal(got.positions, want.positions)
    with pytest.raises(ValueError, match="per attribute"):
        tds._store("tiered").index("attr")
    for ds in (tds, jds):
        ds.create_schema("off", SPEC + ";geomesa.indices.enabled=z3")
        ds.write("off", _rows(4, 3_000))
    _same(tds, jds, "off", ECQL[0])
    with pytest.raises(ValueError, match="disabled"):
        tds._store("off").attribute_index("name")


def test_mesh_store_attr_query_uses_z3_tier():
    """test_attribute_tier.py's mesh case: on an 8-shard mesh store the
    attribute index carries the z3 tier, and attr+bbox+time queries
    answer as the JAX store does."""
    from geomesa_tpu.planning.planner import Query as JaxQuery
    from geomesa_tpu_torch import Query
    rng = np.random.default_rng(10)
    n = 20_000
    rows = {"name": rng.choice(["a", "b", "c"], n).astype(object),
            "dtg": rng.integers(MS, MS + 21 * DAY, n),
            "geom": (rng.uniform(-75, -73, n), rng.uniform(40, 42, n))}
    tds = TpuDataStore(device="cpu", mesh=device_mesh(devices=["cpu"] * 8))
    jds = JaxStore(mesh=jax_mesh())
    for ds in (tds, jds):
        ds.create_schema("evt", "name:String:index=true,dtg:Date,"
                                "*geom:Point")
        ds.write("evt", rows)
    idx = tds._store("evt").attribute_index("name")
    assert isinstance(idx, ShardedAttributeIndex) and idx.tier == "z3"
    ecql = ("name = 'b' AND BBOX(geom,-74.5,40.5,-73.5,41.5) AND dtg "
            "DURING 2018-01-05T00:00:00Z/2018-01-12T00:00:00Z")
    got = tds.query_result("evt", Query.of(ecql,
                                           hints={"QUERY_INDEX": "attr"}))
    want = jds.query_result("evt", JaxQuery.of(
        ecql, hints={"QUERY_INDEX": "attr"}))
    assert got.strategy.index == want.strategy.index == "attr:name"
    np.testing.assert_array_equal(got.positions, want.positions)
    for e in ("name = 'c'", "name IN ('a', 'c') AND dtg DURING "
              "2018-01-02T00:00:00Z/2018-01-04T00:00:00Z", "name < 'b'"):
        _same(tds, jds, "evt", e)
