"""Port parity: the lean XZ tier of geomesa_tpu_torch against geomesa_tpu
— ``LeanXZ2Index`` / ``LeanXZ3Index`` on the generational attribute core
(candidates, tier decisions, bytes, dispatch counts, compaction, the
carry-across) and lean polygon stores (``lean_kind``, ``query_indices``,
INTERSECTS, BBOX, an attribute, ids; the spatial-only and temporal-only
xz3 queries), at 2^12-slot generations with host spills.  Deletes,
snapshots and lean XZ over a mesh are not ported (ROADMAP A5–A7)."""

import numpy as np
import pytest

from geomesa_tpu.datastore import TpuDataStore as JaxStore
from geomesa_tpu.geometry.packed import packed_from_boxes as j_packed
from geomesa_tpu.geometry.types import Polygon as JPolygon
from geomesa_tpu.index import attr_lean as jax_al
from geomesa_tpu.index.xz2_lean import LeanXZ2Index as JLeanXZ2
from geomesa_tpu.index.xz2_lean import LeanXZ3Index as JLeanXZ3
from geomesa_tpu_torch import TpuDataStore
from geomesa_tpu_torch.convert import (
    lean_xz_index_from_state, lean_xz_index_state,
)
from geomesa_tpu_torch.geometry.packed import packed_from_boxes
from geomesa_tpu_torch.geometry.types import Polygon
from geomesa_tpu_torch.index.attr_lean import LeanAttrIndex
from geomesa_tpu_torch.index.xz2_lean import LeanXZ2Index, LeanXZ3Index
from geomesa_tpu_torch.parallel import device_mesh

MS = 1514764800000
DAY = 86_400_000
SLOTS = 1 << 12
BOX = (-80.0, 30.0, -60.0, 50.0)
Q_BOX = ("INTERSECTS(geom, POLYGON((-80 30, -60 30, -60 50, -80 50, "
         "-80 30)))")
Q_TRI = "INTERSECTS(geom, POLYGON((-80 30, -50 35, -70 55, -80 30)))"


@pytest.fixture(scope="module", autouse=True)
def _ci_generation_slots():
    """The port's attribute-index class default follows the JAX one the
    suite's conftest sets (the per-index budget floor reads it)."""
    old = LeanAttrIndex.GENERATION_SLOTS
    LeanAttrIndex.GENERATION_SLOTS = jax_al.LeanAttrIndex.GENERATION_SLOTS
    yield
    LeanAttrIndex.GENERATION_SLOTS = old


@pytest.fixture(scope="module")
def polys():
    rng = np.random.default_rng(31)
    n = 24_000
    cx = rng.uniform(-170, 170, n)
    cy = rng.uniform(-80, 80, n)
    w = rng.uniform(0.001, 0.05, n)
    t = rng.integers(MS, MS + 14 * DAY, n)
    kind = rng.choice(np.array(["road", "building", "park", "rare"], object),
                      n, p=[0.5, 0.39, 0.1, 0.01])
    bb = np.stack([cx - w, cy - w, cx + w, cy + w], axis=1)
    return bb, t, kind


def _box_oracle(bb, box):
    return np.flatnonzero((bb[:, 2] >= box[0]) & (bb[:, 0] <= box[2])
                          & (bb[:, 3] >= box[1]) & (bb[:, 1] <= box[3]))


def _q(poly_cls):
    return poly_cls([(BOX[0], BOX[1]), (BOX[2], BOX[1]), (BOX[2], BOX[3]),
                     (BOX[0], BOX[3])])


def _same_index(got, want):
    assert got.tier_counts() == want.tier_counts()
    assert got.device_bytes() == want.device_bytes()
    assert got.host_key_bytes() == want.host_key_bytes()
    assert got.dispatch_count == want.dispatch_count
    assert len(got) == len(want)


def _fill(pair, bb, t=None, step=3000):
    for lo in range(0, len(bb), step):
        for idx in pair:
            if t is None:
                idx.append_bboxes(bb[lo:lo + step], base_gid=lo)
            else:
                idx.append_bboxes(bb[lo:lo + step], t[lo:lo + step],
                                  base_gid=lo)


@pytest.mark.parametrize("budget_gens", [2, 3, 8])
def test_lean_xz2_candidates_tiers_and_compaction(polys, budget_gens):
    bb, _, _ = polys
    kw = dict(generation_slots=SLOTS, hbm_budget_bytes=budget_gens * SLOTS
              * 20)
    got, want = LeanXZ2Index(device="cpu", **kw), JLeanXZ2(**kw)
    _fill((got, want), bb)
    _same_index(got, want)
    if budget_gens < 8:
        assert got.tier_counts()["host"] >= 1
    for q in (BOX, (0.0, 0.0, 20.0, 20.0), (-180.0, -90.0, 180.0, 90.0)):
        ring = [(q[0], q[1]), (q[2], q[1]), (q[2], q[3]), (q[0], q[3])]
        g = got.query(Polygon(ring))
        w = want.query(JPolygon(ring))
        np.testing.assert_array_equal(np.sort(g), np.sort(w))
        assert set(_box_oracle(bb, q)).issubset(set(g.tolist()))
    _same_index(got, want)
    assert got.compact(factor=2) == want.compact(factor=2)
    _same_index(got, want)
    np.testing.assert_array_equal(np.sort(got.query(_q(Polygon))),
                                  np.sort(want.query(_q(JPolygon))))


@pytest.mark.parametrize("budget_gens", [2, 8])
def test_lean_xz3_candidates_and_clamping(polys, budget_gens):
    bb, t, _ = polys
    kw = dict(generation_slots=SLOTS, hbm_budget_bytes=budget_gens * SLOTS
              * 20)
    got = LeanXZ3Index(period="week", device="cpu", **kw)
    want = JLeanXZ3(period="week", **kw)
    _fill((got, want), bb, t)
    _same_index(got, want)
    assert (got.t_min_ms, got.t_max_ms) == (want.t_min_ms, want.t_max_ms)
    for lo, hi in ((MS + 2 * DAY, MS + 9 * DAY), (None, None),
                   (None, MS + 3 * DAY), (MS + 12 * DAY, None),
                   (MS + 20 * DAY, MS + 30 * DAY)):
        np.testing.assert_array_equal(
            np.sort(got.query(_q(Polygon), lo, hi)),
            np.sort(want.query(_q(JPolygon), lo, hi)))
    assert got.compact(factor=2) == want.compact(factor=2)
    _same_index(got, want)


def test_lean_xz_state_round_trip(polys):
    """JAX lean XZ state → port index: the same candidates, tiers and
    bytes."""
    bb, t, _ = polys
    kw = dict(generation_slots=SLOTS, hbm_budget_bytes=3 * SLOTS * 20)
    j2, j3 = JLeanXZ2(**kw), JLeanXZ3(period="day", **kw)
    _fill((j2,), bb)
    _fill((j3,), bb, t)
    p2 = lean_xz_index_from_state(lean_xz_index_state(j2), device="cpu")
    p3 = lean_xz_index_from_state(lean_xz_index_state(j3), device="cpu")
    assert isinstance(p2, LeanXZ2Index) and isinstance(p3, LeanXZ3Index)
    for p, j in ((p2, j2), (p3, j3)):
        assert p.tier_counts() == j.tier_counts()
        assert p.device_bytes() == j.device_bytes()
    np.testing.assert_array_equal(np.sort(p2.query(_q(Polygon))),
                                  np.sort(j2.query(_q(JPolygon))))
    np.testing.assert_array_equal(
        np.sort(p3.query(_q(Polygon), MS + DAY, MS + 5 * DAY)),
        np.sort(j3.query(_q(JPolygon), MS + DAY, MS + 5 * DAY)))
    # the port index keeps growing from the carried state alike
    more = bb[:500] + 1.0
    p2.append_bboxes(more)
    j2.append_bboxes(more)
    np.testing.assert_array_equal(np.sort(p2.query(_q(Polygon))),
                                  np.sort(j2.query(_q(JPolygon))))


SPEC2 = ("kind:String:index=true,*geom:Polygon;geomesa.index.profile=lean,"
         f"geomesa.lean.generation.slots={SLOTS}")
SPEC3 = ("kind:String:index=true,dtg:Date,*geom:Polygon;"
         "geomesa.index.profile=lean,"
         f"geomesa.lean.generation.slots={SLOTS},"
         f"geomesa.lean.hbm.budget={4 * SLOTS * 40}")


def _stores(polys, spec, with_dtg):
    bb, t, kind = polys
    stores = (JaxStore(), TpuDataStore(device="cpu"))
    for ds, pack in zip(stores, (j_packed, packed_from_boxes)):
        ds.create_schema("osm", spec)
        for lo in range(0, len(bb), 8000):
            d = {"kind": kind[lo:lo + 8000],
                 "geom": pack(bb[lo:lo + 8000])}
            if with_dtg:
                d["dtg"] = t[lo:lo + 8000]
            ds.write("osm", d)
    return stores


@pytest.fixture(scope="module")
def xz2_stores(polys):
    return _stores(polys, SPEC2, False)


@pytest.fixture(scope="module")
def xz3_stores(polys):
    return _stores(polys, SPEC3, True)


def _same_result(stores, q):
    a, b = (ds.query_result("osm", q) for ds in stores)
    assert b.strategy.index == a.strategy.index
    assert b.strategy.cost == a.strategy.cost
    np.testing.assert_array_equal(b.positions, a.positions)
    np.testing.assert_array_equal(b.batch.ids, a.batch.ids)
    return b


def test_lean_xz2_store_kind_and_indices(xz2_stores):
    jds, tds = xz2_stores
    st, jst = tds._store("osm"), jds._store("osm")
    assert st.lean and st.lean_kind == jst.lean_kind == "xz2"
    assert st.query_indices == jst.query_indices == {"xz2", "id", "attr"}
    assert isinstance(st.index("xz2"), LeanXZ2Index)
    assert st.index("xz2").tier_counts() == jst.index("xz2").tier_counts()
    with pytest.raises(ValueError, match="xz2/id only"):
        st.index("z3")
    assert tds.build_pyramids("osm") == jds.build_pyramids("osm") == 0


@pytest.mark.parametrize("q", [
    Q_BOX, Q_TRI, "BBOX(geom, 0, 0, 20, 20)",
    "BBOX(geom, -100, 20, -40, 60) AND kind = 'rare'", "kind = 'park'",
    "IN ('17', '23000', '5')",
    "BBOX(geom, 0, 0, 20, 20) OR BBOX(geom, 100, -20, 120, 0)",
])
def test_lean_xz2_store_queries(xz2_stores, polys, q):
    bb, _, kind = polys
    got = _same_result(xz2_stores, q)
    if q == Q_BOX:
        assert got.strategy.index == "xz2"
        np.testing.assert_array_equal(got.positions, _box_oracle(bb, BOX))
    if q == "kind = 'park'":
        assert got.strategy.index == "attr:kind"
        np.testing.assert_array_equal(got.positions,
                                      np.flatnonzero(kind == "park"))


def test_lean_xz3_store_kind_and_tiers(xz3_stores):
    jds, tds = xz3_stores
    st, jst = tds._store("osm"), jds._store("osm")
    assert st.lean_kind == jst.lean_kind == "xz3"
    assert st.query_indices == jst.query_indices == {"xz3", "id", "attr"}
    idx, jidx = st.index("xz3"), jst.index("xz3")
    assert isinstance(idx, LeanXZ3Index)
    # the xz index is sized under the attribute carve-out, as in JAX
    assert idx.hbm_budget_bytes == jidx._core.hbm_budget_bytes
    assert idx.tier_counts() == jidx.tier_counts()
    assert idx.tier_counts()["host"] >= 1
    assert (st.index("id") is not None
            and st._lean_attr_index("kind").tier_counts()
            == jst._lean_attr_index("kind").tier_counts())


@pytest.mark.parametrize("q", [
    Q_BOX + " AND dtg DURING 2018-01-03T00:00:00Z/2018-01-10T00:00:00Z",
    "BBOX(geom, 0, 0, 20, 20)",
    "dtg DURING 2018-01-02T00:00:00Z/2018-01-04T00:00:00Z",
    "dtg AFTER 2018-01-12T00:00:00Z",
    "kind = 'rare' AND dtg DURING 2018-01-02T00:00:00Z/2018-01-09T00:00:00Z",
    "IN ('3', '9')",
])
def test_lean_xz3_store_queries(xz3_stores, polys, q):
    bb, t, kind = polys
    got = _same_result(xz3_stores, q)
    if q.startswith("BBOX"):
        # spatial-only: xz3 with an open interval clamped to the data
        assert got.strategy.index == "xz3"
        np.testing.assert_array_equal(got.positions,
                                      _box_oracle(bb, (0, 0, 20, 20)))
    if q.startswith("dtg DURING"):
        # temporal-only: the whole world
        lo, hi = MS + DAY, MS + 3 * DAY
        np.testing.assert_array_equal(got.positions,
                                      np.flatnonzero((t >= lo) & (t <= hi)))


def test_lean_xz_stats_and_density_answer_alike(xz3_stores):
    """The lean z3-only paths: an attribute stat folds next to the keys,
    a Z3Histogram and a heatmap over polygons take the materializing
    route or raise alike, and compaction covers the xz index."""
    jds, tds = xz3_stores
    a = jds.stats("osm", "INCLUDE", "Count();Enumeration(kind)")
    b = tds.stats("osm", "INCLUDE", "Count();Enumeration(kind)")
    assert b.stats[0].count == a.stats[0].count
    assert dict(b.stats[1].counts) == dict(a.stats[1].counts)
    with pytest.raises(KeyError) as je:
        jds.density_tile("osm", 1, 0, 0)
    with pytest.raises(KeyError) as te:
        tds.density_tile("osm", 1, 0, 0)
    assert str(te.value) == str(je.value)
    assert set(tds.compact("osm")) == set(jds.compact("osm")) == {
        "xz3", "attr:kind"}


def test_lean_xz_over_mesh_still_raises():
    """Lean XZ schemas over a mesh used to raise; since the sharded lean
    slice they ride ShardedLeanXZ2Index and answer as the JAX mesh store
    does (tests/test_torch_attr_lean_sharded.py holds more)."""
    from geomesa_tpu.parallel import device_mesh as jax_mesh
    from geomesa_tpu_torch.parallel import ShardedLeanXZ2Index
    rng = np.random.default_rng(4)
    cx, cy = rng.uniform(-170, 170, 500), rng.uniform(-80, 80, 500)
    bb = np.stack([cx - 0.5, cy - 0.5, cx + 0.5, cy + 0.5], axis=1)
    kind = rng.choice(np.array(["a", "b"], object), 500)
    ds = TpuDataStore(device="cpu", mesh=device_mesh(devices=["cpu"]))
    jds = JaxStore(mesh=jax_mesh(1))
    ds.create_schema("m", SPEC2)
    jds.create_schema("m", SPEC2)
    ds.write("m", {"kind": kind, "geom": packed_from_boxes(bb)})
    jds.write("m", {"kind": kind, "geom": j_packed(bb)})
    assert isinstance(ds._store("m").index("xz2"), ShardedLeanXZ2Index)
    for q in (Q_BOX, "kind = 'a'"):
        a, b = ds.query_result("m", q), jds.query_result("m", q)
        assert a.strategy.index == b.strategy.index
        np.testing.assert_array_equal(a.positions, b.positions)


@pytest.mark.parametrize("q", [
    Q_TRI + " AND dtg DURING 2018-01-03T00:00:00Z/2018-01-10T00:00:00Z",
    "kind = 'rare' AND " + Q_BOX
    + " AND dtg DURING 2018-01-02T00:00:00Z/2018-01-12T00:00:00Z",
    "BBOX(geom, 0, 0, 20, 20)",
])
def test_lean_xz3_estimator_costs_alike(xz3_stores, monkeypatch, q):
    """With the estimator open on a lean XZ3 store its z3 tier has no
    table there (``z3_rows`` answers None, so xz3 keeps its fraction
    cost) while the attribute tier folds the kind index's sketches: the
    costed options, the choice and the positions equal the JAX store's."""
    from geomesa_tpu import config
    for name in ("GEOMESA_PLANNING_ESTIMATOR_ENABLED",
                 "GEOMESA_PLANNING_REPLAN_THRESHOLD"):
        monkeypatch.delenv(name, raising=False)
        config.clear_property(name.lower().replace("_", "."))
    monkeypatch.setenv("GEOMESA_PLANNING_ESTIMATOR_MIN_ROWS", "0")
    jds, tds = xz3_stores
    assert tds._store("osm").estimator() is not None
    assert tds._store("osm").estimator().z3_rows(
        [(-80.0, 30.0, -60.0, 50.0)], [(MS, MS + DAY)]) is None
    got = _same_result(xz3_stores, q)
    assert got.strategy.source == jds.query_result("osm", q).strategy.source
    if got.strategy.index == "xz3":
        assert got.strategy.source != "sketch"
