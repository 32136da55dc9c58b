"""Port parity: polygon, line and mixed-geometry schemas through the
store facades of geomesa_tpu_torch and geomesa_tpu — chosen strategy,
its cost, positions and exceptions equal over a seeded set of random
ECQL filters, with and without a dtg, on the default profile, a 2-shard
mesh and the lean profile (1,024-slot generations under a budget of
three),
with a write after the first queries (the kept xz indexes' tail).

It pins the xz3-against-full divergence of the port before the xz
indexes (2,000 rectangles, an INTERSECTS of a triangle AND a DURING:
the JAX store plans ``xz3``; the port planned a full scan)."""

import numpy as np
import pytest

from geomesa_tpu.datastore import TpuDataStore as JaxStore
from geomesa_tpu.geometry import types as jt
from geomesa_tpu.index import attr_lean as jax_al
from geomesa_tpu.parallel import device_mesh as jax_mesh
from geomesa_tpu_torch import TpuDataStore
from geomesa_tpu_torch.geometry import types as tt
from geomesa_tpu_torch.index.attr_lean import LeanAttrIndex
from geomesa_tpu_torch.parallel import device_mesh

MS = 1514764800000
DAY = 86_400_000
N = 3000
KINDS = np.array(["road", "building", "park", "water", "rare"], object)


@pytest.fixture(scope="module", autouse=True)
def _ci_generation_slots():
    old = LeanAttrIndex.GENERATION_SLOTS
    LeanAttrIndex.GENERATION_SLOTS = jax_al.LeanAttrIndex.GENERATION_SLOTS
    yield
    LeanAttrIndex.GENERATION_SLOTS = old


def _geoms(types, rng_seed, kind):
    """Seeded geometries: rectangles, lines or multipolygons of two
    triangles ("mixed" draws from all three)."""
    rng = np.random.default_rng(rng_seed)
    out = []
    for i in range(N):
        cx, cy = rng.uniform(-20, 20), rng.uniform(-15, 15)
        d = rng.uniform(0.01, 1.5)
        pick = kind if kind != "mixed" else ("poly", "line", "multi")[i % 3]
        if pick == "poly":
            out.append(types.Polygon([(cx - d, cy - d), (cx + d, cy - d),
                                      (cx + d, cy + d), (cx - d, cy + d)]))
        elif pick == "line":
            out.append(types.LineString(
                [(cx - d, cy), (cx, cy + d / 2), (cx + d, cy - d)]))
        else:
            out.append(types.MultiPolygon((
                types.Polygon([(cx - d, cy - d), (cx, cy - d), (cx, cy)]),
                types.Polygon([(cx + d, cy), (cx + 2 * d, cy),
                               (cx + 2 * d, cy + d)]))))
    return out


def _columns(with_dtg):
    rng = np.random.default_rng(11)
    cols = {"v": rng.integers(0, 100, N),
            "kind": rng.choice(KINDS, N, p=[0.4, 0.4, 0.1, 0.099, 0.001])}
    if with_dtg:
        cols["dtg"] = rng.integers(MS, MS + 60 * DAY, N)
    return cols


def _iso(ms):
    return np.datetime_as_string(np.datetime64(int(ms), "ms"),
                                 unit="s") + "Z"


def _random_filter(rng, with_dtg):
    """One random ECQL filter over the schema's attributes."""
    def spatial():
        x0, y0 = rng.uniform(-25, 20), rng.uniform(-20, 15)
        w, h = rng.uniform(0.2, 20), rng.uniform(0.2, 15)
        k = rng.integers(0, 4)
        if k == 0:
            return f"BBOX(geom, {x0}, {y0}, {x0 + w}, {y0 + h})"
        if k == 1:
            return (f"INTERSECTS(geom, POLYGON(({x0} {y0}, {x0 + w} {y0}, "
                    f"{x0 + w / 2} {y0 + h}, {x0} {y0})))")
        if k == 2:
            return (f"INTERSECTS(geom, POLYGON(({x0} {y0}, {x0 + w} {y0}, "
                    f"{x0 + w} {y0 + h}, {x0} {y0 + h}, {x0} {y0})))")
        return (f"WITHIN(geom, POLYGON(({x0} {y0}, {x0 + w} {y0}, "
                f"{x0 + w} {y0 + h}, {x0} {y0 + h}, {x0} {y0})))")

    def temporal():
        lo = MS + int(rng.integers(-5, 60)) * DAY
        k = rng.integers(0, 4)
        if k == 0:
            hi = lo + int(rng.integers(1, 20)) * DAY
            return f"dtg DURING {_iso(lo)}/{_iso(hi)}"
        if k == 1:
            return f"dtg AFTER {_iso(lo)}"
        if k == 2:
            return f"dtg BEFORE {_iso(lo)}"
        return f"dtg TEQUALS {_iso(lo)}"

    def attr():
        k = rng.integers(0, 4)
        if k == 0:
            return f"kind = '{rng.choice(KINDS)}'"
        if k == 1:
            return f"v > {int(rng.integers(0, 100))}"
        if k == 2:
            return "kind IN ('rare', 'water')"
        ids = ", ".join(f"'{int(i)}'" for i in rng.integers(0, N, 3))
        return f"IN ({ids})"

    parts = [spatial]
    if with_dtg:
        parts.append(temporal)
    parts.append(attr)

    def term(depth=0):
        k = rng.integers(0, 10)
        if depth < 2 and k < 3:
            op = " AND " if k < 2 else " OR "
            return f"({term(depth + 1)}{op}{term(depth + 1)})"
        if depth < 2 and k == 3:
            return f"NOT ({term(depth + 1)})"
        return parts[int(rng.integers(0, len(parts)))]()
    # most filters lead with an indexable AND, as users write them
    if rng.uniform() < 0.6 and with_dtg:
        return f"{spatial()} AND {temporal()}"
    return term()


def _outcome(ds, q):
    try:
        r = ds.query_result("g", q)
    except Exception as e:  # noqa: BLE001 — exceptions compared by type
        return ("raise", type(e).__name__)
    return (r.strategy.index, float(r.strategy.cost),
            np.asarray(r.positions).tolist())


STORES = ["default", "mesh", "lean"]
SCHEMAS = [("poly", True), ("poly", False), ("line", True), ("mixed", True)]


def _make(store_kind, spec_kind, with_dtg):
    geom_t = {"poly": "Polygon", "line": "LineString",
              "mixed": "Geometry"}[spec_kind]
    idx = ":index=true" if store_kind == "lean" else ""
    spec = f"v:Int,kind:String{idx},"
    spec += "dtg:Date," if with_dtg else ""
    spec += f"*geom:{geom_t}"
    if store_kind == "lean":
        spec += (";geomesa.index.profile=lean,"
                 "geomesa.lean.generation.slots=1024,"
                 f"geomesa.lean.hbm.budget={3 * 1024 * 20}")
    if store_kind == "mesh":
        pair = (JaxStore(mesh=jax_mesh(2)),
                TpuDataStore(device="cpu",
                             mesh=device_mesh(devices=["cpu"] * 2)))
    else:
        pair = (JaxStore(), TpuDataStore(device="cpu"))
    for ds in pair:
        ds.create_schema("g", spec)
    return pair


@pytest.mark.parametrize("store_kind", STORES)
@pytest.mark.parametrize("spec_kind,with_dtg", SCHEMAS)
def test_random_filters_plan_and_answer_alike(store_kind, spec_kind,
                                              with_dtg):
    pair = _make(store_kind, spec_kind, with_dtg)
    cols = _columns(with_dtg)
    seed = 1000 * STORES.index(store_kind) + 10 * SCHEMAS.index(
        (spec_kind, with_dtg))
    geoms = (_geoms(jt, 5, spec_kind), _geoms(tt, 5, spec_kind))
    rng = np.random.default_rng(seed)
    half = N // 2
    used = set()
    for lo, hi in ((0, half), (half, N)):
        for ds, g in zip(pair, geoms):
            ds.write("g", {**{k: v[lo:hi] for k, v in cols.items()},
                           "geom": g[lo:hi]})
        for _ in range(20):
            q = _random_filter(rng, with_dtg)
            a, b = (_outcome(ds, q) for ds in pair)
            assert b == a, q
            used.add(a[0])
    if with_dtg:
        assert used & {"xz3", "xz2"}, used


def test_motivation_probe_plans_xz3():
    """2,000 rectangles; the port used to plan a full scan here."""
    rng = np.random.default_rng(0)
    n = 2000
    cx, cy = rng.uniform(-5, 5, n), rng.uniform(-5, 5, n)
    d = rng.uniform(0.01, 0.5, n)
    t = rng.integers(MS, MS + 365 * DAY, n)
    q = ("INTERSECTS(geom, POLYGON((0 0, 3 0, 3 2, 0 0))) AND dtg DURING "
         "2018-03-01T00:00:00Z/2018-05-01T00:00:00Z")
    out = []
    for ds, types in ((JaxStore(), jt), (TpuDataStore(device="cpu"), tt)):
        ds.create_schema("g", "v:Int,dtg:Date,*geom:Polygon")
        ds.write("g", {"v": np.arange(n), "dtg": t, "geom": [
            types.Polygon([(a - e, b - e), (a + e, b - e), (a + e, b + e),
                           (a - e, b + e)]) for a, b, e in zip(cx, cy, d)]})
        out.append(ds.query_result("g", q))
    assert out[0].strategy.index == out[1].strategy.index == "xz3"
    assert out[1].strategy.cost == out[0].strategy.cost
    np.testing.assert_array_equal(out[1].positions, out[0].positions)
    assert len(out[1].positions)


@pytest.mark.parametrize("case", ["temporal-only", "xz3-only-spatial",
                                  "tail", "density-raises"])
def test_default_profile_polygon_paths(case):
    """The JAX package's review cases: a temporal-only query scans the
    whole world on xz3; an xz3-only schema serves a spatial query with an
    open interval; rows written after an index build ride its tail; a
    heatmap over polygons raises alike (no x/y columns)."""
    spec = "dtg:Date,*geom:Polygon"
    if case == "xz3-only-spatial":
        spec += ";geomesa.indices.enabled=xz3,id"
    stores = (JaxStore(), TpuDataStore(device="cpu"))
    outs = []
    for ds, types in zip(stores, (jt, tt)):
        ds.create_schema("p", spec)
        ds.write("p", {"dtg": np.array([MS, MS + 5 * DAY]), "geom": [
            types.Polygon([(0, 0), (1, 0), (1, 1), (0, 1)]),
            types.Polygon([(2, 2), (3, 2), (3, 3), (2, 3)])]})
        q = {"temporal-only": "dtg DURING 2018-01-01T00:00:00Z/"
                              "2018-01-02T00:00:00Z",
             "xz3-only-spatial": "BBOX(geom, -1, -1, 2, 2)",
             "tail": "BBOX(geom, -1, -1, 9, 9)",
             "density-raises": "INCLUDE"}[case]
        if case == "density-raises":
            try:
                ds.density_tile("p", 0, 0, 0)
                outs.append("no error")
            except KeyError as e:
                outs.append(f"KeyError {e}")
            continue
        first = ds.query_result("p", q)
        ds.write("p", {"dtg": np.array([MS + DAY // 2]), "geom": [
            types.Polygon([(5, 5), (6, 5), (6, 6), (5, 6)])]})
        second = ds.query_result("p", q)
        outs.append([(r.strategy.index, list(r.positions))
                     for r in (first, second)]
                    + [ds._store("p").build_counts])
    assert outs[1] == outs[0]
    if case == "temporal-only":
        assert outs[1][0] == ("xz3", [0])
    if case == "tail":
        assert outs[1][1] == ("xz2", [0, 1, 2])


def test_mesh_xz3_only_spatial_raises_alike():
    """Known state of the reference: on a mesh, an xz3-only schema's
    spatial-only query (an open interval) raises ``TypeError`` in the
    sharded xz3 scan of both packages; the port keeps the behavior."""
    spec = "dtg:Date,*geom:Polygon;geomesa.indices.enabled=xz3,id"
    outs = []
    for ds, types in ((JaxStore(mesh=jax_mesh(2)), jt),
                      (TpuDataStore(device="cpu",
                                    mesh=device_mesh(devices=["cpu"] * 2)),
                       tt)):
        ds.create_schema("g", spec)
        ds.write("g", {"dtg": np.array([MS, MS + DAY]), "geom": [
            types.Polygon([(0, 0), (1, 0), (1, 1), (0, 1)]),
            types.Polygon([(5, 5), (6, 5), (6, 6), (5, 6)])]})
        outs.append(_outcome(ds, "BBOX(geom, -1, -1, 2, 2)"))
    assert outs[1] == outs[0] == ("raise", "TypeError")
