"""Port parity: the host XZ2/XZ3 indexes of geomesa_tpu_torch against
geomesa_tpu, and their carry-across (convert.py).

Same seeded geometries — polygons with holes, multipolygons, lines and
multilines — through both packages; candidate and result positions are
equal exactly, with the exact predicate and without it, over bounded,
half-open and open intervals, at ``geomesa.xz.precision`` 8 and 12.
"""

import numpy as np
import pytest

from geomesa_tpu.datastore import TpuDataStore as JStore
from geomesa_tpu.geometry import types as jt
from geomesa_tpu.index.xz2 import XZ2Index as JXZ2Index
from geomesa_tpu.index.xz2 import _is_envelope as j_is_envelope
from geomesa_tpu.index.xz3 import XZ3Index as JXZ3Index
from geomesa_tpu_torch import TpuDataStore
from geomesa_tpu_torch.convert import xz_index_from_state, xz_index_state
from geomesa_tpu_torch.geometry import types as tt
from geomesa_tpu_torch.index.xz2 import XZ2Index, _is_envelope
from geomesa_tpu_torch.index.xz3 import XZ3Index

MS = 1514764800000
DAY = 86_400_000


def _shapes(rng, n):
    """Seeded geometry specs: (kind, coordinate arrays) a row."""
    out = []
    for _ in range(n):
        cx, cy = rng.uniform(-60, 60), rng.uniform(-40, 40)
        d = rng.uniform(0.05, 4.0)
        kind = rng.choice(["poly", "hole", "multi", "line", "mline"],
                          p=[0.4, 0.15, 0.15, 0.2, 0.1])
        box = np.array([[cx - d, cy - d], [cx + d, cy - d], [cx + d, cy + d],
                        [cx - d, cy + d]])
        if kind == "poly":
            out.append(("poly", (box,)))
        elif kind == "hole":
            out.append(("hole", (box, 0.4 * (box - [cx, cy]) + [cx, cy])))
        elif kind == "multi":
            out.append(("multi", (box, box + [3 * d, 0.5 * d])))
        elif kind == "line":
            k = int(rng.integers(2, 6))
            out.append(("line", (np.cumsum(rng.uniform(-d, d, (k, 2)), 0)
                                 + [cx, cy],)))
        else:
            out.append(("mline", (box[:2], box[2:] + [d, d])))
    return out


def _build(types, spec):
    kind, parts = spec
    if kind == "poly":
        return types.Polygon(parts[0])
    if kind == "hole":
        return types.Polygon(parts[0], holes=(parts[1],))
    if kind == "multi":
        return types.MultiPolygon(tuple(types.Polygon(p) for p in parts))
    if kind == "line":
        return types.LineString(parts[0])
    return types.MultiLineString(tuple(types.LineString(p) for p in parts))


@pytest.fixture(scope="module")
def shapes():
    rng = np.random.default_rng(4242)
    specs = _shapes(rng, 1500)
    t = rng.integers(MS, MS + 60 * DAY, len(specs))
    return specs, t


#: query geometries as specs: a triangle, a rectangle written as a
#: five-point polygon (its own envelope), a polygon with a hole, a line,
#: a multipolygon
QUERIES = [
    ("poly", (np.array([[-20.0, -10.0], [25.0, -5.0], [0.0, 30.0]]),)),
    ("poly", (np.array([[-30.0, -20.0], [10.0, -20.0], [10.0, 15.0],
                        [-30.0, 15.0]]),)),
    ("hole", (np.array([[-50.0, -30.0], [50.0, -30.0], [50.0, 30.0],
                        [-50.0, 30.0]]),
              np.array([[-20.0, -10.0], [20.0, -10.0], [20.0, 10.0],
                        [-20.0, 10.0]]))),
    ("line", (np.array([[-55.0, -35.0], [0.0, 5.0], [55.0, 38.0]]),)),
    ("multi", (np.array([[-60.0, -40.0], [-40.0, -40.0], [-40.0, -20.0],
                         [-60.0, -20.0]]),
               np.array([[30.0, 20.0], [45.0, 20.0], [45.0, 35.0],
                         [30.0, 35.0]]))),
]


@pytest.mark.parametrize("g", [8, 12])
@pytest.mark.parametrize("exact", [True, False])
def test_xz2_index_positions(shapes, g, exact):
    specs, _ = shapes
    j = JXZ2Index.build([_build(jt, s) for s in specs], g=g)
    p = XZ2Index.build([_build(tt, s) for s in specs], g=g)
    np.testing.assert_array_equal(p.codes, np.asarray(j.codes))
    np.testing.assert_array_equal(p.pos, np.asarray(j.pos))
    hits = 0
    for q in QUERIES:
        got = p.query(_build(tt, q), exact=exact)
        want = j.query(_build(jt, q), exact=exact)
        np.testing.assert_array_equal(got, want)
        hits += len(got)
    assert hits


@pytest.mark.parametrize("g", [8, 12])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("interval", ["bounded", "open-lo", "open-hi",
                                      "open"])
def test_xz3_index_positions(shapes, g, exact, interval):
    specs, t = shapes
    j = JXZ3Index.build([_build(jt, s) for s in specs], t, g=g)
    p = XZ3Index.build([_build(tt, s) for s in specs], t, g=g)
    for k in ("bins", "codes", "pos"):
        np.testing.assert_array_equal(getattr(p, k), np.asarray(getattr(j, k)))
    lo, hi = MS + 10 * DAY, MS + 24 * DAY
    lo = None if interval in ("open-lo", "open") else lo
    hi = None if interval in ("open-hi", "open") else hi
    hits = 0
    for q in QUERIES:
        got = p.query(_build(tt, q), lo, hi, exact=exact)
        want = j.query(_build(jt, q), lo, hi, exact=exact)
        np.testing.assert_array_equal(got, want)
        hits += len(got)
    assert hits


@pytest.mark.parametrize("spec", QUERIES + [
    ("poly", (np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0],
                        [0.0, 1.0]]),)),
    ("poly", (np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.5, 1.0],
                        [0.0, 1.0]]),)),
])
def test_is_envelope_alike(spec):
    """A BBOX query skips the exact predicate; a five-point rectangle
    written as a polygon is its own envelope too; anything else is not."""
    p, j = _build(tt, spec), _build(jt, spec)
    assert _is_envelope(p, p.envelope) == j_is_envelope(j, j.envelope)


def test_xz_index_state_round_trip(shapes):
    """JAX state → port index: the same query answers, exact and not."""
    specs, t = shapes
    jgeoms = [_build(jt, s) for s in specs]
    for j in (JXZ2Index.build(jgeoms, g=10),
              JXZ3Index.build(jgeoms, t, period="day", g=10)):
        p = xz_index_from_state(xz_index_state(j))
        assert type(p).__name__ == type(j).__name__
        for q in QUERIES:
            for exact in (True, False):
                args = (() if isinstance(j, JXZ2Index)
                        else (MS + 3 * DAY, MS + 40 * DAY))
                np.testing.assert_array_equal(
                    p.query(_build(tt, q), *args, exact=exact),
                    j.query(_build(jt, q), *args, exact=exact))


@pytest.mark.parametrize("precision", [None, "8", "12"])
def test_store_xz_precision_changes_codes(shapes, precision):
    """``geomesa.xz.precision`` sets the codes' resolution as it does in
    the JAX store; plans and positions stay equal."""
    specs, t = shapes
    spec = "v:Int,dtg:Date,*geom:Geometry"
    if precision:
        spec += f";geomesa.xz.precision={precision}"
    jds, tds = JStore(), TpuDataStore(device="cpu")
    for ds, types in ((jds, jt), (tds, tt)):
        ds.create_schema("g", spec)
        ds.write("g", {"v": np.arange(len(specs)), "dtg": t,
                       "geom": [_build(types, s) for s in specs]})
    for name in ("xz2", "xz3"):
        jidx = jds._store("g").index(name)
        pidx = tds._store("g").index(name)
        assert pidx.sfc.g == jidx.sfc.g == int(precision or 12)
        np.testing.assert_array_equal(pidx.codes, np.asarray(jidx.codes))
    for q in ("INTERSECTS(geom, POLYGON((-20 -10, 25 -5, 0 30, -20 -10)))",
              "BBOX(geom, -30, -20, 10, 15) AND dtg DURING "
              "2018-01-05T00:00:00Z/2018-01-20T00:00:00Z"):
        a, b = jds.query_result("g", q), tds.query_result("g", q)
        assert b.strategy.index == a.strategy.index
        np.testing.assert_array_equal(b.positions, a.positions)
