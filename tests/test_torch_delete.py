"""Port parity: deletes, tombstones and the physical age-off, through
geomesa_tpu_torch's store against geomesa_tpu's, on the same seeded rows
— on the default profile, a mesh (2 CPU shards in the port, the suite's
8-device virtual mesh in the JAX package) and the lean profile (point
z3 with an indexed attribute, and polygon XZ2/XZ3).

Held equal, bit for bit: delete counts (a second delete of the same ids
counts 0), positions after the delete (the default profile drops every
built index, kept tails included, and rebuilds; the lean profile keeps
its indexes and masks the tombstoned rows), ids that are never reused,
``get_count``, ``get_bounds``, ``stat``, ``stats`` (the lean push-downs
fall back to the materializing path), and ``age_off`` with and without
``dry_run``; unit-weight heatmaps and tiles exactly, weighted heatmaps
within the ``rtol=1e-5`` of ``tests/test_pallas_kernels.py``."""

import importlib

import numpy as np
import pytest

from geomesa_tpu.age_off import age_off as jax_age_off
from geomesa_tpu.datastore import TpuDataStore as JaxStore
from geomesa_tpu.geometry.packed import packed_from_boxes as j_packed
from geomesa_tpu.index import attr_lean as jax_al
from geomesa_tpu.parallel import device_mesh as jax_mesh
from geomesa_tpu.process.density import density_process as jax_density
from geomesa_tpu_torch import TpuDataStore, device_mesh
from geomesa_tpu_torch.age_off import age_off
from geomesa_tpu_torch.filters import evaluate_filter, parse_ecql
from geomesa_tpu_torch.geometry.packed import packed_from_boxes
from geomesa_tpu_torch.index.attr_lean import LeanAttrIndex
from geomesa_tpu_torch.process.density import density_process

MS = 1514764800000
DAY = 86_400_000
N = 2_500
SPEC = ("actor:String:index=true,score:Double:index=true,dtg:Date,"
        "*geom:Point")
LEAN = (";geomesa.index.profile=lean,geomesa.lean.generation.slots=1024,"
        "geomesa.lean.hbm.budget=200000")
QUERIES = [
    "BBOX(geom, -5, -5, 5, 5) AND dtg DURING "
    "2018-01-05T00:00:00Z/2018-01-20T00:00:00Z",
    "BBOX(geom, -5, -5, 5, 5)",
    "actor = 'b' AND dtg DURING 2018-01-01T00:00:00Z/2018-01-15T00:00:00Z",
    "score BETWEEN 2 AND 4",
    "IN ('1', '3', '2502', '5001', '7777')",
    "INCLUDE",
]
ENV = (-10.0, -10.0, 10.0, 10.0)
stats_mod = importlib.import_module("geomesa_tpu_torch.process.stats_process")


@pytest.fixture(scope="module", autouse=True)
def _ci_generation_slots():
    """The port's attribute-index class default follows the JAX one the
    suite's conftest sets (the per-index budget floor reads it)."""
    old = LeanAttrIndex.GENERATION_SLOTS
    LeanAttrIndex.GENERATION_SLOTS = jax_al.LeanAttrIndex.GENERATION_SLOTS
    yield
    LeanAttrIndex.GENERATION_SLOTS = old


def _rows(rng, n=N):
    return {"actor": rng.choice(np.array(["a", "b", "c"], dtype=object), n),
            "score": rng.uniform(0.0, 10.0, n),
            "dtg": rng.integers(MS, MS + 30 * DAY, n),
            "geom": (rng.uniform(-10, 10, n), rng.uniform(-10, 10, n))}


def _pair(profile: str, writes: int = 4, seed: int = 0):
    out = []
    for side in ("jax", "torch"):
        kw = {}
        if profile == "mesh":
            kw["mesh"] = (jax_mesh() if side == "jax"
                          else device_mesh(devices=["cpu"] * 2))
        ds = (JaxStore(**kw) if side == "jax"
              else TpuDataStore(device="cpu", **kw))
        ds.create_schema("s", SPEC + (LEAN if profile == "lean" else ""))
        rng = np.random.default_rng(seed)
        for _ in range(writes):
            ds.write("s", _rows(rng))
        out.append(ds)
    return out


def _env(e):
    return None if e is None else e.as_tuple()


def _same_reads(jds, tds, queries=QUERIES):
    for ecql in queries:
        want = jds.query_result("s", ecql)
        got = tds.query_result("s", ecql)
        assert got.strategy.index == want.strategy.index, ecql
        np.testing.assert_array_equal(got.positions, want.positions)
        np.testing.assert_array_equal(got.batch.ids.astype(str),
                                      want.batch.ids.astype(str))
    assert tds.get_count("s") == jds.get_count("s")
    assert _env(tds.get_bounds("s")) == _env(jds.get_bounds("s"))
    assert tds.get_attribute_bounds("s", "score") == \
        jds.get_attribute_bounds("s", "score")
    for key in ("count", "dtg_minmax", "score_minmax", "geom_bbox",
                "score_histogram"):
        want, got = jds.stat("s", key), tds.stat("s", key)
        assert (got is None) == (want is None), key
        if got is not None:
            assert got.to_json() == want.to_json(), key


def _delete_ids(rng, n_rows: int, k: int) -> list:
    rows = rng.choice(n_rows, k, replace=False)
    return [str(r) for r in rows] + ["missing", str(n_rows + 5)]


# -- default profile and mesh -------------------------------------------

@pytest.mark.parametrize("profile", ["default", "mesh"])
def test_delete_removes_rows_and_rebuilds(profile):
    jds, tds = _pair(profile)
    # build every index first, so the delete must drop them
    _same_reads(jds, tds)
    ids = _delete_ids(np.random.default_rng(5), 4 * N, 400)
    assert tds.delete("s", ids) == jds.delete("s", ids) == 400
    assert not tds._store("s")._indexes
    assert not tds._store("s")._index_coverage
    _same_reads(jds, tds)
    assert tds.delete("s", ids) == jds.delete("s", ids) == 0
    # auto ids are never reused: the next write mints 10000...
    rng = np.random.default_rng(9)
    rows = _rows(rng, 100)
    jds.write("s", rows)
    tds.write("s", rows)
    got = tds.query_result("s", "IN ('10000', '10099', '10100')")
    assert sorted(got.batch.ids.astype(str)) == ["10000", "10099"]
    _same_reads(jds, tds)
    for spec in ("Count();MinMax(score);Histogram(score,16,0,10)",
                 "Frequency(actor,4,64)", "TopK(actor)"):
        for ecql in QUERIES[:2] + ["INCLUDE"]:
            assert tds.stats("s", ecql, spec).to_json() == \
                jds.stats("s", ecql, spec).to_json()
    np.testing.assert_array_equal(
        density_process(tds, "s", QUERIES[0], ENV, 32, 16),
        np.asarray(jax_density(jds, "s", QUERIES[0], ENV, 32, 16)))


def test_delete_drops_a_kept_index_tail():
    """A kept attribute index serves rows appended after its build as a
    tail; a delete moves every row position, so the index and its tail
    must go (a stale tail hands back wrong rows with no error)."""
    jds, tds = _pair("default", writes=2)
    _same_reads(jds, tds, QUERIES[2:4])
    rng = np.random.default_rng(21)
    rows = _rows(rng, 600)
    jds.write("s", rows)
    tds.write("s", rows)
    assert tds._store("s").index_tail("attr:actor") is not None
    _same_reads(jds, tds, QUERIES[2:4])
    ids = _delete_ids(np.random.default_rng(6), 2 * N + 600, 700)
    assert tds.delete("s", ids) == jds.delete("s", ids) == 700
    assert tds._store("s").index_tail("attr:actor") is None
    _same_reads(jds, tds)
    st = tds._store("s")
    batch = st.batch
    for ecql in QUERIES[2:4]:
        want = np.flatnonzero(evaluate_filter(parse_ecql(ecql), batch))
        np.testing.assert_array_equal(
            np.sort(tds.query_result("s", ecql).positions), want)


def test_delete_on_polygon_schema_and_empty_store():
    rng = np.random.default_rng(4)
    n = 3000
    cx, cy = rng.uniform(-10, 10, n), rng.uniform(-10, 10, n)
    bb = np.stack([cx - 0.1, cy - 0.1, cx + 0.1, cy + 0.1], axis=1)
    t = rng.integers(MS, MS + 14 * DAY, n)
    q = ("INTERSECTS(geom, POLYGON((-5 -5, 5 -5, 0 5, -5 -5))) AND dtg "
         "DURING 2018-01-02T00:00:00Z/2018-01-09T00:00:00Z")
    out = []
    for ds, packed in ((JaxStore(), j_packed),
                       (TpuDataStore(device="cpu"), packed_from_boxes)):
        ds.create_schema("p", "dtg:Date,*geom:Polygon")
        ds.create_schema("e", SPEC)
        assert ds.delete("e", ["1"]) == 0
        ds.write("p", {"dtg": t, "geom": packed(bb)})
        first = ds.query_result("p", q).positions
        removed = ds.delete("p", [str(i) for i in first[::3]])
        out.append((removed, ds.query_result("p", q).positions,
                    ds.query_result("p", "BBOX(geom, -5, -5, 5, 5)").positions,
                    ds.get_count("p"), _env(ds.get_bounds("p"))))
    assert out[0][0] == out[1][0] > 0
    for a, b in zip(out[0][1:3], out[1][1:3]):
        np.testing.assert_array_equal(b, a)
    assert out[0][3:] == out[1][3:]


# -- lean profile ---------------------------------------------------------

def _lean_heatmaps(jds, tds):
    for ecql in (QUERIES[0], "INCLUDE", "BBOX(geom, -5, -5, 5, 5)"):
        np.testing.assert_array_equal(
            density_process(tds, "s", ecql, ENV, 32, 16),
            np.asarray(jax_density(jds, "s", ecql, ENV, 32, 16)))
    np.testing.assert_allclose(
        density_process(tds, "s", QUERIES[0], ENV, 32, 16,
                        weight_attr="score"),
        np.asarray(jax_density(jds, "s", QUERIES[0], ENV, 32, 16,
                               weight_attr="score")), rtol=1e-5)
    for z, x, y in ((0, 0, 0), (1, 1, 0), (3, 4, 3)):
        np.testing.assert_array_equal(
            tds.density_tile("s", z, x, y, tile=16),
            jds.density_tile("s", z, x, y, tile=16))


def test_lean_tombstones_match_reference(monkeypatch):
    jds, tds = _pair("lean", writes=6)
    assert min(tds._store("s").index("z3").tier_counts().values()) > 0
    ids = _delete_ids(np.random.default_rng(7), 6 * N, 900)
    ids += ids[:50] + ["007", "-1", "1.0"]
    assert tds.delete("s", ids) == jds.delete("s", ids) == 900
    st = tds._store("s")
    assert int(st.tombstone.sum()) == 900
    assert tds.delete("s", ids) == jds.delete("s", ids) == 0
    _same_reads(jds, tds)
    # the push-downs fall back: every Count and sketch materializes
    calls = []
    orig = stats_mod._lean_count_pushdown
    monkeypatch.setattr(stats_mod, "_lean_count_pushdown",
                        lambda *a: calls.append(orig(*a)) or calls[-1])
    for spec in ("Count()", "Count();MinMax(score)", "MinMax(score)",
                 "Histogram(score,16,0,10)", "Z3Histogram(geom,dtg,week,8)"):
        for ecql in ("INCLUDE", QUERIES[0]):
            want = jds.stats("s", ecql, spec)
            got = tds.stats("s", ecql, spec)
            assert got.to_json() == want.to_json(), (spec, ecql)
    assert calls and all(c is None for c in calls)
    live = 6 * N - 900
    assert tds.stats("s", "INCLUDE", "Count()").count == live
    assert tds.get_count("s") == live
    _lean_heatmaps(jds, tds)
    # later writes grow the tombstone with live rows
    rng = np.random.default_rng(33)
    rows = {k: v for k, v in _rows(rng, 700).items()}
    jds.write("s", rows)
    tds.write("s", rows)
    assert len(st.tombstone) == 6 * N + 700
    assert not st.tombstone[6 * N:].any()
    _same_reads(jds, tds)
    _lean_heatmaps(jds, tds)


def test_lean_tombstones_without_deletes_keep_pushdowns():
    """A delete of ids that match nothing leaves the push-downs on."""
    jds, tds = _pair("lean", writes=2)
    assert tds.delete("s", ["bogus", str(10 ** 9)]) == 0
    assert tds._store("s").tombstone is None
    assert tds.stats("s", "INCLUDE", "Count()").count == \
        jds.stats("s", "INCLUDE", "Count()").count == 2 * N
    _lean_heatmaps(jds, tds)


@pytest.mark.parametrize("kind", ["xz2", "xz3"])
def test_lean_xz_deletes_match_reference(kind):
    rng = np.random.default_rng(31)
    n = 8_000
    cx, cy = rng.uniform(-170, 170, n), rng.uniform(-80, 80, n)
    w = rng.uniform(0.001, 0.05, n)
    bb = np.stack([cx - w, cy - w, cx + w, cy + w], axis=1)
    t = rng.integers(MS, MS + 14 * DAY, n)
    k = rng.choice(np.array(["road", "park", "rare"], object), n,
                   p=[0.6, 0.39, 0.01])
    spec = ("kind:String:index=true," + ("dtg:Date," if kind == "xz3" else "")
            + "*geom:Polygon;geomesa.index.profile=lean,"
              "geomesa.lean.generation.slots=1024")
    q = ("INTERSECTS(geom, POLYGON((-80 30, -60 30, -60 50, -80 50, "
         "-80 30)))")
    queries = [q, "BBOX(geom, -100, -50, 100, 50)", "kind = 'rare'",
               "IN ('3', '17', '7999')"]
    if kind == "xz3":
        queries.append(q + " AND dtg DURING "
                           "2018-01-02T00:00:00Z/2018-01-06T00:00:00Z")
    out = []
    for ds, packed in ((JaxStore(), j_packed),
                       (TpuDataStore(device="cpu"), packed_from_boxes)):
        ds.create_schema("osm", spec)
        for lo in range(0, n, 2000):
            rows = {"kind": k[lo:lo + 2000], "geom": packed(bb[lo:lo + 2000])}
            if kind == "xz3":
                rows["dtg"] = t[lo:lo + 2000]
            ds.write("osm", rows)
        assert ds._store("osm").lean_kind == kind
        hits = ds.query_result("osm", q).positions
        ids = [str(i) for i in hits[:3]] + ["17", "7999"]
        res = [ds.delete("osm", ids), ds.delete("osm", ids)]
        res += [ds.query_result("osm", e).positions for e in queries]
        res.append(ds.get_count("osm"))
        try:
            res.append(_env(ds.get_bounds("osm")))
        except KeyError as e:
            # the masked extent reads x/y columns a polygon schema does
            # not have: both packages raise
            res.append(f"KeyError {e}")
        out.append(res)
    assert out[0][0] == out[1][0] == 5 and out[1][1] == 0
    for a, b in zip(out[0][2:], out[1][2:]):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a)
        else:
            assert b == a


# -- age-off ---------------------------------------------------------------

@pytest.mark.parametrize("profile", ["default", "mesh"])
def test_age_off_physical_and_dry_run(profile):
    jds, tds = _pair(profile, writes=2)
    cut = MS + 9 * DAY
    assert age_off(tds, "s", older_than_ms=cut, dry_run=True) == \
        jax_age_off(jds, "s", older_than_ms=cut, dry_run=True) > 0
    assert tds.get_count("s") == 2 * N
    removed = age_off(tds, "s", older_than_ms=cut)
    assert removed == jax_age_off(jds, "s", older_than_ms=cut) > 0
    assert age_off(tds, "s", older_than_ms=cut) == 0
    _same_reads(jds, tds)
    dtg = tds._store("s").batch.column("dtg")
    assert (dtg >= cut).all() and tds.get_count("s") == 2 * N - removed


def test_age_off_retention_and_errors():
    tds = TpuDataStore(device="cpu")
    tds.create_schema("s", SPEC)
    tds.create_schema("p", "name:String,*geom:Point")
    with pytest.raises(ValueError, match="need older_than_ms"):
        age_off(tds, "s")
    with pytest.raises(ValueError, match="no dtg"):
        age_off(tds, "p", older_than_ms=MS)
    assert age_off(tds, "s", retention="7 days") == 0
    tds.write("s", _rows(np.random.default_rng(2), 50))
    # every row of 2018 is older than seven days
    assert age_off(tds, "s", retention="7 days", dry_run=True) == 50
    assert age_off(tds, "s", retention="7 days") == 50
    assert tds.get_count("s") == 0


def test_lean_age_off_tombstones_like_a_reference_delete():
    """The JAX ``age_off`` reads the whole id column, which its lean
    batch refuses; the port deletes the expired rows through their
    implicit ids — the same as a JAX ``delete`` of those ids."""
    jds, tds = _pair("lean", writes=3)
    cut = MS + 8 * DAY
    with pytest.raises(AttributeError):
        jax_age_off(jds, "s", older_than_ms=cut)
    dry = age_off(tds, "s", older_than_ms=cut, dry_run=True)
    assert dry == jax_age_off(jds, "s", older_than_ms=cut, dry_run=True) > 0
    jst = jds._store("s")
    expired = np.flatnonzero(jst.batch.column("dtg") < cut)
    assert age_off(tds, "s", older_than_ms=cut) == \
        jds.delete("s", jst.batch.row_ids(expired)) == dry
    assert age_off(tds, "s", older_than_ms=cut) == 0
    # a dry run still counts the tombstoned expired rows, as JAX's does
    assert age_off(tds, "s", older_than_ms=cut, dry_run=True) == dry
    _same_reads(jds, tds)
    _lean_heatmaps(jds, tds)


@pytest.mark.parametrize("prefix", ["", "p1."])
def test_lean_id_lookup_matches_the_reference_loop(prefix):
    """The port resolves implicit ids vectorized; the JAX package's
    per-id loop is the reference (canonical decimal form only, no
    leading zeros, ASCII digits, below the row count; repeats once)."""
    from geomesa_tpu.index.id import LeanIdIndex as JaxLeanIdIndex
    from geomesa_tpu_torch.index.id import LeanIdIndex

    rng = np.random.default_rng(8)
    ids = [str(i) for i in rng.integers(0, 1200, 300)]
    ids += ["0", "007", "00", "-1", "+3", " 3", "3 ", "1e2", "1.0", "٣",
            "999", "1000", "99999999999999999999", "", "abc", "p1.5",
            "p1.p1.5", "p1.05", "p1.", "5p1."]
    ids = [prefix + i if k % 3 else i for k, i in enumerate(ids)]
    for req in (ids, np.asarray(ids, dtype=object), [7, 8, 7], []):
        want = JaxLeanIdIndex(1000, prefix=prefix).query(req)
        got = LeanIdIndex(1000, prefix=prefix).query(req)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int64
