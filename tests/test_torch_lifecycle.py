"""Port parity: the legacy v1 key layouts and the schema lifecycle,
through geomesa_tpu_torch against geomesa_tpu on the same seeded rows.

Held equal, bit for bit: the legacy z2/z3 keys, normalizations, cell
centres and covering ranges (points on ±180/±90 and on cell edges
included); v1 layouts on the default profile, a mesh (2 CPU shards in the
port, the suite's 8-device virtual mesh in the JAX package) and the lean
profile — positions, and candidates through the explain text (its
"scanned" count); ``migrate_schema``; ``update_schema`` (renames, a bad
name, a collision, attribute changes, interceptors that re-resolve,
``geomesa.index.versions=current``); ``remove_schema``; ``type_names``;
``explain``; and a schema store's row-level state carried across
packages."""

import re

import numpy as np
import pytest
import torch

from geomesa_tpu.curve.legacy import legacy_z2_sfc as j_z2
from geomesa_tpu.curve.legacy import legacy_z3_sfc as j_z3
from geomesa_tpu.datastore import CURRENT_INDEX_VERSIONS as J_CURRENT
from geomesa_tpu.datastore import TpuDataStore as JaxStore
from geomesa_tpu.features.feature_type import parse_spec as j_parse_spec
from geomesa_tpu.parallel import device_mesh as jax_mesh
from geomesa_tpu_torch import TpuDataStore, device_mesh
from geomesa_tpu_torch.convert import (
    apply_schema_store_state, schema_store_state,
)
from geomesa_tpu_torch.curve.legacy import legacy_z2_sfc, legacy_z3_sfc
from geomesa_tpu_torch.datastore import CURRENT_INDEX_VERSIONS
from geomesa_tpu_torch.features.feature_type import parse_spec
from geomesa_tpu_torch.filters import evaluate_filter, parse_ecql
from geomesa_tpu_torch.security import StaticAuthorizationsProvider

MS = 1514764800000
DAY = 86_400_000
N = 20_003
SPEC = "name:String:index=true,dtg:Date,*geom:Point"
V1 = "geomesa.index.versions='z3:1,z2:1'"
LEAN = ("geomesa.index.profile=lean,geomesa.lean.generation.slots=2048,"
        "geomesa.lean.hbm.budget=400000")


def _spec(*user_data: str) -> str:
    """SPEC with the given user-data entries (comma-joined after ';')."""
    ud = ",".join(u for u in user_data if u)
    return SPEC + (f";{ud}" if ud else "")


QUERIES = [
    "BBOX(geom, -74.5, 40.5, -73.5, 41.5) AND dtg DURING "
    "2018-01-03T00:00:00Z/2018-01-10T00:00:00Z",
    "BBOX(geom, -74.2, 40.8, -73.9, 41.1)",
    "BBOX(geom, -75, 40, -73, 42) AND dtg DURING "
    "2018-01-01T00:00:00Z/2018-01-22T00:00:00Z",
    "BBOX(geom, -74.9, 40.1, -74.6, 40.4) OR BBOX(geom, -73.4, 41.6, "
    "-73.1, 41.9)",
    "BBOX(geom, -180, -90, -74, 41) AND dtg DURING "
    "2018-01-05T00:00:00Z/2018-01-06T00:00:00Z",
    "name = 'b' AND BBOX(geom, -74.5, 40.5, -73.5, 41.5)",
]


def _data(seed: int, n: int = N):
    rng = np.random.default_rng(seed)
    return {"name": rng.choice(np.array(["a", "b", "c"], dtype=object), n),
            "dtg": rng.integers(MS, MS + 21 * DAY, n),
            "geom": (rng.uniform(-75.0, -73.0, n), rng.uniform(40.0, 42.0, n))}


def _pair(user_data: str = "", profile: str = "default", seed: int = 3,
          writes=1):
    out = []
    for side in ("jax", "torch"):
        kw = {}
        if profile == "mesh":
            kw["mesh"] = (jax_mesh() if side == "jax"
                          else device_mesh(devices=["cpu"] * 2))
        ds = (JaxStore(**kw) if side == "jax"
              else TpuDataStore(device="cpu", **kw))
        ds.create_schema("ev", _spec(user_data,
                                     LEAN if profile == "lean" else ""))
        for w in range(writes):
            ds.write("ev", _data(seed + w, N // writes))
        out.append(ds)
    return out


def _explain(ds, ecql) -> str:
    """The explain text without its timings (the rest — strategy
    options, costs, ranges, the candidates scanned and the hits — must
    be equal)."""
    return re.sub(r"[0-9.]+ms", "", ds.explain("ev", ecql))


# -- the legacy curves ----------------------------------------------------

def _edge_points(rng, n: int = 4000):
    """Random points plus the world's edges and exact cell edges of the
    legacy normalizations (``min + k·(max - min)/precision``)."""
    p21, p31 = (1 << 21) - 1, (1 << 31) - 1
    k = rng.integers(0, p21, 200)
    xs = [rng.uniform(-180, 180, n), [-180.0, 180.0, 0.0, -0.0],
          -180.0 + k * 360.0 / p21, -180.0 + k * 360.0 / p31,
          np.nextafter(-180.0 + k * 360.0 / p21, np.inf)]
    ys = [rng.uniform(-90, 90, n), [-90.0, 90.0, 90.0, -90.0],
          -90.0 + k * 180.0 / p21, -90.0 + k * 180.0 / p31,
          np.nextafter(-90.0 + k * 180.0 / p21, -np.inf)]
    return np.concatenate(xs), np.concatenate(ys)


def test_legacy_z2_keys_bit_exact():
    x, y = _edge_points(np.random.default_rng(1))
    got = legacy_z2_sfc().index(torch.from_numpy(x), torch.from_numpy(y))
    want = np.asarray(j_z2().index(x, y, xp=np))
    np.testing.assert_array_equal(got.numpy(), want)
    for dim in ("lon", "lat"):
        t, j = getattr(legacy_z2_sfc(), dim), getattr(j_z2(), dim)
        v = x if dim == "lon" else y
        np.testing.assert_array_equal(
            t.normalize(torch.from_numpy(v)).numpy(),
            np.asarray(j.normalize(v, xp=np)))
        assert [t.normalize_scalar(float(a)) for a in v[::97]] == \
            [j.normalize_scalar(float(a)) for a in v[::97]]
    gx, gy = legacy_z2_sfc().invert(got)
    wx, wy = j_z2().invert(want)
    np.testing.assert_array_equal(gx.numpy(), wx)
    np.testing.assert_array_equal(gy.numpy(), wy)
    boxes = [(-74.5, 40.5, -73.5, 41.5), (-180.0, -90.0, -179.0, 90.0)]
    np.testing.assert_array_equal(legacy_z2_sfc().ranges(boxes, 64),
                                  j_z2().ranges(boxes, 64))


@pytest.mark.parametrize("period", ["day", "week", "month", "year"])
def test_legacy_z3_keys_bit_exact(period):
    rng = np.random.default_rng(2)
    x, y = _edge_points(rng)
    tmax = float(j_z3(period).time.max)
    t = np.concatenate([rng.uniform(0, tmax, len(x) - 4),
                        [0.0, tmax, tmax / 2, 1.0]])
    got = legacy_z3_sfc(period).index(torch.from_numpy(x),
                                      torch.from_numpy(y),
                                      torch.from_numpy(t))
    want = np.asarray(j_z3(period).index(x, y, t, xp=np))
    np.testing.assert_array_equal(got.numpy(), want)
    for g, w in zip(legacy_z3_sfc(period).invert(got),
                    j_z3(period).invert(want)):
        np.testing.assert_array_equal(g.numpy(), w)
    assert legacy_z3_sfc(period).whole_period == j_z3(period).whole_period
    boxes = [(-74.5, 40.5, -73.5, 41.5)]
    for tlo, thi in ((0, int(tmax)), (1000, 90_000)):
        np.testing.assert_array_equal(
            legacy_z3_sfc(period).ranges(boxes, [(tlo, thi)], 128),
            j_z3(period).ranges(boxes, [(tlo, thi)], 128))


def test_legacy_normalize_is_float64_ceil():
    """The trap: a float32 path or ``floor`` lands a boundary point one
    cell off."""
    dim = legacy_z3_sfc().lon
    edge = -180.0 + 1000 * 360.0 / dim.precision
    assert dim.normalize(torch.tensor([edge], dtype=torch.float64)).item() \
        == dim.normalize_scalar(edge) == j_z3().lon.normalize_scalar(edge)
    nudged = np.nextafter(edge, np.inf)
    assert dim.normalize_scalar(nudged) == dim.normalize_scalar(edge) + 1


# -- v1 layouts through the store ------------------------------------------

@pytest.mark.parametrize("profile", ["default", "mesh", "lean"])
def test_v1_layouts_serve_queries_like_reference(profile):
    jds, tds = _pair(V1, profile, writes=2 if profile == "lean" else 1)
    jst, tst = jds._store("ev"), tds._store("ev")
    assert tst.index_versions == jst.index_versions
    assert tst.index_versions["z3"] == tst.index_versions["z2"] == 1
    batch = tst.batch
    for ecql in QUERIES:
        want = jds.query_result("ev", ecql)
        got = tds.query_result("ev", ecql)
        assert got.strategy.index == want.strategy.index, ecql
        np.testing.assert_array_equal(got.positions, want.positions)
        np.testing.assert_array_equal(
            np.sort(got.positions),
            np.flatnonzero(evaluate_filter(parse_ecql(ecql), batch)))
        assert _explain(tds, ecql) == _explain(jds, ecql), ecql
    assert tst.z3_index().version == jst.z3_index().version == 1
    if profile != "lean":
        assert tst.z2_index().version == jst.z2_index().version == 1
    # migration: the layouts move to the current ones, hits stay
    old = tds.migrate_schema("ev")
    assert old == jds.migrate_schema("ev")
    assert old["z3"] == 1
    assert tst.index_versions == CURRENT_INDEX_VERSIONS == J_CURRENT
    assert "geomesa.index.versions" not in tds.get_schema("ev").user_data
    for ecql in QUERIES:
        want = jds.query_result("ev", ecql)
        got = tds.query_result("ev", ecql)
        np.testing.assert_array_equal(got.positions, want.positions)
        assert _explain(tds, ecql) == _explain(jds, ecql), ecql
    assert tst.z3_index().version == CURRENT_INDEX_VERSIONS["z3"]


def test_v1_and_current_layouts_answer_alike_with_other_keys():
    """The two layouts are different key spaces with equal hit sets."""
    v1 = TpuDataStore(device="cpu")
    v2 = TpuDataStore(device="cpu")
    v1.create_schema("ev", _spec(V1))
    v2.create_schema("ev", SPEC)
    v1.write("ev", _data(5))
    v2.write("ev", _data(5))
    for ecql in QUERIES:
        np.testing.assert_array_equal(v1.query_result("ev", ecql).positions,
                                      v2.query_result("ev", ecql).positions)
    for name in ("z3", "z2"):
        k1 = v1._store("ev").index(name).z[:N].numpy()
        k2 = v2._store("ev").index(name).z[:N].numpy()
        assert not np.array_equal(np.sort(k1), np.sort(k2))


def test_unknown_index_in_versions_raises_alike():
    bad = _spec("geomesa.index.versions='z9:1'")
    for ds in (JaxStore(), TpuDataStore(device="cpu")):
        with pytest.raises(ValueError, match="unknown index"):
            ds.create_schema("ev", bad)


# -- the schema lifecycle ---------------------------------------------------

def test_type_names_is_a_list_in_both_packages():
    out = []
    for ds in (JaxStore(), TpuDataStore(device="cpu")):
        for name in ("zeta", "alpha", "mid"):
            ds.create_schema(name, SPEC)
        out.append(ds.type_names)
        ds.remove_schema("mid")
        ds.remove_schema("never-existed")
        out.append(ds.type_names)
    assert out[0] == out[2] == ["alpha", "mid", "zeta"]
    assert out[1] == out[3] == ["alpha", "zeta"]
    assert isinstance(out[2], list)


def test_remove_schema_drops_rows_and_frees_the_name():
    jds, tds = _pair()
    for ds in (jds, tds):
        ds.remove_schema("ev")
        with pytest.raises(KeyError):
            ds.get_schema("ev")
        ds.create_schema("ev", SPEC)
        assert ds.get_count("ev") == 0
        assert len(ds.query_result("ev", QUERIES[0]).positions) == 0


def test_update_schema_rename_and_user_data():
    jds, tds = _pair()
    want = jds.query_result("ev", QUERIES[0]).positions
    for ds, parse in ((jds, j_parse_spec), (tds, parse_spec)):
        ds.update_schema("ev", parse("renamed", _spec("k=v")))
        assert ds.type_names == ["renamed"]
        assert ds.get_schema("renamed").user_data["k"] == "v"
        np.testing.assert_array_equal(
            ds.query_result("renamed", QUERIES[0]).positions, want)
        with pytest.raises(KeyError):
            ds.get_schema("ev")


@pytest.mark.parametrize("bad", [
    ("bad.name", SPEC, ValueError, "invalid schema name"),
    ("other", SPEC, ValueError, "already exists"),
    ("ev", "name:String,extra:Int,dtg:Date,*geom:Point", ValueError,
     "add/remove"),
    ("ev", "dtg:Date,*geom:Point", ValueError, "add/remove"),
    ("ev", _spec("geomesa.query.interceptors='no.such.module:Nope'"),
     Exception, None),
])
def test_update_schema_rejects_before_changing_state(bad):
    name, spec, exc, match = bad
    for ds, parse in ((JaxStore(), j_parse_spec),
                      (TpuDataStore(device="cpu"), parse_spec)):
        ds.create_schema("ev", SPEC)
        ds.create_schema("other", SPEC)
        ds.write("ev", _data(4, 500))
        with pytest.raises(exc, match=match):
            ds.update_schema("ev", parse(name, spec))
        if "interceptors" in spec:
            # the schema took the update before its interceptor failed to
            # load: its queries fail the same way
            with pytest.raises(exc):
                ds.query_result("ev", "INCLUDE")
        if name != "ev":
            # renames validate before any state changes
            assert ds.type_names == ["ev", "other"]
            assert ds.get_count("ev") == 500


def test_update_schema_reresolves_interceptors():
    guard = {
        "jax": "geomesa_tpu.planning.interceptor:GuardedQueryInterceptor",
        "torch":
            "geomesa_tpu_torch.planning.interceptor:GuardedQueryInterceptor",
    }
    out = {}
    for side, ds, parse in (("jax", JaxStore(), j_parse_spec),
                            ("torch", TpuDataStore(device="cpu"),
                             parse_spec)):
        ds.create_schema("ev", SPEC)
        ds.write("ev", _data(4, 500))
        n_before = len(ds.query_result("ev", "INCLUDE").positions)
        ds.update_schema("ev", parse(
            "ev", _spec(f"geomesa.query.interceptors='{guard[side]}'")))
        with pytest.raises(ValueError) as err:
            ds.query_result("ev", "INCLUDE")
        ds.update_schema("ev", parse("ev", SPEC))
        out[side] = (n_before, str(err.value),
                     len(ds.query_result("ev", "INCLUDE").positions))
    assert out["torch"] == out["jax"]


def test_update_schema_current_triggers_migration():
    jds, tds = _pair(V1)
    before = tds.query_result("ev", QUERIES[0]).positions
    for ds, parse in ((jds, j_parse_spec), (tds, parse_spec)):
        assert ds._store("ev").index_versions["z3"] == 1
        ds.update_schema("ev", parse(
            "ev", _spec("geomesa.index.versions=current")))
        assert ds._store("ev").index_versions["z3"] == 2
        np.testing.assert_array_equal(
            ds.query_result("ev", QUERIES[0]).positions, before)


def test_explain_text_equal():
    jds, tds = _pair()
    for ecql in QUERIES + ["INCLUDE", "IN ('3', '7')", "name = 'a'"]:
        assert _explain(tds, ecql) == _explain(jds, ecql), ecql


# -- row-level state across packages ----------------------------------------

@pytest.mark.parametrize("profile", ["default", "lean"])
def test_schema_store_state_carries_across(profile):
    """Labels, tombstones, layout versions and the id counter written
    through the JAX store answer alike in a port store that holds the
    same rows."""
    auths = {"user"}
    jds = JaxStore()
    tds = TpuDataStore(device="cpu")
    lean = LEAN if profile == "lean" else ""
    jds.create_schema("ev", _spec(V1, lean))
    tds.create_schema("ev", _spec(lean))
    for w, label in enumerate(("", "user", "admin")):
        rows = _data(10 + w, 3000)
        jds.write("ev", rows, visibility=label)
        tds.write("ev", rows)
    jds.delete("ev", [str(i) for i in range(0, 9000, 5)])
    if profile == "default":
        # the port store holds the same surviving rows
        tds.delete("ev", [str(i) for i in range(0, 9000, 5)])
    state = schema_store_state(jds._store("ev"))
    apply_schema_store_state(tds._store("ev"), state)
    assert schema_store_state(tds._store("ev")).keys() == state.keys()
    assert tds._store("ev").index_versions["z3"] == 1
    assert tds._store("ev").next_fid == jds._store("ev").next_fid
    from geomesa_tpu.security import StaticAuthorizationsProvider as JA
    jds._auth_provider = JA(auths)
    tds._auth_provider = StaticAuthorizationsProvider(auths)
    for ecql in QUERIES:
        np.testing.assert_array_equal(tds.query_result("ev", ecql).positions,
                                      jds.query_result("ev", ecql).positions)
    assert tds.get_count("ev") == jds.get_count("ev")
    assert tds.stat("ev", "count").count == jds.stat("ev", "count").count


def test_rename_keeps_the_seal_hook(monkeypatch):
    """A lean schema renamed between writes keeps building a pyramid
    behind every seal (the hook finds the schema under its new name)."""
    from geomesa_tpu_torch.index.pyramid import pyramid_spec

    monkeypatch.setenv("GEOMESA_DENSITY_PYRAMID_BUILD", "seal")
    monkeypatch.setenv("GEOMESA_DENSITY_PYRAMID_BASE", "64")
    slots = 512
    spec = _spec("geomesa.index.profile=lean",
                 f"geomesa.lean.generation.slots={slots}",
                 "geomesa.lean.compaction.factor=0")
    tds = TpuDataStore(device="cpu")
    tds.create_schema("ev", spec)
    tds.write("ev", _data(1, slots + 10))
    tds.update_schema("ev", parse_spec("renamed", spec))
    tds.write("renamed", _data(2, 2 * slots))
    st = tds._store("renamed")
    idx = st.index("z3")
    cache = idx._pyramid_cache.spec_cache(pyramid_spec(64))
    sealed = [g.gen_id for g in idx.generations[:-1]]
    assert len(sealed) == 3 and all(g in cache for g in sealed)
    assert st.pyramid_build_failures == 0
