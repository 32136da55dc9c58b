"""Port parity: row and attribute visibilities under an auth provider,
through geomesa_tpu_torch's store against geomesa_tpu's, on the same
seeded rows — on the default profile, a mesh (2 CPU shards in the port,
the suite's 8-device virtual mesh in the JAX package) and the lean
profile.

Held equal, bit for bit: the label grammar's verdicts and masks over
random expressions, the positions and strategies of restricted queries,
``max_features`` filled from authorized rows only, filters that cannot
probe guarded attribute values, and the counts, bounds, sketches, stats
and heatmaps a restricted caller reads (none of which may leak a hidden
row)."""

import numpy as np
import pytest

from geomesa_tpu.datastore import TpuDataStore as JaxStore
from geomesa_tpu.parallel import device_mesh as jax_mesh
from geomesa_tpu.planning.planner import Query as JaxQuery
from geomesa_tpu.process.density import density_process as jax_density
from geomesa_tpu.security import (
    StaticAuthorizationsProvider as JaxAuths,
    parse_visibility as jax_parse,
    visibility_mask as jax_mask,
)
from geomesa_tpu_torch import TpuDataStore, device_mesh
from geomesa_tpu_torch.planning.planner import Query
from geomesa_tpu_torch.process.density import density_process
from geomesa_tpu_torch.security import (
    StaticAuthorizationsProvider, parse_visibility, visibility_mask,
)

MS = 1514764800000
DAY = 86_400_000
N = 3_000
LABELS = ["", "user", "admin", "user&admin"]
SPEC = ("actor:String:index=true,score:Double:index=true,dtg:Date,"
        "*geom:Point")
LEAN = (";geomesa.index.profile=lean,geomesa.lean.generation.slots=1024,"
        "geomesa.lean.hbm.budget=200000")
QUERIES = [
    "BBOX(geom, -5, -5, 5, 5) AND dtg DURING "
    "2018-01-05T00:00:00Z/2018-01-20T00:00:00Z",
    "BBOX(geom, -5, -5, 5, 5)",
    "BBOX(geom, -8, -8, -2, 0) OR BBOX(geom, 2, 0, 8, 8)",
    "actor = 'b' AND dtg DURING 2018-01-01T00:00:00Z/2018-01-15T00:00:00Z",
    "score BETWEEN 2 AND 4",
    "IN ('1', '3', '3002', '6001', '9999')",
    "INCLUDE",
]


def _rows(seed: int):
    rng = np.random.default_rng(seed)
    return [{"actor": rng.choice(np.array(["a", "b", "c"], dtype=object), N),
             "score": rng.uniform(0.0, 10.0, N),
             "dtg": rng.integers(MS, MS + 30 * DAY, N),
             "geom": (rng.uniform(-10, 10, N), rng.uniform(-10, 10, N))}
            for _ in range(len(LABELS))]


def _pair(profile: str, auths, attr_vis: bool = False, seed: int = 0):
    """The JAX store and the port's on ``profile``, each holding four
    writes labelled ``LABELS`` (and ``actor`` guarded by ``admin`` when
    ``attr_vis``), read through ``auths`` (None: no auth provider)."""
    out = []
    for side in ("jax", "torch"):
        kw = {}
        if auths is not None:
            kw["auth_provider"] = (JaxAuths if side == "jax"
                                   else StaticAuthorizationsProvider)(auths)
        if profile == "mesh":
            kw["mesh"] = (jax_mesh() if side == "jax"
                          else device_mesh(devices=["cpu"] * 2))
        ds = (JaxStore(**kw) if side == "jax"
              else TpuDataStore(device="cpu", **kw))
        ds.create_schema("s", SPEC + (LEAN if profile == "lean" else ""))
        for rows, label in zip(_rows(seed), LABELS):
            ds.write("s", rows, visibility=label,
                     attribute_visibilities=(
                         {"actor": "admin"} if attr_vis else None))
        out.append(ds)
    return out


def _visible_rows(auths) -> np.ndarray:
    allowed = [parse_visibility(lab).evaluate(auths) for lab in LABELS]
    return np.repeat(np.asarray(allowed), N)


# -- the label grammar ------------------------------------------------------

@pytest.mark.parametrize("text", [
    "", "a", "a&b", "a|b", "(a&b)|c", "a&(b|c)", "((a))", '"x y"&a',
    "a&b|c", "a|b&c", "(a", "a)", "a&", "&a", "a b", "a&&b", "()",
    '"unterminated', "a.b:c/d-e_f", "(a|b)&(c|d)"])
def test_parse_matches_reference(text):
    """Every expression parses (and evaluates) or raises alike."""
    try:
        want = jax_parse(text)
    except ValueError:
        with pytest.raises(ValueError):
            parse_visibility(text)
        return
    got = parse_visibility(text)
    assert got.raw == want.raw
    for auths in ({}, {"a"}, {"b", "c"}, {"a", "b"}, {"a", "c", "d"},
                  {"x y"}, {"x y", "a"}, {"a.b:c/d-e_f"}):
        assert got.evaluate(auths) == want.evaluate(auths)


def _random_label(rng, depth: int = 0) -> str:
    tokens = ["u", "v", "w", "admin"]
    if depth > 2 or rng.random() < 0.4:
        return str(rng.choice(tokens))
    op = "&" if rng.random() < 0.5 else "|"
    parts = [_random_label(rng, depth + 1)
             for _ in range(int(rng.integers(2, 4)))]
    return "(" + op.join(parts) + ")"


def test_masks_over_random_labels_match_reference():
    rng = np.random.default_rng(11)
    labels = np.array([_random_label(rng) for _ in range(300)] + [""] * 20,
                      dtype=object)
    labels = labels[rng.permutation(len(labels))]
    for auths in (set(), {"u"}, {"u", "v"}, {"admin"}, {"u", "v", "w"},
                  {"u", "v", "w", "admin"}):
        np.testing.assert_array_equal(visibility_mask(labels, auths),
                                      jax_mask(labels, auths))


# -- restricted queries -----------------------------------------------------

@pytest.mark.parametrize("auths", [{"user"}, {"admin"}, set(),
                                   {"user", "admin"}])
@pytest.mark.parametrize("profile", ["default", "mesh", "lean"])
def test_restricted_queries_match_reference(profile, auths):
    jds, tds = _pair(profile, auths)
    visible = _visible_rows(auths)
    for ecql in QUERIES:
        want = jds.query_result("s", ecql)
        got = tds.query_result("s", ecql)
        assert got.strategy.index == want.strategy.index, ecql
        np.testing.assert_array_equal(got.positions, want.positions)
        assert visible[got.positions].all()
    np.testing.assert_array_equal(
        tds.query_result("s", "INCLUDE").positions, np.flatnonzero(visible))


@pytest.mark.parametrize("profile", ["default", "mesh", "lean"])
def test_max_features_fills_from_authorized_rows(profile):
    jds, tds = _pair(profile, {"admin"})
    for ecql in QUERIES[:2]:
        want = jds.query_result("s", JaxQuery.of(ecql, max_features=25))
        got = tds.query_result("s", Query.of(ecql, max_features=25))
        assert len(got.positions) == 25
        np.testing.assert_array_equal(got.positions, want.positions)
        assert _visible_rows({"admin"})[got.positions].all()


@pytest.mark.parametrize("profile", ["default", "mesh"])
def test_filters_cannot_probe_guarded_attributes(profile):
    """``actor`` is guarded by ``admin``: a ``user`` sees the rows with
    ``actor`` nulled, and a filter on it matches nothing."""
    for auths, hits in (({"user"}, False), ({"user", "admin"}, True)):
        jds, tds = _pair(profile, auths, attr_vis=True)
        for ecql in ("actor = 'b'", "actor = 'b' AND BBOX(geom, -5, -5, 5, 5)",
                     "NOT (actor = 'b')", "BBOX(geom, -5, -5, 5, 5)"):
            want = jds.query_result("s", ecql)
            got = tds.query_result("s", ecql)
            np.testing.assert_array_equal(got.positions, want.positions)
            np.testing.assert_array_equal(
                got.batch.column("actor").astype(str),
                want.batch.column("actor").astype(str))
            if ecql == "actor = 'b'":
                assert bool(len(got.positions)) == hits


def test_sort_by_guarded_column():
    jds, tds = _pair("default", {"user"}, attr_vis=True)
    want = jds.query_result("s", JaxQuery.of("BBOX(geom, -5, -5, 5, 5)",
                                             sort_by="actor"))
    got = tds.query_result("s", Query.of("BBOX(geom, -5, -5, 5, 5)",
                                         sort_by="actor"))
    np.testing.assert_array_equal(got.positions, want.positions)


# -- stats, bounds and heatmaps ---------------------------------------------

@pytest.mark.parametrize("profile", ["default", "mesh", "lean"])
def test_stats_do_not_leak(profile):
    auths = {"user"}
    jds, tds = _pair(profile, auths)
    visible = _visible_rows(auths)
    assert tds.get_count("s") == jds.get_count("s") == int(visible.sum())
    assert tds.get_bounds("s").as_tuple() == jds.get_bounds("s").as_tuple()
    assert tds.get_attribute_bounds("s", "score") == \
        jds.get_attribute_bounds("s", "score")
    assert tds.get_count("s", "BBOX(geom, -5, -5, 5, 5)") == \
        jds.get_count("s", "BBOX(geom, -5, -5, 5, 5)")
    for key in ("count", "dtg_minmax", "score_minmax", "actor_topk",
                "actor_enumeration", "geom_bbox"):
        want, got = jds.stat("s", key), tds.stat("s", key)
        assert (got is None) == (want is None), key
        if got is not None:
            assert got.to_json() == want.to_json(), key
    score = np.concatenate([r["score"] for r in _rows(0)])[visible]
    assert tds.stat("s", "score_minmax").bounds == (score.min(),
                                                    score.max())
    for ecql in (QUERIES[0], "INCLUDE"):
        spec = "Count();MinMax(score);Histogram(score,16,0,10)"
        assert tds.stats("s", ecql, spec).to_json() == \
            jds.stats("s", ecql, spec).to_json()
    assert tds.stats("s", "INCLUDE", "Count()").count == int(visible.sum())
    env = (-10.0, -10.0, 10.0, 10.0)
    for ecql in (QUERIES[0], "INCLUDE"):
        np.testing.assert_array_equal(
            density_process(tds, "s", ecql, env, 32, 16),
            np.asarray(jax_density(jds, "s", ecql, env, 32, 16)))
    np.testing.assert_array_equal(tds.density_tile("s", 1, 1, 0, tile=16),
                                  jds.density_tile("s", 1, 1, 0, tile=16))


def test_guarded_attribute_stats_are_withheld():
    jds, tds = _pair("default", {"user"}, attr_vis=True)
    assert tds.get_attribute_bounds("s", "actor") is None
    assert jds.get_attribute_bounds("s", "actor") is None
    assert tds.stat("s", "actor_topk") is None
    assert jds.stat("s", "actor_topk") is None
    assert tds.stat("s", "score_minmax").to_json() == \
        jds.stat("s", "score_minmax").to_json()


# -- write-time validation --------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"visibility": "a&b|c"},
    {"visibility": "(a"},
    {"attribute_visibilities": {"geom": "admin"}},
    {"attribute_visibilities": {"dtg": "admin"}},
    {"attribute_visibilities": {"nope": "admin"}},
    {"attribute_visibilities": {"actor": "a&b|c"}},
])
def test_bad_labels_raise_alike(kw):
    rows = _rows(1)[0]
    kinds = []
    for ds in (JaxStore(), TpuDataStore(device="cpu")):
        ds.create_schema("s", SPEC)
        with pytest.raises((ValueError, KeyError)) as err:
            ds.write("s", rows, **kw)
        assert ds.get_count("s") == 0
        kinds.append(err.type)
    assert kinds[0] is kinds[1]


def test_lean_rejects_attribute_visibilities_alike():
    rows = _rows(1)[0]
    for ds in (JaxStore(), TpuDataStore(device="cpu")):
        ds.create_schema("s", SPEC + LEAN)
        with pytest.raises(ValueError, match="attribute-level visibility"):
            ds.write("s", rows, attribute_visibilities={"actor": "admin"})
