"""Port parity: the store facade of geomesa_tpu_torch against geomesa_tpu's
``TpuDataStore`` — the whole main path (create_schema → write → ECQL
query → QueryResult.positions and the chosen strategy) on the same
schemas, rows and filters: ``gdelt`` (point + dtg: z3 and z2) and
``places`` (point without a dtg: z2)."""

import numpy as np
import pytest
import torch

from geomesa_tpu.datastore import TpuDataStore as JaxStore
from geomesa_tpu_torch import TpuDataStore

MS_2018 = 1514764800000
DAY = 86_400_000
SPEC = "actor:String,dtg:Date,*geom:Point"
PLACES = "name:String,*geom:Point"


def _batch(seed, n):
    rng = np.random.default_rng(seed)
    return {
        "actor": rng.choice(["a", "b", "c", "d"], n).astype(object),
        "dtg": rng.integers(MS_2018, MS_2018 + 60 * DAY, n),
        "geom": (rng.uniform(-20.0, 20.0, n), rng.uniform(-10.0, 10.0, n)),
    }


ECQL = [
    "BBOX(geom, -5, -5, 5, 5) AND dtg DURING "
    "2018-01-10T00:00:00Z/2018-01-20T00:00:00Z",
    "BBOX(geom, -15, -8, 0, 2)",
    "dtg DURING 2018-02-01T00:00:00Z/2018-02-03T12:00:00Z",
    "BBOX(geom, -10, -10, 10, 10) AND (dtg DURING "
    "2018-01-02T00:00:00Z/2018-01-04T00:00:00Z OR dtg DURING "
    "2018-02-10T00:00:00Z/2018-02-12T00:00:00Z)",
    "BBOX(geom, -5, -5, 5, 5) AND dtg DURING "
    "2018-01-10T00:00:00Z/2018-01-20T00:00:00Z AND actor = 'b'",
    "INCLUDE",
    "EXCLUDE",
    "(BBOX(geom, -5, -5, 0, 0) AND dtg DURING "
    "2018-01-05T00:00:00Z/2018-01-06T00:00:00Z) OR (BBOX(geom, 1, 1, 6, 6) "
    "AND dtg DURING 2018-02-05T00:00:00Z/2018-02-06T00:00:00Z)",
    "BBOX(geom, -5, -5, 0, 0) OR dtg DURING "
    "2018-02-05T00:00:00Z/2018-02-06T00:00:00Z",
]


PLACES_ECQL = [
    "BBOX(geom, -15, -8, 0, 2)",
    "BBOX(geom, -15, -8, 0, 2) OR BBOX(geom, 3, 3, 8, 8)",
    "BBOX(geom, -5, -5, 5, 5) AND name = 'b'",
    "INCLUDE",
]


def _places(seed, n):
    b = _batch(seed, n)
    return {"name": b["actor"], "geom": b["geom"]}


@pytest.fixture(scope="module")
def stores():
    tds, jds = TpuDataStore(device="cpu"), JaxStore()
    for ds in (tds, jds):
        ds.create_schema("gdelt", SPEC)
        ds.create_schema("places", PLACES)
    # write, query (builds the z3 and z2 indexes), then write again: later
    # writes take the incremental append path in both stores
    first = _batch(1, 3000)
    for ds in (tds, jds):
        ds.write("gdelt", first)
        ds.write("places", _places(11, 3000))
        ds.query_result("gdelt", ECQL[0])
        ds.query_result("gdelt", ECQL[1])
        ds.query_result("places", PLACES_ECQL[0])
    for seed in (2, 3):
        b = _batch(seed, 1500)
        for ds in (tds, jds):
            ds.write("gdelt", b)
            ds.write("places", _places(seed + 10, 1500))
    return tds, jds


@pytest.mark.parametrize("ecql", ECQL)
def test_positions_match_jax(stores, ecql):
    tds, jds = stores
    got = tds.query_result("gdelt", ecql)
    want = jds.query_result("gdelt", ecql)
    np.testing.assert_array_equal(got.positions, want.positions)
    np.testing.assert_array_equal(got.batch.ids, want.batch.ids)
    assert len(got.batch) == len(got.positions)


def test_bbox_during_runs_on_z3_in_both(stores):
    tds, jds = stores
    for ecql in (ECQL[0], ECQL[3]):
        assert tds.query_result("gdelt", ecql).strategy.index == "z3"
        assert jds.query_result("gdelt", ecql).strategy.index == "z3"
    # the z3 and z2 indexes were built once each and then appended to
    assert tds._store("gdelt").build_counts == {"z3": 1, "z2": 1}
    assert len(tds._store("gdelt").z3_index()) == 6000
    assert len(tds._store("gdelt").z2_index()) == 6000
    assert tds._store("places").build_counts == {"z2": 1}
    assert len(tds._store("places").z2_index()) == 6000


@pytest.mark.parametrize("schema,ecql,index", [
    *(("gdelt", e, i) for e, i in zip(
        ECQL, ["z3", "z2", "z3", "z3", "z3", "full", "none", "z3",
               "or-split"])),
    *(("places", e, i) for e, i in zip(
        PLACES_ECQL, ["z2", "z2", "z2", "full"])),
])
def test_port_strategy_choice(stores, schema, ecql, index):
    """The port chooses the JAX package's strategy: BBOX alone runs on z2
    in both, on a schema with or without a dtg."""
    tds, jds = stores
    got = tds.query_result(schema, ecql).strategy
    want = jds.query_result(schema, ecql).strategy
    assert got.index == want.index == index
    if index == "or-split":
        assert [b.index for _, b in got.branches] == \
            [b.index for _, b in want.branches] == ["z2", "z3"]


@pytest.mark.parametrize("ecql", PLACES_ECQL)
def test_places_positions_match_jax(stores, ecql):
    tds, jds = stores
    got = tds.query_result("places", ecql)
    want = jds.query_result("places", ecql)
    np.testing.assert_array_equal(got.positions, want.positions)
    np.testing.assert_array_equal(got.batch.ids, want.batch.ids)


def test_z3_only_schema_serves_bbox_on_an_open_interval():
    """With geomesa.indices.enabled=z3 there is no z2: a BBOX alone runs
    on z3 over the clamped time extent, in both packages."""
    spec = SPEC + ";geomesa.indices.enabled=z3"
    tds, jds = TpuDataStore(device="cpu"), JaxStore()
    for ds in (tds, jds):
        ds.create_schema("z3only", spec)
        ds.write("z3only", _batch(21, 2000))
    for ecql in (ECQL[1], ECQL[8]):
        got, want = (ds.query_result("z3only", ecql) for ds in (tds, jds))
        assert got.strategy.index == want.strategy.index
        np.testing.assert_array_equal(got.positions, want.positions)
    assert tds.query_result("z3only", ECQL[1]).strategy.intervals == \
        ((None, None),)
    assert "z2" not in tds._store("z3only").build_counts


def test_multiple_writes_before_first_query():
    tds, jds = TpuDataStore(device="cpu"), JaxStore()
    for ds in (tds, jds):
        ds.create_schema("s", SPEC)
        for seed in (7, 8):
            ds.write("s", _batch(seed, 800))
    for ecql in (ECQL[0], ECQL[3], ECQL[5]):
        np.testing.assert_array_equal(
            tds.query_result("s", ecql).positions,
            jds.query_result("s", ecql).positions)


def test_sort_limit_projection_match_jax(stores):
    from geomesa_tpu.planning.planner import Query as JQuery
    from geomesa_tpu_torch import Query
    tds, jds = stores
    kw = dict(sort_by="dtg", sort_desc=True, max_features=25,
              properties=["actor", "dtg"])
    got = tds.query_result("gdelt", Query.of(ECQL[1], **kw))
    want = jds.query_result("gdelt", JQuery.of(ECQL[1], **kw))
    np.testing.assert_array_equal(got.positions, want.positions)
    np.testing.assert_array_equal(got.batch.column("dtg"),
                                  want.batch.column("dtg"))
    assert got.batch.sft.attribute_names == want.batch.sft.attribute_names


def test_unserved_options_raise(stores):
    from geomesa_tpu_torch import Query
    tds, _ = stores
    with pytest.raises(NotImplementedError):
        tds.query_result("gdelt", Query.of("INCLUDE", hints={"SAMPLING": 2}))
    with pytest.raises(NotImplementedError):
        tds.query_result("gdelt", Query.of("INCLUDE", crs="EPSG:3857"))
    with pytest.raises(NotImplementedError):
        tds.write("gdelt", _batch(4, 3), visibility="admin")
    with pytest.raises(NotImplementedError):
        TpuDataStore(device="cpu", mesh=object())
    with pytest.raises(NotImplementedError):
        TpuDataStore(device="cpu", auth_provider=object())


def test_lean_sized_first_write_raises(monkeypatch):
    tds = TpuDataStore(device="cpu")
    tds.create_schema("big", SPEC)
    monkeypatch.setattr(TpuDataStore, "LEAN_AUTO_ROWS", 100)
    with pytest.raises(NotImplementedError, match="lean"):
        tds.write("big", _batch(5, 100))


def test_lean_sized_first_write_without_dtg_stays_default(monkeypatch):
    """The JAX store flips only point schemas WITH a dtg to the lean
    profile; one without a dtg stays on the default profile at any size,
    so the port takes the z2 path and never raises."""
    tds, jds = TpuDataStore(device="cpu"), JaxStore()
    monkeypatch.setattr(TpuDataStore, "LEAN_AUTO_ROWS", 100)
    monkeypatch.setattr(JaxStore, "LEAN_AUTO_ROWS", 100)
    rows = _places(6, 500)
    for ds in (tds, jds):
        ds.create_schema("big", PLACES)
        ds.write("big", rows)
    assert not jds._store("big").lean
    got, want = (ds.query_result("big", PLACES_ECQL[0]) for ds in (tds, jds))
    assert got.strategy.index == want.strategy.index == "z2"
    np.testing.assert_array_equal(got.positions, want.positions)


def test_store_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TpuDataStore()
    with pytest.raises(RuntimeError):
        TpuDataStore(device="cuda")
