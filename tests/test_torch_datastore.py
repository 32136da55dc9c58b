"""Port parity: the store facade of geomesa_tpu_torch against geomesa_tpu's
``TpuDataStore`` — the whole main path (create_schema → write → ECQL
query → QueryResult.positions) on the same schema, rows and filters."""

import numpy as np
import pytest
import torch

from geomesa_tpu.datastore import TpuDataStore as JaxStore
from geomesa_tpu_torch import TpuDataStore

MS_2018 = 1514764800000
DAY = 86_400_000
SPEC = "actor:String,dtg:Date,*geom:Point"


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


@pytest.fixture(scope="module")
def stores():
    tds, jds = TpuDataStore(device="cpu"), JaxStore()
    for ds in (tds, jds):
        ds.create_schema("gdelt", SPEC)
    # write, query (builds the z3 index), then write again: later writes
    # take the incremental append path in both stores
    first = _batch(1, 3000)
    for ds in (tds, jds):
        ds.write("gdelt", first)
        ds.query_result("gdelt", ECQL[0])
    for seed in (2, 3):
        b = _batch(seed, 1500)
        for ds in (tds, jds):
            ds.write("gdelt", b)
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
    # the z3 index was built once and then appended to
    assert tds._store("gdelt").build_counts == {"z3": 1}
    assert len(tds._store("gdelt").z3_index()) == 6000


@pytest.mark.parametrize("ecql,index", [
    (ECQL[1], "z3"),        # pure spatial: z3 over the clamped time extent
    (ECQL[2], "z3"),        # pure temporal: z3 over the whole world
    (ECQL[5], "full"),
    (ECQL[6], "none"),
    (ECQL[7], "z3"),        # the OR's boxes and windows in one scan
    (ECQL[8], "or-split"),
])
def test_port_strategy_choice(stores, ecql, index):
    tds, _ = stores
    assert tds.query_result("gdelt", ecql).strategy.index == index


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


def test_store_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TpuDataStore()
    with pytest.raises(RuntimeError):
        TpuDataStore(device="cuda")
