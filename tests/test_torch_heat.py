"""Port parity: access-temperature tracking (``geomesa_tpu_torch/obs/heat.py``)
and ``TpuDataStore.heat_report`` against geomesa_tpu's ``obs/heat.py``.

The same seeded rows go into a lean store of each package (one device,
and a 2-shard mesh against the JAX package's 2-device mesh), the same
queries, density tiles and stat push-downs run on both under ONE
replaced clock (both heat modules' ``time``), and the two reports must
rank the same generations alike: order, touches, hits, bytes read, rows
matched, tiers, placement and temperatures (``rtol=1e-9``).  The same
holds after a compaction merge, and with heat disabled.  The tracker's
own arithmetic (decay, eviction, merge credit) is held against the JAX
tracker on identical touch streams.
"""

import types

import numpy as np
import pytest

from geomesa_tpu import config as jcfg
from geomesa_tpu import parallel as jpar
from geomesa_tpu.datastore import TpuDataStore as JStore
from geomesa_tpu.obs import heat as jheat
from geomesa_tpu_torch import config as tcfg
from geomesa_tpu_torch.datastore import TpuDataStore as TStore
from geomesa_tpu_torch.index import attr_lean as tattr
from geomesa_tpu_torch.metrics import registry as tregistry
from geomesa_tpu_torch.obs import heat as theat
from geomesa_tpu_torch.parallel import attr_lean as tpattr
from geomesa_tpu_torch.parallel import device_mesh

MS_2018 = 1_514_764_800_000
DAY = 86_400_000
SPEC = ("score:Double:index=true,dtg:Date,*geom:Point;"
        "geomesa.index.profile=lean,geomesa.lean.generation.slots=4096,"
        "geomesa.lean.compaction.factor=0")
QUERIES = (
    "BBOX(geom,-75,40,-74.5,40.5) AND dtg DURING "
    "2018-01-02T00:00:00Z/2018-01-09T00:00:00Z",
    "BBOX(geom,-74.6,40.2,-74.1,40.9)",
    "BBOX(geom,-80,30,-79,31) AND dtg DURING "
    "2018-01-02T00:00:00Z/2018-01-03T00:00:00Z",
    "score > 50",
    "score < 3 AND dtg DURING 2018-01-05T00:00:00Z/2018-01-20T00:00:00Z",
)
STATS = ("Z3Histogram(geom,dtg,week,8)", "Histogram(score,10,0,100)",
         "MinMax(score)")


class _Clock:
    """One clock for both heat modules (their ``time`` attribute)."""

    def __init__(self, t0: float = 10_000.0):
        self.now = t0
        self.module = types.SimpleNamespace(time=lambda: self.now)

    def tick(self, dt: float) -> None:
        self.now += dt


@pytest.fixture
def clock(monkeypatch):
    monkeypatch.setattr(tattr.LeanAttrIndex, "GENERATION_SLOTS", 1 << 16)
    monkeypatch.setattr(tpattr.ShardedLeanAttrIndex, "GENERATION_SLOTS",
                        1 << 13)
    c = _Clock()
    monkeypatch.setattr(jheat, "time", c.module)
    monkeypatch.setattr(theat, "time", c.module)
    jheat.heat_tracker.clear()
    theat.heat_tracker.clear()
    yield c
    jheat.heat_tracker.clear()
    theat.heat_tracker.clear()


def _rows(n: int, seed: int = 7) -> dict:
    rng = np.random.default_rng(seed)
    return {"score": rng.uniform(0.0, 100.0, n),
            "dtg": rng.integers(MS_2018, MS_2018 + 30 * DAY, n),
            "geom": (rng.uniform(-75, -74, n), rng.uniform(40, 41, n))}


def _pair(shards: int, spec: str = SPEC, n: int = 12_000):
    """A lean store of each package holding the same ``n`` seeded rows,
    written in 3000-row slices."""
    if shards:
        j = JStore(mesh=jpar.device_mesh(shards))
        t = TStore(device="cpu", mesh=device_mesh(devices=["cpu"] * shards))
    else:
        j, t = JStore(), TStore(device="cpu")
    rows = _rows(n)
    step = 3000
    for ds in (j, t):
        ds.create_schema("ht", spec)
        for lo in range(0, n, step):
            ds.write("ht", {k: (tuple(c[lo:lo + step] for c in v)
                                if isinstance(v, tuple) else v[lo:lo + step])
                            for k, v in rows.items()})
    return j, t


def _workload(j, t, clock, queries_only: bool = False):
    """Every query, tile and stat push-down on both stores, each step at
    its own clock reading."""
    for q in QUERIES:
        clock.tick(3.0)
        a, b = j.query_result("ht", q), t.query_result("ht", q)
        assert len(a.positions) == len(b.positions), q
    if queries_only:
        return
    for z, x, y, tile in ((0, 0, 0, 64), (1, 0, 0, 512), (1, 0, 1, 512)):
        clock.tick(2.0)
        np.testing.assert_allclose(j.density_tile("ht", z, x, y, tile=tile),
                                   t.density_tile("ht", z, x, y, tile=tile))
    for spec in STATS:
        clock.tick(1.5)
        j.stats("ht", "INCLUDE", spec)
        t.stats("ht", "INCLUDE", spec)


def _ranked(report: dict) -> list:
    return [(r["rank"], r["schema"], r["index"], r["gen_id"], r["scans"],
             r["hits"], r["bytes_read"], r["rows_matched"], r["tier"],
             r["last_access_ts"], r["first_access_ts"],
             r["placement"]["tier"], r["placement"]["rows"],
             r["placement"]["device_bytes"], r["placement"]["host_bytes"])
            for r in report["generations"]]


def _assert_reports_equal(jr: dict, tr: dict) -> None:
    assert _ranked(tr) == _ranked(jr)
    np.testing.assert_allclose(
        [r["temperature"] for r in tr["generations"]],
        [r["temperature"] for r in jr["generations"]], rtol=1e-9)
    assert sorted(tr["indexes"]) == sorted(jr["indexes"])
    for key, agg in jr["indexes"].items():
        got = tr["indexes"][key]
        for k in ("scans", "bytes_read", "rows_matched", "generations",
                  "touched"):
            assert got[k] == agg[k], (key, k)
        np.testing.assert_allclose(got["temperature"], agg["temperature"],
                                   rtol=1e-9)
    for k in ("tau_s", "enabled", "tracked_entries"):
        assert tr[k] == jr[k], k


@pytest.mark.parametrize("shards", [0, 2], ids=["lean", "mesh-lean"])
def test_heat_report_matches_reference(clock, shards):
    j, t = _pair(shards)
    _workload(j, t, clock)
    clock.tick(30.0)
    jr, tr = j.heat_report(), t.heat_report()
    assert tr["generations"], "no lean generation ranked"
    _assert_reports_equal(jr, tr)
    # every generation of both indexes ranks once, touched by the queries
    gens = [(r["index"], r["gen_id"]) for r in tr["generations"]]
    assert len(gens) == len(set(gens))
    assert {r["index"] for r in tr["generations"]} == {"z3", "attr:score"}
    assert all(r["scans"] for r in tr["generations"])
    # the heat gauges publish from the whole report
    assert tregistry.gauge("heat.ht.z3.scans").value == \
        tr["indexes"]["ht.z3"]["scans"]
    assert "heat.total.temperature" in tregistry.names()


#: budgets that demote sealed runs to a tier where the size-tiered planner
#: groups four of them: keys on one device (S·(40 + 16k + 56) bytes), the
#: host on a 2-shard mesh of 2048-slot generations (live full generation
#: plus the JAX sentinel charges)
_COMPACT_SPECS = {
    0: SPEC + f",geomesa.lean.hbm.budget={4096 * (40 + 16 * 8 + 56)}",
    2: SPEC.replace("slots=4096", "slots=2048")
    + f",geomesa.lean.hbm.budget={2048 * (44 + 20 + 44)}",
}


@pytest.mark.parametrize("shards", [0, 2], ids=["lean", "mesh-lean"])
def test_heat_survives_compaction_like_reference(clock, shards):
    j, t = _pair(shards, spec=_COMPACT_SPECS[shards], n=24_000)
    _workload(j, t, clock, queries_only=True)
    before = _ranked(t.heat_report())
    clock.tick(5.0)
    jc, tc = j.compact("ht"), t.compact("ht")
    assert tc["z3"]["merged_groups"] == jc["z3"]["merged_groups"] >= 1
    clock.tick(5.0)
    jr, tr = j.heat_report(), t.heat_report()
    _assert_reports_equal(jr, tr)
    assert len(tr["generations"]) < len(before)
    # the merged runs inherited their sources' scans
    assert sum(r["scans"] for r in tr["generations"]) == \
        sum(r[4] for r in before)


def test_heat_disabled_records_nothing_in_either_package(clock):
    j, t = _pair(0)
    jcfg.set_property("geomesa.obs.heat.enabled", False)
    tcfg.set_property("geomesa.obs.heat.enabled", False)
    try:
        _workload(j, t, clock)
        assert len(jheat.heat_tracker) == len(theat.heat_tracker) == 0
        jr, tr = j.heat_report(), t.heat_report()
        assert tr["enabled"] is jr["enabled"] is False
        _assert_reports_equal(jr, tr)
        assert all(r["temperature"] == 0.0 and r["scans"] == 0
                   for r in tr["generations"])
    finally:
        jcfg.clear_property("geomesa.obs.heat.enabled")
        tcfg.clear_property("geomesa.obs.heat.enabled")


def test_heat_report_limit_keeps_whole_aggregates(clock):
    _, t = _pair(0)
    t.query_result("ht", QUERIES[0])
    full = t.heat_report()
    top = t.heat_report(limit=2)
    assert len(top["generations"]) == 2
    assert top["generations"] == full["generations"][:2]
    assert top["indexes"] == full["indexes"]


# -- the tracker's arithmetic against the JAX tracker ------------------------
def _touch_stream(seed: int):
    rng = np.random.default_rng(seed)
    now = 0.0
    for _ in range(300):
        now += float(rng.uniform(0.0, 20.0))
        gen = int(rng.integers(0, 40))
        matched = (None if rng.random() < 0.2
                   else int(rng.integers(0, 3)) * int(rng.integers(1, 50)))
        tier = ("full", "keys", "host")[int(rng.integers(0, 3))]
        yield now, [(gen, tier, 1000, int(rng.integers(0, 10_000)),
                     matched)]


@pytest.mark.parametrize("max_entries", [16, 8192])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tracker_stream_matches_reference(seed, max_entries):
    jt = jheat.HeatTracker(tau_s=45.0, max_entries=max_entries)
    tt = theat.HeatTracker(tau_s=45.0, max_entries=max_entries)
    for now, touches in _touch_stream(seed):
        jt.record(("s", "z3"), touches, now=now)
        tt.record(("s", "z3"), touches, now=now)
    jt.merge_generations(("s", "z3"), [1, 2, 3], 99, now=7000.0)
    tt.merge_generations(("s", "z3"), [1, 2, 3], 99, now=7000.0)
    js, ts = jt.snapshot(now=7100.0), tt.snapshot(now=7100.0)
    assert sorted(ts) == sorted(js)
    for key, e in js.items():
        got = ts[key]
        for k, v in e.items():
            if isinstance(v, float):
                np.testing.assert_allclose(got[k], v, rtol=1e-9)
            else:
                assert got[k] == v, (key, k)
    assert len(tt) == len(jt) <= max_entries


def test_tracker_decay_formula():
    tr = theat.HeatTracker(tau_s=10.0)
    tr.record(("s", "z3"), [(1, "keys", 100, 1600, 7)], now=0.0)
    assert tr.snapshot(now=10.0)[("s", "z3", 1)]["temperature"] == \
        pytest.approx(np.exp(-1.0))
    tr.record(("s", "z3"), [(1, "keys", 100, 1600, 3)], now=10.0)
    assert tr.snapshot(now=10.0)[("s", "z3", 1)]["temperature"] == \
        pytest.approx(1.0 + np.exp(-1.0))
    # an empty probe counts a scan and adds no heat
    tr.record(("s", "z3"), [(2, "keys", 100, 1600, 0)], now=10.0)
    snap = tr.snapshot(now=10.0)[("s", "z3", 2)]
    assert snap["temperature"] == 0.0 and snap["scans"] == 1


def test_direct_index_records_under_class_scope(clock):
    from geomesa_tpu_torch.index.z3_lean import LeanZ3Index
    rng = np.random.default_rng(3)
    idx = LeanZ3Index(device="cpu", generation_slots=1024)
    idx.append(rng.uniform(-75, -74, 3000), rng.uniform(40, 41, 3000),
               rng.integers(MS_2018, MS_2018 + 9 * DAY, 3000))
    idx.query([-75, 40, -74, 41], MS_2018, MS_2018 + 9 * DAY)
    keys = [k for k in theat.heat_tracker.snapshot()
            if k[:2] == ("_", "LeanZ3Index")]
    assert sorted(k[2] for k in keys) == [g.gen_id for g in idx.generations]
