"""Port parity: degraded execution, the circuit breaker and the fault
catalog of geomesa_tpu_torch against geomesa_tpu's, on the same seeded
rows.

Held equal: the classifier's verdicts (and, in the port only, a
``torch.OutOfMemoryError`` classified by its type), the breaker's open,
half-open and reset states (on a replaced clock: no sleeps), the spec
parser's errors, the fault registry's firing sequence for the same spec,
seed and hit order, a degraded lean z3 query and a degraded lean
attribute query (positions against the undegraded port answer and the
JAX package's degraded answer, and the ``resilience.*`` counters), the
breaker's host routing, poison propagating, and one chaos arm for every
cataloged point but ``arrow.flush`` (its site waits for the Arrow path).
"""

import numpy as np
import pytest
import torch

from geomesa_tpu import config as jcfg
from geomesa_tpu import metrics as jmetrics
from geomesa_tpu import resilience as jres
from geomesa_tpu.datastore import TpuDataStore as JStore
from geomesa_tpu.index import lsm as jlsm
from geomesa_tpu.resilience import faults as jfaults
from geomesa_tpu_torch import config as tcfg
from geomesa_tpu_torch import metrics as tmetrics
from geomesa_tpu_torch import resilience as tres
from geomesa_tpu_torch.datastore import TpuDataStore as TStore
from geomesa_tpu_torch.index import attr_lean as tattr
from geomesa_tpu_torch.index import lsm as tlsm
from geomesa_tpu_torch.obs import tracer
from geomesa_tpu_torch.resilience import degrade as tdegrade
from geomesa_tpu_torch.resilience import faults as tfaults

MS_2018 = 1_514_764_800_000
DAY = 86_400_000
BBOX = "BBOX(geom,-76,39,-73,42)"
SPEC = ("score:Double:index=true,dtg:Date,*geom:Point;"
        "geomesa.index.profile=lean,geomesa.lean.generation.slots=256,"
        "geomesa.lean.compaction.factor=0")
KNOBS = ("geomesa.resilience.fault.points", "geomesa.resilience.fault.seed",
         "geomesa.resilience.retry.max",
         "geomesa.resilience.breaker.threshold",
         "geomesa.resilience.breaker.cooldown.s")


def _set(name, value):
    jcfg.set_property(name, value)
    tcfg.set_property(name, value)


def _clear():
    for n in KNOBS:
        jcfg.clear_property(n)
        tcfg.clear_property(n)


@pytest.fixture(autouse=True)
def _disarmed(monkeypatch):
    """Every test starts and ends with both packages disarmed."""
    # the JAX attribute floor under this suite's conftest (2^16 slots)
    monkeypatch.setattr(tattr.LeanAttrIndex, "GENERATION_SLOTS", 1 << 16)
    _clear()
    jres.breaker.reset()
    tres.breaker.reset()
    yield
    _clear()
    jres.breaker.reset()
    tres.breaker.reset()


def _rows(n, seed=11):
    rng = np.random.default_rng(seed)
    return {"score": rng.uniform(0.0, 100.0, n),
            "dtg": rng.integers(MS_2018, MS_2018 + 13 * DAY, n),
            "geom": (rng.uniform(-75, -74, n), rng.uniform(40, 41, n))}


#: a lean budget whose z3 share (three quarters beside one attribute
#: index) leaves 256-slot generations one full, four keys, the rest host
TIERED = ",geomesa.lean.hbm.budget=54614"


def _pair(name, n=3000, extra=""):
    rows = _rows(n)
    j, t = JStore(), TStore(device="cpu")
    for ds in (j, t):
        ds.create_schema(name, SPEC + extra)
        ds.write(name, rows)
    return j, t


def _counts(names):
    return ({k: jmetrics.registry.counter(k).count for k in names},
            {k: tmetrics.registry.counter(k).count for k in names})


def _delta(before, after):
    return {k: after[k] - before[k] for k in before}


def _positions(ds, name, q):
    return sorted(ds.query_result(name, q).positions.tolist())


# -- classification -------------------------------------------------------

@pytest.mark.parametrize("exc, want", [
    (RuntimeError("RESOURCE_EXHAUSTED: out of memory while trying to "
                  "allocate"), "transient"),
    (RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
     "transient"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "poison"),
    (RuntimeError("z3_mask kernel launch failed: CUDA error 700"),
     "poison"),
    (ValueError("whatever"), "poison"),
])
def test_classifier_matches_reference(exc, want):
    assert tres.classify_device_failure(exc) == want
    assert jres.classify_device_failure(exc) == want


def test_classifier_takes_the_allocator_error_by_type():
    # an out-of-memory error whose message carries no marker at all
    oom = torch.OutOfMemoryError("allocator refused")
    assert tres.classify_device_failure(oom) == "transient"
    for kind, want in (("oom", "transient"), ("error", "poison")):
        assert tres.classify_device_failure(
            tfaults.FaultInjected("device.dispatch", kind)) == want
        assert jres.classify_device_failure(
            jfaults.FaultInjected("device.dispatch", kind)) == want


def test_breaker_open_half_open_and_reset(monkeypatch):
    now = [1000.0]
    monkeypatch.setattr(tdegrade, "_clock", lambda: now[0])
    _set("geomesa.resilience.breaker.threshold", 2)
    _set("geomesa.resilience.breaker.cooldown.s", 30.0)
    cb = tres.CircuitBreaker()
    key = ("unit", 1)
    opened = tmetrics.registry.counter("resilience.breaker.open")
    assert cb.allows(key)
    cb.record_failure(key)
    assert cb.allows(key)            # one failure: still closed
    cb.record_failure(key)
    before = opened.count
    assert not cb.allows(key)        # open for the cooldown
    assert opened.count == before + 1
    now[0] += 29.0
    assert not cb.allows(key)
    now[0] += 2.0
    assert cb.allows(key)            # half-open: one trial
    cb.record_failure(key)           # the trial failed: open again
    assert not cb.allows(key)
    now[0] += 31.0
    assert cb.allows(key)
    cb.record_success(key)           # the trial passed: reset
    assert cb.allows(key) and cb.allows(key)


# -- the fault registry ---------------------------------------------------

@pytest.mark.parametrize("spec", ["no.such.point", "device.dispatch=boom",
                                  "host.spill:2=melt"])
def test_spec_errors_match_reference(spec):
    _set("geomesa.resilience.fault.points", spec)
    with pytest.raises(ValueError) as jerr:
        jfaults.FaultRegistry().maybe_fail("host.spill")
    with pytest.raises(ValueError) as terr:
        tfaults.FaultRegistry().maybe_fail("host.spill")
    assert str(terr.value) == str(jerr.value)


def _fire_pattern(mod, points, hits):
    reg = mod.FaultRegistry()
    out = []
    for i in range(hits):
        p = points[i % len(points)]
        try:
            reg.maybe_fail(p)
            out.append((p, None))
        except mod.FaultInjected as e:
            out.append((p, e.kind))
    return out


@pytest.mark.parametrize("spec, seed", [
    ("host.spill:0.3=error,device.dispatch:0.5=oom", 7),
    ("device.dispatch:3=oom", 0),
    ("ingest.append,compaction.merge_step:2", 0),
    ("pyramid.build:0.25", 1234),
])
def test_registry_fires_on_the_same_hits(spec, seed):
    _set("geomesa.resilience.fault.points", spec)
    _set("geomesa.resilience.fault.seed", seed)
    points = ["host.spill", "device.dispatch", "ingest.append",
              "compaction.merge_step", "pyramid.build"]
    j = _fire_pattern(jfaults, points, 60)
    t = _fire_pattern(tfaults, points, 60)
    assert t == j
    assert any(k is not None for _, k in t)


# -- degraded execution ---------------------------------------------------

DEGRADE_COUNTERS = ("resilience.degraded", "resilience.retries",
                    "resilience.faults.injected", "resilience.breaker.open")


@pytest.mark.parametrize("query", [BBOX + " AND dtg DURING "
                                   "2018-01-02T00:00:00Z/2018-01-09T00:00:00Z",
                                   "score > 80"],
                         ids=["z3", "attr"])
def test_degraded_lean_query_is_exact(query):
    name = "rz_deg"
    j, t = _pair(name)
    baseline = _positions(t, name, query)
    assert baseline == _positions(j, name, query)
    before = _counts(DEGRADE_COUNTERS)
    _set("geomesa.resilience.fault.points", "device.dispatch:1=oom")
    with tracer.capture() as cap:
        degraded_t = _positions(t, name, query)
    degraded_j = _positions(j, name, query)
    after = _counts(DEGRADE_COUNTERS)
    assert degraded_t == baseline == degraded_j
    dj, dt = _delta(before[0], after[0]), _delta(before[1], after[1])
    assert dt == dj
    assert dt["resilience.degraded"] >= 1 and dt["resilience.retries"] == 1
    spans = [s for tr in cap.traces() for s in tr.spans
             if s.name == "query.scan.degraded"]
    assert len(spans) == 1
    # flagged True, then (as in the JAX package) the degraded-generation
    # count mirrored onto the same attribute by obs_count
    assert spans[0].attributes["resilience.degraded"] \
        == 1 + dt["resilience.degraded"]
    # the demoted generations are host-tier in both, and the store keeps
    # answering exactly once disarmed
    _clear()
    key = "z3" if query.startswith("BBOX") else "attr:score"
    tiers = [g.tier for g in t._store(name)._indexes[key].generations]
    jtiers = [g.tier for g in j._store(name)._indexes[key].generations]
    assert tiers == jtiers and "host" in tiers
    assert _positions(t, name, query) == baseline


@pytest.mark.parametrize("query", [BBOX, "score > 80"], ids=["z3", "attr"])
def test_poison_propagates_in_both(query):
    name = "rz_poison"
    j, t = _pair(name, n=800)
    _set("geomesa.resilience.fault.points", "device.dispatch:1=error")
    with pytest.raises(jfaults.FaultInjected):
        j.query_result(name, query)
    with pytest.raises(tfaults.FaultInjected):
        t.query_result(name, query)
    _clear()
    assert _positions(t, name, query) == _positions(j, name, query)


def test_zero_retry_budget_propagates_transients():
    name = "rz_budget"
    j, t = _pair(name, n=800)
    _set("geomesa.resilience.retry.max", 0)
    _set("geomesa.resilience.fault.points", "device.dispatch:1=oom")
    with pytest.raises(jfaults.FaultInjected):
        j.query_result(name, BBOX)
    with pytest.raises(tfaults.FaultInjected):
        t.query_result(name, BBOX)


def test_open_breaker_routes_generations_to_the_host_tier():
    name = "rz_breaker"
    j, t = _pair(name, n=1500)
    baseline = _positions(t, name, BBOX)
    _set("geomesa.resilience.breaker.threshold", 1)
    for ds, res in ((j, jres), (t, tres)):
        idx = ds._store(name)._indexes["z3"]
        gen = next(g for g in idx.generations if g.tier == "full")
        res.breaker.record_failure((id(idx), gen.gen_id))
    before = _counts(DEGRADE_COUNTERS)
    assert _positions(t, name, BBOX) == baseline == _positions(j, name, BBOX)
    after = _counts(DEGRADE_COUNTERS)
    dj, dt = _delta(before[0], after[0]), _delta(before[1], after[1])
    assert dt == dj
    assert dt["resilience.breaker.open"] >= 1
    assert dt["resilience.degraded"] == 1 and dt["resilience.retries"] == 0
    tiers = [g.tier for g in t._store(name)._indexes["z3"].generations]
    assert tiers == [g.tier for g in j._store(name)._indexes["z3"].generations]
    assert tiers.count("host") == 1


# -- the chaos grid: one arm per cataloged point --------------------------

def _chaos_ingest_append(ds, name, fault_type):
    extra = {"score": np.full(50, 1.0),
             "dtg": np.full(50, MS_2018, dtype=np.int64),
             "geom": (np.full(50, -74.5), np.full(50, 40.5))}
    with pytest.raises(fault_type):
        ds.write(name, extra)
    n_failed = len(ds.query_result(name, BBOX).positions)
    _clear()
    ds.write(name, extra)
    return n_failed, _positions(ds, name, BBOX)


def _chaos_host_spill(ds, name, fault_type):
    idx = ds._store(name)._indexes["z3"]
    gen = next(g for g in idx.generations if g.tier == "full")
    with pytest.raises(fault_type):
        idx._spill(gen)
    stayed = gen.tier
    _clear()
    idx._spill(gen)
    return stayed, gen.tier, _positions(ds, name, BBOX)


def _chaos_pyramid_build(ds, name, fault_type):
    with pytest.raises(fault_type):
        ds.build_pyramids(name)
    _clear()
    built = ds.build_pyramids(name)
    world = ds._store(name)._indexes["z3"].density(
        [(-180.0, -90.0, 180.0, 90.0)], None, None,
        (-180.0, -90.0, 180.0, 90.0), 64, 64)
    return built, float(world.sum()), _positions(ds, name, BBOX)


def _chaos_merge_step(ds, name, fault_type):
    idx = ds._store(name)._indexes["z3"]
    n_gens = len(idx.generations)
    with pytest.raises(fault_type):
        ds.compact(name)
    untouched = len(idx.generations) == n_gens
    _clear()
    ds.compact(name)
    return untouched, len(idx.generations), _positions(ds, name, BBOX)


CHAOS = {"ingest.append": _chaos_ingest_append,
         "host.spill": _chaos_host_spill,
         "pyramid.build": _chaos_pyramid_build,
         "compaction.merge_step": _chaos_merge_step}


def test_chaos_grid_covers_the_catalog():
    """Every cataloged point has an arm here, but ``arrow.flush``, whose
    site waits for the Arrow result path (ROADMAP A9)."""
    assert set(CHAOS) | {"device.dispatch", "arrow.flush"} \
        == set(tfaults.FAULT_POINTS) == set(jfaults.FAULT_POINTS)


@pytest.mark.parametrize("point", sorted(CHAOS))
def test_chaos_arm_matches_reference(point):
    name = "rz_chaos"
    j, t = _pair(name, n=1500, extra=TIERED)
    tiers = [g.tier for g in t._store(name)._indexes["z3"].generations]
    assert tiers == ["host", "keys", "keys", "keys", "keys", "full"]
    baseline = _positions(t, name, BBOX)
    _set("geomesa.resilience.fault.points", f"{point}:1=error")
    jout = CHAOS[point](j, name, jfaults.FaultInjected)
    _set("geomesa.resilience.fault.points", f"{point}:1=error")
    tout = CHAOS[point](t, name, tfaults.FaultInjected)
    assert tout == jout
    if point != "ingest.append":
        assert tout[-1] == baseline


def test_chaos_merge_step_interrupts_between_merges():
    for lsm, faults in ((jlsm, jfaults), (tlsm, tfaults)):
        merged: list = []
        groups = [["a"], ["b"], ["c"]]

        def plan():
            return [g for g in groups if g[0] not in merged]

        def merge_one(group):
            merged.append(group[0])

        _set("geomesa.resilience.fault.points",
             "compaction.merge_step:2=error")
        with pytest.raises(faults.FaultInjected):
            lsm.compact_incremental(plan, merge_one)
        assert merged == ["a"]
        _clear()
        assert lsm.compact_incremental(plan, merge_one) == 2
        assert merged == ["a", "b", "c"]


def test_queries_after_a_degrade_see_the_demoted_rows():
    """A store that already has host generations: the degraded query
    demotes its group, and the NEXT query must still see the demoted
    generations' rows.  The JAX index caches a host stack built from the
    host generations its degraded query started with, so its next query
    misses the rows the degrade demoted (ROADMAP C); the port caches a
    stack only while it holds every host generation, and stays equal to
    the oracle."""
    name = "rz_next"
    rows = _rows(1500)
    j, t = _pair(name, n=1500, extra=TIERED)
    q = BBOX + " AND dtg DURING 2018-01-02T00:00:00Z/2018-01-09T00:00:00Z"
    x, y = rows["geom"]
    tt = rows["dtg"]
    lo, hi = MS_2018 + DAY, MS_2018 + 8 * DAY
    want = np.flatnonzero((x >= -76) & (x <= -73) & (y >= 39) & (y <= 42)
                          & (tt >= lo) & (tt <= hi)).tolist()
    assert _positions(t, name, q) == want == _positions(j, name, q)
    _set("geomesa.resilience.fault.points", "device.dispatch:1=oom")
    assert _positions(t, name, q) == want == _positions(j, name, q)
    _clear()
    after_t, after_j = _positions(t, name, q), _positions(j, name, q)
    assert after_t == want
    assert set(after_j) < set(want)      # the reference's stale stack


def test_a_transient_failure_demotes_the_tier_batch(monkeypatch):
    """The port gathers a tier's generations and copies them once, so a
    transient failure demotes every generation of that batch.  The JAX
    index, once a tier's padded buffer passes ``BATCH_SCAN_BUDGET``,
    dispatches one generation at a time and demotes only the failed one
    (ROADMAP C); both answers stay exact."""
    from geomesa_tpu.index import z3_lean as jz3
    monkeypatch.setattr(jz3.LeanZ3Index, "BATCH_SCAN_BUDGET", 1 << 10)
    name = "rz_batch"
    j, t = _pair(name, n=1500, extra=TIERED)
    baseline = _positions(t, name, BBOX)
    assert baseline == _positions(j, name, BBOX)

    def keys_tiers(ds):
        return [g.tier for g in ds._store(name)._indexes["z3"].generations]

    n_keys = keys_tiers(t).count("keys")
    assert n_keys > 1 and keys_tiers(j) == keys_tiers(t)
    before = _counts(DEGRADE_COUNTERS)
    # the first dispatch is the full tier's, the second the keys tier's
    _set("geomesa.resilience.fault.points", "device.dispatch:2=oom")
    assert _positions(t, name, BBOX) == baseline == _positions(j, name, BBOX)
    after = _counts(DEGRADE_COUNTERS)
    dj, dt = _delta(before[0], after[0]), _delta(before[1], after[1])
    assert dt["resilience.degraded"] == n_keys
    assert dj["resilience.degraded"] == 1
    assert keys_tiers(t).count("keys") == 0
    assert keys_tiers(j).count("keys") == n_keys - 1
    _clear()
    assert _positions(t, name, BBOX) == baseline


def test_a_faulted_append_leaves_the_write_absent():
    """``ingest.append`` fires in the z3 index's append.  The port appends
    the z3 keys before it grows the column store, labels and stats, so
    the faulted write is wholly absent and a later write lines up with
    its rows.  The JAX store grows its column store first: the faulted
    rows stay in its batch without keys, and the next write's keys point
    at them (ROADMAP C)."""
    name = "rz_append"
    j, t = _pair(name, n=1000)
    rng = np.random.default_rng(3)

    def chunk():
        return {"score": rng.uniform(0.0, 100.0, 200),
                "dtg": rng.integers(MS_2018, MS_2018 + 13 * DAY, 200),
                "geom": (rng.uniform(-75, -74, 200),
                         rng.uniform(40, 41, 200))}

    lost, kept = chunk(), chunk()
    _set("geomesa.resilience.fault.points", "ingest.append:1")
    for ds, faults in ((j, jfaults), (t, tfaults)):
        with pytest.raises(faults.FaultInjected):
            ds.write(name, lost)
    assert len(t._store(name).batch) == 1000          # the port: absent
    assert len(j._store(name).batch) == 1200          # the reference
    assert t.get_count(name) == 1000
    _clear()
    for ds in (j, t):
        ds.write(name, kept)
    rows = _rows(1000)
    xs = np.concatenate([rows["geom"][0], kept["geom"][0]])
    ys = np.concatenate([rows["geom"][1], kept["geom"][1]])
    box = (-74.6, 40.2, -74.1, 40.7)
    want = np.flatnonzero((xs >= box[0]) & (xs <= box[2]) & (ys >= box[1])
                          & (ys <= box[3])).tolist()
    q = f"BBOX(geom,{box[0]},{box[1]},{box[2]},{box[3]})"
    assert _positions(t, name, q) == want
    assert _positions(j, name, q) != want
