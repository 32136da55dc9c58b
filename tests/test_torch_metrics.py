"""Port parity: the metrics registry, its reporters and the naming lint,
the query audit, and the counters each store records for the same
operations — against the JAX package's ``metrics`` and ``audit``
modules and store."""

import json
import logging
import threading

import numpy as np
import pytest

import geomesa_tpu.metrics as jm
from geomesa_tpu.audit import InMemoryAuditWriter as JaxMemoryWriter
from geomesa_tpu.datastore import TpuDataStore as JaxStore
from geomesa_tpu.parallel.stats import (
    allreduce_metrics_snapshot as jax_allreduce,
)
from geomesa_tpu.resilience import admission_gate as jax_gate
from geomesa_tpu_torch import TpuDataStore, device_mesh
from geomesa_tpu_torch import metrics as pm
from geomesa_tpu_torch.audit import (
    InMemoryAuditWriter, JsonlAuditWriter, QueryEvent,
)
from geomesa_tpu_torch.parallel.stats import allreduce_metrics_snapshot
from geomesa_tpu_torch.resilience import admission_gate

MS = 1_514_764_800_000
DAY = 86_400_000
SPEC = "dtg:Date,*geom:Point"
LEAN = (";geomesa.index.profile=lean,geomesa.lean.generation.slots=256,"
        "geomesa.lean.compaction.factor=0")
WINDOWS = [([(-75.0, 40.0, -74.0, 41.0)], MS + DAY, MS + 8 * DAY),
           ([(-74.5, 40.5, -73.0, 42.0)], None, None)]


@pytest.fixture(autouse=True)
def _gates():
    admission_gate.reset()
    jax_gate.reset()
    yield
    assert admission_gate.inflight == 0 and jax_gate.inflight == 0


def _feed(mod):
    """The same updates on a fresh registry of either package."""
    reg = mod.MetricRegistry()
    reg.counter("query.a.count").inc()
    reg.counter("query.a.count").inc(4)
    reg.gauge("storage.total.device_bytes").set(123.5)
    rng = np.random.default_rng(3)
    for v in np.r_[rng.lognormal(1.0, 2.0, 300), [0.0, -1.0]]:
        reg.histogram("plan.estimate.ratio").update(float(v))
    for v in rng.uniform(0.01, 50.0, 100):
        reg.timer("query.a.scan_ms").update(float(v))
    with reg.timer("query.a.plan_ms"):
        pass
    return reg


def _strip_timer(snap):
    # the context-manager sample is a real elapsed time: equal count only
    out = dict(snap)
    out["query.a.plan_ms"] = {"count": snap["query.a.plan_ms"]["count"]}
    return out


@pytest.mark.parametrize("buckets", [False, True])
def test_snapshot_matches(buckets):
    a = _feed(pm).snapshot(buckets=buckets)
    b = _feed(jm).snapshot(buckets=buckets)
    assert _strip_timer(a) == _strip_timer(b)
    assert a["query.a.count"] == {"count": 5}
    assert a["storage.total.device_bytes"] == {"value": 123.5}
    h = a["plan.estimate.ratio"]
    assert h["count"] == 302 and h["min"] == -1.0
    assert h["p50"] <= h["p95"] <= h["p99"] <= h["max"]


def test_merge_snapshots_matches():
    parts = []
    for seed in range(3):
        reg = pm.MetricRegistry()
        rng = np.random.default_rng(seed)
        reg.counter("write.s.features").inc(int(rng.integers(1, 100)))
        reg.gauge("storage.s.device_bytes").set(float(seed + 1))
        for v in rng.uniform(0, 10, 50 + seed):
            reg.histogram("serving.fanin").update(float(v))
        parts.append(reg.snapshot(buckets=True))
    got = pm.merge_snapshots(parts)
    assert got == jm.merge_snapshots(json.loads(json.dumps(parts)))
    assert got["storage.s.device_bytes"] == {"value": 6.0}
    assert got["serving.fanin"]["count"] == 153
    with pytest.raises(ValueError, match="buckets=True"):
        pm.merge_snapshots([pm.MetricRegistry().snapshot()
                            | {"x.h": {"count": 1, "mean": 1.0,
                                       "min": 1.0, "max": 1.0}}])


def test_allreduce_metrics_snapshot_one_process():
    got = allreduce_metrics_snapshot(_feed(pm))
    want = jax_allreduce(_feed(jm))
    assert _strip_timer(got) == _strip_timer(want)
    assert got["query.a.count"] == {"count": 5}
    assert "buckets" not in got["plan.estimate.ratio"]


def test_allreduce_metrics_snapshot_multihost_store():
    """A one-process multihost store: the registry reduction is the
    identity, and the store's own counters are in it."""
    ds = TpuDataStore(device="cpu", mesh=device_mesh(devices=["cpu"] * 2),
                      multihost=True)
    ds.create_schema("amh", SPEC)
    rng = np.random.default_rng(4)
    ds.write("amh", {"dtg": rng.integers(MS, MS + 9 * DAY, 500),
                     "geom": (rng.uniform(-75, -73, 500),
                              rng.uniform(40, 42, 500))})
    ds.query_windows("amh", WINDOWS)
    snap = allreduce_metrics_snapshot()
    assert snap["write.amh.features"] == {"count": 500}
    assert snap["query.amh.windows"] == {"count": 2}
    assert snap["query.amh.count"]["count"] >= 1


def test_lint_metric_names_matches():
    names = ["query.evt.count", "storage.evt.attr:score.device_bytes",
             "serving.tenant.shed.t-1", "bogus.key", "query", "query.",
             "write.a b.features", "tile.request.ms", "jax.compile.count"]
    assert pm.lint_metric_names(names) == jm.lint_metric_names(names) == [
        "bogus.key", "query", "query.", "write.a b.features"]
    assert pm.METRIC_NAMESPACES == jm.METRIC_NAMESPACES


def test_reporters_emit_the_same_rows(tmp_path, caplog):
    rows = {}
    for key, mod in (("port", pm), ("jax", jm)):
        reg = _feed(mod)
        logger = logging.getLogger(f"metrics-test-{key}")
        with caplog.at_level(logging.INFO, logger=logger.name):
            caplog.clear()
            rep = mod.LoggingReporter(reg, logger=logger)
            rep.report()
            reg.counter("query.a.count").inc(2)
            rep.report()
            rows[key] = [r.getMessage() for r in caplog.records
                         if "plan_ms" not in r.getMessage()]
        path = tmp_path / f"{key}.csv"
        mod.DelimitedFileReporter(reg, str(path)).report()
        rows[key + "_csv"] = [
            line.split(",", 1)[1] for line in path.read_text().splitlines()
            if "plan_ms" not in line]
    assert rows["port"] == rows["jax"]
    assert rows["port_csv"] == rows["jax_csv"]
    # the second report carries the interval delta of the counter
    assert any("'delta': 2" in r for r in rows["port"])


def test_periodic_reporter_flushes_on_stop():
    seen = []

    class Sink:
        def report(self):
            seen.append(1)

    rep = pm.PeriodicReporter(Sink(), interval_s=3600.0).start()
    assert rep.start() is rep                 # a second start is a no-op
    rep.stop()
    assert seen == [1] and rep._thread is None


def test_counter_is_thread_safe():
    reg = pm.MetricRegistry()

    def bump():
        for _ in range(1000):
            reg.counter("query.t.count").inc()

    ts = [threading.Thread(target=bump) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert reg.counter("query.t.count").count == 4000


# -- the stores' counters and audit --------------------------------------------

_KEYS = ("query.{}.count", "query.{}.windows", "write.{}.features")


def _counts(reg, name):
    return [reg.counter(k.format(name)).count for k in _KEYS] + [
        reg.counter("serving.bypass").count,
        reg.timer(f"query.{name}.plan_ms").count,
        reg.timer(f"query.{name}.scan_ms").count]


@pytest.mark.parametrize("profile", ["default", "lean"])
def test_store_counters_match(profile):
    name = f"cnt_{profile}"
    spec = SPEC + (LEAN if profile == "lean" else "")
    rng = np.random.default_rng(9)
    rows = {"dtg": rng.integers(MS, MS + 9 * DAY, 800),
            "geom": (rng.uniform(-75, -73, 800), rng.uniform(40, 42, 800))}
    deltas = {}
    for key, ds, reg in (("port", TpuDataStore(device="cpu"), pm.registry),
                         ("jax", JaxStore(), jm.registry)):
        ds.create_schema(name, spec)
        before = _counts(reg, name)
        ds.query_result(name, "INCLUDE")          # empty schema
        for _ in range(2):
            ds.write(name, {"dtg": rows["dtg"].copy(),
                            "geom": (rows["geom"][0].copy(),
                                     rows["geom"][1].copy())})
        ds.query_result(name, "BBOX(geom, -75, 40, -74, 41)")
        ds.query_windows(name, WINDOWS)
        ds.query_fused(name, "BBOX(geom, -75, 40, -74, 41)")
        ds.query_fused(name, "INCLUDE")
        deltas[key] = [b - a for a, b in zip(before, _counts(reg, name))]
    assert deltas["port"] == deltas["jax"]
    fused = 1 if profile == "lean" else 0
    assert deltas["port"][:4] == [5, 2 + fused, 1600, 2 - fused]


def test_audit_events_match():
    rng = np.random.default_rng(10)
    rows = {"dtg": rng.integers(MS, MS + 9 * DAY, 400),
            "geom": (rng.uniform(-75, -73, 400), rng.uniform(40, 42, 400))}
    events = {}
    for key, ds in (("port", TpuDataStore(device="cpu",
                                          audit_writer=InMemoryAuditWriter(),
                                          user="ana")),
                    ("jax", JaxStore(audit_writer=JaxMemoryWriter(),
                                     user="ana"))):
        ds.create_schema("au", SPEC)
        ds.write("au", {"dtg": rows["dtg"].copy(),
                        "geom": (rows["geom"][0].copy(),
                                 rows["geom"][1].copy())})
        ds.query_result("au", "BBOX(geom, -75, 40, -74, 41)")
        ds.query_windows("au", WINDOWS)
        events[key] = [(e.store, e.type_name, e.user, e.filter, e.hints,
                        e.hits, e.trace_id, e.plan_time_ms == 0.0)
                       for e in ds._audit_writer.query_events("au")]
    # both stores stamp the trace id of the query's recorded trace (each
    # its own random id)
    assert [e[:6] + e[7:] for e in events["port"]] == \
        [e[:6] + e[7:] for e in events["jax"]]
    assert all(len(e[6]) == 16 for e in events["port"] + events["jax"])
    assert len(events["port"]) == 2
    assert events["port"][1][3] == "batched windows[2]"
    # the batched path never planned: no plan_ms sample, recorded as 0.0
    assert events["port"][1][-1] is True


def test_jsonl_audit_writer(tmp_path):
    path = tmp_path / "audit.jsonl"
    w = JsonlAuditWriter(str(path))
    for i in range(3):
        w.write_event(QueryEvent(store="tpu", type_name="s", user="u",
                                 filter=f"f{i}", hits=i))
    w.close()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [x["filter"] for x in lines] == ["f0", "f1", "f2"]
    assert lines[2]["hits"] == 2 and lines[0]["trace_id"] == ""
    mem = InMemoryAuditWriter(capacity=2)
    for i in range(3):
        mem.write_event(QueryEvent(store="tpu", type_name="s", user="u",
                                   filter=f"f{i}", timestamp=float(i)))
    assert [e.filter for e in mem.query_events(since=1.0)] == ["f1", "f2"]
    assert mem.query_events(type_name="other") == []
