"""Port parity: the SLO plane (``geomesa_tpu_torch/obs/slo.py``), stage
attribution (``obs/attribution.py``) and the Prometheus text
(``obs/prom.py``) against geomesa_tpu's modules of the same names.

* ``attribute()``: equal stage ledgers for the same seeded span trees
  (``rtol=1e-12``).
* ``SloPlane``: the same traces fold into equal burns, alerts, tenant
  labels, ``report()`` and exposition under ONE replaced clock (the
  port's ``slo._clock`` and the JAX module's ``time``).
* ``prometheus_text``: identical text for one snapshot.
* A traced query on a sharded lean store leaves under 10% of its wall
  in the ``unattributed`` stage, and real traces reach the process-wide
  plane through the tracer's finish hook.
"""

import itertools
import re
import types

import numpy as np
import pytest

from geomesa_tpu import config as jcfg
from geomesa_tpu.obs import attribution as jatt
from geomesa_tpu.obs import prom as jprom
from geomesa_tpu.obs import slo as jslo
from geomesa_tpu.obs import trace as jtrace
from geomesa_tpu_torch import config as tcfg
from geomesa_tpu_torch import obs as tobs
from geomesa_tpu_torch.datastore import TpuDataStore as TStore
from geomesa_tpu_torch.metrics import registry as tregistry
from geomesa_tpu_torch.obs import attribution as tatt
from geomesa_tpu_torch.obs import prom as tprom
from geomesa_tpu_torch.obs import slo as tslo
from geomesa_tpu_torch.obs import trace as ttrace
from geomesa_tpu_torch.parallel import device_mesh

MS_2018 = 1_514_764_800_000
DAY = 86_400_000
_OPTS = ("geomesa.slo.enabled", "geomesa.slo.objectives",
         "geomesa.slo.burn.alert", "geomesa.slo.tenants.max",
         "geomesa.slo.window.short.s", "geomesa.slo.bucket.s")
_ids = itertools.count(1)
#: span names a tree draws from: every mapped one, a structural wrapper
#: the ledger does not map, and the fusion span
_NAMES = sorted(tatt.SPAN_STAGE) + ["query.structural"]


def _set(name, value):
    jcfg.set_property(name, value)
    tcfg.set_property(name, value)


@pytest.fixture(autouse=True)
def _clean():
    for n in _OPTS:
        jcfg.clear_property(n)
        tcfg.clear_property(n)
    yield
    for n in _OPTS:
        jcfg.clear_property(n)
        tcfg.clear_property(n)


@pytest.fixture
def clock(monkeypatch):
    now = [50_000.0]
    monkeypatch.setattr(jslo, "time", types.SimpleNamespace(
        time=lambda: now[0]))
    monkeypatch.setattr(tslo, "_clock", lambda: now[0])
    return now


def _tree(mod, spec):
    """A finished trace of module ``mod`` from a package-neutral spec:
    ``(tid, cls, root_ms, root_attrs, [(name, ms, parent_index)])``."""
    tid, cls, root_ms, attrs, children = spec
    t = mod.Trace(tid)
    root = mod.Span(tid, None, cls, dict(attrs))
    root.duration_ms = float(root_ms)
    t.root_span = root
    made = []
    for name, ms, parent in children:
        pid = root.span_id if parent is None else made[parent].span_id
        sp = mod.Span(tid, pid, name, {})
        sp.duration_ms = float(ms)
        made.append(sp)
    t.spans = made + [root]
    return t


def _random_spec(rng, cls="query", tenant=None, root_ms=None):
    n = int(rng.integers(0, 12))
    children = []
    for i in range(n):
        parent = None if i == 0 or rng.random() < 0.4 \
            else int(rng.integers(0, i))
        children.append((_NAMES[int(rng.integers(0, len(_NAMES)))],
                         float(rng.uniform(0.0, 40.0)), parent))
    attrs = {}
    if rng.random() < 0.5:
        attrs["admission.queue_ms"] = float(rng.uniform(0.0, 5.0))
    if rng.random() < 0.3:
        attrs["coalesce.ms"] = float(rng.uniform(0.0, 3.0))
    if rng.random() < 0.3:
        attrs["fused.dispatch.ms"] = float(rng.uniform(0.0, 9.0))
    if rng.random() < 0.1:
        attrs["error"] = "boom"
    if tenant is not None:
        attrs["tenant"] = tenant
    ms = float(rng.uniform(1.0, 300.0)) if root_ms is None else root_ms
    return (f"tid{next(_ids):08x}", cls, ms, attrs, children)


@pytest.mark.parametrize("seed", range(6))
def test_attribution_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        spec = _random_spec(rng, cls=("query", "write", "tile.render")[
            int(rng.integers(0, 3))])
        ja = jatt.attribute(_tree(jtrace, spec))
        ta = tatt.attribute(_tree(ttrace, spec))
        assert ta["stages"].keys() == ja["stages"].keys()
        for k in ("class", "tenant", "trace_id", "error"):
            assert ta[k] == ja[k], k
        np.testing.assert_allclose(ta["total_ms"], ja["total_ms"],
                                   rtol=1e-12)
        np.testing.assert_allclose(
            [ta["stages"][s] for s in tatt.STAGES],
            [ja["stages"][s] for s in jatt.STAGES], rtol=1e-12, atol=0.0)
    assert tatt.STAGES == jatt.STAGES and tatt.SPAN_STAGE == jatt.SPAN_STAGE
    assert tatt.attribute(ttrace.Trace("empty")) is None


def _feed(planes, specs, retained, clock, step_s):
    for spec, keep in zip(specs, retained):
        clock[0] += step_s
        planes[0].on_trace_finish(_tree(jtrace, spec), keep)
        planes[1].on_trace_finish(_tree(ttrace, spec), keep)


def _same_plane_state(jp, tp):
    for cls in ("query", "write", "tile.render"):
        for w in (60.0, 300.0, 3600.0):
            np.testing.assert_allclose(tp.burn(cls, w), jp.burn(cls, w),
                                       rtol=1e-12)
    assert tp.alerts() == jp.alerts()
    assert tp.report() == jp.report()
    assert tp.exposition() == jp.exposition()
    assert tp._tenants == jp._tenants


@pytest.mark.parametrize("seed", range(3))
def test_slo_plane_matches_reference(clock, seed):
    _set("geomesa.slo.objectives", "query:80:0.9,write:200:0.99,"
         "tile.render:60:0.95")
    _set("geomesa.slo.burn.alert", 2.0)
    _set("geomesa.slo.tenants.max", 3)
    _set("geomesa.slo.window.short.s", 120.0)
    jp, tp = jslo.SloPlane(), tslo.SloPlane()
    rng = np.random.default_rng(100 + seed)
    tenants = ["acme co", "beta", "gamma/1", "delta", "", None]
    specs = [_random_spec(rng, cls=("query", "write", "tile.render", "x")[
        int(rng.integers(0, 4))],
        tenant=tenants[int(rng.integers(0, len(tenants)))])
        for _ in range(120)]
    retained = [bool(rng.random() < 0.5) for _ in specs]
    # fast traffic, then a burning stretch, then a quiet one that lets the
    # short window recover and re-arm the alert, then a second burn
    _feed((jp, tp), specs[:40], retained[:40], clock, 1.0)
    _same_plane_state(jp, tp)
    slow = [(s[0] + "s", s[1], 400.0, s[3], s[4]) for s in specs[40:80]]
    _feed((jp, tp), slow, retained[40:80], clock, 2.0)
    _same_plane_state(jp, tp)
    clock[0] += 600.0
    _feed((jp, tp), specs[80:100], retained[80:100], clock, 1.0)
    _feed((jp, tp), slow[:20], retained[100:120], clock, 1.0)
    _same_plane_state(jp, tp)
    assert tp.alerts(), "the burning stretches raised no alert"
    assert tp._tenants <= {"acme_co", "beta", "gamma_1", "delta"}


def test_alert_fires_once_per_crossing(clock):
    _set("geomesa.slo.objectives", "query:100:0.9")
    _set("geomesa.slo.burn.alert", 1.0)
    tp = tslo.SloPlane()
    fired = tregistry.counter("alert.slo.fired").count
    for _ in range(4):
        clock[0] += 1.0
        tp.on_trace_finish(_tree(ttrace, ("a", "query", 500.0, {}, [])),
                           False)
    assert tregistry.counter("alert.slo.fired").count == fired + 1
    assert len(tp.alerts(cls="query")) == 1
    assert tp.report()["alerts_active"] == ["query"]


def test_slo_disabled_is_inert(clock):
    _set("geomesa.slo.enabled", False)
    tp = tslo.SloPlane()
    req = tregistry.counter("slo.query.requests").count
    tp.on_trace_finish(_tree(ttrace, ("b", "query", 500.0, {}, [])), True)
    assert tregistry.counter("slo.query.requests").count == req
    assert tp.exposition() == ""
    assert tp.report()["enabled"] is False


def test_parse_objectives_matches_reference():
    spec = ("query:250:0.99, tile.render:40:0.9,bad,write:x:0.5,"
            "a.b.c:10:2,:5:0.5")
    got = {k: o.to_json() for k, o in tslo._parse_objectives(spec).items()}
    want = {k: o.to_json() for k, o in jslo._parse_objectives(spec).items()}
    assert got == want and "tile.render" in got and "write" not in got


def _snapshot(rng) -> dict:
    snap = {}
    for i in range(12):
        kind = int(rng.integers(0, 3))
        key = f"query.pts.k{i}.ms" if kind == 2 else f"storage.s{i}.bytes"
        if kind == 0:
            snap[key] = {"value": float(rng.uniform(0, 1e9))}
        elif kind == 1:
            snap[f"query.count{i}"] = {"count": int(rng.integers(0, 1e6))}
        else:
            n = int(rng.integers(0, 50))
            snap[key] = {"count": n, "mean": float(rng.uniform(0, 9)),
                         "p50": float(rng.uniform(0, 9)),
                         "p95": float("inf") if i % 5 == 0 else 3.25,
                         "p99": float("nan") if i % 7 == 0 else 7.0,
                         **({"total": 12.5} if i % 2 else {})}
    return snap


@pytest.mark.parametrize("seed", range(4))
def test_prometheus_text_matches_reference(seed):
    snap = _snapshot(np.random.default_rng(seed))
    assert tprom.prometheus_text(snap) == jprom.prometheus_text(snap)
    assert tprom.metric_name("storage.evt.attr:score.device_bytes") == \
        jprom.metric_name("storage.evt.attr:score.device_bytes")


#: one sample line of the text exposition format (with an optional
#: OpenMetrics exemplar), or a ``# TYPE`` line
_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_]+="[^"]*"\})? '
    r'[-+0-9.eE]+(inf)?( # \{trace_id="[^"]+"\} [-+0-9.eE]+)?$')
_TYPE = re.compile(r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* "
                   r"(counter|gauge|summary|histogram)$")


def _lean_mesh_store(n=12_000):
    rng = np.random.default_rng(5)
    ds = TStore(device="cpu", mesh=device_mesh(devices=["cpu"] * 2))
    ds.create_schema("sl", "dtg:Date,*geom:Point;geomesa.index.profile=lean,"
                     "geomesa.lean.generation.slots=2048,"
                     "geomesa.lean.compaction.factor=0,"
                     f"geomesa.lean.hbm.budget={2048 * 70}")
    for lo in range(0, n, 2000):
        ds.write("sl", {"dtg": rng.integers(MS_2018, MS_2018 + 28 * DAY,
                                            2000),
                        "geom": (rng.uniform(-75, -74, 2000),
                                 rng.uniform(40, 41, 2000))})
    return ds


def test_sharded_lean_trace_is_attributed():
    """The sharded lean index places the spans attribution maps: the
    query's unattributed share stays under 10% of its wall, and the
    finished root reaches the process-wide plane through the tracer's
    finish hook."""
    _set("geomesa.slo.objectives", "query:0.001:0.9")
    ds = _lean_mesh_store()
    tiers = ds._store("sl")._indexes["z3"].tier_counts()
    assert tiers["host"] and (tiers["full"] or tiers["keys"]), tiers
    q = ("BBOX(geom,-74.9,40.1,-74.2,40.8) AND dtg DURING "
         "2018-01-03T00:00:00Z/2018-01-20T00:00:00Z")
    ds.query_result("sl", q)                          # warm
    tobs.slo_plane.reset()
    req = tregistry.counter("slo.query.requests").count
    shares = []
    with tobs.tracer.capture() as cap:
        for _ in range(3):
            ds.query_result("sl", q)
    for tr in cap.traces():
        names = {s.name for s in tr.spans}
        assert {"query.decompose", "query.scan.device",
                "query.scan.host"} <= names, names
        att = tobs.attribute(tr)
        shares.append(att["stages"]["unattributed"] / att["total_ms"])
    assert len(shares) == 3 and min(shares) < 0.10, shares
    assert tregistry.counter("slo.query.requests").count == req + 3
    assert tobs.slo_plane.burn("query", 300.0) > 0.0
    text = (tobs.prometheus_text(tregistry.snapshot())
            + tobs.slo_plane.exposition())
    for line in text.splitlines():
        assert _SAMPLE.match(line) or _TYPE.match(line), line
    assert "geomesa_slo_query_latency_ms_bucket" in text
