"""Port parity: the trace layer (``geomesa_tpu_torch/obs/trace.py``)
against geomesa_tpu's ``obs/trace.py``.

Held equal: the span tree (names and parent links) of a default-profile
z3 query, a z2 (BBOX-only) query, a lean query, ``query_windows`` and a
write, on stores holding the same seeded rows; the samplers; the ring and
JSONL exporters (the same JSON keys); the slow log; ``capture()``; and
the audit's ``trace_id``.

One listed difference: a traced lean write in the JAX package ends in a
``write.device`` span that waits for the device; the port's untraced
write ends without a copy, so it puts no span there (a span adds no
synchronization the untraced path lacks; ROADMAP C).
"""

import json

import numpy as np
import pytest

from geomesa_tpu import config as jcfg
from geomesa_tpu.datastore import TpuDataStore as JStore
from geomesa_tpu.obs import trace as jtrace
from geomesa_tpu_torch import config as tcfg
from geomesa_tpu_torch.audit import InMemoryAuditWriter
from geomesa_tpu_torch.datastore import TpuDataStore as TStore
from geomesa_tpu_torch.obs import trace as ttrace

MS_2018 = 1_514_764_800_000
DAY = 86_400_000
N = 4000
DURING = ("BBOX(geom,-75,40,-73,42) AND dtg DURING "
          "2018-01-03T00:00:00Z/2018-01-10T00:00:00Z")
BBOX = "BBOX(geom,-75,40,-73,42)"
DEFAULT = "name:String,dtg:Date,*geom:Point"
LEAN = (DEFAULT + ";geomesa.index.profile=lean,"
        "geomesa.lean.generation.slots=1024,geomesa.lean.compaction.factor=0")
OBS = ("geomesa.obs.sampler", "geomesa.obs.slow.ms", "geomesa.obs.enabled",
       "geomesa.obs.sample.ratio")

#: spans only one package records, by name (module doc)
ONLY_JAX = {"write.device"}


@pytest.fixture(autouse=True)
def _obs_defaults():
    for n in OBS:
        jcfg.clear_property(n)
        tcfg.clear_property(n)
    yield
    for n in OBS:
        jcfg.clear_property(n)
        tcfg.clear_property(n)


def _rows(n=N, seed=5):
    rng = np.random.default_rng(seed)
    return {"name": np.array([f"n{i % 7}" for i in range(n)], dtype=object),
            "dtg": rng.integers(MS_2018, MS_2018 + 20 * DAY, n),
            "geom": (rng.uniform(-76, -72, n), rng.uniform(39, 43, n))}


def _stores(spec, name="tr"):
    j, t = JStore(), TStore(device="cpu")
    for ds in (j, t):
        ds.create_schema(name, spec)
        ds.write(name, _rows())
    return j, t


def _canon(trace, drop=frozenset()):
    """The span tree as nested (name, sorted children), ``drop`` pruned."""
    kids: dict = {}
    root = None
    for s in trace.spans:
        if s.parent_id is None:
            root = s
        else:
            kids.setdefault(s.parent_id, []).append(s)

    def node(s):
        return (s.name, tuple(sorted(node(c) for c in kids.get(s.span_id, ())
                                     if c.name not in drop)))

    return node(root)


def _parents_ok(trace):
    ids = {s.span_id for s in trace.spans}
    return all(s.parent_id is None or s.parent_id in ids
               for s in trace.spans)


def _traced(tracer, fn):
    with tracer.capture(capacity=64) as cap:
        fn()
    traces = cap.traces()
    assert traces and all(_parents_ok(tr) for tr in traces)
    return traces


def _compare(jfn, tfn):
    jt = _traced(jtrace.tracer, jfn)
    tt = _traced(ttrace.tracer, tfn)
    assert [_canon(t) for t in tt] == [_canon(t, ONLY_JAX) for t in jt]
    return jt, tt


@pytest.fixture(scope="module")
def default_stores():
    return _stores(DEFAULT)


@pytest.fixture(scope="module")
def lean_stores():
    return _stores(LEAN, "trl")


def test_default_z3_query_tree(default_stores):
    j, t = default_stores
    for ds in (j, t):   # build the indexes outside the traced call
        ds.query_result("tr", DURING)
    jt, tt = _compare(lambda: j.query_result("tr", DURING),
                      lambda: t.query_result("tr", DURING))
    names = {s.name for s in tt[0].spans}
    assert {"query", "query.plan", "query.scan", "query.scan.device",
            "query.post_filter"} <= names
    root = tt[0].root_span.attributes
    assert root["hits"] == jt[0].root_span.attributes["hits"]
    assert root["plan.actual.matched"] == root["hits"]


def test_default_z2_query_tree(default_stores):
    j, t = default_stores
    for ds in (j, t):
        ds.query_result("tr", BBOX)
    jt, tt = _compare(lambda: j.query_result("tr", BBOX),
                      lambda: t.query_result("tr", BBOX))
    plan = next(s for s in tt[0].spans if s.name == "query.plan")
    assert plan.attributes["strategy"] == "z2"


def test_lean_query_tree(lean_stores):
    j, t = lean_stores
    jt, tt = _compare(lambda: j.query_result("trl", DURING),
                      lambda: t.query_result("trl", DURING))
    names = [s.name for s in tt[0].spans]
    assert "query.decompose" in names and "query.scan.device" in names
    dev = [s for s in tt[0].spans if s.name == "query.scan.device"]
    # the root carries the sum of its device spans' ms
    root_ms = tt[0].root_span.attributes["device_ms"]
    assert root_ms == pytest.approx(
        sum(s.attributes["device_ms"] for s in dev), abs=1e-2)


def test_query_windows_tree(default_stores, lean_stores):
    windows = [([(-75.0, 40.0, -74.0, 41.0)], MS_2018, MS_2018 + 5 * DAY),
               ([(-74.0, 41.0, -73.0, 42.0)], None, None),
               ([(-75.5, 39.5, -74.5, 40.5)], MS_2018 + DAY,
                MS_2018 + 9 * DAY)]
    for (j, t), name in ((default_stores, "tr"), (lean_stores, "trl")):
        for ds in (j, t):
            ds.query_windows(name, windows)
        jt, tt = _compare(lambda: j.query_windows(name, windows),
                          lambda: t.query_windows(name, windows))
        assert tt[0].root_span.attributes["hits"] \
            == jt[0].root_span.attributes["hits"]


@pytest.mark.parametrize("spec", ["default", "lean"])
def test_write_tree(spec):
    j, t = _stores(DEFAULT if spec == "default" else LEAN, "trw")
    for ds in (j, t):
        ds.query_result("trw", DURING)   # indexes exist: writes append
    rows = _rows(n=1500, seed=9)
    jt, tt = _compare(lambda: j.write("trw", rows),
                      lambda: t.write("trw", rows))
    assert tt[0].root_span.attributes["rows"] == 1500
    if spec == "lean":
        assert "write.device" in {s.name for s in jt[0].spans}


def test_audit_carries_the_trace_id():
    audit = InMemoryAuditWriter()
    t = TStore(device="cpu", audit_writer=audit)
    t.create_schema("tra", DEFAULT)
    t.write("tra", _rows(n=500))
    tcfg.set_property("geomesa.obs.sampler", "always")
    t.query_result("tra", DURING)
    ev = audit.query_events("tra")[-1]
    assert ev.trace_id and ttrace.tracer.find(ev.trace_id) is not None
    tcfg.set_property("geomesa.obs.sampler", "never")
    t.query_result("tra", DURING)
    assert audit.query_events("tra")[-1].trace_id == ""


# -- samplers, exporters, the slow log, capture ---------------------------

def _sampler_kinds(mod):
    out = {}
    for kind in ("always", "never", "ratio", "slow", "bogus"):
        mcfg = jcfg if mod is jtrace else tcfg
        mcfg.set_property("geomesa.obs.sampler", kind)
        out[kind] = type(mod.Tracer()._resolve_sampler()).__name__
    return out


def test_sampler_resolution_matches_reference():
    assert _sampler_kinds(ttrace) == _sampler_kinds(jtrace)


def test_samplers_head_and_tail():
    tr = ttrace.Trace("t")
    tr.root_span = ttrace.Span("t", None, "q", {})
    tr.root_span.duration_ms = 10.0
    assert ttrace.AlwaysSampler().sample("q")
    assert not ttrace.NeverSampler().sample("q")
    assert ttrace.SlowOnlySampler(5.0).retain(tr)
    assert not ttrace.SlowOnlySampler(50.0).retain(tr)
    assert ttrace.RatioSampler(1.0).sample("q")
    assert not ttrace.RatioSampler(0.0).sample("q")


def _run(mod, tracer):
    with tracer.span("query", schema="s") as root:
        with tracer.span("query.plan") as p:
            p.set_attr("strategy", "z3")
        mod.obs_count("obs.test.counter", 2)
        root.set_attr("hits", 3)


def test_ring_and_jsonl_exporters_match_reference(tmp_path):
    lines = {}
    for mod, cfg in ((jtrace, jcfg), (ttrace, tcfg)):
        path = tmp_path / f"{mod.__name__}.jsonl"
        ring = mod.RingExporter(4)
        tracer = mod.Tracer(sampler=mod.AlwaysSampler(),
                            exporters=[ring, mod.JsonlExporter(str(path))])
        for _ in range(6):
            _run(mod, tracer)
        assert len(ring) == 4
        got = [json.loads(ln) for ln in path.read_text().splitlines()]
        assert len(got) == 6
        lines[mod] = got[-1]
        assert tracer.find(ring.traces()[-1].trace_id) is not None
    jl, tl = lines[jtrace], lines[ttrace]
    assert set(tl) == set(jl)
    assert [set(s) for s in tl["spans"]] == [set(s) for s in jl["spans"]]
    assert [s["name"] for s in tl["spans"]] == [s["name"] for s in jl["spans"]]


def test_jsonl_rotation(tmp_path):
    path = tmp_path / "t.jsonl"
    tracer = ttrace.Tracer(sampler=ttrace.AlwaysSampler(),
                           exporters=[ttrace.JsonlExporter(str(path),
                                                           max_bytes=2000)])
    for _ in range(40):
        _run(ttrace, tracer)
    assert path.exists() and (tmp_path / "t.jsonl.1").exists()
    longest = max(len(ln) + 1 for ln in path.read_text().splitlines())
    # rotation at half the cap: the live file holds at most one line past
    assert path.stat().st_size <= 1000 + longest


def test_slow_log_and_never():
    tcfg.set_property("geomesa.obs.slow.ms", 0.0001)
    tracer = ttrace.Tracer()
    _run(ttrace, tracer)
    assert len(tracer.slow_log) == 1
    tcfg.set_property("geomesa.obs.sampler", "never")
    _run(ttrace, tracer)
    assert len(tracer.slow_log) == 1 and len(tracer.ring) == 1


def test_capture_records_under_never_and_stays_out_of_the_ring():
    tcfg.set_property("geomesa.obs.sampler", "never")
    tracer = ttrace.Tracer()
    with tracer.capture() as cap:
        _run(ttrace, tracer)
    assert len(cap) == 1 and len(tracer.ring) == 0
    assert [s.name for s in cap.traces()[0].spans] == ["query.plan", "query"]


def test_disabled_tracing_is_a_noop():
    tcfg.set_property("geomesa.obs.enabled", False)
    tracer = ttrace.Tracer()
    with tracer.span("query") as sp:
        assert sp is ttrace.NOOP_SPAN
        assert ttrace.current_trace_id() == ""
    assert len(tracer.ring) == 0
