"""Port parity: the background-job registry (``geomesa_tpu_torch/obs/jobs.py``)
with ``jobs.CompactionJob`` / ``run_compaction`` / ``PyramidJob`` against
geomesa_tpu's ``obs/jobs.py`` and ``jobs.py``, and the kernel-build watch
(``obs/recompile.py``).

The same seeded lean store is compacted and pyramid-built in each
package; the job records must agree in kind, state, detail, phase names,
progress and error, also for jobs that fail.  The build watch counts a
completed ``nvcc`` build (faked here: no compiler on this machine) into
the ``jax.compile.*`` metrics and stamps the span it ran under.
"""

import os

import numpy as np
import pytest

from geomesa_tpu import jobs as jjobs
from geomesa_tpu.datastore import TpuDataStore as JStore
from geomesa_tpu.obs.jobs import jobs_registry as jreg
from geomesa_tpu_torch import jobs as tjobs
from geomesa_tpu_torch import obs as tobs
from geomesa_tpu_torch.datastore import TpuDataStore as TStore
from geomesa_tpu_torch.metrics import registry as tregistry
from geomesa_tpu_torch.obs import recompile as trecompile
from geomesa_tpu_torch.obs.jobs import JobRegistry
from geomesa_tpu_torch.obs.jobs import jobs_registry as treg
from geomesa_tpu_torch.ops import build as tbuild

MS_2018 = 1_514_764_800_000
DAY = 86_400_000
#: a keys-tier budget (S·(40 + 16k + 56) bytes) so four sealed runs group
SPEC = ("dtg:Date,*geom:Point;geomesa.index.profile=lean,"
        "geomesa.lean.generation.slots=4096,geomesa.lean.compaction.factor=0,"
        f"geomesa.lean.hbm.budget={4096 * (40 + 16 * 5 + 56)}")


@pytest.fixture(scope="module")
def stores():
    rng = np.random.default_rng(17)
    n = 24_000
    dtg = rng.integers(MS_2018, MS_2018 + 21 * DAY, n)
    x, y = rng.uniform(-75, -74, n), rng.uniform(40, 41, n)
    out = []
    for cls in (JStore, TStore):
        ds = cls() if cls is JStore else cls(device="cpu")
        ds.create_schema("jb", SPEC)
        for lo in range(0, n, 3000):
            ds.write("jb", {"dtg": dtg[lo:lo + 3000],
                            "geom": (x[lo:lo + 3000], y[lo:lo + 3000])})
        out.append(ds)
    return out


def _record(rec) -> dict:
    j = rec.to_json()
    return {"kind": j["kind"], "state": j["state"], "detail": j["detail"],
            "phases": [p["name"] for p in j["phases"]],
            "progress": j["progress"], "error": j["error"],
            "traced": bool(j["trace_id"])}


def test_compaction_and_pyramid_jobs_match_reference(stores):
    j, t = stores
    jreg.clear()
    treg.clear()
    jout = jjobs.CompactionJob(j, "jb").run()
    with tobs.tracer.capture() as cap:
        tout = tjobs.CompactionJob(t, "jb").run()
    assert tout["z3"]["merged_groups"] == jout["z3"]["merged_groups"] >= 1
    assert tjobs.run_pyramid_build(t, "jb") == \
        jjobs.run_pyramid_build(j, "jb") >= 1
    jr = [_record(r) for r in jreg.jobs()]
    tr = [_record(r) for r in treg.jobs()]
    assert tr == jr
    assert [r["kind"] for r in tr] == ["pyramid", "compaction"]
    assert all(r["state"] == "succeeded" for r in tr)
    assert tr[1]["progress"]["merged_groups"] >= 1
    # the job's root span holds its phase; the record keeps the trace id
    (trace,) = [x for x in cap.traces() if x.name == "job.compaction"]
    phases = [s for s in trace.spans if s.name == "job.phase"]
    assert [s.attributes["phase"] for s in phases] == ["compact"]
    rec = treg.jobs(kind="compaction")[0]
    assert rec.trace_id == trace.trace_id
    assert treg.get(rec.job_id) is rec
    assert tregistry.counter("job.compaction.runs").count >= 1
    assert tregistry.timer("job.pyramid.ms").count >= 1


class _Boom:
    """A store whose maintenance raises."""

    def compact(self, name, budget_ms=None):
        raise RuntimeError(f"compaction of {name} failed")

    def build_pyramids(self, name):
        raise RuntimeError(f"pyramid build of {name} failed")


@pytest.mark.parametrize("kind", ["compaction", "pyramid"])
def test_failed_job_records_terminal_outcome_like_reference(kind):
    jreg.clear()
    treg.clear()
    failures = tregistry.counter(f"job.{kind}.failures").count
    for jobs, reg in ((jjobs, jreg), (tjobs, treg)):
        job = (jobs.CompactionJob(_Boom(), "x", budget_ms=5.0)
               if kind == "compaction" else jobs.PyramidJob(_Boom(), "x"))
        with pytest.raises(RuntimeError, match="failed"):
            job.run()
    jr, tr = _record(jreg.jobs()[0]), _record(treg.jobs()[0])
    assert tr == jr
    assert tr["state"] == "failed" and "RuntimeError" in tr["error"]
    assert tregistry.counter(f"job.{kind}.failures").count == failures + 1


def test_registry_capacity_and_filters():
    reg = JobRegistry(capacity=3)
    for i in range(5):
        with reg.run("compaction", schema=f"s{i}") as job:
            job.progress(i=i)
    with pytest.raises(ValueError):
        with reg.run("pyramid"):
            raise ValueError("x")
    rows = reg.jobs()
    assert len(rows) == 3 and rows[0].kind == "pyramid"
    assert [r.progress["i"] for r in reg.jobs(kind="compaction")] == [4, 3]
    assert [r.state for r in reg.jobs(state="failed")] == ["failed"]
    assert reg.jobs(limit=1) == rows[:1]


# -- the kernel-build watch ---------------------------------------------------
class _FakeBuild:
    """What ``ops.build._start`` hands ``_finish`` for a successful
    compile: a finished process with its start time."""

    returncode = 0

    def __init__(self, started: float):
        self.started = started

    def communicate(self):
        return "", ""


def test_build_watch_counts_a_build_and_stamps_its_span(tmp_path):
    assert trecompile.installed()
    n0 = trecompile.compile_count()
    ms0 = tregistry.timer("jax.compile.ms").count
    lib = tmp_path / "libfake.so"
    tmp = tmp_path / "tmp.so"
    tmp.write_bytes(b"x")
    with tobs.tracer.capture() as cap:
        with tobs.span("query") as sp:
            assert tbuild._finish(lib, _FakeBuild(0.0), str(tmp)) == lib
            sp_id = sp.span_id
    assert lib.exists() and not os.path.exists(tmp)
    assert trecompile.compile_count() == n0 + 1
    assert tregistry.timer("jax.compile.ms").count == ms0 + 1
    (trace,) = cap.traces()
    (root,) = [s for s in trace.spans if s.span_id == sp_id]
    assert root.attributes["jax.recompiles"] == 1
    # an already-built library is no build
    assert tbuild._finish(lib, None, None) == lib
    assert trecompile.compile_count() == n0 + 1


def test_build_watch_ignores_a_failed_build(tmp_path):
    n0 = trecompile.compile_count()

    class _Failed(_FakeBuild):
        returncode = 1

        def communicate(self):
            return "", "error: boom"

    tmp = tmp_path / "tmp.so"
    tmp.write_bytes(b"x")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tbuild._finish(tmp_path / "lib.so", _Failed(0.0), str(tmp))
    assert trecompile.compile_count() == n0


def test_warm_queries_build_nothing(stores):
    _, t = stores
    q = ("BBOX(geom,-74.9,40.1,-74.2,40.8) AND dtg DURING "
         "2018-01-03T00:00:00Z/2018-01-12T00:00:00Z")
    t.query_result("jb", q)
    n0 = trecompile.compile_count()
    for _ in range(3):
        t.query_result("jb", q)
    assert trecompile.compile_count() == n0
