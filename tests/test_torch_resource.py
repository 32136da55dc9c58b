"""Port parity: ``storage_report`` and ``publish_storage_gauges``
(``geomesa_tpu_torch/obs/resource.py``) against geomesa_tpu's
``obs/resource.py``, on stores holding the same seeded rows.

Held equal: the accounted device, host and cache totals and per-index
device and host bytes of default, mesh and lean stores (with full, keys
and host generations and a lean attribute index).  Listed differences:
the sentinel bytes (the JAX indexes allocate padding buffers and report
them; the port pads nothing and reports 0, while its budgets still charge
them, so the tiers stay equal) and the batch bytes of a lean store
(the port keeps fixed-width string columns).  Also held: the accounted
view reconciles with the actual buffers within the tolerances, and the
admission gate sheds on the published ``storage.total.device_bytes``.
"""

import numpy as np
import pytest

from geomesa_tpu import parallel as jpar
from geomesa_tpu.datastore import TpuDataStore as JStore
from geomesa_tpu.obs import resource as jres
from geomesa_tpu_torch import config as tcfg
from geomesa_tpu_torch import metrics as tmetrics
from geomesa_tpu_torch.datastore import TpuDataStore as TStore
from geomesa_tpu_torch.index import attr_lean as tattr
from geomesa_tpu_torch.obs import resource as tres
from geomesa_tpu_torch.parallel import attr_lean as tpattr
from geomesa_tpu_torch.parallel import device_mesh
from geomesa_tpu_torch.resilience import Backpressure, admission_gate

MS_2018 = 1_514_764_800_000
DAY = 86_400_000
BASE = "score:Double:index=true,dtg:Date,*geom:Point"
LEAN = (BASE + ";geomesa.index.profile=lean,"
        "geomesa.lean.generation.slots=512,geomesa.lean.compaction.factor=0,"
        "geomesa.lean.hbm.budget=98304")
BBOX = "BBOX(geom,-76,39,-73,42)"


@pytest.fixture(autouse=True)
def _attr_slots(monkeypatch):
    monkeypatch.setattr(tattr.LeanAttrIndex, "GENERATION_SLOTS", 1 << 16)
    monkeypatch.setattr(tpattr.ShardedLeanAttrIndex, "GENERATION_SLOTS",
                        1 << 13)


def _rows(n, seed=21):
    rng = np.random.default_rng(seed)
    return {"score": rng.uniform(0.0, 100.0, n),
            "dtg": rng.integers(MS_2018, MS_2018 + 30 * DAY, n),
            "geom": (rng.uniform(-75, -74, n), rng.uniform(40, 41, n))}


def _pair(spec, n, shards=None):
    if shards:
        j = JStore(mesh=jpar.device_mesh(shards))
        t = TStore(device="cpu", mesh=device_mesh(devices=["cpu"] * shards))
    else:
        j, t = JStore(), TStore(device="cpu")
    rows = _rows(n)
    for ds in (j, t):
        ds.create_schema("rs", spec)
        for lo in range(0, n, 2000):
            ds.write("rs", {k: (tuple(c[lo:lo + 2000] for c in v)
                                if isinstance(v, tuple) else v[lo:lo + 2000])
                            for k, v in rows.items()})
        ds.query_result("rs", BBOX)              # builds the indexes
        ds.query_result("rs", "score > 50")
    return j, t


def _index_bytes(report):
    out = {}
    for key, st in report["schemas"]["rs"]["indexes"].items():
        if "device_bytes" in st:
            out[key] = (st["device_bytes"], st["host_bytes"],
                        st.get("tiers"))
    return out


CASES = {"default": (BASE, 6000, None), "lean": (LEAN, 6000, None),
         "mesh": (BASE, 6000, 2), "mesh-lean": (LEAN, 6000, 2)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_accounted_totals_match_reference(case):
    spec, n, shards = CASES[case]
    j, t = _pair(spec, n, shards)
    jr, tr = jres.storage_report(j), tres.storage_report(t)
    for k in ("device_bytes", "host_bytes", "cache_bytes"):
        assert tr["totals"][k] == jr["totals"][k], k
    assert _index_bytes(tr) == _index_bytes(jr)
    assert tr["totals"]["sentinel_bytes"] == 0
    if case == "lean":
        tiers = _index_bytes(tr)["z3"][2]
        assert all(tiers.get(k) for k in ("full", "keys", "host")), tiers
    elif not shards:
        assert tr["totals"]["batch_bytes"] == jr["totals"]["batch_bytes"]
    assert tr["schemas"]["rs"]["rows"] == jr["schemas"]["rs"]["rows"] == n
    assert tr["reconciliation"]["within_tolerance"], tr["reconciliation"]


def test_reconciliation_counts_actual_tensors():
    _, t = _pair(LEAN, 6000)
    rep = tres.storage_report(t)
    idx = t._store("rs")._indexes["z3"]
    dev = sum(g.bins.untyped_storage().nbytes()
              + g.z.untyped_storage().nbytes()
              + g.pos.untyped_storage().nbytes()
              + sum(c.untyped_storage().nbytes()
                    for c in (g.x, g.y, g.t) if c is not None)
              for g in idx.generations if g.tier != "host")
    assert rep["schemas"]["rs"]["indexes"]["z3"]["actual"]["device_bytes"] \
        == dev
    rec = rep["reconciliation"]
    assert rec["device"]["delta_pct"] == 0.0
    assert 0.0 <= rec["host"]["delta_pct"] <= 35.0
    # an understatement fails in every direction
    bad = tres._reconcile(90, 100, "host")
    assert not bad["ok"] and tres._reconcile(130, 100, "host")["ok"]
    assert not tres._reconcile(140, 100, "host")["ok"]
    # a view over one storage counts it once
    import torch
    a = torch.zeros(100, dtype=torch.int64)
    assert tres._add_buffers(0, set(), a, a[:10], [a[50:]]) == 800


def test_published_gauge_sheds_admission():
    _, t = _pair(LEAN, 6000)
    rep = tres.publish_storage_gauges(t)
    dev = rep["totals"]["device_bytes"]
    reg = tmetrics.registry
    assert reg.gauge("storage.total.device_bytes").value == dev > 0
    assert reg.gauge("storage.rs.z3.device_bytes").value \
        == rep["schemas"]["rs"]["indexes"]["z3"]["device_bytes"]
    admission_gate.reset()
    try:
        tcfg.set_property("geomesa.resilience.hbm.headroom", dev - 1)
        tcfg.set_property("geomesa.resilience.admission.queue.ms", 1.0)
        with pytest.raises(Backpressure):
            t.query_result("rs", BBOX)
        tcfg.set_property("geomesa.resilience.hbm.headroom", dev + 1)
        assert len(t.query_result("rs", BBOX).positions) == 6000
    finally:
        tcfg.clear_property("geomesa.resilience.hbm.headroom")
        tcfg.clear_property("geomesa.resilience.admission.queue.ms")
        admission_gate.reset()
    # a dropped schema's gauges retire at the next publish
    t.remove_schema("rs")
    tres.publish_storage_gauges(t)
    assert "storage.rs.z3.device_bytes" not in reg.snapshot()
