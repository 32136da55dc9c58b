"""Port parity: EXPLAIN ANALYZE (``geomesa_tpu_torch/obs/
explain_analyze.py``) against geomesa_tpu's, on stores holding the same
seeded rows: the summary's keys, the strategy, the estimate and the
actual rows scanned and matched, and the rendered tree's span names.
Times are not compared."""

import numpy as np
import pytest

from geomesa_tpu import config as jcfg
from geomesa_tpu.datastore import TpuDataStore as JStore
from geomesa_tpu_torch import config as tcfg
from geomesa_tpu_torch.datastore import TpuDataStore as TStore

MS_2018 = 1_514_764_800_000
DAY = 86_400_000
DURING = ("BBOX(geom,-75,40,-74,41) AND dtg DURING "
          "2018-01-02T00:00:00Z/2018-01-12T00:00:00Z")
SPECS = {"default": "dtg:Date,*geom:Point",
         "lean": ("dtg:Date,*geom:Point;geomesa.index.profile=lean,"
                  "geomesa.lean.generation.slots=1024")}


def _names(node):
    return [node["name"]] + sorted(n for c in node["children"]
                                   for n in _names(c))


@pytest.mark.parametrize("profile", sorted(SPECS))
def test_explain_analyze_matches_reference(profile):
    rng = np.random.default_rng(2)
    n = 5000
    rows = {"dtg": rng.integers(MS_2018, MS_2018 + 30 * DAY, n),
            "geom": (rng.uniform(-76, -73, n), rng.uniform(39, 42, n))}
    # the sampler is off: an explicit EXPLAIN ANALYZE still records
    jcfg.set_property("geomesa.obs.sampler", "never")
    tcfg.set_property("geomesa.obs.sampler", "never")
    try:
        out = {}
        for key, ds in (("jax", JStore()), ("port", TStore(device="cpu"))):
            ds.create_schema("ea", SPECS[profile])
            ds.write("ea", rows)
            hits = len(ds.query_result("ea", DURING).positions)
            out[key] = (ds.explain_analyze("ea", DURING), hits)
    finally:
        jcfg.clear_property("geomesa.obs.sampler")
        tcfg.clear_property("geomesa.obs.sampler")
    (jea, jhits), (tea, thits) = out["jax"], out["port"]
    assert thits == jhits
    js, ts = jea.summary, tea.summary
    assert set(ts) == set(js)
    for k in ("hits", "estimate_rows", "actual_scanned", "actual_matched",
              "estimate_source", "replanned", "strategy", "options"):
        assert ts.get(k) == js.get(k), k
    assert ts["actual_matched"] == ts["hits"] == thits
    assert tea.result_summary["hits"] == thits
    assert set(tea.to_json()) == set(jea.to_json())
    assert _names(tea.tree()) == _names(jea.tree())
    text = tea.render()
    assert text.startswith("EXPLAIN ANALYZE schema:ea")
    assert "query.scan" in text and "Plan narration:" in text
