"""Port parity: adaptive mid-query replanning and the sketch-fed
cardinality estimator of geomesa_tpu_torch against geomesa_tpu, on lean
stores fed the same seeded rows.

Held equal: the chosen strategy, its cost ``source`` and ``max_ranges``,
positions, the explain trace (but its timings), the estimator's
``z3_rows``, ``size_max_ranges``, ``attr_equals_rows`` and
``attr_range_rows``, and the named attribute selectivities; the replan
scope's mechanics are the JAX package's."""

import numpy as np
import pytest

from geomesa_tpu.datastore import TpuDataStore as JaxStore
from geomesa_tpu.planning.explain import ExplainString as JaxExplain
from geomesa_tpu.planning.planner import Query as JaxQuery
from geomesa_tpu_torch import TpuDataStore
from geomesa_tpu_torch.planning.adaptive import (
    ReplanSignal, check_replan, current_replan_scope, replan_scope,
)
from geomesa_tpu_torch.planning.estimator import CardinalityEstimator
from geomesa_tpu_torch.planning.explain import ExplainString
from geomesa_tpu_torch.planning.planner import Query

MS_2018 = 1_514_764_800_000
DAY = 86_400_000
SLOTS = 512
N = 12 * SLOTS
HOT = "BBOX(geom,-74.06,39.99,-73.99,40.06)"
#: one full, three keys and eight host generations
TIERED = SLOTS * (40 + 16 + 40) + SLOTS * 16 * 3
_PLANNING_ENV = ("GEOMESA_PLANNING_ESTIMATOR_ENABLED",
                 "GEOMESA_PLANNING_ESTIMATOR_MIN_ROWS",
                 "GEOMESA_PLANNING_SELECTIVITY_EQUALS_DEFAULT",
                 "GEOMESA_PLANNING_SELECTIVITY_RANGE_DEFAULT",
                 "GEOMESA_PLANNING_REPLAN_THRESHOLD",
                 "GEOMESA_PLANNING_REPLAN_MIN_ROWS")


@pytest.fixture(autouse=True)
def _planning_env(monkeypatch):
    """Both packages read these knobs from the environment: start every
    test from their defaults."""
    from geomesa_tpu import config
    for name in _PLANNING_ENV:
        monkeypatch.delenv(name, raising=False)
        config.clear_property(name.lower().replace("_", "."))


@pytest.fixture
def sketch_on(monkeypatch):
    """The skewed store is far below the production estimator floor:
    open it so its plans take the sketch tier."""
    monkeypatch.setenv("GEOMESA_PLANNING_ESTIMATOR_MIN_ROWS", "0")


def _both(spec: str, writes):
    jds, tds = JaxStore(), TpuDataStore(device="cpu")
    for ds in (jds, tds):
        ds.create_schema("evt", spec)
        for w in writes:
            ds.write("evt", w)
    return jds, tds


def _skewed_writes(seed=23):
    """85% of the points in a dense cluster and the rest spread wide —
    where whole-store fractions mispredict and per-generation sketches
    don't (the JAX planning tests' store, without attribute indexes)."""
    rng = np.random.default_rng(seed)
    out = []
    for lo in range(0, N, SLOTS):
        m = min(SLOTS, N - lo)
        dense = int(m * 0.85)
        out.append({
            "name": np.where(rng.uniform(size=m) < 0.9, "hot",
                             "cold").astype(object),
            "score": rng.uniform(0.0, 100.0, m),
            "dtg": rng.integers(MS_2018, MS_2018 + 14 * DAY, m),
            "geom": (np.concatenate([rng.uniform(-74.05, -74.0, dense),
                                     rng.uniform(-80.0, -70.0, m - dense)]),
                     np.concatenate([rng.uniform(40.0, 40.05, dense),
                                     rng.uniform(35.0, 45.0, m - dense)]))})
    return out


@pytest.fixture(scope="module", params=[None, TIERED],
                ids=["full", "tiered"])
def skewed(request):
    budget = ("" if request.param is None
              else f",geomesa.lean.hbm.budget={request.param}")
    return _both("name:String,score:Double,dtg:Date,*geom:Point;"
                 "geomesa.index.profile=lean,"
                 f"geomesa.lean.generation.slots={SLOTS},"
                 f"geomesa.lean.compaction.factor=0{budget}",
                 _skewed_writes())


def _run(ds, ecql, explain_cls, query_cls, hints=None):
    e = explain_cls()
    q = query_cls.of(ecql)
    q.hints.update(hints or {})
    r = ds.query_result("evt", q, e)
    lines = [ln for ln in str(e).splitlines()
             if not ln.strip().startswith("Scan:")]   # timings differ
    return r, lines


def _same(jds, tds, ecql, hints=None):
    jr, jl = _run(jds, ecql, JaxExplain, JaxQuery, hints)
    tr, tl = _run(tds, ecql, ExplainString, Query, hints)
    assert (tr.strategy.index, tr.strategy.source, tr.strategy.max_ranges) \
        == (jr.strategy.index, jr.strategy.source, jr.strategy.max_ranges)
    assert tr.strategy.cost == jr.strategy.cost
    np.testing.assert_array_equal(tr.positions, jr.positions)
    assert tl == jl
    return tr, tl


# -- C1: the 9,000-row store where the z3 probe replans to id ------------
@pytest.fixture(scope="module")
def c1():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(0, 1, 8000), rng.uniform(-180, 180, 1000)])
    y = np.concatenate([rng.uniform(0, 1, 8000), rng.uniform(-90, 90, 1000)])
    rows = {"score": rng.uniform(0, 1, 9000),
            "dtg": rng.integers(MS_2018, MS_2018 + 28 * DAY, 9000),
            "geom": (x, y)}
    return _both("score:Double,dtg:Date,*geom:Point;"
                 "geomesa.index.profile=lean", [rows])


def test_c1_probe_replans_to_id(c1):
    r, lines = _same(*c1, "BBOX(geom, 0, 0, 1, 1) AND IN ('1', '2', '3')")
    assert r.strategy.index == "id"
    np.testing.assert_array_equal(r.positions, [1, 2, 3])
    assert sum(ln.strip().startswith("Replanning: z3 observed 8000 "
                                     "candidates at query.scan.probe")
               for ln in lines) == 1


def test_c1_iso_dtg_term_fails_or_answers_alike(c1):
    ecql = ("BBOX(geom, 0, 0, 1, 1) AND IN ('1', '2', '3') AND "
            "dtg >= '2018-01-31T00:00:00Z'")
    outcomes = []
    for ds in c1:
        try:
            outcomes.append(("ok", ds.query_result("evt", ecql)
                             .positions.tolist()))
        except Exception as e:  # noqa: BLE001 — the outcome is compared
            outcomes.append(("raised", type(e).__name__))
    assert outcomes[0] == outcomes[1]


# -- the replan scope ------------------------------------------------------
def test_check_replan_outside_scope_is_noop():
    assert current_replan_scope() is None
    check_replan("query.scan.probe", 10**9)


def test_replan_scope_triggers_on_underestimate_once():
    with pytest.raises(ReplanSignal) as ei:
        with replan_scope(10.0, 8.0, min_rows=0):
            check_replan("query.scan.probe", 1000)
    sig = ei.value
    assert (sig.observed, sig.estimate, sig.point) == (
        1000, 10.0, "query.scan.probe")
    assert current_replan_scope() is None   # the scope reset on exit


def test_replan_scope_disarms_after_signal():
    with replan_scope(10.0, 8.0, min_rows=0) as scope:
        with pytest.raises(ReplanSignal):
            check_replan("query.scan.probe", 1000)
        assert not scope.armed
        check_replan("query.scan.probe", 10**6)   # disarmed: no raise


@pytest.mark.parametrize("estimate,threshold,min_rows,observed", [
    (10.0, 8.0, 4096, 1000),     # under the floor
    (100.0, 8.0, 0, 500),        # under 8 x (100 + 1)
    (100.0, 0.0, 0, 10**9),      # threshold <= 0 disarms
])
def test_replan_scope_respects_min_rows_and_threshold(estimate, threshold,
                                                      min_rows, observed):
    with replan_scope(estimate, threshold, min_rows=min_rows):
        check_replan("query.scan.probe", observed)


# -- mispredicted, well-predicted and pinned plans -------------------------
def test_mispredict_replans_exactly_once(skewed, sketch_on, monkeypatch):
    jds, tds = skewed
    monkeypatch.setenv("GEOMESA_PLANNING_REPLAN_THRESHOLD", "0.0")
    oracle = tds.query_result("evt", HOT).positions
    monkeypatch.setenv("GEOMESA_PLANNING_ESTIMATOR_ENABLED", "false")
    monkeypatch.setenv("GEOMESA_PLANNING_REPLAN_THRESHOLD", "2.0")
    monkeypatch.setenv("GEOMESA_PLANNING_REPLAN_MIN_ROWS", "64")
    r, lines = _same(jds, tds, HOT)
    assert r.strategy.source == "observed"
    assert sum("Replanning:" in ln for ln in lines) == 1
    np.testing.assert_array_equal(r.positions, oracle)


def test_well_predicted_query_never_replans(skewed, sketch_on, monkeypatch):
    monkeypatch.setenv("GEOMESA_PLANNING_REPLAN_THRESHOLD", "2.0")
    monkeypatch.setenv("GEOMESA_PLANNING_REPLAN_MIN_ROWS", "64")
    r, lines = _same(*skewed, HOT)
    assert r.strategy.source == "sketch" and r.strategy.max_ranges
    assert not any("Replanning:" in ln for ln in lines)


def test_forced_index_hint_never_replans(skewed, sketch_on, monkeypatch):
    monkeypatch.setenv("GEOMESA_PLANNING_ESTIMATOR_ENABLED", "false")
    monkeypatch.setenv("GEOMESA_PLANNING_REPLAN_THRESHOLD", "2.0")
    monkeypatch.setenv("GEOMESA_PLANNING_REPLAN_MIN_ROWS", "64")
    _, lines = _same(*skewed, HOT, {"QUERY_INDEX": "z3"})
    assert not any("Replanning:" in ln for ln in lines)


@pytest.mark.parametrize("ecql", [
    HOT + " AND dtg DURING 2018-01-02T00:00:00Z/2018-01-05T00:00:00Z",
    "BBOX(geom,-77.06,42.99,-76.99,43.06)",
    "BBOX(geom,-80,35,-70,45) OR BBOX(geom,-74.06,39.99,-73.99,40.06)",
    "INCLUDE",
])
def test_estimator_costed_plans_match(skewed, sketch_on, ecql):
    _same(*skewed, ecql)


def test_estimator_below_row_floor_is_off(skewed, sketch_on, monkeypatch):
    monkeypatch.setenv("GEOMESA_PLANNING_ESTIMATOR_MIN_ROWS", str(N + 1))
    monkeypatch.setenv("GEOMESA_PLANNING_REPLAN_THRESHOLD", "0.0")
    r, _ = _same(*skewed, HOT)
    assert r.strategy.source in ("stats", "heuristic")
    assert r.strategy.max_ranges is None


# -- the estimator ---------------------------------------------------------
def test_z3_rows_and_budget_match_reference(skewed, sketch_on):
    jds, tds = skewed
    jest, test_ = jds._store("evt").estimator(), tds._store("evt").estimator()
    assert isinstance(test_, CardinalityEstimator)
    cases = [([(-180.0, -90.0, 180.0, 90.0)], [(MS_2018, MS_2018 + 14 * DAY)]),
             ([(-74.06, 39.99, -73.99, 40.06)], [(None, None)]),
             ([(-77.06, 42.99, -76.99, 43.06)], [(MS_2018, MS_2018 + 3 * DAY)]),
             ([(-75.0, 39.0, -73.0, 41.0), (-80.0, 35.0, -79.0, 36.0)],
              [(MS_2018, MS_2018 + DAY), (MS_2018 + 5 * DAY, None)])]
    for boxes, ivs in cases:
        assert test_.z3_rows(boxes, ivs) == jest.z3_rows(boxes, ivs)
    assert test_.z3_rows(*cases[0][:2]) == N
    for rows in (0, 1, 100, 10_000, 1_000_000, 10**9):
        assert (CardinalityEstimator.size_max_ranges(rows)
                == jest.size_max_ranges(rows))


def test_warm_estimates_do_no_device_work(skewed, sketch_on):
    _, tds = skewed
    st = tds._store("evt")
    est = st.estimator()
    est.z3_rows([(-74.06, 39.99, -73.99, 40.06)], [(MS_2018, None)])
    idx = st._indexes["z3"]
    d0 = idx.dispatch_count
    for _ in range(5):
        est.z3_rows([(-75.0, 39.0, -73.0, 41.0)],
                    [(MS_2018, MS_2018 + 7 * DAY)])
    assert idx.dispatch_count == d0   # cached per generation signature


def test_appends_invalidate_the_estimate(sketch_on):
    writes = _skewed_writes(seed=5)
    jds, tds = _both("name:String,score:Double,dtg:Date,*geom:Point;"
                     "geomesa.index.profile=lean,"
                     f"geomesa.lean.generation.slots={SLOTS},"
                     "geomesa.lean.compaction.factor=0", writes[:3])
    box, iv = [(-180.0, -90.0, 180.0, 90.0)], [(None, None)]
    for w in writes[3:6]:
        ests = [ds._store("evt").estimator() for ds in (jds, tds)]
        assert ests[1].z3_rows(box, iv) == ests[0].z3_rows(box, iv)
        for ds in (jds, tds):
            ds.write("evt", w)
    for ds in (jds, tds):
        ds.compact("evt")
    ests = [ds._store("evt").estimator() for ds in (jds, tds)]
    assert ests[1].z3_rows(box, iv) == ests[0].z3_rows(box, iv) == 6 * SLOTS


# -- the estimator's attribute tier (test_zz_planning.py) -----------------
ATTR_SPEC = ("name:String:index=true,score:Double:index=true,dtg:Date,"
             "*geom:Point;geomesa.index.profile=lean,"
             f"geomesa.lean.generation.slots={SLOTS},"
             "geomesa.lean.compaction.factor=0")


@pytest.fixture(scope="module")
def skewed_attr():
    """The JAX planning tests' store: the skewed points with indexed
    ``name`` (90% 'hot') and ``score`` attributes."""
    from geomesa_tpu.index.attr_lean import LeanAttrIndex as JaxAttr
    from geomesa_tpu_torch.index.attr_lean import LeanAttrIndex
    old = LeanAttrIndex.GENERATION_SLOTS
    # the suite runs the JAX index at CI-sized default generations
    LeanAttrIndex.GENERATION_SLOTS = JaxAttr.GENERATION_SLOTS
    yield _both(ATTR_SPEC, _skewed_writes())
    LeanAttrIndex.GENERATION_SLOTS = old


def test_attr_sketch_estimates(skewed_attr, sketch_on):
    jds, tds = skewed_attr
    jest, est = (ds._store("evt").estimator() for ds in (jds, tds))
    hot = est.attr_equals_rows("name", ("hot",))
    assert hot == jest.attr_equals_rows("name", ("hot",))
    truth = len(tds.query_result("evt", Query.of("name = 'hot'")).positions)
    # count-min overcounts only
    assert truth <= hot <= 1.25 * truth
    assert est.attr_equals_rows("name", ("hot", "cold", "nope")) == \
        jest.attr_equals_rows("name", ("hot", "cold", "nope"))
    for lo, hi in ((0.0, 50.0), (None, 10.0), (99.0, None), (60.0, 20.0)):
        assert est.attr_range_rows("score", lo, hi) == \
            jest.attr_range_rows("score", lo, hi)
    half = est.attr_range_rows("score", 0.0, 50.0)
    assert 0.3 * N <= half <= 0.7 * N
    # string attributes carry no histogram; unknown ones no sketch
    assert est.attr_range_rows("name", "a", "z") is None
    assert est.attr_equals_rows("nosuch", ("x",)) is None


@pytest.mark.parametrize("ecql", [
    "name = 'cold'",
    "name = 'hot' AND " + HOT,
    "score BETWEEN 10 AND 12",
    "score > 99.5 AND BBOX(geom,-80,35,-70,45)",
    "name IN ('cold', 'x') AND dtg DURING "
    "2018-01-02T00:00:00Z/2018-01-04T00:00:00Z",
])
def test_attr_plans_costed_alike(skewed_attr, sketch_on, ecql):
    r, _ = _same(*skewed_attr, ecql)
    if ecql == "name = 'cold'":
        assert (r.strategy.index, r.strategy.source) == \
            ("attr:name", "sketch")


def test_selectivity_defaults_are_configurable(monkeypatch):
    from geomesa_tpu.features.feature_type import parse_spec as jax_spec
    from geomesa_tpu.filters import parse_ecql as jax_ecql
    from geomesa_tpu.planning import StrategyDecider as JaxDecider
    from geomesa_tpu_torch.features.feature_type import parse_spec
    from geomesa_tpu_torch.filters.ecql import parse_ecql
    from geomesa_tpu_torch.planning.strategy import StrategyDecider
    spec = "name:String:index=true,dtg:Date,*geom:Point"
    d = StrategyDecider(parse_spec("t", spec), stats={}, total_count=1000)
    jd = JaxDecider(jax_spec("t", spec), stats={}, total_count=1000)
    rng = (None, "x", True, True)
    for kind, payload, want in (("equals", "x", 100.0), ("range", rng, 250.0),
                                ("in", ("x", "y"), 200.0)):
        assert d._attr_cost("name", kind, payload) == \
            jd._attr_cost("name", kind, payload) == (want, "heuristic")
    monkeypatch.setenv("GEOMESA_PLANNING_SELECTIVITY_EQUALS_DEFAULT", "0.5")
    monkeypatch.setenv("GEOMESA_PLANNING_SELECTIVITY_RANGE_DEFAULT", "0.9")
    assert d._attr_cost("name", "equals", "x") == \
        jd._attr_cost("name", "equals", "x") == (500.0, "heuristic")
    assert d._attr_cost("name", "range", rng)[0] == \
        jd._attr_cost("name", "range", rng)[0] == 900.0
    # the configured selectivity flows into real plans
    chosen, _ = d.decide_with_options(parse_ecql("name = 'x'"))
    jchosen, _ = jd.decide_with_options(jax_ecql("name = 'x'"))
    assert (chosen.index, chosen.cost, chosen.source) == \
        (jchosen.index, jchosen.cost, jchosen.source) == \
        ("attr:name", 500.0, "heuristic")
