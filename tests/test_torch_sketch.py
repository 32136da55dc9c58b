"""Port parity: the lean sketch push-down of geomesa_tpu_torch against
geomesa_tpu — the spec classifier (``plan_pushdown``), the client-side
fill of attribute stats, ``LeanZ3Index.z3_cell_counts`` on every tier
and across compaction, and the store's whole-extent Count and
Z3Histogram stats, which must also equal the materialized answer."""

import dataclasses

import numpy as np
import pytest

from geomesa_tpu.datastore import TpuDataStore as JaxStore
from geomesa_tpu.index.z3_lean import LeanZ3Index as JaxLean
from geomesa_tpu.stats import sketch as jax_sketch
from geomesa_tpu.stats.stat import parse_stat as jax_parse
from geomesa_tpu_torch import TpuDataStore
from geomesa_tpu_torch.curve.binnedtime import TimePeriod
from geomesa_tpu_torch.index.z3_lean import LeanZ3Index
from geomesa_tpu_torch.stats import sketch
from geomesa_tpu_torch.stats.stat import Z3HistogramStat, parse_stat

MS = 1514764800000
DAY = 86_400_000
SLOTS = 1 << 11
I64 = np.iinfo(np.int64)

SPECS = [
    "Count()", "Count();Count()", "Z3Histogram(geom,dtg,week,10)",
    "Count();Z3Histogram(geom,dtg,week,8)", "Z3Histogram(geom,dtg,day,10)",
    "Z3Histogram(other,dtg,week,10)", "MinMax(score)", "MinMax(name)",
    "Histogram(score,10,0,100)", "Histogram(score,10,0,100);"
    "Histogram(score,20,0,100)", "Frequency(k,4,64)",
    "Frequency(k,4,64);Frequency(k,2,64)", "TopK(k);Enumeration(k)",
    "DescriptiveStats(score);Count()", "GroupBy(k,Count())", "MinMax(nope)",
]
ATTRS = [{}, {"score": "Double", "k": "Int", "name": "String"},
         {"name": "String"}]


def _plan_view(p):
    if p is None:
        return None
    return ({a: (dataclasses.asdict(f), [type(s).__name__ for s in g])
             for a, (f, g) in p.attr_groups.items()},
            [(s.period, s.bits) for s in p.z3hists], len(p.counts),
            p.count_source)


@pytest.mark.parametrize("attrs", ATTRS, ids=["none", "numeric", "string"])
@pytest.mark.parametrize("t_open", [True, False], ids=["open", "window"])
@pytest.mark.parametrize("spec", SPECS)
def test_plan_pushdown_classifies_like_reference(spec, attrs, t_open):
    from geomesa_tpu.curve.binnedtime import TimePeriod as JaxPeriod
    slo, shi = (int(I64.min), int(I64.max)) if t_open else (MS, MS + DAY)
    got = sketch.plan_pushdown(
        sketch.flatten_stats(parse_stat(spec)), attrs, "z3", "geom", "dtg",
        slo, shi, t_open, z3_period=TimePeriod.WEEK)
    want = jax_sketch.plan_pushdown(
        jax_sketch.flatten_stats(jax_parse(spec)), attrs, "z3", "geom",
        "dtg", slo, shi, t_open, z3_period=JaxPeriod.WEEK)
    assert _plan_view(got) == _plan_view(want)


@pytest.mark.parametrize("attr_type", ["Double", "Int", "Date"])
def test_fill_stats_from_partial_matches_reference(attr_type):
    rng = np.random.default_rng(2)
    vals = (rng.normal(0, 50, 100) if attr_type == "Double"
            else rng.integers(-1000, 1000, 100))
    if attr_type == "Double":
        bits = vals.view(np.int64)
        keys = np.where(bits < 0, (np.int64(-1) - (bits ^ I64.min)), bits)
    else:
        keys = vals.astype(np.int64)
    np.testing.assert_array_equal(
        sketch.decode_attr_keys(keys, attr_type),
        jax_sketch.decode_attr_keys(keys, attr_type))
    uniq, cnt = np.unique(vals, return_counts=True)
    part = jax_sketch.RunSketch(
        count=100, kmin=int(keys.min()), kmax=int(keys.max()),
        vsum=float(vals.sum()), vsumsq=float((vals * vals).sum()),
        hist=np.arange(8, dtype=np.int64), cms=np.ones((2, 16), np.int64),
        values={(float(v) if attr_type == "Double" else int(v)): int(c)
                for v, c in zip(uniq, cnt)})
    spec = "MinMax(a);DescriptiveStats(a);Histogram(a,8,0,1);" \
           "Frequency(a,2,16);Enumeration(a);TopK(a,5)"
    got = sketch.flatten_stats(parse_stat(spec))
    want = jax_sketch.flatten_stats(jax_parse(spec))
    sketch.fill_stats_from_partial(got, part, attr_type)
    jax_sketch.fill_stats_from_partial(want, part, attr_type)
    for g, w in zip(got, want):
        assert g.to_json() == w.to_json()


# -- z3_cell_counts --------------------------------------------------------
def _data(n, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-75, -73, n), rng.uniform(40, 42, n),
            rng.integers(MS, MS + 40 * DAY, n))


def _streamed(n_gens, payload, budget):
    x, y, t = _data(n_gens * SLOTS + 300)
    kw = dict(period="week", generation_slots=SLOTS,
              payload_on_device=payload, hbm_budget_bytes=budget,
              compaction_factor=0)
    jidx, tidx = JaxLean(**kw), LeanZ3Index(device="cpu", **kw)
    for lo in range(0, len(x), SLOTS):
        sl = slice(lo, lo + SLOTS)
        jidx.append(x[sl], y[sl], t[sl])
        tidx.append(x[sl], y[sl], t[sl])
    return jidx, tidx, (x, y, t)


def _oracle_cells(x, y, t, bits):
    s = Z3HistogramStat("geom", "dtg", "week", bits)

    class _B:
        def geom_xy(self, g):
            return x, y

        def column(self, c):
            return t

    s.observe(_B())
    return s.counts


@pytest.mark.parametrize("payload,budget", [
    (True, None), (False, None),
    (True, SLOTS * (40 + 16 + 40) + SLOTS * 16 * 2)],
    ids=["full", "keys", "all-tiers"])
def test_z3_cell_counts_match_reference_and_survive_compaction(payload,
                                                                budget):
    jidx, tidx, (x, y, t) = _streamed(9, payload, budget)
    assert tidx.tier_counts() == jidx.tier_counts()
    for bits in (6, 10, 14):
        got = tidx.z3_cell_counts(bits)
        assert got == jidx.z3_cell_counts(bits)
        assert got == _oracle_cells(x, y, t, bits)
    # warm: only the live generation folds again
    d0 = tidx.dispatch_count
    assert tidx.z3_cell_counts(10) == jidx.z3_cell_counts(10)
    assert tidx.dispatch_count - d0 <= 1
    sealed = [g.gen_id for g in tidx.generations[:-1]]
    cache = next(c for s, c in tidx._sketch_cache.items()
                 if s[:2] == ("z3cells", 10))
    assert set(sealed) <= set(cache)
    res = tidx.compact(factor=2)
    assert res == jidx.compact(factor=2)
    # full-tier runs never merge; keys and host runs do
    assert (res["merged_groups"] >= 1) == (tidx.tier_counts()["full"] < 9)
    live_ids = {g.gen_id for g in tidx.generations}
    assert set(cache) <= live_ids        # merged-away partials dropped
    assert tidx.z3_cell_counts(10) == jidx.z3_cell_counts(10) \
        == _oracle_cells(x, y, t, 10)


def test_z3_cell_counts_empty_index():
    assert LeanZ3Index(device="cpu").z3_cell_counts(10) == {}


# -- the store's push-down -------------------------------------------------
SPEC = ("score:Double,k:Int,dtg:Date,*geom:Point;"
        "geomesa.index.profile=lean,"
        f"geomesa.lean.generation.slots={SLOTS},"
        f"geomesa.lean.hbm.budget={SLOTS * (40 + 16 + 40) + SLOTS * 16 * 2},"
        "geomesa.lean.compaction.factor=0")
WORLD = "BBOX(geom,-180,-90,180,90)"


@pytest.fixture(scope="module")
def stores():
    rng = np.random.default_rng(11)
    n = 8 * SLOTS + 500
    x, y, t = _data(n, seed=11)
    d = {"score": rng.normal(50.0, 20.0, n), "k": rng.integers(0, 40, n)}
    jds, tds = JaxStore(), TpuDataStore(device="cpu")
    for ds in (jds, tds):
        ds.create_schema("evt", SPEC)
        for lo in range(0, n, SLOTS):
            sl = slice(lo, lo + SLOTS)
            ds.write("evt", {"score": d["score"][sl], "k": d["k"][sl],
                             "dtg": t[sl], "geom": (x[sl], y[sl])})
    return jds, tds, (x, y, t)


class _NoMaterialize:
    """Wraps a store so that a materializing query fails the test."""

    def __init__(self, ds, monkeypatch):
        def refuse(*a, **kw):
            raise AssertionError("the stat materialized its hits")
        monkeypatch.setattr(ds, "query_result", refuse)


@pytest.mark.parametrize("query", ["INCLUDE", WORLD,
                                   f"{WORLD} AND dtg AFTER "
                                   "2017-01-01T00:00:00Z"])
@pytest.mark.parametrize("spec", [
    "Count()", "Z3Histogram(geom,dtg,week,10)",
    "Count();Z3Histogram(geom,dtg,week,6)"])
def test_whole_extent_stats_push_down(stores, monkeypatch, query, spec):
    jds, tds, (x, y, t) = stores
    want = jds.stats("evt", query, spec).to_json()
    materialized = tds.stats("evt", f"{query} AND score > -1e9",
                             spec).to_json()
    _NoMaterialize(tds, monkeypatch)
    got = tds.stats("evt", query, spec)
    assert got.to_json() == want == materialized
    for s in sketch.flatten_stats(got):
        if isinstance(s, Z3HistogramStat):
            assert s.counts == _oracle_cells(x, y, t, s.bits)
        else:
            assert s.count == len(x)


@pytest.mark.parametrize("query,spec", [
    ("BBOX(geom,-74.5,40.5,-73.5,41.5)", "Z3Histogram(geom,dtg,week,10)"),
    (f"{WORLD} AND dtg DURING 2018-01-03T00:00:00Z/2018-01-10T00:00:00Z",
     "Z3Histogram(geom,dtg,week,10)"),
    ("INCLUDE", "Z3Histogram(geom,dtg,day,10)"),
    ("INCLUDE", "Count();MinMax(score)"),
])
def test_unpushable_stats_materialize_alike(stores, query, spec):
    jds, tds, _ = stores
    assert tds.stats("evt", query, spec).to_json() == \
        jds.stats("evt", query, spec).to_json()
