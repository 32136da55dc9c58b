"""Port parity: the lean sketch push-down of geomesa_tpu_torch against
geomesa_tpu — the spec classifier (``plan_pushdown``), the client-side
fill of attribute stats, ``LeanZ3Index.z3_cell_counts`` on every tier
and across compaction, the store's whole-extent Count and Z3Histogram
stats, the attribute folds (``device_fold_body``, ``fold_attr_runs``,
``RunSketch``, the estimator's probes) and the store's attribute
push-down, which must also equal the materialized answer."""

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

@pytest.fixture(scope="module", autouse=True)
def _ci_generation_slots():
    """The suite's conftest runs the JAX lean attribute index at CI-sized
    default generations, which set its budget floor; the port's default
    follows it here."""
    from geomesa_tpu.index.attr_lean import LeanAttrIndex as JaxAttr
    from geomesa_tpu_torch.index.attr_lean import LeanAttrIndex
    old = LeanAttrIndex.GENERATION_SLOTS
    LeanAttrIndex.GENERATION_SLOTS = JaxAttr.GENERATION_SLOTS
    yield
    LeanAttrIndex.GENERATION_SLOTS = old


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


# -- the attribute folds ---------------------------------------------------
def _run(attr_type, n=3000, seed=3):
    """One (key, sec) run of a lean attribute index: sorted keys with a
    sentinel tail, as a device generation holds them."""
    from geomesa_tpu_torch.index.attr_lean import encode_attr_values
    rng = np.random.default_rng(seed)
    if attr_type == "double":
        v = rng.normal(50.0, 30.0, n)
        v[::211] = -0.0
        v[3::307] = np.inf
        v[5::401] = -np.inf
        v[7::503] = np.nan
    elif attr_type == "date":
        v = rng.integers(MS, MS + 30 * DAY, n)
    else:
        v = rng.integers(-500, 500, n)
    k = encode_attr_values(v, attr_type)
    s = rng.integers(0, 100, n)
    order = np.lexsort((s, k))
    pad = 37
    return (np.r_[k[order], np.full(pad, I64.max)],
            np.r_[s[order], np.full(pad, I64.max)])


FOLDS = [
    dict(slo=int(I64.min), shi=int(I64.max)),
    dict(slo=10, shi=80, bins=16, hlo=0.0, hhi=100.0, depth=3, width=64),
    dict(slo=0, shi=50, bins=7, hlo=-200.0, hhi=250.0),
    dict(slo=90, shi=120, depth=4, width=2048),
    dict(slo=200, shi=300, bins=4, hlo=0.0, hhi=1.0, depth=2, width=32),
]


@pytest.mark.parametrize("fold", FOLDS, ids=["open", "all", "hist", "cms",
                                             "empty"])
@pytest.mark.parametrize("attr_type", ["long", "double", "date"])
def test_device_fold_body_matches_reference(attr_type, fold, monkeypatch):
    """The torch device fold against the JAX one on the same run:
    counts, key min/max, histogram and count-min exact; the float64
    moment sums within rtol 1e-12 (they reduce in another order)."""
    import jax.numpy as jnp
    import torch
    k, s = _run(attr_type)
    f = sketch.SketchFold(**fold)
    is_float = attr_type == "double"
    want = [np.asarray(a) for a in jax_sketch.device_fold_body(
        jnp.asarray(k), jnp.asarray(s), jnp.int64(f.slo), jnp.int64(f.shi),
        jnp.float64(f.hlo), jnp.float64(f.hhi), bins=f.bins, depth=f.depth,
        width=f.width, is_float=is_float)]
    for kernel in (False, True):
        got = [t.numpy() for t in sketch.device_fold_body(
            torch.from_numpy(k), torch.from_numpy(s), f.slo, f.shi, f.hlo,
            f.hhi, bins=f.bins, depth=f.depth, width=f.width,
            is_float=is_float, hist_kernel=kernel)]
        for i in (0, 1, 2, 5, 6):
            np.testing.assert_array_equal(got[i], want[i])
        np.testing.assert_allclose(got[3:5], want[3:5], rtol=1e-12)


@pytest.mark.parametrize("attr_type", ["long", "double", "date"])
def test_fold_attr_runs_matches_reference(attr_type):
    runs = [_run(attr_type, n, seed) for n, seed in ((900, 1), (0, 2),
                                                      (2500, 3))]
    for fold in FOLDS + [dict(slo=10, shi=80, want_values=True)]:
        got = sketch.fold_attr_runs(runs, sketch.SketchFold(**fold),
                                    attr_type)
        want = jax_sketch.fold_attr_runs(
            runs, jax_sketch.SketchFold(**fold), attr_type)
        # (NaN moments compare equal here; the folds are the same numpy)
        _json_close([p.to_json() for p in got], [p.to_json() for p in want])
        merged = got[0] + got[1] + got[2]
        _json_close(merged.to_json(), (want[0] + want[1] + want[2]).to_json())
        _json_close(sketch.RunSketch.from_json(merged.to_json()).to_json(),
                    merged.to_json())
        _json_close((sketch.RunSketch() + merged).to_json(),
                    merged.to_json())


@pytest.mark.parametrize("attr_type", ["long", "double"])
def test_sketch_probes_match_reference(attr_type):
    runs = [_run(attr_type, 4000, 9)]
    fold = dict(bins=32, hlo=-100.0, hhi=200.0, depth=4, width=256)
    got = sketch.fold_attr_runs(runs, sketch.SketchFold(**fold),
                                attr_type)[0]
    want = jax_sketch.fold_attr_runs(runs, jax_sketch.SketchFold(**fold),
                                     attr_type)[0]
    f, jf = sketch.SketchFold(**fold), jax_sketch.SketchFold(**fold)
    for v in (0, 7, -3, 499, 10_000, "x", None):
        assert sketch.sketch_equals_count(got, f, v, attr_type) == \
            jax_sketch.sketch_equals_count(want, jf, v, attr_type)
    for lo, hi in ((None, None), (0, 50), (-1e9, 10), (30.5, None),
                   (60, 20), ("a", 3)):
        assert sketch.sketch_range_count(got, f, lo, hi) == \
            jax_sketch.sketch_range_count(want, jf, lo, hi)
    empty = sketch.RunSketch()
    assert sketch.sketch_equals_count(empty, f, 1, attr_type) == 0
    no_cms = sketch.SketchFold(bins=4)
    assert sketch.sketch_equals_count(got, no_cms, 1, attr_type) is None
    assert sketch.sketch_range_count(got, sketch.SketchFold(), 0, 1) is None


# -- the store's attribute push-down (test_zz_sketch_pushdown.py) ----------
ATTR_SLOTS = 1 << 12
ATTR_RUNS = 16
ATTR_SPEC = ("name:String:index=true,score:Double:index=true,"
             "k:Int:index=true,dtg:Date,*geom:Point;"
             "geomesa.index.profile=lean,"
             f"geomesa.lean.generation.slots={ATTR_SLOTS},"
             "geomesa.lean.compaction.factor=0")
DURING = "dtg DURING 2018-01-03T00:00:00Z/2018-01-10T00:00:00Z"
T_LO, T_HI = MS + 2 * DAY, MS + 9 * DAY


@pytest.fixture(scope="module")
def attr_stores():
    rng = np.random.default_rng(11)
    n = ATTR_RUNS * ATTR_SLOTS
    d = {"x": rng.uniform(-75, -73, n), "y": rng.uniform(40, 42, n),
         "t": rng.integers(MS, MS + 14 * DAY, n),
         "score": rng.normal(50.0, 20.0, n), "k": rng.integers(0, 40, n),
         "name": rng.choice(np.array(["a", "b", "c"], object), n)}
    jds, tds = JaxStore(), TpuDataStore(device="cpu")
    for ds in (jds, tds):
        ds.create_schema("evt", ATTR_SPEC)
        for lo in range(0, n, ATTR_SLOTS):
            sl = slice(lo, lo + ATTR_SLOTS)
            ds.write("evt", {"name": d["name"][sl], "score": d["score"][sl],
                             "k": d["k"][sl], "dtg": d["t"][sl],
                             "geom": (d["x"][sl], d["y"][sl])})
    return jds, tds, d


def _json_close(got, want):
    """Stat JSON equal, float moments within rtol 1e-12."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for key in want:
            _json_close(got[key], want[key])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _json_close(g, w)
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=1e-12)
    else:
        assert got == want


@pytest.mark.parametrize("query,spec", [
    (f"{WORLD} AND {DURING}",
     "Count();MinMax(score);Histogram(score,20,0,100)"),
    (f"{WORLD} AND {DURING}",
     "DescriptiveStats(score);Frequency(k,4,256);Enumeration(k);TopK(k)"),
    (f"{WORLD} AND {DURING}", "Count()"),
    ("INCLUDE", "MinMax(k);Histogram(k,8,0,40);Count()"),
    ("INCLUDE", "Frequency(score,4,1024)"),
])
def test_attr_stats_push_down_like_reference(attr_stores, monkeypatch, query,
                                             spec):
    """Attribute sub-stats on a lean store fold over the attribute keys
    (no hit materializes), equal the JAX store's and the materialized
    answer; a Count rides the fold for a selective time window."""
    jds, tds, d = attr_stores
    want = jds.stats("evt", query, spec).to_json()
    materialized = tds.stats("evt", f"({query}) AND score > -1e9",
                             spec).to_json()
    _NoMaterialize(tds, monkeypatch)
    got = tds.stats("evt", query, spec).to_json()
    _json_close(got, want)
    _json_close(got, materialized)
    m = ((d["t"] >= T_LO) & (d["t"] <= T_HI) if "DURING" in query
         else np.ones(len(d["t"]), bool))
    for s in sketch.flatten_stats(tds.stats("evt", query, spec)):
        if s.kind == "count":
            assert s.count == int(m.sum())
        elif s.kind == "minmax":
            assert s.min == d[s.attr][m].min() and s.max == d[s.attr][m].max()


def test_attr_sketch_scan_cache_and_compaction(attr_stores):
    """Sealed runs' partials cache per fold; compaction mints fresh runs,
    drops the merged-away partials, and the refold equals the JAX
    index's and the oracle."""
    jds, tds, d = attr_stores
    idx = tds._store("evt")._lean_attr_index("k")
    jidx = jds._store("evt")._lean_attr_index("k")
    fold = sketch.SketchFold(slo=T_LO, shi=T_HI, bins=8, hlo=0.0, hhi=40.0)
    jfold = jax_sketch.SketchFold(slo=T_LO, shi=T_HI, bins=8, hlo=0.0,
                                  hhi=40.0)
    before = idx.sketch_scan(fold)
    assert before.to_json() == jidx.sketch_scan(jfold).to_json()
    cache = idx._sketch_cache.spec_cache(fold)
    dead = [g.gen_id for g in idx.generations[:-1]]
    assert set(dead) <= set(cache)
    d0 = idx.dispatch_count
    assert idx.sketch_scan(fold).to_json() == before.to_json()
    assert idx.dispatch_count - d0 == 1     # the live run only
    assert idx.compact(factor=4) == jidx.compact(factor=4)
    live = {g.gen_id for g in idx.generations}
    assert set(cache) <= live
    after = idx.sketch_scan(fold)
    assert after.to_json() == before.to_json() == \
        jidx.sketch_scan(jfold).to_json()
    m = (d["t"] >= T_LO) & (d["t"] <= T_HI)
    np.testing.assert_array_equal(
        after.hist, np.bincount(np.clip(d["k"][m] * 8 // 40, 0, 7),
                                minlength=8))


def test_string_attr_stats_materialize_alike(attr_stores):
    jds, tds, _ = attr_stores
    for spec in ("Enumeration(name)", "MinMax(score);MinMax(name)"):
        assert tds.stats("evt", f"{WORLD} AND {DURING}", spec).to_json() \
            == jds.stats("evt", f"{WORLD} AND {DURING}", spec).to_json()
