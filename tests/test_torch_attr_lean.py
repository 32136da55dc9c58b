"""Port parity: the lean attribute tier of geomesa_tpu_torch against
geomesa_tpu — the order-preserving int64 lexicodes (bit-exact), the
generational ``LeanAttrIndex`` with device and host tiers (candidates,
tier counts, bytes, dispatch counts, compaction), and the lean store over
indexed attributes (strategy, cost, positions, ``query_indices``, each
index's tiers and bytes, the z3 budget carve-out)."""

import numpy as np
import pytest

from geomesa_tpu.datastore import TpuDataStore as JaxStore
from geomesa_tpu.index import attr_lean as jax_al
from geomesa_tpu_torch import TpuDataStore
from geomesa_tpu_torch.index import attr_lean as al
from geomesa_tpu_torch.index.attr_lean import LeanAttrIndex

MS = 1514764800000
DAY = 86_400_000
I64 = np.iinfo(np.int64)


@pytest.fixture(scope="module", autouse=True)
def _ci_generation_slots():
    """The suite's conftest runs the JAX lean attribute index at CI-sized
    default generations; the port's default follows it here, so store
    builds without ``geomesa.lean.generation.slots`` compare alike."""
    old = LeanAttrIndex.GENERATION_SLOTS
    LeanAttrIndex.GENERATION_SLOTS = jax_al.LeanAttrIndex.GENERATION_SLOTS
    yield
    LeanAttrIndex.GENERATION_SLOTS = old


# -- the lexicodes --------------------------------------------------------
def _numeric(kind):
    rng = np.random.default_rng(1)
    if kind in ("int", "integer"):
        return rng.integers(-2**31, 2**31 - 1, 3000).astype(np.int32)
    if kind in ("long", "date"):
        return np.r_[rng.integers(-10**17, 10**17, 3000),
                     [I64.max, I64.max - 1, I64.min, 0]]
    return np.r_[rng.normal(0, 1e3, 3000),
                 [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-308,
                  -1e-308, 1e308, -1e308, 5e-324, -5e-324]]


@pytest.mark.parametrize("kind", ["int", "integer", "long", "date", "float",
                                  "double"])
def test_numeric_encoding_bit_exact(kind):
    v = _numeric(kind)
    got = al.encode_attr_values(v, kind)
    np.testing.assert_array_equal(got, jax_al.encode_attr_values(v, kind))
    assert got.dtype == np.int64 and got.max() < I64.max
    for x in v[-6:]:
        assert al.encode_attr_value(x, kind) == \
            jax_al.encode_attr_value(x, kind)
    if kind in ("float", "double"):
        assert al.encode_attr_value(-0.0, kind) == \
            al.encode_attr_value(0.0, kind)
        finite = v[~np.isnan(v)]
        k = al.encode_attr_values(finite, kind)
        np.testing.assert_array_equal(np.sort(finite),
                                      finite[np.argsort(k, kind="stable")])


STRINGS = [
    np.array(["", "a", "ab", "abc", "abcdefgh", "abcdefghi", "zzz",
              "Zebra", "mid", "middle"], object),
    np.array(["ümlaut", "日本語テキスト", "abc", None, "", "\xff" * 9,
              "naïve-café"], object),
    np.array(["abc", None, "None", ""], object),
    np.array(["USA", "GBR", "FRA"]),
    np.array(["", "abcdefghij", "ab\x7f", "x" * 20]),
    np.array(["ümlaut", "abc", ""]),
    np.array([], dtype="U3"),
]


@pytest.mark.parametrize("words", STRINGS, ids=["ascii", "unicode", "none",
                                                "fixed", "fixed-long",
                                                "fixed-unicode",
                                                "fixed-empty"])
def test_string_encoding_bit_exact(words):
    got = al.encode_attr_values(words, "string")
    np.testing.assert_array_equal(got,
                                  jax_al.encode_attr_values(words, "string"))
    assert not len(got) or got.max() < I64.max
    for p in ("", "ab", "ü", "abcdefghij"):
        assert al.string_prefix_bounds(p) == jax_al.string_prefix_bounds(p)


def test_unindexable_type_rejected():
    with pytest.raises(TypeError, match="not indexable"):
        LeanAttrIndex("b", "bytes", device="cpu")
    with pytest.raises(TypeError, match="not indexable"):
        al.encode_attr_values(np.array([b"x"]), "bytes")


# -- the index: the JAX index on the same appends -------------------------
SLOTS = 1 << 12


@pytest.fixture(scope="module")
def attr_data():
    rng = np.random.default_rng(5)
    n = 60_000
    names = rng.choice(np.array(["alpha", "beta", "gamma", "delta", "rare"],
                                object), n, p=[.4, .3, .2, .099, .001])
    vals = rng.integers(0, 1000, n)
    score = rng.normal(0, 50, n)
    score[::997] = -0.0
    score[5::1999] = np.inf
    dtg = rng.integers(MS, MS + 14 * DAY, n)
    return names, vals, score, dtg


def _pair(attr_type, col, dtg, budget, chunk=7000):
    got = LeanAttrIndex("a", attr_type, generation_slots=SLOTS,
                        hbm_budget_bytes=budget, device="cpu")
    want = jax_al.LeanAttrIndex("a", attr_type, generation_slots=SLOTS,
                                hbm_budget_bytes=budget)
    for lo in range(0, len(col), chunk):
        sl = slice(lo, lo + chunk)
        got.append(col[sl], dtg[sl])
        want.append(col[sl], dtg[sl])
    return got, want


def _same_state(got, want):
    assert got.tier_counts() == want.tier_counts()
    assert got.device_bytes() == want.device_bytes()
    assert got.host_key_bytes() == want.host_key_bytes()
    assert got.dispatch_count == want.dispatch_count
    assert len(got) == len(want)
    assert [g.n for g in got.generations] == [g.n for g in want.generations]


def _same(got, want, call):
    d0, j0 = got.dispatch_count, want.dispatch_count
    a, b = call(got), call(want)
    np.testing.assert_array_equal(a, np.sort(b))
    assert got.dispatch_count - d0 == want.dispatch_count - j0
    return a


W = (MS + 2 * DAY, MS + 5 * DAY)


@pytest.mark.parametrize("budget", [3 * SLOTS * 20, 100 * SLOTS * 20],
                         ids=["spilled", "device"])
def test_string_index_matches_reference(attr_data, budget):
    names, _, _, dtg = attr_data
    got, want = _pair("string", names, dtg, budget)
    _same_state(got, want)
    if budget < 10 * SLOTS * 20:
        assert got.tier_counts()["host"] >= 1
    for call in (lambda i: i.query_equals("gamma"),
                 lambda i: i.query_equals("gamma", sec_window=W),
                 lambda i: i.query_equals("rare", sec_window=(None, W[1])),
                 lambda i: i.query_in(["alpha", "nope", "delta"], W),
                 lambda i: i.query_in([]),
                 lambda i: i.query_range("beta", "delta"),
                 lambda i: i.query_range(None, "beta", True, False),
                 lambda i: i.query_prefix("de"),
                 lambda i: i.query_prefix("")):
        _same(got, want, call)
    np.testing.assert_array_equal(
        _same(got, want, lambda i: i.query_equals("gamma")),
        np.flatnonzero(names == "gamma"))
    # compaction: merge groups alike, answers unchanged at every step
    for _ in range(3):
        assert got.compact(factor=4, max_groups=1) == \
            want.compact(factor=4, max_groups=1)
        _same_state(got, want)
        _same(got, want, lambda i: i.query_in(["rare", "beta"], W))
    assert got.compactions == want.compactions


@pytest.mark.parametrize("kind,col", [("long", 1), ("double", 2)])
def test_numeric_index_matches_reference(attr_data, kind, col):
    data = attr_data[col]
    dtg = attr_data[3]
    got, want = _pair(kind, data, dtg, 5 * SLOTS * 20, chunk=9000)
    _same_state(got, want)
    lo, hi = (100, 300) if kind == "long" else (-10.0, 0.0)
    for call in (lambda i: i.query_range(lo, hi, True, False),
                 lambda i: i.query_range(hi, None),
                 lambda i: i.query_range(None, lo),
                 lambda i: i.query_equals(data[3], W),
                 lambda i: i.query_in([data[0], data[1], data[2]]),
                 lambda i: i.query_equals(0.0 if kind == "double" else 7),
                 lambda i: i.query_range(data.max(), None)):
        _same(got, want, call)
    assert got.compact() == want.compact()
    _same_state(got, want)
    _same(got, want, lambda i: i.query_range(hi, None))


def test_fixed_dispatches_and_storage(attr_data):
    names, vals, _, dtg = attr_data
    got, want = _pair("long", vals, dtg, 100 * SLOTS * 20, chunk=60_000)
    assert got.tier_counts()["host"] == 0
    d0 = got.dispatch_count
    _same(got, want, lambda i: i.query_equals(vals[0]))
    # one totals probe + one gather over every device generation
    assert got.dispatch_count - d0 == 2
    s, j = got.storage_stats(), want.storage_stats()
    for k in ("rows", "attr", "tiers", "device_bytes", "host_bytes",
              "hbm_budget_bytes"):
        assert s[k] == j[k]
    assert [(g["tier"], g["rows"], g["capacity"]) for g in s["generations"]] \
        == [(g["tier"], g["rows"], g["capacity"]) for g in j["generations"]]


def test_generation_listeners_fire_on_seal_and_merge(attr_data):
    names, _, _, dtg = attr_data
    got, want = (cls("a", "string", generation_slots=SLOTS,
                     **({"device": "cpu"} if cls is LeanAttrIndex else {}))
                 for cls in (LeanAttrIndex, jax_al.LeanAttrIndex))
    seen: dict = {id(got): [], id(want): []}
    for idx in (got, want):
        idx.generation_listeners.append(
            lambda kind, ids, i=idx: seen[id(i)].append((kind, ids)))
        idx.append(names[:5 * SLOTS], dtg[:5 * SLOTS])
        idx.compact(factor=2)
    assert seen[id(got)] == seen[id(want)]
    assert [k for k, _ in seen[id(got)]].count("seal") == 4


# -- the lean store (test_lean_attr.py's store) ---------------------------
N = 60_000
#: one full, three keys and the rest host generations for the z3 index
#: under the carve-out (0.75 of this budget)
BUDGET = SLOTS * 200
SPEC = ("name:String:index=true,score:Double:index=true,flag:Boolean:"
        "index=true,dtg:Date,*geom:Point;geomesa.index.profile=lean,"
        f"geomesa.lean.generation.slots={SLOTS},"
        f"geomesa.lean.hbm.budget={BUDGET},geomesa.lean.compaction.factor=0")


@pytest.fixture(scope="module")
def lean_stores():
    rng = np.random.default_rng(7)
    names = rng.choice(np.array(["alpha", "beta", "gamma", "delta", "rare"],
                                object), N, p=[.4, .3, .2, .099, .001])
    rows = {"name": names, "score": rng.uniform(0, 100, N),
            "flag": rng.choice([True, False], N),
            "dtg": rng.integers(MS, MS + 14 * DAY, N),
            "geom": (rng.uniform(-75, -73, N), rng.uniform(40, 42, N))}
    tds, jds = TpuDataStore(device="cpu"), JaxStore()
    for ds in (tds, jds):
        ds.create_schema("evt", SPEC)
        for lo in range(0, N, 25_000):
            ds.write("evt", {k: (v[0][lo:lo + 25_000], v[1][lo:lo + 25_000])
                             if isinstance(v, tuple) else v[lo:lo + 25_000]
                             for k, v in rows.items()})
    return tds, jds


ECQL = [
    "name = 'rare'",
    "name = 'rare' AND BBOX(geom, -75, 40, -73, 42)",
    "name IN ('rare', 'delta')",
    "name LIKE 'ga%'",
    "score > 99.5",
    "score BETWEEN 10.0 AND 10.6",
    "name = 'alpha' AND dtg DURING 2018-01-02T00:00:00Z/2018-01-03T00:00:00Z",
    "name = 'alpha' AND BBOX(geom, -74.01, 40.99, -73.99, 41.01)",
    "flag = true AND BBOX(geom, -74.5, 40.5, -73.5, 41.5)",
    "name = 'beta' OR name = 'rare'",
]


@pytest.mark.parametrize("ecql", ECQL)
def test_lean_store_attr_queries_match_reference(lean_stores, ecql):
    tds, jds = lean_stores
    got, want = (ds.query_result("evt", ecql) for ds in (tds, jds))
    assert (got.strategy.index, got.strategy.source) == \
        (want.strategy.index, want.strategy.source)
    assert got.strategy.cost == want.strategy.cost
    np.testing.assert_array_equal(got.positions, want.positions)


def test_lean_store_indexes_match_reference(lean_stores):
    tds, jds = lean_stores
    st, jst = tds._store("evt"), jds._store("evt")
    assert st.query_indices == jst.query_indices == {"z3", "id", "attr"}
    assert st._lean_attr_names() == jst._lean_attr_names() == \
        ["name", "score"]
    for key in ("z3", "attr:name", "attr:score"):
        got, want = st._indexes[key], jst._indexes[key]
        assert got.tier_counts() == want.tier_counts(), key
        assert got.device_bytes() == want.device_bytes(), key
        assert got.hbm_budget_bytes == want.hbm_budget_bytes, key
        assert st.build_counts[key] == jst.build_counts[key] == 1
        assert st._index_coverage.get(key, N) == jst._index_coverage[key] \
            == N
    assert tds.query_result("evt", ECQL[0]).strategy.index == "attr:name"


def test_z3_budget_carve_out(lean_stores):
    """With lean attribute indexes the z3 index gets 0.75 of the lean
    budget, as in the JAX store, and its tiers follow; without them it
    keeps the whole budget."""
    tds, jds = lean_stores
    z3 = tds._store("evt")._indexes["z3"]
    assert z3.hbm_budget_bytes == int(BUDGET * 0.75) == \
        jds._store("evt")._indexes["z3"].hbm_budget_bytes
    assert z3.tier_counts() == {"full": 1, "keys": 3, "host": 11}
    plain = TpuDataStore(device="cpu")
    plain.create_schema("p", SPEC.replace(":index=true", ""))
    plain.write("p", {"name": np.array(["a"] * 10, object),
                      "score": np.zeros(10), "flag": np.ones(10, bool),
                      "dtg": np.full(10, MS),
                      "geom": (np.zeros(10), np.zeros(10))})
    assert plain._store("p").query_indices == {"z3", "id"}
    assert plain._store("p")._indexes["z3"].hbm_budget_bytes == BUDGET


def test_lean_store_compaction_matches_reference(lean_stores):
    tds, jds = lean_stores
    assert tds.compact("evt") == jds.compact("evt")
    for ecql in ECQL[:3]:
        got, want = (ds.query_result("evt", ecql) for ds in (tds, jds))
        np.testing.assert_array_equal(got.positions, want.positions)


def test_fixed_width_string_column_answers_alike():
    """A lean write of a fixed-width string column keeps it fixed-width
    (no Python string a row), and answers, stats and result rows equal
    the JAX store's, which stores an object column."""
    rng = np.random.default_rng(3)
    n = 20_000
    codes = np.array(["USA", "UKR", "GBR", "FRA", "ÜML"])
    rows = {"name": codes[rng.integers(0, len(codes), n)],
            "score": np.round(rng.integers(-100, 101, n) / 10.0, 1),
            "flag": rng.choice([True, False], n),
            "dtg": rng.integers(MS, MS + 30 * DAY, n),
            "geom": (rng.uniform(-10, 10, n), rng.uniform(-10, 10, n))}
    tds, jds = TpuDataStore(device="cpu"), JaxStore()
    for ds in (tds, jds):
        ds.create_schema("evt", SPEC)
        ds.write("evt", rows)
    assert tds._store("evt").batch.column("name").dtype.kind == "U"
    for ecql in ("name = 'UKR'", "name LIKE 'U%'", "name < 'G'",
                 "name IN ('USA', 'FRA', 'ÜML', 'GBR', 'x') AND dtg DURING "
                 "2018-01-02T00:00:00Z/2018-01-05T00:00:00Z",
                 "name > 5", "score BETWEEN 2.95 AND 3.05"):
        got, want = (ds.query_result("evt", ecql) for ds in (tds, jds))
        assert got.strategy.index == want.strategy.index
        np.testing.assert_array_equal(got.positions, want.positions)
        assert got.batch.column("name").dtype == object
        np.testing.assert_array_equal(got.batch.column("name"),
                                      want.batch.column("name"))
    for spec in ("Enumeration(name)", "TopK(name)", "Count()"):
        assert tds.stats("evt", "name LIKE 'U%'", spec).to_json() == \
            jds.stats("evt", "name LIKE 'U%'", spec).to_json()
