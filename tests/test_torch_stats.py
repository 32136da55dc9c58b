"""Port parity: the sharded stats of geomesa_tpu_torch (moments,
histograms and count-min sketches per shard, summed) and its
``stats_process`` against geomesa_tpu's on the same rows, on an 8-shard
CPU mesh against the suite's 8-device virtual mesh.

Tolerances: counts, min, max, histograms and count-min tables are exact;
float64 sums (sum, sumsq) are taken per shard in another order than
XLA's, so they agree within rtol 1e-12."""

import warnings

import numpy as np
import pytest
import torch

from geomesa_tpu.datastore import TpuDataStore as JaxStore
from geomesa_tpu.parallel import device_mesh as jax_mesh
from geomesa_tpu.parallel import merged_stats as jax_merged_stats
from geomesa_tpu.parallel import sharded_frequency_scan as jax_freq
from geomesa_tpu.parallel import sharded_stats_scan as jax_stats
from geomesa_tpu.parallel.scan import ShardedZ3Index as JaxZ3
from geomesa_tpu.process import stats_process as jax_stats_process
from geomesa_tpu.stats.stat import _hash_col
from geomesa_tpu_torch import TpuDataStore, stats_process
from geomesa_tpu_torch.features.batch import FeatureBatch
from geomesa_tpu_torch.features.feature_type import parse_spec
from geomesa_tpu_torch.parallel import (
    ShardedZ3Index, device_mesh, merged_stats, sharded_frequency_scan,
    sharded_stats_scan,
)
from geomesa_tpu_torch.parallel import stats as stats_mod

MS = 1514764800000
DAY = 86_400_000
N = 20_011
BOX = (-74.5, 40.5, -73.5, 41.5)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(41)
    return (rng.uniform(-75.0, -73.0, N), rng.uniform(40.0, 42.0, N),
            rng.integers(MS, MS + 14 * DAY, N), rng.uniform(0, 100, N))


@pytest.fixture(scope="module")
def pair(data):
    x, y, t, _ = data
    return (ShardedZ3Index.build(x, y, t, period="week",
                                 mesh=device_mesh(devices=["cpu"] * 8)),
            JaxZ3.build(x, y, t, period="week", mesh=jax_mesh()))


@pytest.fixture
def launches(monkeypatch):
    """Count the histograms that take the kernel route (on the CPU the
    wrapper runs its plain version and its own count stays 0)."""
    calls = []
    real = stats_mod.hist1d

    def spy(*args):
        calls.append(args[3])
        return real(*args)

    monkeypatch.setattr(stats_mod, "hist1d", spy)
    return calls


def _same_moments(got, want):
    assert got["count"] == want["count"]
    assert got["min"] == want["min"] and got["max"] == want["max"]
    assert got["sum"] == pytest.approx(want["sum"], rel=1e-12)
    assert got["sumsq"] == pytest.approx(want["sumsq"], rel=1e-12)


@pytest.mark.parametrize("window", [
    ([BOX], MS + DAY, MS + 8 * DAY),
    ([(-74.8, 40.2, -73.2, 41.8)], MS, MS + 14 * DAY),
    ([BOX, (-74.9, 40.1, -74.6, 40.4)], None, None),
    ([(10.0, 10.0, 11.0, 11.0)], None, None),
])
def test_stats_scan_moments_and_histogram(pair, data, window, launches):
    port, ref = pair
    v = data[3]
    got = sharded_stats_scan(port, *window, values=v, hist_bins=16,
                             hist_range=(0.0, 100.0))
    want = jax_stats(ref, *window, values=v, hist_bins=16,
                     hist_range=(0.0, 100.0))
    _same_moments(got, want)
    assert got["histogram"].dtype == np.int64
    np.testing.assert_array_equal(got["histogram"], want["histogram"])
    assert launches == [16] * 8  # one kernel-route histogram per shard


def test_stats_scan_default_x(pair):
    port, ref = pair
    got = sharded_stats_scan(port, [BOX], None, None)
    want = jax_stats(ref, [BOX], None, None)
    _same_moments(got, want)
    assert "histogram" not in got


def test_histogram_routes(pair, data, launches, monkeypatch):
    """Below HIST_KERNEL_MAX_SLOTS per shard the kernel serves the
    histogram; at or above it the int64 scatter does, with the same
    counts (the JAX package's f32-exactness rule)."""
    port, ref = pair
    v = data[3]
    kw = dict(values=v, hist_bins=64, hist_range=(0.0, 100.0))
    want = jax_stats(ref, [BOX], None, None, **kw)["histogram"]
    got = sharded_stats_scan(port, [BOX], None, None, **kw)["histogram"]
    assert len(launches) == 8
    monkeypatch.setattr(stats_mod, "HIST_KERNEL_MAX_SLOTS", port.capacity)
    got2 = sharded_stats_scan(port, [BOX], None, None, **kw)["histogram"]
    freq = sharded_frequency_scan(port, [BOX], None, None, v)
    assert len(launches) == 8  # the int64 route launched nothing
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got2, want)
    np.testing.assert_array_equal(
        freq.table, jax_freq(ref, [BOX], None, None, v).table)


def test_histogram_bins_of_non_finite_values(pair):
    """NaN, ±inf and huge values get the bins the JAX CPU backend gives
    them (XLA's saturating float→int32, then the clip): NaN and -inf to
    bin 0, +inf and 1e300 to the last."""
    port, ref = pair
    v = np.random.default_rng(2).uniform(-20, 120, N)
    v[::7] = np.nan
    v[1::11] = np.inf
    v[2::13] = -np.inf
    v[3::17] = 1e300
    v[4::19] = -1e300
    kw = dict(values=v, hist_bins=10, hist_range=(0.0, 100.0))
    got = sharded_stats_scan(port, [BOX], None, None, **kw)
    want = jax_stats(ref, [BOX], None, None, **kw)
    np.testing.assert_array_equal(got["histogram"], want["histogram"])
    assert got["count"] == want["count"]


def _host_table(vals, sel, kind):
    from geomesa_tpu_torch.stats.stat import Frequency
    host = Frequency("v")
    sft = parse_spec("f", f"v:{kind},dtg:Date,*geom:Point")
    n = int(sel.sum())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        host.observe(FeatureBatch.from_dict(sft, {
            "v": vals[sel], "dtg": np.zeros(n, np.int64),
            "geom": (np.zeros(n), np.zeros(n))}))
    return host.table


@pytest.mark.parametrize("kind", ["numeric", "strings", "bigint", "nonfinite"])
def test_frequency_scan_matches_jax_and_host(pair, data, kind, launches):
    """The count-min table equals the JAX device sketch and a host
    observe over the matching rows (the cases of
    test_parallel_stats.py's frequency tests)."""
    port, ref = pair
    x, y, t, _ = data
    rng = np.random.default_rng(77)
    if kind == "numeric":
        vals, spec = rng.integers(0, 50, N).astype(np.float64), "Double"
    elif kind == "strings":
        vals = np.array(["tail_%d" % (i % 200) for i in range(N)],
                        dtype=object)
        vals[:6000] = "heavy_α"
        vals[6000:9000] = "heavy_β"
        spec = "String"
    elif kind == "bigint":
        # adjacent int64 past 2^53, and values with the top bit set
        vals = (1 << 60) + rng.integers(0, 4, N)
        vals[::3] = -(1 << 62) - rng.integers(0, 4, len(vals[::3]))
        spec = "Long"
    else:
        vals = rng.uniform(0, 10, N)
        vals[::7] = np.nan
        vals[1::11] = np.inf
        vals[2::13] = -np.inf
        vals[3::17] = 1e300
        vals[4::19] = -1e300
        spec = "Double"
    lo, hi = MS + DAY, MS + 5 * DAY
    got = sharded_frequency_scan(port, [BOX], lo, hi, vals)
    want = jax_freq(ref, [BOX], lo, hi, vals)
    np.testing.assert_array_equal(got.table, want.table)
    sel = ((x >= BOX[0]) & (x <= BOX[2]) & (y >= BOX[1]) & (y <= BOX[3])
           & (t >= lo) & (t <= hi))
    np.testing.assert_array_equal(got.table, _host_table(vals, sel, spec))
    assert got.table.shape == (4, 1024) and got.table.dtype == np.int64
    assert launches == [1024] * (4 * 8)  # depth rows per shard


def test_uint64_hash_in_int64():
    """The int64 splitmix64, logical shifts and unsigned remainder equal
    numpy's uint64 arithmetic, on values with the top bit set."""
    rng = np.random.default_rng(5)
    v = rng.integers(-(1 << 63), (1 << 63) - 1, 4096, dtype=np.int64)
    v[:4] = [-1, -(1 << 63), (1 << 63) - 1, 0]
    for seed in (1, 2, 3, 4):
        want = _hash_col(v, seed)
        h = stats_mod._splitmix64(
            torch.from_numpy(v) ^ stats_mod._as_int64(
                seed * 0x9E3779B97F4A7C15))
        np.testing.assert_array_equal(h.numpy().view(np.uint64), want)
        for width in (1024, 1000, 7):
            np.testing.assert_array_equal(
                stats_mod._umod(h, width).numpy(),
                (want % np.uint64(width)).astype(np.int64))


@pytest.fixture(scope="module")
def batch(data):
    x, y, t, v = data
    rng = np.random.default_rng(43)
    names = np.array(["a", "b", "c", "d", "e"], dtype=object)[
        rng.integers(0, 5, N)]
    return {"name": names, "score": v, "dtg": t, "geom": (x, y)}


@pytest.mark.parametrize("spec", [
    "Count()", "MinMax(score)", "Enumeration(name)",
    "Histogram(score,20,0,100)", "DescriptiveStats(score)", "TopK(name)",
    "Frequency(name)",
])
def test_merged_stats_matches_jax(batch, spec):
    from geomesa_tpu.features import FeatureBatch as JaxBatch
    from geomesa_tpu.features.feature_type import parse_spec as jax_spec
    sft_spec = "name:String:index=true,score:Double,dtg:Date,*geom:Point"
    ours = FeatureBatch.from_dict(parse_spec("obs", sft_spec), batch)
    theirs = JaxBatch.from_dict(jax_spec("obs", sft_spec), batch)
    shards = np.random.default_rng(3).integers(-1, 8, N)
    for split in (8, shards):
        got = merged_stats(ours, spec, split).to_json()
        want = jax_merged_stats(theirs, spec, split).to_json()
        assert set(got) == set(want)
        for k, g in got.items():
            if isinstance(g, float):
                assert g == pytest.approx(want[k], rel=1e-12)
            else:
                assert g == want[k]


# -- stats_process against the JAX stores (test_datastore_mesh.py) ------
SPEC = ("name:String:index=true,score:Double,dtg:Date,*geom:Point;"
        "geomesa.z3.interval=week")
Q = ("BBOX(geom, -74.5, 40.5, -73.5, 41.5) AND dtg DURING "
     "2018-01-03T00:00:00Z/2018-01-10T00:00:00Z")
Q_AND = ("BBOX(geom, -74.8, 40.2, -73.8, 41.2) AND "
         "BBOX(geom, -74.2, 40.8, -73.2, 41.8) AND dtg DURING "
         "2018-01-02T00:00:00Z/2018-01-12T00:00:00Z")
Q_EMPTY = ("BBOX(geom, -74.8, 40.2, -74.5, 40.4) AND "
           "BBOX(geom, -73.5, 41.5, -73.2, 41.8)")


@pytest.fixture(scope="module")
def stores():
    rng = np.random.default_rng(77)
    n = 30_007
    data = {
        "name": rng.choice(["alpha", "beta", "gamma", "delta"], n),
        "score": rng.uniform(0, 100, n),
        "dtg": rng.integers(MS, MS + 21 * DAY, n),
        "geom": (rng.uniform(-75.0, -73.0, n), rng.uniform(40.0, 42.0, n)),
    }
    out = {"plain": (TpuDataStore(device="cpu"), JaxStore()),
           "mesh": (TpuDataStore(device="cpu",
                                 mesh=device_mesh(devices=["cpu"] * 8)),
                    JaxStore(mesh=jax_mesh()))}
    for ours, theirs in out.values():
        for ds in (ours, theirs):
            ds.create_schema("events", SPEC)
            ds.write("events", data)
    return out


def _same_stat(got, want):
    a, b = got.to_json(), want.to_json()
    assert set(a) == set(b)
    for k, va in a.items():
        assert va == b[k], k


@pytest.mark.parametrize("store", ["plain", "mesh"])
@pytest.mark.parametrize("query,spec", [
    (Q, "Count();MinMax(score);Histogram(score,16,0,100)"),
    (Q, "Frequency(name,4,1024)"),
    (Q, "Frequency(score,4,1024)"),
    (Q, "TopK(name)"),
    (Q + " AND name = 'alpha'", "Count()"),
    (Q_AND, "Count()"),
    (Q_EMPTY, "Count()"),
    ("INCLUDE", "Count();MinMax(score);Histogram(score,64,0,100)"),
])
def test_stats_process_matches_jax(stores, store, query, spec):
    ours, theirs = stores[store]
    got = ours.stats("events", query, spec)
    want = theirs.stats("events", query, spec)
    _same_stat(got, want)
    _same_stat(stats_process(ours, "events", query, spec),
               jax_stats_process(theirs, "events", query, spec))
    if query == Q_EMPTY:
        assert got.count == 0
    elif spec == "Count()":
        assert got.count > 0


def test_mesh_stats_push_down(stores, launches, monkeypatch):
    """On the mesh store the pushable specs run the sharded scans (one
    kernel-route histogram per shard, depth per shard for a Frequency);
    TopK and residual filters take the materializing path.  With the
    kernel's slot bound lowered below the shards' capacity the same specs
    take the int64 route, launch nothing, and still equal the JAX
    store."""
    ours, theirs = stores["mesh"]
    specs = ["Count();MinMax(score);Histogram(score,16,0,100)",
             "Frequency(name,4,1024)"]
    ours.stats("events", Q, specs[0])
    assert launches == [16] * 8
    ours.stats("events", Q, specs[1])
    assert len(launches) == 8 + 4 * 8
    ours.stats("events", Q, "TopK(name)")
    ours.stats("events", Q + " AND name = 'alpha'", "Histogram(score,4,0,1)")
    assert len(launches) == 8 + 4 * 8
    monkeypatch.setattr(stats_mod, "HIST_KERNEL_MAX_SLOTS", 1 << 10)
    for spec in specs:
        _same_stat(ours.stats("events", Q, spec),
                   theirs.stats("events", Q, spec))
    assert len(launches) == 8 + 4 * 8


def test_string_digest_matches_jax_on_mixed_objects():
    """The digest is computed once per distinct ``str(v)``: values that
    compare equal but print differently (1, 1.0, True) keep their own
    digests, as in the JAX package's one-pass version."""
    from geomesa_tpu.stats.stat import _string_digest as jax_digest
    from geomesa_tpu_torch.stats.stat import _string_digest
    col = np.array([1, 1.0, True, "1", None, "heavy_α", np.str_("x"), "x",
                    "", 1], dtype=object)
    np.testing.assert_array_equal(_string_digest(col), jax_digest(col))
    assert len(set(_string_digest(col)[:3].tolist())) == 3
