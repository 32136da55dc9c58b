"""Port parity: ShardedLeanZ3Index of geomesa_tpu_torch on 2- and 8-shard
CPU meshes (``device_mesh(devices=["cpu"] * n)``) against geomesa_tpu's on
the suite's virtual CPU mesh of the same size — the same rows in the same
appends, the same generation size and per-shard budget.

Held equal, bit for bit: hit gids (and a brute-force oracle), the tier of
every generation, consumed slots, device bytes and ``dispatch_count``
deltas, unit-weight density grids, range counts, Z3Histogram cell
counts, pyramids and compaction.  The mirrored oracles are the JAX
package's tests/test_lean_sharded.py (all nine),
test_lean_density.py::test_sharded_lean_density_and_count,
test_pyramid.py::test_sharded_pyramid_exact_and_compaction_inherits and
test_zz_lean_compaction.py::test_sharded_compaction_releases_slack_slots.
"""

import numpy as np
import pytest

from geomesa_tpu.parallel import device_mesh as jax_mesh
from geomesa_tpu.parallel.lean import ShardedLeanZ3Index as JaxSharded
from geomesa_tpu_torch import TpuDataStore, density_process, device_mesh
from geomesa_tpu_torch.index.z3_lean import LeanZ3Index
from geomesa_tpu_torch.parallel import ShardedLeanZ3Index, stats_process
from geomesa_tpu_torch.parallel import lean as plean

MS = 1514764800000
DAY = 86_400_000
WORLD = (-180.0, -90.0, 180.0, 90.0)
BOX = (-74.5, 40.5, -73.5, 41.5)
N = 50_000

WINDOWS = [([BOX], MS + 2 * DAY, MS + 9 * DAY),
           ([(-74.2, 40.1, -73.1, 41.2)], None, None),
           ([(-74.9, 41.5, -74.6, 41.9)], MS, MS + 4 * DAY),
           ([(10.0, 10.0, 11.0, 11.0)], None, None)]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(23)
    return (rng.uniform(-75, -73, N), rng.uniform(40, 42, N),
            rng.integers(MS, MS + 14 * DAY, N))


def _brute(x, y, t, boxes, lo, hi):
    m = np.zeros(len(x), dtype=bool)
    for b in np.atleast_2d(np.asarray(boxes)):
        m |= ((x >= b[0]) & (x <= b[2]) & (y >= b[1]) & (y <= b[3]))
    if lo is not None:
        m &= t >= lo
    if hi is not None:
        m &= t <= hi
    return np.flatnonzero(m)


def _brute_grid(x, y, env, w, h):
    g = np.zeros((h, w))
    gx = np.clip(((x - env[0]) / (env[2] - env[0]) * w).astype(int), 0, w - 1)
    gy = np.clip(((y - env[1]) / (env[3] - env[1]) * h).astype(int), 0, h - 1)
    np.add.at(g, (gy, gx), 1.0)
    return g


def _pair(n_shards, step, rows, **kw):
    """Both packages' sharded lean z3 over the same appends."""
    port = ShardedLeanZ3Index(period="week",
                              mesh=device_mesh(devices=["cpu"] * n_shards),
                              **kw)
    ref = JaxSharded(period="week", mesh=jax_mesh(n_shards), **kw)
    x, y, t = rows
    for s in range(0, len(x), step):
        sl = slice(s, min(s + step, len(x)))
        port.append(x[sl], y[sl], t[sl])
        ref.append(x[sl], y[sl], t[sl])
    return port, ref


def _same_layout(port, ref):
    assert port.total() == ref.total()
    assert port.tier_counts() == ref.tier_counts()
    assert ([(g.tier, g.n_slots, g.slots, g.gen_id)
             for g in port.generations]
            == [(g.tier, g.n_slots, g.slots, g.gen_id)
                for g in ref.generations])
    assert port.device_bytes() == ref.device_bytes()
    assert port.host_key_bytes() == ref.host_key_bytes()
    assert port.dispatch_count == ref.dispatch_count
    assert (port.t_min_ms, port.t_max_ms) == (ref.t_min_ms, ref.t_max_ms)


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_lean_build_query_oracle(data, n_shards):
    port, ref = _pair(n_shards, 20_000, data, generation_slots=1 << 13)
    _same_layout(port, ref)
    assert len(port.generations) >= 2
    lo, hi = MS + 2 * DAY, MS + 9 * DAY
    got = port.query([BOX], lo, hi)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, ref.query([BOX], lo, hi))
    np.testing.assert_array_equal(got, _brute(*data, [BOX], lo, hi))
    assert port.dispatch_count == ref.dispatch_count


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_lean_query_many_fixed_dispatches(data, n_shards):
    port, ref = _pair(n_shards, N, data, generation_slots=1 << 13)
    before = port.dispatch_count, ref.dispatch_count
    got = port.query_many(WINDOWS)
    want = ref.query_many(WINDOWS)
    assert port.dispatch_count - before[0] == 2   # one probe + one scan
    assert ref.dispatch_count - before[1] == 2
    for g, w, (bxs, lo, hi) in zip(got, want, WINDOWS):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, _brute(*data, bxs, lo, hi))


def test_sharded_lean_matches_single_chip(data):
    x, y, t = data
    sharded = ShardedLeanZ3Index(period="week",
                                 mesh=device_mesh(devices=["cpu"] * 8),
                                 generation_slots=1 << 13)
    single = LeanZ3Index(period="week", generation_slots=1 << 14,
                         payload_on_device=False, device="cpu")
    ref = JaxSharded(period="week", mesh=jax_mesh(8),
                     generation_slots=1 << 13)
    for idx in (sharded, single, ref):
        idx.append(x, y, t)
    lo, hi = MS + DAY, MS + 10 * DAY
    got = sharded.query([BOX], lo, hi)
    np.testing.assert_array_equal(got, single.query([BOX], lo, hi))
    np.testing.assert_array_equal(got, ref.query([BOX], lo, hi))


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_lean_big_scan_falls_back_per_generation(data, n_shards):
    """Candidate totals past BATCH_SCAN_BUDGET count one scan per
    generation, sized by its own total — never a silent truncation."""
    port, ref = _pair(n_shards, N, data, generation_slots=1 << 12)
    assert len(port.generations) >= 2
    port.BATCH_SCAN_BUDGET = ref.BATCH_SCAN_BUDGET = 1 << 10
    before = port.dispatch_count, ref.dispatch_count
    got = port.query([WORLD], None, None)
    np.testing.assert_array_equal(got, np.arange(N))
    np.testing.assert_array_equal(got, ref.query([WORLD], None, None))
    assert port.dispatch_count - before[0] == 1 + len(port.generations)
    assert ref.dispatch_count - before[1] == 1 + len(ref.generations)


def test_sharded_lean_oversized_append_chunks(data):
    """One append larger than generation_slots × shards loops through
    several rollovers."""
    slots = 1 << 9
    n = 3 * slots * 8
    rows = tuple(c[:n] for c in data)
    port, ref = _pair(8, n, rows, generation_slots=slots)
    _same_layout(port, ref)
    assert len(port.generations) >= 3
    np.testing.assert_array_equal(port.query([BOX], None, None),
                                  _brute(*rows, [BOX], None, None))


def test_sharded_lean_empty_and_payload_provider(data):
    x, y, t = data
    idx = ShardedLeanZ3Index(period="week",
                             mesh=device_mesh(devices=["cpu"] * 2),
                             generation_slots=1 << 13)
    assert idx.query([(-75, 40, -73, 42)], None, None).size == 0
    assert idx.density([WORLD], None, None, WORLD, 4, 4).sum() == 0
    assert idx.z3_cell_counts(4) == {}
    idx.payload_provider = lambda: (x, y, t)
    idx.append(x, y, t)
    assert idx._payload == [] and idx._flat is None
    np.testing.assert_array_equal(idx.query([BOX], None, None),
                                  _brute(x, y, t, [BOX], None, None))
    rows = np.array([5, 0, N - 1])
    for a, b in zip(idx.gather_payload(rows), (x[rows], y[rows], t[rows])):
        np.testing.assert_array_equal(a, b)


def test_sharded_lean_default_full_tier(data):
    """New generations carry per-shard payload by default: the exact mask
    runs on the device and the tier stays ``full`` under the default
    budget."""
    port, ref = _pair(8, N, data, generation_slots=1 << 13)
    assert port.tier_counts()["full"] == len(port.generations)
    assert port.generations[0].x is not None
    _same_layout(port, ref)


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_lean_budget_demotes_payload_then_spills(data, n_shards):
    """Tight per-shard budgets demote oldest-first — payload drops before
    key runs spill, the active generation never spills — and queries
    stay oracle-exact across the mixed-tier regime."""
    slots = 1 << 10
    budget = slots * 20 * 3
    port, ref = _pair(n_shards, 15_000, data, generation_slots=slots,
                      hbm_budget_bytes=budget)
    _same_layout(port, ref)
    tiers = port.tier_counts()
    assert tiers["host"] >= 1 and tiers["full"] == 0, tiers
    assert port.generations[-1].tier != "host"
    assert port.host_key_bytes() > 0
    assert port._per_shard_resident() <= budget
    lo, hi = MS + 2 * DAY, MS + 9 * DAY
    for w in (([BOX], lo, hi), ([BOX], None, None)):
        got = port.query(*w)
        np.testing.assert_array_equal(got, ref.query(*w))
        np.testing.assert_array_equal(got, _brute(*data, *w))
    assert port.dispatch_count == ref.dispatch_count


def test_sharded_lean_mixed_full_keys_oracle(data):
    """A budget that keeps the newest generation full while older payloads
    drop serves one query through the device-exact path AND the keys
    candidate path together."""
    slots = 1 << 12
    budget = slots * (20 + 44) + slots * 44 + 2 * slots * 20
    port, ref = _pair(8, 10_000, data, generation_slots=slots,
                      hbm_budget_bytes=budget)
    _same_layout(port, ref)
    tiers = port.tier_counts()
    assert tiers["full"] >= 1 and tiers["keys"] >= 1, tiers
    assert port.generations[-1].tier == "full"
    lo, hi = MS + 2 * DAY, MS + 9 * DAY
    got = port.query([BOX], lo, hi)
    np.testing.assert_array_equal(got, ref.query([BOX], lo, hi))
    np.testing.assert_array_equal(got, _brute(*data, [BOX], lo, hi))
    # the mixed regime's heatmap: exact on the full tier, cell-granular on
    # the keys tier — both alike in both packages
    env = (-75.0, 40.0, -73.0, 42.0)
    np.testing.assert_array_equal(
        port.density([BOX], lo, hi, env, 64, 32),
        np.asarray(ref.density([BOX], lo, hi, env, 64, 32)))
    assert port.range_count([BOX], lo, hi) == ref.range_count([BOX], lo, hi)


def test_sharded_lean_density_and_count(data):
    """Store-level push-downs over a mesh, and a budget-spilled index whose
    host partials merge into the grid."""
    x, y, t = data
    want = _brute_grid(x, y, WORLD, 256, 128)
    ds = TpuDataStore(device="cpu", mesh=device_mesh(devices=["cpu"] * 8))
    ds.create_schema("evt", "dtg:Date,*geom:Point;"
                            "geomesa.index.profile=lean")
    ds.write("evt", {"dtg": t, "geom": (x, y)})
    assert isinstance(ds._store("evt").index("z3"), ShardedLeanZ3Index)
    np.testing.assert_array_equal(
        density_process(ds, "evt", "INCLUDE", WORLD, 256, 128), want)
    assert stats_process(ds, "evt", "INCLUDE", "Count()").count == N
    slots = 1 << 10
    port, ref = _pair(8, 12_000, data, generation_slots=slots,
                      hbm_budget_bytes=slots * 20 * 3)
    assert port.tier_counts()["host"] >= 1
    got = port.density([WORLD], None, None, WORLD, 256, 128)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(ref.density([WORLD], None, None, WORLD, 256, 128)))
    assert (port.range_count([WORLD], None, None)
            == ref.range_count([WORLD], None, None) == N)
    assert port.z3_cell_counts(6) == ref.z3_cell_counts(6)
    assert port.dispatch_count == ref.dispatch_count


def test_sharded_pyramid_exact_and_compaction_inherits():
    slots = 1 << 9
    step = slots * 8                     # one sealed generation per step
    rng = np.random.default_rng(3)
    n = 8 * step
    rows = (rng.uniform(-75, -73, n), rng.uniform(40, 42, n),
            rng.integers(MS, MS + 14 * DAY, n))
    port, ref = _pair(8, step, rows, generation_slots=slots,
                      hbm_budget_bytes=slots * 20 * 3)
    assert port.tier_counts()["host"] >= 1
    want = _brute_grid(rows[0], rows[1], WORLD, 64, 64)
    built = port.build_pyramids(base=64)
    assert built == ref.build_pyramids(base=64) == len(port.generations) - 1
    hits = port.pyramid_serve_hits
    got = port.density([WORLD], None, None, WORLD, 64, 64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(ref.density([WORLD], None, None, WORLD, 64, 64)))
    assert port.pyramid_serve_hits - hits == built
    got = port.density_tile(0, 0, 0, tile=32)
    np.testing.assert_array_equal(
        got, _brute_grid(rows[0], rows[1], WORLD, 32, 32))
    np.testing.assert_array_equal(
        got, np.asarray(ref.density_tile(0, 0, 0, tile=32)))
    np.testing.assert_array_equal(port.density_tile(1, 0, 0, tile=32),
                                  np.asarray(ref.density_tile(1, 0, 0,
                                                              tile=32)))
    assert port.compact() == ref.compact()
    assert port.build_pyramids(base=64) == 0   # merged runs inherited
    np.testing.assert_array_equal(
        port.density([WORLD], None, None, WORLD, 64, 64), want)
    np.testing.assert_array_equal(
        np.asarray(ref.density([WORLD], None, None, WORLD, 64, 64)), want)
    _same_layout(port, ref)


def test_sharded_compaction_releases_slack_slots():
    """Sharded generations seal with slack; the merged run is sized to the
    consumed slots, so device residency drops by the released slack, as
    in the JAX index."""
    rng = np.random.default_rng(5)
    n = 30 * 200
    rows = (rng.uniform(-75, -73, n), rng.uniform(40, 42, n),
            rng.integers(MS, MS + 14 * DAY, n))
    port, ref = _pair(8, 200, rows, generation_slots=120,
                      payload_on_device=False)
    sealed = port.generations[:-1]
    assert len(sealed) >= 4
    assert sum(g.slots - g.n_slots for g in sealed[:4]) > 0
    before = port.device_bytes()
    lo, hi = MS + 2 * DAY, MS + 9 * DAY
    hits0 = port.query([BOX], lo, hi)
    np.testing.assert_array_equal(hits0, ref.query([BOX], lo, hi))
    stats = port.compact()
    assert stats == ref.compact()
    assert stats["merged_groups"] >= 1
    assert port.device_bytes() < before
    _same_layout(port, ref)
    np.testing.assert_array_equal(port.query([BOX], lo, hi), hits0)
    np.testing.assert_array_equal(hits0, _brute(*rows, [BOX], lo, hi))
    np.testing.assert_array_equal(hits0, ref.query([BOX], lo, hi))


def test_multihost_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        ShardedLeanZ3Index(mesh=device_mesh(devices=["cpu"]),
                           multihost=True)
    with pytest.raises(ValueError, match="mesh"):
        ShardedLeanZ3Index()


def test_lexsort_orders_ties_by_gid():
    import torch
    b = torch.tensor([1, 0, 1, 0, 1], dtype=torch.int32)
    z = torch.tensor([5, 7, 5, 7, 2], dtype=torch.int64)
    p = torch.tensor([9, 4, 3, 1, 8], dtype=torch.int64)
    perm = plean.lexsort(b, z, p)
    assert p[perm].tolist() == [1, 4, 8, 3, 9]
