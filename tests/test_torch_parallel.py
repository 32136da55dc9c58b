"""Port parity: the sharded z3 and z2 indexes of geomesa_tpu_torch on an
8-shard CPU mesh (``device_mesh(devices=["cpu"] * 8)``) against
geomesa_tpu's on the suite's 8-device virtual CPU mesh — the same rows,
the same shard layout, the same queries.  Hit gids are compared bit for
bit; unit-weight density grids exactly, weighted ones within rtol 1e-12
(float64 sums in another order)."""

import numpy as np
import pytest

from geomesa_tpu.parallel import device_mesh as jax_mesh
from geomesa_tpu.parallel.scan import ShardedZ3Index as JaxZ3
from geomesa_tpu.parallel.z2 import ShardedZ2Index as JaxZ2
from geomesa_tpu_torch.convert import (
    sharded_index_state, sharded_z2_index_from_state,
    sharded_z3_index_from_state,
)
from geomesa_tpu_torch.parallel import (
    ShardedZ2Index, ShardedZ3Index, device_mesh,
)
from geomesa_tpu_torch.parallel import scan as scan_mod

MS = 1514764800000
DAY = 86_400_000
N = 20_011
M = 1_503

BOX = (-74.5, 40.5, -73.5, 41.5)
QUERIES = [
    ([BOX], MS + DAY, MS + 8 * DAY),
    ([(-74.9, 40.1, -74.6, 40.4), (-73.4, 41.6, -73.1, 41.9)],
     MS + 2 * DAY, MS + 12 * DAY),
    ([(-75.0, 40.0, -73.0, 42.0)], None, None),
    ([BOX], MS + 5 * DAY, MS + 5 * DAY + 3_600_000),
    ([(10.0, 10.0, 11.0, 11.0)], None, None),         # no hits
    ([BOX], MS + 30 * DAY, MS + 40 * DAY),            # past the data
]


def _rows(seed, n, days=14):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-75.0, -73.0, n), rng.uniform(40.0, 42.0, n),
            rng.integers(MS, MS + days * DAY, n))


def _oracle(x, y, t, boxes, lo, hi):
    lo = -np.inf if lo is None else lo
    hi = np.inf if hi is None else hi
    m = np.zeros(len(x), bool)
    for b in boxes:
        m |= (x >= b[0]) & (x <= b[2]) & (y >= b[1]) & (y <= b[3])
    return np.flatnonzero(m & (t >= lo) & (t <= hi))


@pytest.fixture(scope="module")
def mesh():
    return device_mesh(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def z3_pair(mesh):
    """Both packages' sharded z3 over the same rows, then one append."""
    x, y, t = _rows(41, N)
    ax, ay, at = _rows(42, M, days=21)
    port = ShardedZ3Index.build(x, y, t, period="week", mesh=mesh)
    ref = JaxZ3.build(x, y, t, period="week", mesh=jax_mesh())
    port.append(ax, ay, at)
    ref.append(ax, ay, at)
    rows = tuple(np.concatenate(p) for p in ((x, ax), (y, ay), (t, at)))
    return port, ref, rows


@pytest.fixture(scope="module")
def z2_pair(mesh):
    x, y, _ = _rows(43, N)
    ax, ay, _ = _rows(44, M)
    port = ShardedZ2Index.build(x, y, mesh=mesh)
    ref = JaxZ2.build(x, y, mesh=jax_mesh())
    port.append(ax, ay)
    ref.append(ax, ay)
    return port, ref, (np.concatenate([x, ax]), np.concatenate([y, ay]))


def test_layout_matches_jax(z3_pair, z2_pair):
    """Shard counts, per-shard capacity and residency segments match the
    JAX mesh slot for slot."""
    for port, ref in (z3_pair[:2], z2_pair[:2]):
        assert len(port) == len(ref) == N + M
        np.testing.assert_array_equal(port._shard_counts, ref._shard_counts)
        assert port._segments == ref._segments
        assert port.capacity == int(ref.z.shape[0]) // 8
    port, ref, _ = z3_pair
    assert (port.t_min_ms, port.t_max_ms) == (ref.t_min_ms, ref.t_max_ms)
    # every shard holds the same multiset of gids, sorted by the same keys
    st = sharded_index_state(port)
    rs = sharded_index_state(ref)
    for s in range(8):
        assert sorted(st["gid"][s]) == sorted(rs["gid"][s])
        np.testing.assert_array_equal(st["z"][s], rs["z"][s])
        np.testing.assert_array_equal(st["bins"][s], rs["bins"][s])


@pytest.mark.parametrize("q", range(len(QUERIES)))
def test_z3_query_matches_jax(z3_pair, q):
    port, ref, rows = z3_pair
    boxes, lo, hi = QUERIES[q]
    got = port.query(boxes, lo, hi)
    want = ref.query(boxes, lo, hi)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle(*rows, boxes, lo, hi))
    assert port.range_count(boxes, lo, hi) == ref.range_count(boxes, lo, hi)


def test_z3_two_phase_read(z3_pair, monkeypatch):
    """At or above the two-phase threshold the read compacts per shard
    and decays the capacity; both reads give the same gids."""
    port, ref, rows = z3_pair
    monkeypatch.setattr(scan_mod, "SHARDED_TWO_PHASE_MIN_CAPACITY", 1 << 10)
    port._capacity = 1 << 12
    for boxes, lo, hi in QUERIES:
        got = port.query(boxes, lo, hi)
        np.testing.assert_array_equal(got, ref.query(boxes, lo, hi))
        assert port._capacity >= port.DEFAULT_CAPACITY
    # an explicit capacity below the candidates regrows and still agrees
    boxes, lo, hi = QUERIES[2]
    np.testing.assert_array_equal(port.query(boxes, lo, hi, capacity=1024),
                                  _oracle(*rows, boxes, lo, hi))


def test_z3_query_many_matches_jax(z3_pair):
    port, ref, rows = z3_pair
    got = port.query_many(QUERIES)
    want = ref.query_many(QUERIES)
    for g, w, q in zip(got, want, QUERIES):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, _oracle(*rows, *q))


def test_shard_of_gids_after_append(z3_pair, mesh):
    """The case of test_parallel_stats.py's residency test: build rows in
    blocks of ceil(n/8), append rows in blocks of the append's per-shard
    slot count, in both packages alike."""
    port, ref, _ = z3_pair
    gids = np.arange(-3, N + M + 3)
    sh = port.shard_of_gids(gids)
    np.testing.assert_array_equal(sh, ref.shard_of_gids(gids))
    assert (sh[:3] == -1).all() and (sh[-3:] == -1).all()
    per = -(-N // 8)
    np.testing.assert_array_equal(sh[3:3 + N], np.arange(N) // per)


@pytest.mark.parametrize("boxes", [
    [(-74.2, 40.8, -73.9, 41.1)],
    [(-74.9, 40.1, -74.6, 40.4), (-73.4, 41.6, -73.1, 41.9)],
    [(-75.0, 40.0, -73.0, 42.0)],
    [(10.0, 10.0, 11.0, 11.0)],
])
def test_z2_query_matches_jax(z2_pair, boxes):
    port, ref, (x, y) = z2_pair
    got = port.query(boxes)
    np.testing.assert_array_equal(got, ref.query(boxes))
    np.testing.assert_array_equal(
        got, _oracle(x, y, np.zeros(len(x)), boxes, None, None))


def test_z2_query_many_matches_jax(z2_pair):
    port, ref, _ = z2_pair
    sets = [[(-74.2, 40.8, -73.9, 41.1)], [(10.0, 10.0, 11.0, 11.0)],
            [(-74.9, 40.1, -74.6, 40.4), (-73.4, 41.6, -73.1, 41.9)]]
    for g, w in zip(port.query_many(sets), ref.query_many(sets)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("weighted", [False, True])
def test_sharded_density_matches_jax(z3_pair, weighted):
    port, ref, rows = z3_pair
    env = (-74.8, 40.2, -73.2, 41.8)
    w = (np.random.default_rng(5).uniform(0, 10, N + M) if weighted
         else None)
    for boxes, lo, hi in QUERIES[:3]:
        got = port.density(boxes, lo, hi, env, 32, 16, weights=w)
        want = np.asarray(ref.density(boxes, lo, hi, env, 32, 16,
                                      weights=w))
        assert got.shape == want.shape == (16, 32)
        if weighted:
            np.testing.assert_allclose(got, want, rtol=1e-12)
        else:
            np.testing.assert_array_equal(got, want)
            assert got.sum() == len(_oracle(*rows, boxes, lo, hi))


def test_convert_carries_jax_state(z3_pair, z2_pair, mesh):
    """The JAX sharded indexes' per-shard columns, loaded into the port,
    answer the same queries with the same gids (and append alike)."""
    _, ref, rows = z3_pair
    port = sharded_z3_index_from_state(sharded_index_state(ref), mesh)
    assert port._segments == ref._segments
    for boxes, lo, hi in QUERIES:
        np.testing.assert_array_equal(port.query(boxes, lo, hi),
                                      ref.query(boxes, lo, hi))
    _, ref2, _ = z2_pair
    port2 = sharded_z2_index_from_state(sharded_index_state(ref2), mesh)
    for boxes in ([(-74.2, 40.8, -73.9, 41.1)], [(-75, 40, -73, 42)]):
        np.testing.assert_array_equal(port2.query(boxes), ref2.query(boxes))
    with pytest.raises(ValueError):
        sharded_z3_index_from_state(sharded_index_state(ref),
                                    device_mesh(devices=["cpu"] * 4))


def test_unported_mesh_paths_raise(z3_pair):
    """The multi-controller builds still raise; the ring scan, which used
    to, answers as the replicated scan does (the ring tests below)."""
    port = z3_pair[0]
    for call in (lambda: ShardedZ3Index.build_multihost([], [], []),
                 lambda: ShardedZ2Index.build_multihost([], [])):
        with pytest.raises(NotImplementedError):
            call()
    rows = _rows(9, 100)
    port_small = ShardedZ3Index.build(*rows, mesh=port.mesh)
    port_small.RING_MIN_RANGES_PER_DEVICE = 0
    np.testing.assert_array_equal(port_small.query([BOX], None, None),
                                  _oracle(*rows, [BOX], None, None))


# -- the ring-parallel scan (the JAX package's tests/test_parallel.py ring
# tests, held against its ShardedZ3Index on the same rows) ---------------
RING_Q = ([BOX], MS + DAY, MS + 6 * DAY)


def test_ring_range_counts_match_replicated(z3_pair):
    """Ring-rotated per-range counts sum to the replicated count and equal
    the JAX package's ring counts."""
    port, ref, _ = z3_pair
    boxes, lo, hi = [BOX], MS + 2 * DAY, MS + 9 * DAY
    per_range = port.range_counts_ring(boxes, lo, hi)
    assert per_range.sum() == port.range_count(boxes, lo, hi)
    assert (per_range >= 0).all() and len(per_range) >= 1
    np.testing.assert_array_equal(per_range,
                                  ref.range_counts_ring(boxes, lo, hi))


def test_ring_range_counts_oracle(z3_pair):
    """Per-range counts vs a host brute-force count over the same plan
    (512 ranges: not a multiple of the mesh size after planning)."""
    from geomesa_tpu_torch.curve.binnedtime import to_binned_time
    from geomesa_tpu_torch.index.z3 import plan_z3_query
    port, ref, (x, y, t) = z3_pair
    box = (-74.3, 40.2, -73.6, 41.7)
    lo, hi = MS + DAY, MS + 12 * DAY
    plan = plan_z3_query([box], lo, hi, "week", 512, sfc=port.sfc)
    per_range = port.range_counts_ring([box], lo, hi, max_ranges=512)
    assert len(per_range) == plan.num_ranges
    bins, offs = to_binned_time(np.asarray(t, np.int64), port.period)
    import torch
    z = port.sfc.index(torch.from_numpy(x), torch.from_numpy(y),
                       torch.from_numpy(offs.astype(np.float64))).numpy()
    want = np.array([np.count_nonzero((bins == plan.rbin[i])
                                      & (z >= plan.rzlo[i])
                                      & (z <= plan.rzhi[i]))
                     for i in range(plan.num_ranges)])
    np.testing.assert_array_equal(per_range, want)
    np.testing.assert_array_equal(
        per_range, ref.range_counts_ring([box], lo, hi, max_ranges=512))


def test_ring_query_matches_replicated(z3_pair):
    """The ring query (plan split and rotated, data stationary) returns
    the replicated scan's hit set, with a tiny capacity too (regrowth)
    and a plan whose range count the mesh size does not divide."""
    port, ref, rows = z3_pair
    rep = port.query(*RING_Q)
    np.testing.assert_array_equal(rep, _oracle(*rows, *RING_Q))
    for kw in ({}, {"capacity": 64}, {"max_ranges": 509}):
        ring = port.query_ring(*RING_Q, **kw)
        assert ring.dtype == np.int64
        np.testing.assert_array_equal(ring, rep)
        np.testing.assert_array_equal(ring, ref.query_ring(*RING_Q, **kw))


def test_huge_plan_routes_through_ring(z3_pair, monkeypatch):
    """Plans above RING_MIN_RANGES_PER_DEVICE ranges per device take the
    ring path from ``query``, exactly; the totals-first probe sizes each
    pass so no pass regrows its capacity."""
    port, _, rows = z3_pair
    calls = {"ring": 0, "passes": []}
    orig_plan = ShardedZ3Index._query_ring_plan
    orig_pass = ShardedZ3Index._ring_pass

    def spy_plan(self, plan, capacity=None):
        calls["ring"] += 1
        return orig_plan(self, plan, capacity)

    def spy_pass(self, r, ixy, bxs, t_lo, t_hi, cap):
        calls["passes"].append(cap)
        return orig_pass(self, r, ixy, bxs, t_lo, t_hi, cap)

    monkeypatch.setattr(ShardedZ3Index, "_query_ring_plan", spy_plan)
    monkeypatch.setattr(ShardedZ3Index, "_ring_pass", spy_pass)
    monkeypatch.setattr(ShardedZ3Index, "RING_MIN_RANGES_PER_DEVICE", 8)
    hits = port.query(*RING_Q, max_ranges=2000)
    assert calls["ring"] == 1 and len(calls["passes"]) == 1
    np.testing.assert_array_equal(hits, _oracle(*rows, *RING_Q))
    # a chunk budget below the candidates splits the plan into passes
    monkeypatch.setattr(ShardedZ3Index, "RING_MAX_CAPACITY", 1 << 10)
    np.testing.assert_array_equal(port.query(*RING_Q),
                                  _oracle(*rows, *RING_Q))
    assert len(calls["passes"]) > 2


def test_gid_coding_matches_jax():
    from geomesa_tpu.parallel.scan import decode_gids as jax_decode
    from geomesa_tpu.parallel.scan import encode_gids as jax_encode
    from geomesa_tpu_torch.parallel.scan import decode_gids, encode_gids
    rows = np.array([0, 1, 17, (1 << 40) - 1], dtype=np.int64)
    for proc in (0, 3):
        got = encode_gids(rows, proc)
        np.testing.assert_array_equal(got, jax_encode(rows, proc))
        for a, b in zip(decode_gids(got), jax_decode(got)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(decode_gids(encode_gids(rows))[1], rows)


def test_device_mesh(mesh, monkeypatch):
    import torch
    assert mesh.size == 8 and len(mesh.devices) == 8
    assert all(d == torch.device("cpu") for d in mesh)
    assert device_mesh(3, devices=["cpu"] * 8).size == 3
    with pytest.raises(ValueError):
        device_mesh(9, devices=["cpu"] * 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_mesh()
