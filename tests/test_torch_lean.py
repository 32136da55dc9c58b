"""Port parity: the tiered generational ``LeanZ3Index`` of
geomesa_tpu_torch against geomesa_tpu's, on the same seeded rows, at
small generations (2^12 slots) so every CPU append stays a small sort.

Held equal: the tier layout and byte accounting, each device
generation's sorted ``bins`` and ``z`` bit for bit (``pos`` within runs
of equal ``(bin, z)`` only as multisets: the JAX sort leaves ties in no
fixed order), each host run, query and ``query_many`` positions, the
float64 density grids (exactly: they are integer counts), ``range_count``,
compaction's layout and answers, the density partial cache, and an index
carried across with ``convert.lean_z3_index_state``.
"""

import numpy as np
import pytest

from geomesa_tpu.index import z3_lean as jl
from geomesa_tpu_torch import convert
from geomesa_tpu_torch.index import z3_lean as tl

MS_2018 = 1514764800000
DAY = 86_400_000
SLOTS = 1 << 12
N = 30_000
#: (payload_on_device, hbm budget) → the tiers they leave after N rows
BUDGETS = {
    "full": (True, None),                              # 8 full
    "keys": (False, None),                             # 8 keys
    "mixed": (True, SLOTS * (40 + 16 + 40) + SLOTS * 16 * 3),
}
BOX = (-74.5, 40.5, -73.5, 41.5)
ENV = (-75.0, 40.0, -73.0, 42.0)
WORLD = (-180.0, -90.0, 180.0, 90.0)


def _rows(seed=3, n=N):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-75.0, -73.0, n)
    y = rng.uniform(40.0, 42.0, n)
    t = rng.integers(MS_2018, MS_2018 + 40 * DAY, n)
    # exact duplicates: equal (bin, z) runs whose pos order may differ
    x[:50], y[:50], t[:50] = x[50:100], y[50:100], t[50:100]
    return x, y, t


def _pair(kind, rows=None, step=7_000, **kw):
    on_dev, budget = BUDGETS[kind]
    x, y, t = _rows() if rows is None else rows
    j = jl.LeanZ3Index(period="week", generation_slots=SLOTS,
                       hbm_budget_bytes=budget,
                       payload_on_device=on_dev, **kw)
    p = tl.LeanZ3Index(period="week", generation_slots=SLOTS,
                       hbm_budget_bytes=budget, payload_on_device=on_dev,
                       device="cpu", **kw)
    for s in range(0, len(x), step):   # slices straddle generations
        sl = slice(s, s + step)
        j.append(x[sl], y[sl], t[sl])
        p.append(x[sl], y[sl], t[sl])
    return j, p


_PAIRS: dict = {}


def _cached_pair(kind):
    """One (JAX, port) index pair per budget kind for the whole module:
    the JAX side compiles a program per shape, which dominates the run."""
    if kind not in _PAIRS:
        _PAIRS[kind] = (kind, *_pair(kind))
    return _PAIRS[kind]


@pytest.fixture(scope="module", params=sorted(BUDGETS))
def pair(request):
    return _cached_pair(request.param)


def _layout(idx):
    return [(g.n, g.base, g.tier, g.capacity if g.tier != "host" else 0)
            for g in idx.generations]


def _host_cols(run):
    return (np.repeat(run._bin_vals, np.diff(run._bin_starts)),
            np.asarray(run.z), np.asarray(run.pos))


def _assert_same_keys(b1, z1, p1, b2, z2, p2):
    np.testing.assert_array_equal(b1, b2)
    np.testing.assert_array_equal(z1, z2)
    k1 = np.lexsort((p1, z1, b1))
    k2 = np.lexsort((p2, z2, b2))
    np.testing.assert_array_equal(p1[k1], p2[k2])


def assert_same_index(j, p):
    assert len(j) == len(p)
    assert _layout(j) == _layout(p)
    assert j.tier_counts() == p.tier_counts()
    assert j.device_bytes() == p.device_bytes()
    assert j.host_key_bytes() == p.host_key_bytes()
    assert (j.t_min_ms, j.t_max_ms) == (p.t_min_ms, p.t_max_ms)
    for gj, gp in zip(j.generations, p.generations):
        if gj.tier == "host":
            _assert_same_keys(*_host_cols(gj.run), *_host_cols(gp.run))
            continue
        _assert_same_keys(np.asarray(gj.bins), np.asarray(gj.z),
                          np.asarray(gj.pos), gp.bins.numpy(),
                          gp.z.numpy(), gp.pos.numpy())
        if gj.tier == "full":
            for k in ("x", "y", "t"):
                np.testing.assert_array_equal(np.asarray(getattr(gj, k)),
                                              getattr(gp, k).numpy())


EXPECTED_TIERS = {"full": {"full": 8, "keys": 0, "host": 0},
                  "keys": {"full": 0, "keys": 8, "host": 0},
                  "mixed": {"full": 1, "keys": 3, "host": 4}}


def test_layout_keys_and_accounting(pair):
    kind, j, p = pair
    assert p.tier_counts() == EXPECTED_TIERS[kind]
    assert_same_index(j, p)
    assert p.storage_stats()["device_bytes"] == j.device_bytes()


WINDOWS = [
    ([BOX], MS_2018 + 2 * DAY, MS_2018 + 9 * DAY),
    ([BOX], None, None),                                    # open bounds
    ([BOX], MS_2018 + 5 * DAY, None),                       # half open
    ([(-74.9, 40.1, -74.6, 40.4), (-73.4, 41.6, -73.1, 41.9)],
     MS_2018 + DAY, MS_2018 + 30 * DAY),                    # two boxes
    ([(10.0, 10.0, 11.0, 11.0)], MS_2018, MS_2018 + 9 * DAY),   # empty
    ([(-74.2, 40.2, -74.2, 40.2)], None, None),             # a point box
]


#: every window on the store holding all three tiers; the single-tier
#: stores (many full, many keys generations) take a bounded and an
#: open window
CASES = ([("mixed", w) for w in range(len(WINDOWS))]
         + [(k, w) for k in ("full", "keys") for w in (0, 1)])


@pytest.mark.parametrize("kind,w", CASES)
def test_query_parity(kind, w):
    _, j, p = _cached_pair(kind)
    bxs, lo, hi = WINDOWS[w]
    np.testing.assert_array_equal(p.query(bxs, lo, hi), j.query(bxs, lo, hi))


def test_query_many_parity(pair):
    _, j, p = pair
    for got, want in zip(p.query_many(WINDOWS), j.query_many(WINDOWS)):
        np.testing.assert_array_equal(got, want)


def test_two_phase_and_per_generation_fallback(monkeypatch):
    """The full tier's two-phase read (device compaction of the coded
    buffer) and the JAX package's per-generation fallback past its batch
    budget answer alike."""
    _, j, p = _cached_pair("full")
    want = [j.query(*w) for w in WINDOWS]
    monkeypatch.setattr(jl, "_TWO_PHASE_MIN_SLOTS", 1 << 10)
    monkeypatch.setattr(tl, "_TWO_PHASE_MIN_SLOTS", 1 << 10)
    monkeypatch.setattr(jl.LeanZ3Index, "BATCH_SCAN_BUDGET", 1 << 10)
    for w, expect in zip(WINDOWS, want):
        np.testing.assert_array_equal(p.query(*w), expect)
        np.testing.assert_array_equal(j.query(*w), expect)


DENSITY = [
    ([BOX], MS_2018 + 2 * DAY, MS_2018 + 9 * DAY, ENV, 64, 48),  # boxed
    ([BOX], None, None, BOX, 50, 30),                  # boxed, open time
    ([WORLD], None, None, WORLD, 64, 64),              # world sweep, pow2
    ([WORLD], None, None, WORLD, 60, 30),              # world, not pow2
    ([WORLD], None, None, ENV, 32, 32),                # sweep, other env
]


@pytest.mark.parametrize(
    "kind,d", [("mixed", d) for d in range(len(DENSITY))]
    + [(k, d) for k in ("full", "keys") for d in (0, 2)])
def test_density_parity(kind, d):
    _, j, p = _cached_pair(kind)
    bxs, lo, hi, env, w, h = DENSITY[d]
    want = np.asarray(j.density(bxs, lo, hi, env, w, h), np.float64)
    got = p.density(bxs, lo, hi, env, w, h)
    assert got.dtype == np.float64 and got.shape == (h, w)
    np.testing.assert_array_equal(got, want)
    # warm repeat: served in part from the sealed partial cache
    np.testing.assert_array_equal(p.density(bxs, lo, hi, env, w, h), want)


def test_range_count_parity():
    _, j, p = _cached_pair("mixed")
    for bxs, lo, hi in WINDOWS[:2]:
        assert p.range_count(bxs, lo, hi) == j.range_count(bxs, lo, hi)


def test_density_tile_parity():
    _, j, p = _cached_pair("mixed")
    for z, x, y in [(1, 0, 0), (9, 150, 140)]:
        np.testing.assert_array_equal(
            p.density_tile(z, x, y, tile=64),
            np.asarray(j.density_tile(z, x, y, tile=64), np.float64))


@pytest.mark.parametrize("factor", [1, 2, 4])
def test_compaction_parity(factor):
    """Budgeted compaction (budget_ms=0: one group a call) resumes call by
    call to the same layout and answers on both sides."""
    j, p = _pair("mixed")
    while True:
        rj = j.compact(budget_ms=0, factor=factor)
        rp = p.compact(budget_ms=0, factor=factor)
        assert rp == rj
        assert_same_index(j, p)
        if not rj["merged_groups"]:
            break
    assert len(p.generations) < 8
    for w in WINDOWS[:4]:
        np.testing.assert_array_equal(p.query(*w), j.query(*w))
    bxs, lo, hi, env, w, h = DENSITY[0]
    np.testing.assert_array_equal(
        p.density(bxs, lo, hi, env, w, h),
        np.asarray(j.density(bxs, lo, hi, env, w, h), np.float64))


def test_opportunistic_compaction_parity():
    j, p = _pair("mixed", compaction_factor=2)
    assert_same_index(j, p)
    assert p.compactions == j.compactions > 0


def test_density_cache_hits_and_invalidation():
    """Sealed keys/host generations cache their partial per spec; a warm
    call equals the cold one; compaction drops the merged-away ids."""
    _, p = _pair("mixed")
    bxs, lo, hi, env, w, h = DENSITY[0]
    cold = p.density(bxs, lo, hi, env, w, h)
    spec = next(iter(p._density_cache))
    cache = p._density_cache.spec_cache(spec)
    sealed = {g.gen_id for g in p.generations[:-1] if g.tier != "full"}
    assert set(cache) == sealed
    d0 = p.dispatch_count
    np.testing.assert_array_equal(p.density(bxs, lo, hi, env, w, h), cold)
    # only the full (live) generation is scanned again
    assert p.dispatch_count - d0 <= 2
    p.compact(factor=2)
    live_ids = {g.gen_id for g in p.generations}
    assert set(p._density_cache.spec_cache(spec)) <= live_ids
    np.testing.assert_array_equal(p.density(bxs, lo, hi, env, w, h), cold)


def test_gather_payload_parity():
    _, j, p = _cached_pair("mixed")
    pos = np.array([29_999, 5, 17_000, 5, 4_096, 0, 20_480])
    for a, b in zip(p.gather_payload(pos), j.gather_payload(pos)):
        np.testing.assert_array_equal(a, b)


def test_host_budget_spills_every_sealed_run():
    """A budget for one live full generation only: every sealed run
    spills to host RAM, on both sides alike."""
    rows = _rows(n=12_000)
    j = jl.LeanZ3Index(period="week", generation_slots=SLOTS,
                       hbm_budget_bytes=SLOTS * 16 * 6)
    p = tl.LeanZ3Index(period="week", generation_slots=SLOTS,
                       hbm_budget_bytes=SLOTS * 16 * 6, device="cpu")
    j.append(*rows)
    p.append(*rows)
    assert p.tier_counts() == {"full": 1, "keys": 0, "host": 2}
    assert_same_index(j, p)
    np.testing.assert_array_equal(p.query(*WINDOWS[0]), j.query(*WINDOWS[0]))


def test_budget_too_small_raises():
    for cls, kw in ((jl.LeanZ3Index, {}), (tl.LeanZ3Index,
                                           {"device": "cpu"})):
        idx = cls(period="week", generation_slots=SLOTS,
                  hbm_budget_bytes=SLOTS * 16, **kw)
        x, y, t = _rows(n=100)
        with pytest.raises(MemoryError):
            idx.append(x, y, t)


def test_not_ported_raise():
    """Pyramids and the z3 cell-count fold, once left out (and raising),
    are ported: they answer as the JAX index does."""
    j, p = _pair("full", rows=_rows(n=2_000))
    assert p.build_pyramids(base=64) == j.build_pyramids(base=64)
    assert p.z3_cell_counts(8) == j.z3_cell_counts(8)


def test_convert_carries_state():
    """A JAX index's generations (all three tiers) carried into the port
    answer queries and grids as the JAX index does, and its state
    round-trips."""
    _, j, _ = _cached_pair("mixed")
    state = convert.lean_z3_index_state(j)
    p = convert.lean_z3_index_from_state(state, device="cpu")
    assert_same_index(j, p)
    for w in WINDOWS[:2]:
        np.testing.assert_array_equal(p.query(*w), j.query(*w))
    for bxs, lo, hi, env, w, h in (DENSITY[0], DENSITY[2]):
        np.testing.assert_array_equal(
            p.density(bxs, lo, hi, env, w, h),
            np.asarray(j.density(bxs, lo, hi, env, w, h), np.float64))
    back = convert.lean_z3_index_state(p)
    assert [(g["tier"], g["n"], g["base"], g["gen_id"])
            for g in back["generations"]] == [
        (g["tier"], g["n"], g["base"], g["gen_id"])
        for g in state["generations"]]
