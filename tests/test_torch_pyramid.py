"""Port parity: sealed-generation density pyramids of geomesa_tpu_torch's
``LeanZ3Index`` against geomesa_tpu's, fed the same seeded rows.

Held equal, bit for bit: the direct and the pyramid-served whole-world
grids at every ladder level on all three tiers (full, keys, host), after
live appends, after compaction (the merged run inherits its parents'
summed pyramid) and after an interrupted build; slippy tiles in and past
the pyramid base; the 2×2 reduction ladder; the store's
``build_pyramids`` and its build-on-seal trigger."""

import numpy as np
import pytest
import torch

from geomesa_tpu import config as jax_config
from geomesa_tpu.datastore import TpuDataStore as JaxStore
from geomesa_tpu.index.pyramid import pyramid_spec as jax_pyramid_spec
from geomesa_tpu.index.z3_lean import LeanZ3Index as JaxLean
from geomesa_tpu.ops.density import pyramid_reduce as jax_reduce
from geomesa_tpu_torch import TpuDataStore
from geomesa_tpu_torch.index import z3_lean
from geomesa_tpu_torch.index.pyramid import (
    DensityPyramid, _ladder_depth, pyramid_spec,
)
from geomesa_tpu_torch.index.z3_lean import LeanZ3Index
from geomesa_tpu_torch.ops.density import pyramid_reduce, pyramid_reduce_np

MS = 1514764800000
DAY = 86_400_000
WORLD = (-180.0, -90.0, 180.0, 90.0)
SLOTS = 1 << 11


def _data(n, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-75, -73, n), rng.uniform(40, 42, n),
            rng.integers(MS, MS + 14 * DAY, n))


def _streamed(n_gens, payload=False, budget=None, seed=3):
    """The same rows streamed into a JAX and a port lean index."""
    x, y, t = _data(n_gens * SLOTS, seed=seed)
    kw = dict(period="week", generation_slots=SLOTS,
              payload_on_device=payload, hbm_budget_bytes=budget,
              compaction_factor=0)
    jidx, tidx = JaxLean(**kw), LeanZ3Index(device="cpu", **kw)
    for lo in range(0, len(x), SLOTS):
        sl = slice(lo, lo + SLOTS)
        jidx.append(x[sl], y[sl], t[sl])
        tidx.append(x[sl], y[sl], t[sl])
    return jidx, tidx


def _world(idx, w):
    return idx.density([WORLD], None, None, WORLD, w, w)


@pytest.mark.parametrize("payload,budget", [
    (True, None),                 # all full
    (False, None),                # all keys
    (False, 3 * SLOTS * 16),      # keys and host (forced demotions)
], ids=["full", "keys", "host"])
def test_pyramid_served_density_bit_exact_all_tiers(payload, budget):
    jidx, tidx = _streamed(6, payload=payload, budget=budget)
    assert tidx.tier_counts() == jidx.tier_counts()
    direct = _world(tidx, 128)
    np.testing.assert_array_equal(direct, _world(jidx, 128))
    built = tidx.build_pyramids(base=128)
    assert built == jidx.build_pyramids(base=128) == len(tidx.generations) - 1
    assert tidx.build_pyramids(base=128) == 0      # idempotent resume
    hits = tidx.pyramid_serve_hits
    served = _world(tidx, 128)
    assert tidx.pyramid_serve_hits - hits == built
    np.testing.assert_array_equal(served, direct)
    w = 64
    while w >= 1:     # every level the 2x2 ladder carries
        np.testing.assert_array_equal(_world(tidx, w), _world(jidx, w))
        w //= 2
    jc = jidx._pyramid_cache.spec_cache(jax_pyramid_spec(128))
    tc = tidx._pyramid_cache.spec_cache(pyramid_spec(128))
    assert sorted(tc) == sorted(jc)
    for gid in tc:
        assert sorted(tc[gid].levels) == sorted(jc[gid].levels)
        for lw, grid in tc[gid].levels.items():
            assert grid.dtype == np.float64
            np.testing.assert_array_equal(grid, jc[gid].levels[lw])


def test_partial_ladder_and_rectangular_grids():
    jidx, tidx = _streamed(3)
    assert (tidx.build_pyramids(base=64, levels=2)
            == jidx.build_pyramids(base=64, levels=2) == 2)
    pyr = tidx._pyramid_cache.spec_cache(pyramid_spec(64))[1]
    assert sorted(pyr.levels) == [16, 32, 64]
    hits = tidx.pyramid_serve_hits
    for w, h in ((8, 8), (64, 32), (32, 32)):
        np.testing.assert_array_equal(
            tidx.density([WORLD], None, None, WORLD, w, h),
            jidx.density([WORLD], None, None, WORLD, w, h))
    assert tidx.pyramid_serve_hits - hits == 2    # only the 32x32 grid


def test_pyramid_never_stales_live_appends():
    jidx, tidx = _streamed(3)
    tidx.build_pyramids(base=64)
    jidx.build_pyramids(base=64)
    x2, y2, t2 = _data(500, seed=11)
    for idx in (jidx, tidx):
        idx.append(x2, y2, t2)
    np.testing.assert_array_equal(_world(tidx, 64), _world(jidx, 64))
    assert _world(tidx, 64).sum() == 3 * SLOTS + 500


def test_empty_index_builds_nothing_and_serves_zeros():
    idx = LeanZ3Index(period="week", generation_slots=SLOTS, device="cpu")
    assert idx.build_pyramids(base=64) == 0
    assert _world(idx, 64).sum() == 0


def test_base_must_be_a_power_of_two():
    _, tidx = _streamed(2)
    with pytest.raises(ValueError, match="power of two"):
        tidx.build_pyramids(base=96)


def test_tiles_reassemble_exactly_and_fall_back_past_base(monkeypatch):
    jidx, tidx = _streamed(4)
    tidx.build_pyramids(base=128)
    jidx.build_pyramids(base=128)
    np.testing.assert_array_equal(tidx.density_tile(0, 0, 0, tile=64),
                                  _world(jidx, 64))
    assembled = np.zeros((128, 128))
    for ty in range(2):
        for tx in range(2):
            got = tidx.density_tile(1, tx, ty, tile=64)
            np.testing.assert_array_equal(
                got, jidx.density_tile(1, tx, ty, tile=64))
            assembled[(1 - ty) * 64:(2 - ty) * 64,
                      tx * 64:(tx + 1) * 64] = got
    np.testing.assert_array_equal(assembled, _world(jidx, 128))
    # finer than the pyramid base: the direct bbox scan, in both
    monkeypatch.setenv("GEOMESA_DENSITY_PYRAMID_BASE", "128")
    jax_config.clear_property("geomesa.density.pyramid.base")
    hits = tidx.pyramid_serve_hits
    np.testing.assert_array_equal(tidx.density_tile(2, 1, 1, tile=64),
                                  jidx.density_tile(2, 1, 1, tile=64))
    assert tidx.pyramid_serve_hits == hits


def test_compaction_inherits_summed_pyramids_and_drops_dead():
    jidx, tidx = _streamed(12)      # keys tier: what compaction merges
    assert tidx.build_pyramids(base=64) == jidx.build_pyramids(base=64) == 11
    pre = set(tidx._pyramid_cache.spec_cache(pyramid_spec(64)))
    res = tidx.compact()
    assert res == jidx.compact()
    assert res["merged_groups"] >= 1
    post = set(tidx._pyramid_cache.spec_cache(pyramid_spec(64)))
    assert post <= {g.gen_id for g in tidx.generations}   # dead dropped
    assert post - pre                                        # inherited
    assert post == set(jidx._pyramid_cache.spec_cache(jax_pyramid_spec(64)))
    assert tidx.build_pyramids(base=64) == 0
    hits = tidx.pyramid_serve_hits
    np.testing.assert_array_equal(_world(tidx, 64), _world(jidx, 64))
    assert tidx.pyramid_serve_hits - hits == len(tidx.generations) - 1
    assert _world(tidx, 64).sum() == 12 * SLOTS


def test_interrupted_build_stays_exact_and_resumes(monkeypatch):
    from geomesa_tpu.resilience import FaultInjected

    jidx, tidx = _streamed(5)
    want = _world(jidx, 64)
    jax_config.set_property("geomesa.resilience.fault.points",
                            "pyramid.build:2")
    try:
        with pytest.raises(FaultInjected):
            jidx.build_pyramids(base=64)
    finally:
        jax_config.clear_property("geomesa.resilience.fault.points")
    sweep = LeanZ3Index._sweep_device
    calls = []

    def failing_second(self, *a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("interrupted build")
        return sweep(self, *a, **kw)

    monkeypatch.setattr(LeanZ3Index, "_sweep_device", failing_second)
    with pytest.raises(RuntimeError, match="interrupted"):
        tidx.build_pyramids(base=64)
    monkeypatch.setattr(LeanZ3Index, "_sweep_device", sweep)
    tc = tidx._pyramid_cache.spec_cache(pyramid_spec(64))
    assert len(tc) == len(jidx._pyramid_cache.spec_cache(
        jax_pyramid_spec(64))) == 1
    np.testing.assert_array_equal(_world(tidx, 64), want)
    assert tidx.build_pyramids(base=64) == jidx.build_pyramids(base=64) == 3
    np.testing.assert_array_equal(_world(tidx, 64), want)


@pytest.mark.parametrize("w,levels", [(1, 0), (2, 0), (64, 0), (256, 3),
                                      (128, 9)])
def test_pyramid_reduce_matches_reference(w, levels):
    rng = np.random.default_rng(w)
    grid = rng.integers(0, 1000, (w, w)).astype(np.float64)
    depth = _ladder_depth(w, levels)
    want = [np.asarray(g) for g in jax_reduce(grid, depth)]
    got = [g.numpy() for g in pyramid_reduce(torch.from_numpy(grid), depth)]
    got_np = list(pyramid_reduce_np(grid, depth))
    assert len(got) == len(got_np) == len(want) == depth
    for a, b, c in zip(got, got_np, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    pyr = DensityPyramid.from_base(grid, levels)
    assert sorted(pyr.levels) == [w >> k for k in range(depth, -1, -1)]
    assert pyr.base == w and pyr.nbytes == sum(
        g.nbytes for g in pyr.levels.values())
    assert DensityPyramid.sum([pyr, pyr]).level(w).sum() == 2 * grid.sum()


def test_pyramid_sum_needs_equal_level_sets():
    g = np.ones((4, 4))
    assert DensityPyramid.sum([DensityPyramid.from_base(g),
                               DensityPyramid.from_base(g, 1)]) is None
    assert DensityPyramid.sum([]) is None


# -- the store -------------------------------------------------------------
SPEC = ("dtg:Date,*geom:Point;geomesa.index.profile=lean,"
        f"geomesa.lean.generation.slots={SLOTS},"
        "geomesa.lean.compaction.factor=0")


def _store_writes(ds, n=3 * SLOTS + 100):
    x, y, t = _data(n)
    for lo in range(0, n, SLOTS):
        sl = slice(lo, lo + SLOTS)
        ds.write("sealed", {"dtg": t[sl], "geom": (x[sl], y[sl])})


def test_store_build_pyramids_and_tiles_match_reference():
    jds, tds = JaxStore(), TpuDataStore(device="cpu")
    for ds in (jds, tds):
        ds.create_schema("sealed", SPEC)
        _store_writes(ds)
        ds.create_schema("plain", "dtg:Date,*geom:Point")
    assert tds.build_pyramids("sealed") == jds.build_pyramids("sealed") == 3
    assert tds.build_pyramids("plain") == jds.build_pyramids("plain") == 0
    for z, x, y in ((0, 0, 0), (1, 0, 0), (1, 0, 1)):
        np.testing.assert_array_equal(
            tds.density_tile("sealed", z, x, y, tile=128),
            jds.density_tile("sealed", z, x, y, tile=128))


@pytest.fixture
def seal_trigger(monkeypatch):
    for k, v in (("GEOMESA_DENSITY_PYRAMID_BUILD", "seal"),
                 ("GEOMESA_DENSITY_PYRAMID_BASE", "64")):
        monkeypatch.setenv(k, v)
    for name in ("geomesa.density.pyramid.build",
                 "geomesa.density.pyramid.base"):
        jax_config.clear_property(name)


def test_build_on_seal_trigger(seal_trigger):
    jds, tds = JaxStore(), TpuDataStore(device="cpu")
    for ds in (jds, tds):
        ds.create_schema("sealed", SPEC)
        _store_writes(ds)
    tidx = tds._store("sealed").index("z3")
    jidx = jds._store("sealed")._lean_index()
    tc = tidx._pyramid_cache.spec_cache(pyramid_spec(64))
    sealed = [g.gen_id for g in tidx.generations[:-1]]
    assert len(sealed) == 3 and all(gid in tc for gid in sealed)
    assert set(tc) == set(jidx._pyramid_cache.spec_cache(
        jax_pyramid_spec(64)))
    assert tds._store("sealed").pyramid_build_failures == 0


def test_failed_seal_build_never_fails_the_write(seal_trigger, monkeypatch):
    def boom(self, *a, **kw):
        raise RuntimeError("build failed")

    monkeypatch.setattr(z3_lean.LeanZ3Index, "build_pyramids", boom)
    tds = TpuDataStore(device="cpu")
    tds.create_schema("sealed", SPEC)
    _store_writes(tds)
    st = tds._store("sealed")
    assert st.pyramid_build_failures == 3
    assert str(st.pyramid_build_error) == "build failed"
    assert len(tds.query_result("sealed", "INCLUDE").positions) == \
        3 * SLOTS + 100
