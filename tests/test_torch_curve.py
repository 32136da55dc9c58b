"""Port parity: the curve layer of geomesa_tpu_torch against geomesa_tpu.

Same inputs (numpy, from a seed) through both packages; keys and
decoded dimensions must be equal bit for bit.
"""

import numpy as np
import pytest
import torch

from geomesa_tpu.curve import (
    TimePeriod,
    deinterleave2 as j_deinterleave2,
    deinterleave3 as j_deinterleave3,
    interleave2 as j_interleave2,
    interleave3 as j_interleave3,
    max_offset,
    to_binned_time as j_to_binned_time,
    z2_sfc as j_z2_sfc,
    z3_sfc as j_z3_sfc,
)
from geomesa_tpu_torch.curve import (
    deinterleave2,
    deinterleave3,
    interleave2,
    interleave3,
    to_binned_time,
    z2_sfc,
    z3_sfc,
)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_interleave3_roundtrip_matches_jax():
    rng = np.random.default_rng(1)
    dims = [rng.integers(0, 1 << 21, 5000, dtype=np.int64) for _ in range(3)]
    dims = [np.concatenate([d, [0, (1 << 21) - 1]]) for d in dims]
    z = interleave3(*map(_t, dims)).numpy()
    zj = np.asarray(j_interleave3(*dims, xp=np)).astype(np.int64)
    np.testing.assert_array_equal(z, zj)
    assert z.max() < (1 << 63) and z.min() >= 0
    for got, want, orig in zip(deinterleave3(_t(z)),
                               j_deinterleave3(zj, xp=np), dims):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
        np.testing.assert_array_equal(got.numpy(), orig)


def test_interleave2_roundtrip_matches_jax():
    rng = np.random.default_rng(2)
    dims = [rng.integers(0, 1 << 31, 5000, dtype=np.int64) for _ in range(2)]
    z = interleave2(*map(_t, dims)).numpy()
    zj = np.asarray(j_interleave2(*dims, xp=np)).astype(np.int64)
    np.testing.assert_array_equal(z, zj)
    for got, want in zip(deinterleave2(_t(z)), j_deinterleave2(zj, xp=np)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("period", ["day", "week", "month", "year"])
def test_z3_index_edges_match_jax(period):
    """Encode/decode at the edges: lon ±180, lat ±90, t = max offset, and
    values past both ends (which clamp)."""
    rng = np.random.default_rng(3)
    mo = float(max_offset(TimePeriod.parse(period)))
    x = np.concatenate([rng.uniform(-180, 180, 2000),
                        [-180.0, 180.0, -181.5, 200.0, 0.0, -0.0]])
    y = np.concatenate([rng.uniform(-90, 90, 2000),
                        [-90.0, 90.0, -95.0, 91.0, 0.0, 1e-12]])
    t = np.concatenate([rng.uniform(0, mo, 2000),
                        [0.0, mo, -5.0, mo + 10.0, mo - 1.0, 0.5]])
    sfc, jsfc = z3_sfc(period), j_z3_sfc(period)
    z = sfc.index(_t(x), _t(y), _t(t))
    assert z.dtype == torch.int64
    zj = np.asarray(jsfc.index(x, y, t)).astype(np.int64)
    np.testing.assert_array_equal(z.numpy(), zj)
    for got, want in zip(sfc.invert(z), jsfc.invert(zj)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for dim, jdim, v in ((sfc.lon, jsfc.lon, x), (sfc.lat, jsfc.lat, y),
                         (sfc.time, jsfc.time, t)):
        got = dim.normalize(_t(v))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jdim.normalize(v, xp=np)))
        assert [dim.normalize_scalar(float(a)) for a in v[-6:]] == \
            [jdim.normalize_scalar(float(a)) for a in v[-6:]]


@pytest.mark.parametrize("boxes,window,budget", [
    ([(-74.5, 40.5, -73.5, 41.5)], (1000, 200000), 2000),
    ([(-10.0, -10.0, 10.0, 10.0), (100.0, 20.0, 120.0, 30.0)],
     (0, 604800), 2000),
    ([(-180.0, -90.0, 180.0, 90.0)], (0, 604800), 2000),
    ([(2.0, 48.0, 2.5, 49.0)], (3600, 7200), 64),
    ([(179.0, 89.0, 180.0, 90.0)], (604000, 604800), 500),
])
def test_z3_ranges_match_jax(boxes, window, budget):
    got = z3_sfc("week").ranges(boxes, [window], max_ranges=budget)
    want = j_z3_sfc("week").ranges(boxes, [window], max_ranges=budget)
    assert got.dtype == np.int64 and len(got) > 0
    np.testing.assert_array_equal(got, want)


def test_z2_index_edges_match_jax():
    """Encode/decode at the edges: lon ±180, lat ±90, and values past
    both ends (which clamp)."""
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.uniform(-180, 180, 3000),
                        [-180.0, 180.0, -181.5, 200.0, 0.0, -0.0]])
    y = np.concatenate([rng.uniform(-90, 90, 3000),
                        [-90.0, 90.0, -95.0, 91.0, 0.0, 1e-12]])
    sfc, jsfc = z2_sfc(), j_z2_sfc()
    z = sfc.index(_t(x), _t(y))
    assert z.dtype == torch.int64
    zj = np.asarray(jsfc.index(x, y, xp=np)).astype(np.int64)
    np.testing.assert_array_equal(z.numpy(), zj)
    assert z.max() < (1 << 62) and z.min() >= 0
    for got, want in zip(sfc.invert(z), jsfc.invert(zj)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("boxes,budget", [
    ([(-74.5, 40.5, -73.5, 41.5)], 2000),
    ([(-10.0, -10.0, 10.0, 10.0), (100.0, 20.0, 120.0, 30.0)], 2000),
    ([(-180.0, -90.0, 180.0, 90.0)], 2000),
    ([(2.0, 48.0, 2.5, 49.0)], 8),
    ([(179.0, 89.0, 180.0, 90.0)], 500),
])
def test_z2_ranges_match_jax(boxes, budget):
    got = z2_sfc().ranges(boxes, max_ranges=budget)
    want = j_z2_sfc().ranges(boxes, max_ranges=budget)
    assert got.dtype == np.int64 and len(got) > 0
    np.testing.assert_array_equal(got, want)


def test_binned_time_matches_jax():
    rng = np.random.default_rng(4)
    ms = rng.integers(0, 2_800_000_000_000, 3000)  # < day max date
    for period in ("day", "week", "month", "year"):
        for got, want in zip(to_binned_time(ms, period),
                             j_to_binned_time(ms, period)):
            np.testing.assert_array_equal(got, want)
