"""Port parity: the z3 point index of geomesa_tpu_torch against
geomesa_tpu's, on the same rows — built from raw rows in both packages,
and from one resident state carried across with ``convert``.

Sorted keys are compared bit for bit; ``pos`` within runs of equal
``(bin, z)`` keys only as multisets (the JAX sort leaves ties in no
fixed order); query positions are sorted and must be equal outright.
"""

import numpy as np
import pytest
import torch

from geomesa_tpu.index import z3 as jz3
from geomesa_tpu_torch import convert
from geomesa_tpu_torch.index import z3 as tz3

MS_2018 = 1514764800000
DAY = 86_400_000


def oracle(x, y, t, boxes, tlo, thi):
    m = np.zeros(len(x), dtype=bool)
    for b in np.atleast_2d(boxes):
        m |= (x >= b[0]) & (x <= b[2]) & (y >= b[1]) & (y <= b[3])
    return np.flatnonzero(m & (t >= tlo) & (t <= thi))


def _rows(seed, n, days=30):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-75.0, -73.0, n)
    y = rng.uniform(40.0, 42.0, n)
    t = rng.integers(MS_2018, MS_2018 + days * DAY, n)
    # exact duplicates: equal (bin, z) runs whose pos order may differ
    x[:50], y[:50], t[:50] = x[50:100], y[50:100], t[50:100]
    return x, y, t


def assert_same_state(tidx, jidx):
    n = len(jidx)
    assert len(tidx) == n
    tb, tz, tp = (getattr(tidx, k).cpu().numpy()[:n] for k in ("bins", "z", "pos"))
    jb, jz, jp = (np.asarray(getattr(jidx, k))[:n] for k in ("bins", "z", "pos"))
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tz, jz)
    # pos: equal multisets within each run of equal (bin, z) keys
    key_t = np.lexsort((tp, tz, tb))
    key_j = np.lexsort((jp, jz, jb))
    np.testing.assert_array_equal(tp[key_t], jp[key_j])
    assert (tidx.t_min_ms, tidx.t_max_ms) == (jidx.t_min_ms, jidx.t_max_ms)


QUERIES = [
    ([(-74.5, 40.5, -73.5, 41.5)], MS_2018 + DAY, MS_2018 + 5 * DAY),
    ([(-74.5, 40.5, -73.5, 41.5)], MS_2018, MS_2018 + 30 * DAY),
    ([(-75.0, 40.0, -74.0, 41.0), (-73.8, 41.2, -73.1, 41.9)],
     MS_2018 + 3 * DAY, MS_2018 + 17 * DAY),
    ([(10.0, 10.0, 11.0, 11.0)], MS_2018, MS_2018 + 9 * DAY),   # empty
    ([(-74.2, 40.2, -74.2, 40.2)], None, None),                 # open interval
]


@pytest.fixture(scope="module")
def pair():
    x, y, t = _rows(99, 20_000)
    return (x, y, t), tz3.Z3PointIndex.build(x, y, t, device="cpu"), \
        jz3.Z3PointIndex.build(x, y, t)


def test_build_matches_jax(pair):
    _, tidx, jidx = pair
    assert_same_state(tidx, jidx)
    assert tidx.bins.dtype == torch.int32 and tidx.z.dtype == torch.int64


@pytest.mark.parametrize("q", range(len(QUERIES)))
def test_query_matches_jax(pair, q):
    (x, y, t), tidx, jidx = pair
    boxes, lo, hi = QUERIES[q]
    got = tidx.query(boxes, lo, hi)
    np.testing.assert_array_equal(got, jidx.query(boxes, lo, hi))
    lo = MS_2018 if lo is None else lo
    hi = MS_2018 + 30 * DAY if hi is None else hi
    np.testing.assert_array_equal(got, oracle(x, y, t, boxes, lo, hi))


def test_query_many_matches_jax(pair):
    _, tidx, jidx = pair
    windows = [QUERIES[0], QUERIES[2], QUERIES[3]]
    for g, w in zip(tidx.query_many(windows), jidx.query_many(windows)):
        np.testing.assert_array_equal(g, w)


def test_two_phase_matches_jax(monkeypatch, pair):
    (x, y, t), _, _ = pair
    monkeypatch.setattr(tz3, "TWO_PHASE_MIN_CAPACITY", 1)
    monkeypatch.setattr(jz3, "TWO_PHASE_MIN_CAPACITY", 1)
    tidx = tz3.Z3PointIndex.build(x, y, t, device="cpu")
    jidx = jz3.Z3PointIndex.build(x, y, t)
    for boxes, lo, hi in QUERIES[:4]:
        got = tidx.query(boxes, lo, hi)
        np.testing.assert_array_equal(got, jidx.query(boxes, lo, hi))
    # the capacity regrows and decays alike
    assert tidx._capacity == jidx._capacity


def test_append_matches_jax():
    x, y, t = _rows(17, 5_000, days=21)
    tidx = tz3.Z3PointIndex.build(x, y, t, device="cpu")
    jidx = jz3.Z3PointIndex.build(x, y, t)
    rng = np.random.default_rng(18)
    for m in (1, 300, 4_000):
        nx = rng.uniform(-75.0, -73.0, m)
        ny = rng.uniform(40.0, 42.0, m)
        nt = rng.integers(MS_2018 - DAY, MS_2018 + 30 * DAY, m)
        tidx.append(nx, ny, nt)
        jidx.append(nx, ny, nt)
        x, y, t = (np.concatenate(p) for p in ((x, nx), (y, ny), (t, nt)))
        assert_same_state(tidx, jidx)
        # sentinels fill the capacity padding past the rows, sorted last
        assert tidx.z.shape == np.asarray(jidx.z).shape
        assert (tidx.z[len(tidx):] == tz3._SENTINEL_Z).all()
        for boxes, lo, hi in QUERIES[:3]:
            got = tidx.query(boxes, lo, hi)
            np.testing.assert_array_equal(got, jidx.query(boxes, lo, hi))
            np.testing.assert_array_equal(got, oracle(x, y, t, boxes, lo, hi))
    tidx.append([], [], [])
    assert len(tidx) == len(x)


def test_state_round_trip_queries_match_jax():
    """One resident state (with append padding) queried through both
    packages, and carried back unchanged."""
    x, y, t = _rows(5, 6_000)
    jidx = jz3.Z3PointIndex.build(x[:4_000], y[:4_000], t[:4_000])
    jidx.append(x[4_000:], y[4_000:], t[4_000:])
    state = convert.z3_index_state(jidx)
    tidx = convert.z3_index_from_state(state, device="cpu")
    for boxes, lo, hi in QUERIES:
        np.testing.assert_array_equal(tidx.query(boxes, lo, hi),
                                      jidx.query(boxes, lo, hi))
    windows = [QUERIES[1], QUERIES[2]]
    for g, w in zip(tidx.query_many(windows), jidx.query_many(windows)):
        np.testing.assert_array_equal(g, w)
    back = convert.z3_index_state(tidx)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v)


def test_build_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tz3.Z3PointIndex.build([0.0], [0.0], [MS_2018])
    with pytest.raises(RuntimeError):
        convert.z3_index_from_state(
            convert.z3_index_state(
                tz3.Z3PointIndex.build([0.0], [0.0], [MS_2018], device="cpu")))


def test_legacy_layout_is_not_ported():
    """The v1 layout (the legacy curve) is ported since the lifecycle
    slice: a v1 index keys and answers as the JAX package's v1 index,
    built directly and carried across in its state."""
    x, y, t = _rows(5, 6_000)
    jidx = jz3.Z3PointIndex.build(x, y, t, version=1)
    tidx = tz3.Z3PointIndex.build(x, y, t, version=1, device="cpu")
    assert tidx.version == 1
    carried = convert.z3_index_from_state(convert.z3_index_state(jidx),
                                          device="cpu")
    for boxes, lo, hi in QUERIES:
        want = jidx.query(boxes, lo, hi)
        np.testing.assert_array_equal(tidx.query(boxes, lo, hi), want)
        np.testing.assert_array_equal(carried.query(boxes, lo, hi), want)
