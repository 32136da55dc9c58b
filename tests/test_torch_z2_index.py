"""Port parity: the z2 point index and the z2 candidate mask of
geomesa_tpu_torch against geomesa_tpu's, on the same points.

The index cases are those of tests/test_z2_index.py.  Sorted keys are
compared bit for bit; ``pos`` within runs of equal z only as multisets
(the JAX sort leaves ties in no fixed order); query positions are sorted
and must be equal outright, to the JAX package and to a brute-force
oracle.  ``density_world`` counts are exact.  The mask's plain version is
held against ``z2_mask_pallas`` run in interpret mode, bit for bit.
"""

import numpy as np
import pytest
import torch

from geomesa_tpu.curve import z2_sfc as j_z2_sfc
from geomesa_tpu.index import z2 as jz2
from geomesa_tpu.ops.pallas_kernels import z2_mask_pallas
from geomesa_tpu_torch import convert
from geomesa_tpu_torch.index import z2 as tz2
from geomesa_tpu_torch.ops.z2_mask import z2_mask


def oracle(x, y, boxes):
    m = np.zeros(len(x), dtype=bool)
    for b in np.atleast_2d(boxes):
        m |= (x >= b[0]) & (x <= b[2]) & (y >= b[1]) & (y <= b[3])
    return np.flatnonzero(m)


def _points(seed, n):
    """Clustered + uniform, world-wide, with exact duplicates (equal-z runs
    whose pos order may differ) and the world's corner values."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.uniform(-180, 180, n // 2),
                        rng.normal(2.35, 0.5, n - n // 2).clip(-180, 180)])
    y = np.concatenate([rng.uniform(-90, 90, n // 2),
                        rng.normal(48.85, 0.5, n - n // 2).clip(-90, 90)])
    x[:50], y[:50] = x[50:100], y[50:100]
    x[100:104] = [-180.0, 180.0, 0.0, 180.0]
    y[100:104] = [-90.0, 90.0, 0.0, -90.0]
    return x, y


def assert_same_state(tidx, jidx):
    n = len(jidx)
    assert len(tidx) == n
    tz, tp = (getattr(tidx, k).cpu().numpy()[:n] for k in ("z", "pos"))
    jz, jp = (np.asarray(getattr(jidx, k))[:n] for k in ("z", "pos"))
    np.testing.assert_array_equal(tz, jz)
    # pos: equal multisets within each run of equal z keys
    np.testing.assert_array_equal(tp[np.lexsort((tp, tz))],
                                  jp[np.lexsort((jp, jz))])


@pytest.fixture(scope="module")
def pair():
    x, y = _points(17, 120_000)
    return (x, y), tz2.Z2PointIndex.build(x, y, device="cpu"), \
        jz2.Z2PointIndex.build(x, y)


def test_build_matches_jax(pair):
    (x, _), tidx, jidx = pair
    assert_same_state(tidx, jidx)
    assert tidx.z.dtype == torch.int64 and tidx.pos.dtype == torch.int32
    # the index owns its coordinate columns
    assert tidx.x.dtype == torch.float64
    assert not np.shares_memory(tidx.x.numpy(), x)


QUERIES = {
    "single": ([(2.0, 48.5, 2.7, 49.1)], {}),
    "multi_or": ([(2.0, 48.5, 2.7, 49.1), (-123.3, 37.2, -121.7, 38.1),
                  (139.0, 35.0, 140.5, 36.2)], {}),
    "overlapping": ([(2.0, 48.5, 2.7, 49.1), (2.3, 48.7, 3.0, 49.3)], {}),
    "world": ([(-180.0, -90.0, 180.0, 90.0)], {}),
    "empty": ([(-179.99, -0.001, -179.98, 0.001)], {}),
    "west_edge": ([(-180.0, -90.0, -179.0, 90.0)], {}),
    "east_edge": ([(179.0, -90.0, 180.0, 90.0)], {}),
    "budget": ([(0.0, 40.0, 25.0, 55.0)], {"max_ranges": 8}),
}


@pytest.mark.parametrize("case", sorted(QUERIES))
def test_query_matches_jax(pair, case):
    (x, y), tidx, jidx = pair
    boxes, kw = QUERIES[case]
    got = tidx.query(boxes, **kw)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jidx.query(boxes, **kw))
    np.testing.assert_array_equal(got, oracle(x, y, boxes))
    assert len(got) == len(np.unique(got))


def test_query_many_matches_singles_and_jax(pair):
    _, tidx, jidx = pair
    sets = [QUERIES[k][0] for k in ("single", "multi_or", "empty",
                                    "east_edge", "overlapping")]
    batched = tidx.query_many(sets)
    for boxes, got, want in zip(sets, batched, jidx.query_many(sets)):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, tidx.query(boxes))
    assert tidx.query_many([]) == []


@pytest.mark.parametrize("w,h", [(256, 128), (64, 64), (16, 8), (8, 32)])
def test_density_world_matches_jax(pair, w, h):
    _, tidx, jidx = pair
    got = tidx.density_world(w, h)
    assert got.shape == (h, w) and got.dtype == np.float64
    np.testing.assert_array_equal(got, np.asarray(jidx.density_world(w, h)))
    assert got.sum() == len(tidx)


def test_density_world_rejects_non_pow2(pair):
    _, tidx, _ = pair
    with pytest.raises(ValueError):
        tidx.density_world(100, 64)


def test_append_matches_jax():
    x, y = _points(5, 6_000)
    tidx = tz2.Z2PointIndex.build(x, y, device="cpu")
    jidx = jz2.Z2PointIndex.build(x, y)
    rng = np.random.default_rng(6)
    for m in (1, 300, 4_000):
        nx = rng.uniform(-10.0, 10.0, m)
        ny = rng.uniform(40.0, 55.0, m)
        tidx.append(nx, ny)
        jidx.append(nx, ny)
        x, y = np.concatenate([x, nx]), np.concatenate([y, ny])
        assert_same_state(tidx, jidx)
        # sentinels fill the capacity padding past the rows, sorted last
        assert tidx.z.shape == np.asarray(jidx.z).shape
        assert (tidx.z[len(tidx):] == tz2._SENTINEL_Z2).all()
        for boxes, kw in (QUERIES["single"], QUERIES["multi_or"],
                          ([(-5.0, 45.0, 5.0, 50.0)], {})):
            got = tidx.query(boxes, **kw)
            np.testing.assert_array_equal(got, jidx.query(boxes, **kw))
            np.testing.assert_array_equal(got, oracle(x, y, boxes))
        np.testing.assert_array_equal(tidx.density_world(64, 32),
                                      np.asarray(jidx.density_world(64, 32)))
    tidx.append([], [])
    assert len(tidx) == len(x)


def test_state_round_trip_queries_match_jax():
    """One resident state (with append padding) queried through both
    packages, and carried back unchanged."""
    x, y = _points(8, 6_000)
    jidx = jz2.Z2PointIndex.build(x[:4_000], y[:4_000])
    jidx.append(x[4_000:], y[4_000:])
    state = convert.z2_index_state(jidx)
    tidx = convert.z2_index_from_state(state, device="cpu")
    assert len(tidx) == 6_000 and tidx.z.shape[0] > 6_000
    for boxes, kw in QUERIES.values():
        np.testing.assert_array_equal(tidx.query(boxes, **kw),
                                      jidx.query(boxes, **kw))
    back = convert.z2_index_state(tidx)
    assert back.keys() == state.keys()
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v)


def test_build_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tz2.Z2PointIndex.build([0.0], [0.0])
    with pytest.raises(RuntimeError):
        convert.z2_index_from_state(convert.z2_index_state(
            tz2.Z2PointIndex.build([0.0], [0.0], device="cpu")))


def test_legacy_layout_is_not_ported():
    """The v1 layout (the legacy curve) is ported since the lifecycle
    slice: a v1 index keys and answers as the JAX package's v1 index,
    built directly and carried across in its state."""
    x, y = _points(8, 6_000)
    jidx = jz2.Z2PointIndex.build(x, y, version=1)
    tidx = tz2.Z2PointIndex.build(x, y, version=1, device="cpu")
    assert tidx.version == 1
    carried = convert.z2_index_from_state(convert.z2_index_state(jidx),
                                          device="cpu")
    for boxes, kw in QUERIES.values():
        want = jidx.query(boxes, **kw)
        np.testing.assert_array_equal(tidx.query(boxes, **kw), want)
        np.testing.assert_array_equal(carried.query(boxes, **kw), want)


# -- the z2 candidate mask ---------------------------------------------------

def _mask_case(n, seed, boxes, pad_to=None):
    """Random z2 keys and the int-space bounds of ``boxes``, optionally
    with never-matching [1, 1, 0, 0] padding boxes."""
    rng = np.random.default_rng(seed)
    sfc = j_z2_sfc()
    z = np.asarray(sfc.index(rng.uniform(-180, 180, n),
                             rng.uniform(-90, 90, n), xp=np)).astype(np.int64)
    ixy = np.array([[sfc.lon.normalize_scalar(b[0]),
                     sfc.lat.normalize_scalar(b[1]),
                     sfc.lon.normalize_scalar(b[2]),
                     sfc.lat.normalize_scalar(b[3])] for b in boxes],
                   dtype=np.int32).reshape(-1, 4)
    if pad_to is not None:
        ixy = np.concatenate(
            [ixy, np.tile(np.array([[1, 1, 0, 0]], np.int32),
                          (pad_to - len(ixy), 1))])
    return z, ixy


_BOXES = [(-60.0, -30.0, 20.0, 40.0), (100.0, 10.0, 140.0, 55.0)]


@pytest.mark.parametrize("n,boxes,pad_to", [
    (3000, _BOXES, None),
    (3000, _BOXES, 8),                 # padded to a pow2 box count
    (8192 + 37, _BOXES[:1], None),     # ragged past one (8, 1024) block
    (1, _BOXES, 2),                    # a single candidate
    (777, [], 1),                      # only a never-matching padded box
    (2000, [(-180.0, -90.0, 180.0, 90.0)], None),   # the world
])
def test_z2_mask_cpu_matches_pallas(n, boxes, pad_to):
    z, ixy = _mask_case(n, n, boxes, pad_to)
    got = z2_mask(torch.from_numpy(z), torch.from_numpy(ixy))
    want = np.asarray(z2_mask_pallas(z, ixy))
    assert got.dtype == torch.bool and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    if boxes and n > 100:
        assert want.any()
    if not boxes:
        assert not want.any()


def test_z2_mask_checks_its_inputs():
    z, ixy = (torch.from_numpy(a) for a in _mask_case(64, 1, _BOXES))
    with pytest.raises(TypeError):
        z2_mask(z.to(torch.int32), ixy)
    with pytest.raises(TypeError):
        z2_mask(z, ixy.to(torch.int64))
    with pytest.raises(ValueError):
        z2_mask(z, ixy.reshape(-1, 2))
    with pytest.raises(ValueError):
        z2_mask(z[::2], ixy)
    with pytest.raises(ValueError):
        z2_mask(z.reshape(8, 8), ixy)


def test_z2_mask_cpu_does_not_count_launches():
    before = z2_mask.launches
    z2_mask(*(torch.from_numpy(a) for a in _mask_case(100, 2, _BOXES)))
    assert z2_mask.launches == before
