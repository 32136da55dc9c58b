"""Port parity: the density layer of geomesa_tpu_torch against
geomesa_tpu's — the grid functions of ``ops/density.py``, the density
kernel's plain version against ``density_grid_pallas`` (interpret mode),
and ``density_process`` / ``TpuDataStore.density_tile`` on the same rows
and filters.

Tolerances: unit weights are counts and must be equal exactly.  Weighted
float64 grids sum in another order than XLA's scatter: ``rtol=1e-12``.
Against the float32 contract (the Pallas kernel sums in float32, the
port's kernel in float64 rounded once): ``rtol=1e-5``, the tolerance of
tests/test_pallas_kernels.py.
"""

import numpy as np
import pytest
import torch

from geomesa_tpu.datastore import TpuDataStore as JaxStore
from geomesa_tpu.ops import density as jd
from geomesa_tpu.ops.pallas_kernels import density_grid_pallas
from geomesa_tpu.process.density import density_process as j_density_process
from geomesa_tpu_torch import TpuDataStore, density_process
from geomesa_tpu_torch.ops import density as td
from geomesa_tpu_torch.ops.density_kernel import (
    density_grid_kernel, density_grid_kernel_reference, launch_shape,
)
from geomesa_tpu_torch.ops.launch import (
    MAX_SHARED_BYTES, STAGE_BYTES, THREADS,
)

MS_2018 = 1514764800000
DAY = 86_400_000
ENV = (-10.0, -5.0, 10.0, 5.0)


def _case(n, seed, unit=True):
    """Points inside and around ``ENV``, a few far outside it (~1e11
    cells away, past int32), some exactly on its edges."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-12, 12, n)
    y = rng.uniform(-6, 6, n)
    if n >= 8:
        x[:8] = [-3e11, 3e11, -10.0, 10.0, 0.0, 1e300, -1e300, 9.999999]
        y[:8] = [3e11, -3e11, -5.0, 5.0, 0.0, 0.0, 1.0, -4.999999]
    w = np.ones(n) if unit else rng.uniform(0.5, 2.0, n)
    mask = rng.random(n) > 0.3
    return x, y, w, mask


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


CASES = [(1000, 32, 32), (5000, 64, 48), (100, 7, 5), (20_000, 256, 256)]


@pytest.mark.parametrize("n,w,h", CASES)
def test_grid_snap_matches_jax(n, w, h):
    x, y, _, _ = _case(n, n)
    ix, iy = td.grid_snap(*_t(x, y), ENV, w, h)
    jx, jy = jd.grid_snap(x, y, ENV, w, h)
    np.testing.assert_array_equal(ix.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(iy.numpy(), np.asarray(jy))


@pytest.mark.parametrize("unit", [True, False], ids=["unit", "weighted"])
@pytest.mark.parametrize("n,w,h", CASES)
def test_density_grid_matches_jax(n, w, h, unit):
    x, y, wts, mask = _case(n, n, unit)
    got = td.density_grid(*_t(x, y, wts, mask), ENV, w, h)
    want = np.asarray(jd.density_grid(x, y, wts, mask, ENV, w, h))
    assert got.dtype == torch.float64 and got.shape == (h, w)
    if unit:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


@pytest.mark.parametrize("unit", [True, False], ids=["unit", "weighted"])
@pytest.mark.parametrize("n,w,h", CASES)
def test_density_grid_sorted_matches_jax(n, w, h, unit):
    x, y, wts, mask = _case(n, n, unit)
    got = td.density_grid_sorted(*_t(x, y, wts, mask), ENV, w, h)
    want = np.asarray(jd.density_grid_sorted(x, y, wts, mask, ENV, w, h))
    assert got.dtype == torch.float32 and got.shape == (h, w)
    if unit:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("unit", [True, False], ids=["unit", "weighted"])
@pytest.mark.parametrize("n,w,h", CASES[:3])
def test_kernel_reference_matches_pallas(n, w, h, unit):
    x, y, wts, mask = _case(n, n, unit)
    got = density_grid_kernel_reference(*_t(x, y, wts, mask), ENV, w, h)
    want = np.asarray(density_grid_pallas(x, y, wts, mask, ENV, w, h))
    assert got.dtype == torch.float32 and got.shape == (h, w)
    if unit:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(got.numpy().sum(), wts[mask].sum(), rtol=1e-5)


@pytest.mark.parametrize("n,w,h", CASES)
def test_kernel_reference_unit_counts_equal_jax_cpu_path(n, w, h):
    """Unit-weight grids of the kernel's contract equal the JAX CPU
    path's float64 counts cast to float32, and density_grid_sorted."""
    x, y, wts, mask = _case(n, n)
    got = density_grid_kernel_reference(*_t(x, y, wts, mask), ENV, w, h)
    counts = np.asarray(jd.density_grid(x, y, wts, mask, ENV, w, h))
    np.testing.assert_array_equal(got.numpy(), counts.astype(np.float32))
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jd.density_grid_sorted(x, y, wts, mask, ENV, w, h)))


@pytest.mark.parametrize("fn", [td.density_grid, td.density_grid_sorted,
                                density_grid_kernel_reference,
                                density_grid_kernel, td.density_grid_auto])
def test_all_masked_gives_zeros(fn):
    x, y, wts, _ = _case(256, 3)
    got = fn(*_t(x, y, wts, np.zeros(256, bool)), (-1.0, -1.0, 1.0, 1.0),
             16, 16)
    assert got.shape == (16, 16) and float(got.abs().sum()) == 0.0


def test_auto_and_kernel_on_cpu_run_the_plain_versions():
    x, y, wts, mask = _t(*_case(3000, 4, unit=False))
    before = density_grid_kernel.launches
    assert torch.equal(td.density_grid_auto(x, y, wts, mask, ENV, 40, 20),
                       td.density_grid(x, y, wts, mask, ENV, 40, 20))
    assert torch.equal(density_grid_kernel(x, y, wts, mask, ENV, 40, 20),
                       density_grid_kernel_reference(x, y, wts, mask, ENV,
                                                     40, 20))
    assert density_grid_kernel.launches == before


def test_kernel_checks_its_inputs():
    x, y, wts, mask = _t(*_case(64, 5))
    with pytest.raises(TypeError):
        density_grid_kernel(x.float(), y, wts, mask, ENV, 8, 8)
    with pytest.raises(TypeError):
        density_grid_kernel(x, y, wts, mask.to(torch.uint8), ENV, 8, 8)
    with pytest.raises(ValueError):
        density_grid_kernel(x, y[:-1], wts, mask, ENV, 8, 8)
    with pytest.raises(ValueError):
        density_grid_kernel(x[::2], y[::2], wts[::2], mask[::2], ENV, 8, 8)
    with pytest.raises(ValueError):
        density_grid_kernel(x, y, wts, mask, ENV, 0, 8)
    with pytest.raises(ValueError):
        density_grid_kernel(x, y, wts, mask, ENV[:3], 8, 8)


def _h100(cluster, smem, max_cluster=16):
    """A model of an H100's occupancy query: 132 SMs of 228 KB (1 KB
    reserved per block), 2048 threads each; clusters inside 8 GPCs of 16
    SMs; none above ``max_cluster``."""
    per_sm = min(2048 // THREADS, 233_472 // (smem + 1024))
    if cluster <= 1:
        return 132 * per_sm
    if cluster > max_cluster:
        return 0
    return 8 * (16 * per_sm // cluster) * cluster


@pytest.mark.parametrize("width,height,cluster", [
    (7, 5, 1),
    (218, 128, 1),        # 27,904 cells: the largest grid one block holds
    (27_905, 1, 2),       # one cell more: a cluster of two
    (256, 256, 4),        # the heatmap grid: 64 KB of counts a block
    (872, 512, 16),       # 446,464 cells: the largest at two blocks an SM
    (446_465, 1, 8),      # one cell more: 8 blocks, one an SM
    (892, 1024, 16),      # 913,408 cells: the largest a cluster holds
    (913_409, 1, 0),      # one cell more: global float64 atomics
    (1024, 1024, 0),
])
def test_launch_shape(width, height, cluster):
    """The branch the density kernel takes: unit weights counted in a
    private uint32 grid per block, or in one spread over a cluster's
    distributed shared memory, or with global atomics past what a
    cluster of 16 holds; the partial count grids each cover at least two
    points a cell."""
    n = 1 << 24
    cells = width * height
    shape = launch_shape(n, width, height, _h100)
    assert shape.cluster == cluster
    assert shape.smem <= MAX_SHARED_BYTES
    assert 1 <= shape.blocks <= _h100(shape.cluster, shape.smem)
    if cluster:
        assert shape.blocks % cluster == 0
        assert shape.parts == shape.blocks // cluster
        assert 4 * -(-cells // cluster) + STAGE_BYTES <= shape.smem
        assert shape.parts * 2 * cells <= n
    else:
        assert (shape.parts, shape.smem) == (1, STAGE_BYTES)
    # a few points: one block or cluster, one count grid
    few = launch_shape(10, width, height, _h100)
    assert (few.blocks, few.parts) == (max(cluster, 1), 1)


def test_launch_shape_follows_the_card():
    """A cluster size the card cannot hold is not chosen."""
    def portable(c, smem):
        return _h100(c, smem, max_cluster=8)
    assert launch_shape(1 << 24, 892, 1024, portable).cluster == 0
    assert launch_shape(1 << 24, 892, 512, portable).cluster == 8
    assert launch_shape(1 << 24, 256, 256, portable).cluster == 4


# -- density_process and density_tile on the store facade --------------------

SPEC = "actor:String,score:Double,dtg:Date,*geom:Point"


def _rows(seed, n):
    rng = np.random.default_rng(seed)
    return {
        "actor": rng.choice(["a", "b", "c"], n).astype(object),
        "score": rng.uniform(0.0, 10.0, n),
        "dtg": rng.integers(MS_2018, MS_2018 + 60 * DAY, n),
        "geom": (rng.uniform(-20.0, 20.0, n), rng.uniform(-10.0, 10.0, n)),
    }


@pytest.fixture(scope="module")
def stores():
    tds, jds = TpuDataStore(device="cpu"), JaxStore()
    for ds in (tds, jds):
        ds.create_schema("gdelt", SPEC)
        ds.create_schema("places", "name:String,*geom:Point")
    for seed in (1, 2):
        rows = _rows(seed, 3000)
        places = {"name": rows["actor"], "geom": rows["geom"]}
        for ds in (tds, jds):
            ds.write("gdelt", rows)
            ds.write("places", places)
            # the first pass builds the indexes: the second write appends
            ds.query_result("gdelt", "BBOX(geom, -5, -5, 5, 5)")
            ds.query_result("gdelt", "BBOX(geom, -5, -5, 5, 5) AND dtg "
                                     "DURING 2018-01-05T00:00:00Z/"
                                     "2018-01-20T00:00:00Z")
    return tds, jds


DENSITY_QUERIES = [
    ("gdelt", "BBOX(geom, -5, -5, 5, 5) AND dtg DURING "
              "2018-01-05T00:00:00Z/2018-01-20T00:00:00Z"),
    ("gdelt", "BBOX(geom, -15, -8, 0, 2)"),
    ("gdelt", "INCLUDE"),
    ("gdelt", "EXCLUDE"),
    ("gdelt", "BBOX(geom, -5, -5, 0, 0) OR dtg DURING "
              "2018-02-05T00:00:00Z/2018-02-06T00:00:00Z"),
    ("places", "BBOX(geom, -15, -8, 0, 2) OR BBOX(geom, 3, 3, 8, 8)"),
    ("places", "INCLUDE"),
]


@pytest.mark.parametrize("schema,ecql", DENSITY_QUERIES)
@pytest.mark.parametrize("env,w,h", [((-20.0, -10.0, 20.0, 10.0), 64, 32),
                                     ((-5.0, -5.0, 5.0, 5.0), 16, 16)])
def test_density_process_matches_jax(stores, schema, ecql, env, w, h):
    tds, jds = stores
    got = density_process(tds, schema, ecql, env, w, h)
    want = np.asarray(j_density_process(jds, schema, ecql, env, w, h))
    assert got.dtype == want.dtype == np.float64 and got.shape == (h, w)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ecql", [q for s, q in DENSITY_QUERIES
                                  if s == "gdelt"])
def test_weighted_density_process_matches_jax(stores, ecql):
    tds, jds = stores
    env = (-20.0, -10.0, 20.0, 10.0)
    got = density_process(tds, "gdelt", ecql, env, 32, 32,
                          weight_attr="score")
    want = np.asarray(j_density_process(jds, "gdelt", ecql, env, 32, 32,
                                        weight_attr="score"))
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("schema,z,x,y,query", [
    ("gdelt", 0, 0, 0, None),
    ("gdelt", 3, 3, 3, None),
    ("gdelt", 3, 4, 4, None),
    ("gdelt", 5, 15, 15, "actor = 'a'"),
    ("gdelt", 4, 7, 7, "dtg DURING 2018-01-05T00:00:00Z/2018-01-20T00:00:00Z"),
    ("places", 2, 1, 1, None),
    ("places", 30, 0, 0, None),
])
def test_density_tile_matches_jax(stores, schema, z, x, y, query):
    tds, jds = stores
    got = tds.density_tile(schema, z, x, y, tile=32, query=query)
    want = jds.density_tile(schema, z, x, y, tile=32, query=query)
    assert got.dtype == np.float64 and got.shape == (32, 32)
    np.testing.assert_array_equal(got, want)


def test_density_tile_rejects_what_it_does_not_serve(stores):
    tds, _ = stores
    with pytest.raises(ValueError):
        tds.density_tile("gdelt", 2, 4, 0)
    with pytest.raises(ValueError):
        tds.density_tile("gdelt", 31, 0, 0)
    with pytest.raises(NotImplementedError):
        tds.density_tile("gdelt", 1, 0, 0, timeout_ms=100.0)
    with pytest.raises(KeyError):
        tds.density_tile("nope", 0, 0, 0)


def test_tile_env_matches_jax():
    from geomesa_tpu.index.pyramid import tile_env as j_tile_env
    from geomesa_tpu_torch.index.pyramid import tile_env
    for z, x, y in ((0, 0, 0), (1, 1, 0), (3, 5, 2), (30, 12345, 67890)):
        assert tile_env(z, x, y) == j_tile_env(z, x, y)
