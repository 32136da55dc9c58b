"""The port's CUDA kernels on the card, held against their plain PyTorch
versions (which the CPU parity tests hold against the JAX package).

Every test here needs an NVIDIA GPU and skips without one.  The file
imports nothing of JAX, so on the machine with the card it runs without
the suite's JAX conftest::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from geomesa_tpu_torch import TpuDataStore, density_process
from geomesa_tpu_torch.curve import z2_sfc, z3_sfc
from geomesa_tpu_torch.index.z2 import Z2PointIndex
from geomesa_tpu_torch.index.z3 import Z3PointIndex
from geomesa_tpu_torch.ops.density_kernel import (
    density_grid_kernel, density_grid_kernel_reference,
)
from geomesa_tpu_torch.ops.hist1d_kernel import (
    hist1d, hist1d_reference, launch_shape,
)
from geomesa_tpu_torch.ops.z2_mask import z2_mask, z2_mask_reference
from geomesa_tpu_torch.ops.z3_mask import z3_mask, z3_mask_reference

pytestmark = pytest.mark.cuda

MS_2018 = 1514764800000
DAY = 86_400_000


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _mask_inputs(n, n_boxes, pad_to, seed, device):
    rng = np.random.default_rng(seed)
    sfc = z3_sfc("week")
    z = sfc.index(torch.tensor(rng.uniform(-180, 180, n)),
                  torch.tensor(rng.uniform(-90, 90, n)),
                  torch.tensor(rng.uniform(0, 604800.0, n)))
    lo = rng.integers(0, 1 << 20, (n_boxes, 2))
    ixy = np.concatenate([lo, lo + rng.integers(0, 1 << 19, (n_boxes, 2))],
                         axis=1)
    ixy = np.concatenate([ixy, np.tile([[1, 1, 0, 0]], (pad_to - n_boxes, 1))])
    tlo = rng.integers(0, 1 << 20, n).astype(np.int32)
    thi = (tlo + rng.integers(0, 1 << 20, n)).astype(np.int32)
    return [t.to(device) for t in (z, torch.tensor(ixy.astype(np.int32)),
                                   torch.tensor(tlo), torch.tensor(thi))]


@pytest.mark.parametrize("n,n_boxes,pad_to", [
    (1 << 20, 5, 8),            # padded boxes
    ((1 << 20) + 37, 1, 1),     # ragged tail
    (1, 2, 2),
    (50_000, 700, 700),         # many boxes in shared memory
    (20_000, 3072, 3072),       # the most one launch stages
])
def test_z3_mask_kernel_matches_reference(cuda_device, n, n_boxes, pad_to):
    args = _mask_inputs(n, n_boxes, pad_to, n, cuda_device)
    before = z3_mask.launches
    got = z3_mask(*args)
    torch.cuda.synchronize()
    assert z3_mask.launches == before + 1
    assert got.dtype == torch.bool and got.device.type == "cuda"
    assert torch.equal(got, z3_mask_reference(*args))


def test_z3_mask_kernel_rejects_too_many_boxes(cuda_device):
    args = _mask_inputs(64, 3073, 3073, 0, cuda_device)
    with pytest.raises(ValueError):
        z3_mask(*args)


def test_z3_mask_kernel_rejects_mixed_devices(cuda_device):
    z, ixy, tlo, thi = _mask_inputs(64, 1, 1, 0, cuda_device)
    with pytest.raises(ValueError):
        z3_mask(z, ixy.cpu(), tlo, thi)


def test_index_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(7)
    n = 200_000
    x = rng.uniform(-75.0, -73.0, n)
    y = rng.uniform(40.0, 42.0, n)
    t = rng.integers(MS_2018, MS_2018 + 30 * DAY, n)
    gpu = Z3PointIndex.build(x, y, t, device=cuda_device)
    cpu = Z3PointIndex.build(x, y, t, device="cpu")
    gpu.append(x[:1000] + 0.01, y[:1000], t[:1000])
    cpu.append(x[:1000] + 0.01, y[:1000], t[:1000])
    assert torch.equal(gpu.z.cpu(), cpu.z) and torch.equal(gpu.bins.cpu(), cpu.bins)
    before = z3_mask.launches
    for box, lo, hi in [((-74.5, 40.5, -73.5, 41.5), MS_2018 + DAY, MS_2018 + 9 * DAY),
                        ((-75.0, 40.0, -73.0, 42.0), MS_2018, MS_2018 + 30 * DAY)]:
        np.testing.assert_array_equal(gpu.query([box], lo, hi),
                                      cpu.query([box], lo, hi))
    assert z3_mask.launches > before


def _z2_inputs(n, n_boxes, pad_to, seed, device):
    rng = np.random.default_rng(seed)
    z = z2_sfc().index(torch.tensor(rng.uniform(-180, 180, n)),
                       torch.tensor(rng.uniform(-90, 90, n)))
    lo = rng.integers(0, 1 << 30, (n_boxes, 2))
    ixy = np.concatenate([lo, lo + rng.integers(0, 1 << 29, (n_boxes, 2))],
                         axis=1)
    ixy = np.concatenate([ixy, np.tile([[1, 1, 0, 0]], (pad_to - n_boxes, 1))])
    return z.to(device), torch.tensor(ixy.astype(np.int32)).to(device)


@pytest.mark.parametrize("n,n_boxes,pad_to", [
    (1 << 20, 5, 8),            # padded boxes
    ((1 << 20) + 37, 1, 1),     # ragged tail
    (1, 2, 2),
    (50_000, 700, 700),         # many boxes in shared memory
    (20_000, 3072, 3072),       # the most one launch stages
])
def test_z2_mask_kernel_matches_reference(cuda_device, n, n_boxes, pad_to):
    z, ixy = _z2_inputs(n, n_boxes, pad_to, n, cuda_device)
    before = z2_mask.launches
    got = z2_mask(z, ixy)
    torch.cuda.synchronize()
    assert z2_mask.launches == before + 1
    assert got.dtype == torch.bool and got.device.type == "cuda"
    assert torch.equal(got, z2_mask_reference(z, ixy))


def test_z2_mask_kernel_any_keys_and_bounds(cuda_device):
    # keys over all of int64 (32-bit dimensions, the top bit set) and box
    # bounds below 0: the kernel's unsigned compares agree with int64 ones
    rng = np.random.default_rng(7)
    i64 = np.iinfo(np.int64)
    z = np.concatenate([
        rng.integers(i64.min, i64.max, 100_000, dtype=np.int64),
        [0, -1, i64.max, i64.min, (1 << 62) - 1]]).astype(np.int64)
    ixy = np.concatenate([
        rng.integers(-(1 << 31), (1 << 31) - 1, (60, 4)),
        [[-5, -5, (1 << 31) - 1, (1 << 31) - 1], [-9, 0, -1, 1 << 30],
         [0, -(1 << 31), 1 << 30, -1], [1, 1, 0, 0]]]).astype(np.int32)
    z, ixy = torch.tensor(z).to(cuda_device), torch.tensor(ixy).to(cuda_device)
    got = z2_mask(z, ixy)
    want = z2_mask_reference(z, ixy)
    assert 0 < int(want.sum()) < len(want)
    assert torch.equal(got, want)


def test_z2_mask_kernel_rejects_bad_inputs(cuda_device):
    z, ixy = _z2_inputs(64, 3073, 3073, 0, cuda_device)
    with pytest.raises(ValueError):
        z2_mask(z, ixy)
    with pytest.raises(ValueError):
        z2_mask(z, ixy[:2].cpu())


def _density_inputs(n, seed, device, unit=True, clustered=False):
    rng = np.random.default_rng(seed)
    if clustered:
        c = rng.uniform(-20, 20, (8, 2))
        k = rng.integers(0, 8, n)
        x = c[k, 0] + rng.standard_normal(n) * 0.3
        y = c[k, 1] + rng.standard_normal(n) * 0.3
    else:
        # a margin outside the envelope exercises the clamp
        x = rng.uniform(-25, 25, n)
        y = rng.uniform(-12, 12, n)
    w = np.ones(n) if unit else rng.uniform(0.5, 2.0, n)
    mask = rng.random(n) < 0.5
    return [torch.tensor(a).to(device) for a in (x, y, w, mask)]


@pytest.mark.parametrize("n,w,h,unit,clustered", [
    (1 << 20, 256, 256, True, True),
    ((1 << 20) + 37, 1024, 1024, True, False),
    (100_003, 7, 5, False, False),
    (1, 3, 3, True, False),
    (200_000, 256, 128, False, True),
])
def test_density_kernel_matches_reference(cuda_device, n, w, h, unit,
                                          clustered):
    args = _density_inputs(n, n, cuda_device, unit, clustered)
    env = (-20.0, -10.0, 20.0, 10.0)
    before = density_grid_kernel.launches
    got = density_grid_kernel(*args, env, w, h)
    torch.cuda.synchronize()
    assert density_grid_kernel.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (h, w)
    want = density_grid_kernel_reference(*args, env, w, h)
    if unit:
        assert torch.equal(got, want)
    else:
        # float64 atomics sum in an order that changes from run to run,
        # then round to float32
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_density_kernel_far_points_and_empty_mask(cuda_device):
    x = torch.tensor([-1e12, 1e12, 0.0, 3e11], device=cuda_device,
                     dtype=torch.float64)
    y = torch.tensor([1e12, -1e12, 0.0, 0.0], device=cuda_device,
                     dtype=torch.float64)
    w = torch.ones(4, dtype=torch.float64, device=cuda_device)
    env = (-1.0, -1.0, 1.0, 1.0)
    for mask in (torch.ones(4, dtype=torch.bool, device=cuda_device),
                 torch.zeros(4, dtype=torch.bool, device=cuda_device)):
        got = density_grid_kernel(x, y, w, mask, env, 16, 16)
        assert torch.equal(got, density_grid_kernel_reference(
            x, y, w, mask, env, 16, 16))
        assert float(got.sum()) == float(mask.sum())


def test_density_kernel_rejects_mixed_devices(cuda_device):
    x, y, w, mask = _density_inputs(64, 0, cuda_device)
    with pytest.raises(ValueError):
        density_grid_kernel(x, y, w.cpu(), mask, (-1, -1, 1, 1), 8, 8)


def test_z2_index_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(9)
    n = 200_000
    x = rng.uniform(-180, 180, n)
    y = rng.uniform(-90, 90, n)
    gpu = Z2PointIndex.build(x, y, device=cuda_device)
    cpu = Z2PointIndex.build(x, y, device="cpu")
    gpu.append(x[:1000] + 0.01, y[:1000])
    cpu.append(x[:1000] + 0.01, y[:1000])
    assert torch.equal(gpu.z.cpu(), cpu.z)
    before = z2_mask.launches
    boxes = [[(2.0, 48.0, 3.0, 49.0)],
             [(-10.0, -10.0, 10.0, 10.0), (100.0, 20.0, 120.0, 30.0)]]
    for b in boxes:
        np.testing.assert_array_equal(gpu.query(b), cpu.query(b))
    assert z2_mask.launches > before
    for g, c in zip(gpu.query_many(boxes), cpu.query_many(boxes)):
        np.testing.assert_array_equal(g, c)
    np.testing.assert_array_equal(gpu.density_world(256, 128),
                                  cpu.density_world(256, 128))


def test_density_process_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(11)
    n = 50_000
    data = {"actor": np.array(["a"] * n, dtype=object),
            "dtg": rng.integers(MS_2018, MS_2018 + 30 * DAY, n),
            "geom": (rng.uniform(-20, 20, n), rng.uniform(-10, 10, n))}
    stores = []
    for dev in (cuda_device, "cpu"):
        ds = TpuDataStore(device=dev)
        ds.create_schema("s", "actor:String,dtg:Date,*geom:Point")
        ds.write("s", data)
        stores.append(ds)
    before = density_grid_kernel.launches
    for q in ("BBOX(geom, -5, -5, 5, 5)", "INCLUDE",
              "BBOX(geom, -5, -5, 5, 5) AND dtg DURING "
              "2018-01-03T00:00:00Z/2018-01-09T00:00:00Z"):
        g, c = (density_process(ds, "s", q, (-20, -10, 20, 10), 64, 32)
                for ds in stores)
        assert g.dtype == np.float32 and c.dtype == np.float64
        np.testing.assert_array_equal(g, c.astype(np.float32))
    assert density_grid_kernel.launches > before
    gpu_tile, cpu_tile = (ds.density_tile("s", 2, 1, 1, tile=64)
                          for ds in stores)
    np.testing.assert_array_equal(gpu_tile, cpu_tile)


@pytest.mark.parametrize("n,n_bins", [
    (1 << 22, 64),              # shared-memory replicas, one per warp
    ((1 << 22) + 37, 1024),     # ragged tail, a Frequency width
    (1 << 20, 20_000),          # one shared copy above the 48 KB opt-in
    (1 << 20, 65_536),          # wider than shared memory: global atomics
    (1, 1),
    (0, 64),
])
@pytest.mark.parametrize("unit", [True, False])
def test_hist1d_kernel_matches_reference(cuda_device, n, n_bins, unit):
    rng = np.random.default_rng(n + n_bins)
    bins = torch.tensor(rng.integers(-9, n_bins + 9, n).astype(np.int32))
    w = torch.tensor((np.ones(n) if unit else rng.uniform(0, 3, n))
                     .astype(np.float32))
    mask = torch.tensor(rng.random(n) < 0.6)
    args = [t.to(cuda_device) for t in (bins, w, mask)]
    before = hist1d.launches
    got = hist1d(*args, n_bins)
    torch.cuda.synchronize()
    assert hist1d.launches == before + (1 if n else 0)
    assert got.dtype == torch.float32 and got.shape == (n_bins,)
    want = hist1d_reference(*args, n_bins)
    if unit:
        # integer partials below 2^24 are exact in float32
        assert torch.equal(got, want)
    else:
        # float32 atomics sum in an order that changes from run to run
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
    copies = launch_shape(max(n, 1), n_bins, 132)[1]
    assert (copies == 0) == (n_bins == 65_536)


def test_hist1d_kernel_rejects_mixed_devices(cuda_device):
    b = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    w = torch.ones(8, dtype=torch.float32, device=cuda_device)
    with pytest.raises(ValueError):
        hist1d(b, w, torch.ones(8, dtype=torch.bool), 8)


def test_mesh_store_on_card_matches_cpu(cuda_device):
    """The mesh store on a one-card mesh against the same store on a
    one-device CPU mesh: positions, heatmaps (the card's float32 grid
    equals the CPU's float64 counts cast) and stats, the histograms
    through the hist1d kernel."""
    from geomesa_tpu_torch import device_mesh
    rng = np.random.default_rng(13)
    n = 100_000
    data = {"actor": rng.choice(["a", "b", "c"], n).astype(object),
            "score": rng.uniform(0, 100, n),
            "dtg": rng.integers(MS_2018, MS_2018 + 30 * DAY, n),
            "geom": (rng.uniform(-20, 20, n), rng.uniform(-10, 10, n))}
    stores = []
    for dev, mesh in ((cuda_device, device_mesh(1)),
                      ("cpu", device_mesh(devices=["cpu"]))):
        ds = TpuDataStore(device=dev, mesh=mesh)
        ds.create_schema("s", "actor:String,score:Double,dtg:Date,*geom:Point")
        ds.write("s", data)
        stores.append(ds)
    q = ("BBOX(geom, -5, -5, 5, 5) AND dtg DURING "
         "2018-01-03T00:00:00Z/2018-01-19T00:00:00Z")
    for ecql in (q, "BBOX(geom, -5, -5, 5, 5)"):
        g, c = (ds.query_result("s", ecql).positions for ds in stores)
        np.testing.assert_array_equal(g, c)
    g, c = (density_process(ds, "s", q, (-20, -10, 20, 10), 64, 32)
            for ds in stores)
    np.testing.assert_array_equal(g, c.astype(np.float32))
    before = hist1d.launches
    spec = ("Count();MinMax(score);Histogram(score,64,0,100);"
            "Frequency(actor,4,1024)")
    g, c = (ds.stats("s", q, spec) for ds in stores)
    assert g.to_json() == c.to_json()
    assert hist1d.launches == before + 1 + 4
