"""The port's CUDA kernels on the card, held against their plain PyTorch
versions (which the CPU parity tests hold against the JAX package).

Every test here needs an NVIDIA GPU and skips without one.  The file
imports nothing of JAX, so on the machine with the card it runs without
the suite's JAX conftest::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import functools

import numpy as np
import pytest
import torch

from geomesa_tpu_torch import TpuDataStore, density_process
from geomesa_tpu_torch.curve import z2_sfc, z3_sfc
from geomesa_tpu_torch.index.z2 import Z2PointIndex
from geomesa_tpu_torch.index.z3 import Z3PointIndex
from geomesa_tpu_torch.ops import density_kernel as dk
from geomesa_tpu_torch.ops import hist1d_kernel as hk
from geomesa_tpu_torch.ops.density_kernel import (
    density_grid_kernel, density_grid_kernel_reference,
)
from geomesa_tpu_torch.ops.hist1d_kernel import hist1d, hist1d_reference
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


def _resident(module):
    """The card's own occupancy query of a kernel module."""
    return functools.partial(module._resident, torch.cuda.current_device())


def _density_inputs(n, seed, device, unit=True, clustered=False,
                    share=0.5):
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
    mask = rng.random(n) < share
    return [torch.tensor(a).to(device) for a in (x, y, w, mask)]


def _density_check(got, want, unit):
    if unit:
        assert torch.equal(got, want)
    else:
        # float64 sums in an order that changes from run to run, then
        # rounded to float32
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("n,w,h,unit,clustered", [
    (1 << 20, 256, 256, True, True),
    ((1 << 20) + 37, 1024, 1024, True, False),
    (100_003, 7, 5, False, False),
    (1, 3, 3, True, False),
    (200_000, 256, 128, False, True),
    ((1 << 20) + 1, 256, 256, True, True),   # not a multiple of 16 rows
    (300, 256, 256, True, True),              # below one 512-row tile
    (300, 1024, 1024, False, False),
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
    _density_check(got, want, unit)


@pytest.mark.parametrize("w,h,cluster", [
    (218, 128, 1),        # the largest grid one block holds
    (27_905, 1, 2),       # one cell more
    (872, 512, 16),       # the largest at two blocks an SM
    (446_465, 1, 8),      # one cell more
    (892, 1024, 16),      # the largest a cluster holds
    (913_409, 1, 0),      # one cell more: global atomics
])
@pytest.mark.parametrize("unit", [True, False])
def test_density_kernel_branch_edges(cuda_device, w, h, cluster, unit):
    """Each side of each branch edge of launch_shape, on the card's own
    occupancy."""
    n = 1 << 21
    args = _density_inputs(n, w, cuda_device, unit)
    env = (-20.0, -10.0, 20.0, 10.0)
    shape = dk.launch_shape(n, w, h, _resident(dk))
    assert shape.cluster == cluster
    got = density_grid_kernel(*args, env, w, h)
    _density_check(got, density_grid_kernel_reference(*args, env, w, h),
                   unit)


@pytest.mark.parametrize("w,h", [(256, 256), (7, 5), (1024, 1024)])
@pytest.mark.parametrize("unit", [True, False])
def test_density_kernel_hot_cell(cuda_device, w, h, unit):
    """Every point in one cell, every point masked in: the warp merge and
    the same-address adds of every branch."""
    n = (1 << 20) + 3
    rng = np.random.default_rng(w)
    x = torch.full((n,), 1.25, dtype=torch.float64, device=cuda_device)
    y = torch.full((n,), -0.5, dtype=torch.float64, device=cuda_device)
    wt = (torch.ones(n, dtype=torch.float64, device=cuda_device) if unit
          else torch.tensor(rng.uniform(0.5, 2.0, n), device=cuda_device))
    mask = torch.ones(n, dtype=torch.bool, device=cuda_device)
    env = (-20.0, -10.0, 20.0, 10.0)
    got = density_grid_kernel(x, y, wt, mask, env, w, h)
    _density_check(got, density_grid_kernel_reference(x, y, wt, mask, env,
                                                      w, h), unit)
    assert int((got != 0).sum()) == 1


@pytest.mark.parametrize("w,h", [(256, 256), (1024, 1024)])
@pytest.mark.parametrize("unit", [True, False])
def test_density_kernel_few_hot_cells(cuda_device, w, h, unit):
    """Points spread over a few cells, half masked in: warps enter and
    leave the merge of hot cells as their cells repeat or not."""
    n = (1 << 20) + 7
    rng = np.random.default_rng(w + 11)
    hot = rng.random(n) < 0.8
    x = np.where(hot, 1.0 + 0.05 * rng.integers(0, 4, n),
                 rng.uniform(-20, 20, n))
    y = np.where(hot, 0.5, rng.uniform(-10, 10, n))
    wt = np.ones(n) if unit else rng.uniform(0.5, 2.0, n)
    args = [torch.tensor(a).to(cuda_device)
            for a in (x, y, wt, rng.random(n) < 0.5)]
    env = (-20.0, -10.0, 20.0, 10.0)
    _density_check(density_grid_kernel(*args, env, w, h),
                   density_grid_kernel_reference(*args, env, w, h), unit)


@pytest.mark.parametrize("unit", [True, False])
def test_density_kernel_all_masked_in(cuda_device, unit):
    """256x256 over clustered points, every point masked in (the mask
    process/density.py passes)."""
    n = 1 << 22
    args = _density_inputs(n, 5, cuda_device, unit, clustered=True,
                           share=1.0)
    env = (-20.0, -10.0, 20.0, 10.0)
    got = density_grid_kernel(*args, env, 256, 256)
    _density_check(got, density_grid_kernel_reference(*args, env, 256, 256),
                   unit)
    if unit:
        assert float(got.double().sum()) == n


@pytest.mark.parametrize("w,h", [(256, 256), (7, 5), (1024, 1024)])
def test_density_kernel_mixed_weights(cuda_device, w, h):
    """Unit weights (counted in shared memory) and other weights (global
    float64 atomics) in one launch."""
    n = (1 << 20) + 5
    x, y, wt, mask = _density_inputs(n, 7, cuda_device, False, True)
    wt[::2] = 1.0
    env = (-20.0, -10.0, 20.0, 10.0)
    _density_check(density_grid_kernel(x, y, wt, mask, env, w, h),
                   density_grid_kernel_reference(x, y, wt, mask, env, w, h),
                   False)


@pytest.mark.parametrize("w,h,cluster", [
    (7, 5, 1),            # a private grid per block
    (256, 256, 4),        # a grid spread over a cluster
    (1024, 1024, 0),      # global atomics
])
@pytest.mark.parametrize("unit", [True, False])
def test_density_kernel_far_points_and_empty_mask(cuda_device, w, h,
                                                  cluster, unit):
    """Points ~1e12 cells outside the envelope clamp to its edges; an
    all-false mask gives a zero grid (the reduce pass over nothing
    accumulated)."""
    x = torch.tensor([-1e12, 1e12, 0.0, 3e11], device=cuda_device,
                     dtype=torch.float64)
    y = torch.tensor([1e12, -1e12, 0.0, 0.0], device=cuda_device,
                     dtype=torch.float64)
    wt = (torch.ones(4, dtype=torch.float64, device=cuda_device) if unit
          else torch.tensor([0.75, 1.5, 2.25, 0.5], dtype=torch.float64,
                            device=cuda_device))
    env = (-1.0, -1.0, 1.0, 1.0)
    assert dk.launch_shape(4, w, h, _resident(dk)).cluster == cluster
    for mask in (torch.ones(4, dtype=torch.bool, device=cuda_device),
                 torch.zeros(4, dtype=torch.bool, device=cuda_device)):
        got = density_grid_kernel(x, y, wt, mask, env, w, h)
        assert torch.equal(got, density_grid_kernel_reference(
            x, y, wt, mask, env, w, h))
        assert float(got.sum()) == float(wt[mask].sum())


@pytest.mark.parametrize("w,h", [(256, 256), (7, 5), (1024, 1024)])
def test_density_kernel_unaligned(cuda_device, w, h):
    """Inputs not 16-byte aligned take the row-a-lane path."""
    n = (1 << 20) + 9
    x, y, wt, mask = _density_inputs(n, 3, cuda_device, True, True)
    env = (-20.0, -10.0, 20.0, 10.0)
    sub = [t[1:] for t in (x, y, wt, mask)]
    assert sub[0].data_ptr() % 16 != 0
    _density_check(density_grid_kernel(*sub, env, w, h),
                   density_grid_kernel_reference(*sub, env, w, h), True)


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
    shape = hk.launch_shape(max(n, 1), n_bins, _resident(hk))
    # 65,536 bins: a histogram spread over a cluster
    assert (shape.cluster > 1) == (n_bins == 65_536)


def _hist_check(got, want, unit):
    if unit:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("n_bins,cluster", [
    (28_544, 1),        # the widest one block holds
    (28_545, 2),        # one bin more
    (446_464, 16),      # the widest at two blocks an SM
    (446_465, 8),       # one bin more
    (913_408, 16),      # the widest a cluster holds
    (913_409, 0),       # one bin more: global atomics
])
@pytest.mark.parametrize("unit", [True, False])
def test_hist1d_kernel_branch_edges(cuda_device, n_bins, cluster, unit):
    """Each side of each branch edge of launch_shape, on the card's own
    occupancy."""
    n = 1 << 21
    rng = np.random.default_rng(n_bins)
    bins = torch.tensor(rng.integers(-9, n_bins + 9, n).astype(np.int32))
    w = torch.tensor((np.ones(n) if unit else rng.uniform(0, 3, n))
                     .astype(np.float32))
    mask = torch.tensor(rng.random(n) < 0.6)
    args = [t.to(cuda_device) for t in (bins, w, mask)]
    assert hk.launch_shape(n, n_bins, _resident(hk)).cluster == cluster
    _hist_check(hist1d(*args, n_bins), hist1d_reference(*args, n_bins),
                unit)


@pytest.mark.parametrize("n_bins", [64, 65_536, 913_409])
@pytest.mark.parametrize("unit", [True, False])
def test_hist1d_kernel_hot_bin(cuda_device, n_bins, unit):
    """Every row in one bin, every row masked in.  Random weights over
    fewer rows: float32 sums of millions of rows in one bin drift past
    rtol 1e-5 in any order."""
    n = (1 << 22) + 5 if unit else (1 << 16) + 5
    rng = np.random.default_rng(n_bins)
    bins = torch.full((n,), 5, dtype=torch.int32, device=cuda_device)
    w = (torch.ones(n, dtype=torch.float32, device=cuda_device) if unit
         else torch.tensor(rng.uniform(0, 3, n).astype(np.float32),
                           device=cuda_device))
    mask = torch.ones(n, dtype=torch.bool, device=cuda_device)
    got = hist1d(bins, w, mask, n_bins)
    want = hist1d_reference(bins, w, mask, n_bins)
    if unit:
        assert torch.equal(got, want) and float(got[5]) == n
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("n_bins", [65_536, 913_409])
@pytest.mark.parametrize("unit", [True, False])
def test_hist1d_kernel_skewed_bins(cuda_device, n_bins, unit):
    """Zipf-skewed bins, half masked in: warps enter and leave the merge
    of hot bins as their bins repeat or not.  Random weights over fewer
    rows, as for one hot bin."""
    n = (1 << 22) + 5 if unit else (1 << 16) + 5
    rng = np.random.default_rng(n_bins + 3)
    bins = np.minimum(rng.zipf(1.3, n), n_bins + 9) - 1
    w = np.ones(n) if unit else rng.uniform(0, 3, n)
    args = [torch.tensor(a).to(cuda_device)
            for a in (bins.astype(np.int32), w.astype(np.float32),
                      rng.random(n) < 0.5)]
    _hist_check(hist1d(*args, n_bins), hist1d_reference(*args, n_bins),
                unit)


@pytest.mark.parametrize("n,n_bins,share", [
    (300, 64, 0.6),                # below one 512-row tile
    ((1 << 20) + 1, 1024, 0.6),    # not a multiple of 16 rows
    (1 << 22, 64, 1.0),            # every row masked in (INCLUDE stats)
])
def test_hist1d_kernel_tails_and_all_in(cuda_device, n, n_bins, share):
    rng = np.random.default_rng(n)
    bins = torch.tensor(rng.integers(-9, n_bins + 9, n).astype(np.int32))
    w = torch.ones(n, dtype=torch.float32)
    mask = torch.tensor(rng.random(n) < share)
    args = [t.to(cuda_device) for t in (bins, w, mask)]
    _hist_check(hist1d(*args, n_bins), hist1d_reference(*args, n_bins),
                True)


@pytest.mark.parametrize("n_bins", [64, 65_536, 913_409])
def test_hist1d_kernel_mixed_weights(cuda_device, n_bins):
    """Unit weights (counted in shared memory) and other weights (global
    float atomics) in one launch."""
    n = (1 << 21) + 3
    rng = np.random.default_rng(n_bins + 2)
    bins = torch.tensor(rng.integers(-9, n_bins + 9, n).astype(np.int32))
    w = torch.tensor(rng.uniform(0, 3, n).astype(np.float32))
    w[::2] = 1.0
    mask = torch.tensor(rng.random(n) < 0.6)
    args = [t.to(cuda_device) for t in (bins, w, mask)]
    _hist_check(hist1d(*args, n_bins), hist1d_reference(*args, n_bins),
                False)


@pytest.mark.parametrize("n_bins", [64, 65_536, 913_409])
def test_hist1d_kernel_unaligned(cuda_device, n_bins):
    """Inputs not 16-byte aligned take the row-a-lane path."""
    n = (1 << 21) + 9
    rng = np.random.default_rng(n_bins + 1)
    bins = torch.tensor(rng.integers(-9, n_bins + 9, n).astype(np.int32))
    w = torch.ones(n, dtype=torch.float32)
    mask = torch.tensor(rng.random(n) < 0.6)
    sub = [t.to(cuda_device)[1:] for t in (bins, w, mask)]
    assert sub[0].data_ptr() % 16 != 0
    _hist_check(hist1d(*sub, n_bins), hist1d_reference(*sub, n_bins), True)


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


def test_lean_store_on_card_matches_cpu(cuda_device):
    """A lean store on the card against the same store on the CPU, at
    2^14-slot generations under a budget that leaves all three tiers:
    the tier layout, positions, pushed-down heatmaps (float64 counts,
    equal), a weighted heatmap (the density kernel's float32 grid
    against the CPU's float64 sums, rtol 1e-5), Count, and the answers
    after compaction.  The card's device generations stay on the card."""
    slots = 1 << 14
    budget = slots * (40 + 16 + 40) + slots * 16 * 3
    spec = ("score:Double,dtg:Date,*geom:Point;geomesa.index.profile=lean,"
            f"geomesa.lean.generation.slots={slots},"
            f"geomesa.lean.hbm.budget={budget},"
            "geomesa.lean.compaction.factor=0")
    rng = np.random.default_rng(21)
    chunks = []
    for _ in range(4):
        m = 35_000
        chunks.append({"score": rng.uniform(0, 100, m),
                       "dtg": rng.integers(MS_2018, MS_2018 + 60 * DAY, m),
                       "geom": (rng.uniform(-20, 20, m),
                                rng.uniform(-10, 10, m))})
    stores = []
    for dev in (cuda_device, "cpu"):
        ds = TpuDataStore(device=dev)
        ds.create_schema("s", spec)
        for c in chunks:
            ds.write("s", c)
        stores.append(ds)
    gidx, cidx = (ds._store("s").index("z3") for ds in stores)
    assert gidx.tier_counts() == cidx.tier_counts() == {
        "full": 1, "keys": 3, "host": 5}
    for g in gidx.generations:
        if g.tier != "host":
            assert g.z.device.type == "cuda"
    q = ("BBOX(geom, -5, -5, 5, 5) AND dtg DURING "
         "2018-01-03T00:00:00Z/2018-01-19T00:00:00Z")
    queries = (q, "BBOX(geom, -5, -5, 5, 5)", "BBOX(geom, -20, -10, 0, 0) "
               "AND dtg DURING 2018-02-01T00:00:00Z/2018-02-20T00:00:00Z")
    for ecql in queries:
        g, c = (ds.query_result("s", ecql).positions for ds in stores)
        np.testing.assert_array_equal(g, c)
    for query, env in ((q, (-5, -5, 5, 5)),
                       ("INCLUDE", (-180, -90, 180, 90)),
                       ("INCLUDE", (-20, -10, 20, 10))):
        g, c = (density_process(ds, "s", query, env, 64, 32)
                for ds in stores)
        np.testing.assert_array_equal(g, c)
    before = density_grid_kernel.launches
    g, c = (density_process(ds, "s", q, (-5, -5, 5, 5), 64, 32,
                            weight_attr="score") for ds in stores)
    assert density_grid_kernel.launches == before + 1
    np.testing.assert_allclose(g, c, rtol=1e-5, atol=0.0)
    for ecql in (q, "INCLUDE"):
        g, c = (ds.stats("s", ecql, "Count()").count for ds in stores)
        assert g == c
    g, c = (ds.compact("s") for ds in stores)
    assert g == c and g["z3"]["merged_groups"] >= 1
    for ecql in queries:
        g, c = (ds.query_result("s", ecql).positions for ds in stores)
        np.testing.assert_array_equal(g, c)


def test_lean_pyramids_and_cell_counts_on_card_match_cpu(cuda_device):
    """A lean store's density pyramids, pyramid-served heatmaps and tiles,
    z3 cell counts and Z3Histogram stat on the card against the same
    store on the CPU, at 2^14-slot generations over all three tiers,
    before and after compaction (the merged run inherits the summed
    pyramid): every grid and count equal."""
    from geomesa_tpu_torch.index.pyramid import pyramid_spec

    slots = 1 << 14
    budget = slots * (40 + 16 + 40) + slots * 16 * 3
    spec = ("dtg:Date,*geom:Point;geomesa.index.profile=lean,"
            f"geomesa.lean.generation.slots={slots},"
            f"geomesa.lean.hbm.budget={budget},"
            "geomesa.lean.compaction.factor=0")
    rng = np.random.default_rng(22)
    chunks = [{"dtg": rng.integers(MS_2018, MS_2018 + 60 * DAY, 35_000),
               "geom": (rng.uniform(-20, 20, 35_000),
                        rng.uniform(-10, 10, 35_000))} for _ in range(4)]
    stores = []
    for dev in (cuda_device, "cpu"):
        ds = TpuDataStore(device=dev)
        ds.create_schema("s", spec)
        for c in chunks:
            ds.write("s", c)
        stores.append(ds)
    gidx, cidx = (ds._store("s").index("z3") for ds in stores)
    assert gidx.tier_counts() == cidx.tier_counts() == {
        "full": 1, "keys": 3, "host": 5}
    built = [ds.build_pyramids("s") for ds in stores]
    assert built[0] == built[1] == len(gidx.generations) - 1
    gp, cp = (i._pyramid_cache.spec_cache(pyramid_spec(512))
              for i in (gidx, cidx))
    assert sorted(gp) == sorted(cp)
    for gid in gp:
        for w, grid in gp[gid].levels.items():
            np.testing.assert_array_equal(grid, cp[gid].levels[w])

    def answers():
        out = []
        for ds in stores:
            idx = ds._store("s").index("z3")
            h0 = idx.pyramid_serve_hits
            out.append((density_process(ds, "s", "INCLUDE",
                                        (-180, -90, 180, 90), 256, 256),
                        ds.density_tile("s", 1, 1, 0),
                        idx.z3_cell_counts(12),
                        ds.stats("s", "INCLUDE",
                                 "Z3Histogram(geom,dtg,week,10)").counts,
                        ds.stats("s", "INCLUDE", "Count()").count,
                        idx.pyramid_serve_hits - h0))
        return out

    for before in (True, False):
        g, c = answers()
        for a, b in zip(g, c):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b
        assert g[4] == 4 * 35_000 and g[5] > 0
        if before:
            res = [ds.compact("s") for ds in stores]
            assert res[0] == res[1] and res[0]["z3"]["merged_groups"] >= 1


def _attr_pair(cuda_device, attr_type, col, dtg, slots, budget):
    from geomesa_tpu_torch.index.attr_lean import LeanAttrIndex
    pair = [LeanAttrIndex("a", attr_type, generation_slots=slots,
                          hbm_budget_bytes=budget, device=dev)
            for dev in (cuda_device, "cpu")]
    for lo in range(0, len(col), 30_000):
        for idx in pair:
            idx.append(col[lo:lo + 30_000], dtg[lo:lo + 30_000])
    return pair


def test_lean_attr_index_on_card_matches_cpu(cuda_device):
    """LeanAttrIndex queries on the card against the same index on the
    CPU, at 2^14-slot generations with device and host tiers, before and
    after compaction: tiers, bytes, dispatches and every candidate set
    equal; the card's device generations stay on the card."""
    rng = np.random.default_rng(31)
    n = 150_000
    names = rng.choice(np.array(["USA", "GBR", "FRA", "ÜML", "rare"],
                                object), n, p=[.4, .3, .2, .099, .001])
    dtg = rng.integers(MS_2018, MS_2018 + 30 * DAY, n)
    slots = 1 << 14
    g, c = _attr_pair(cuda_device, "string", names, dtg, slots,
                      4 * slots * 20)
    assert g.tier_counts() == c.tier_counts()
    assert g.tier_counts()["host"] >= 1 and g.tier_counts()["device"] >= 1
    for gen in g.generations:
        if gen.tier == "device":
            assert gen.keys.device.type == torch.device(cuda_device).type
    w = (MS_2018 + 2 * DAY, MS_2018 + 9 * DAY)
    calls = (lambda i: i.query_equals("rare"),
             lambda i: i.query_equals("FRA", w),
             lambda i: i.query_in(["USA", "ÜML", "x"], w),
             lambda i: i.query_range("GBR", "USA", True, False),
             lambda i: i.query_prefix("U"))
    for compacted in (False, True):
        for call in calls:
            np.testing.assert_array_equal(call(g), call(c))
        assert g.dispatch_count == c.dispatch_count
        assert g.device_bytes() == c.device_bytes()
        if not compacted:
            assert g.compact(factor=2) == c.compact(factor=2)
    np.testing.assert_array_equal(np.sort(g.query_equals("rare")),
                                  np.flatnonzero(names == "rare"))


@pytest.mark.parametrize("attr_type", ["double", "long"])
def test_lean_attr_sketch_folds_on_card_match_cpu(cuda_device, attr_type):
    """Sketch folds over a LeanAttrIndex on the card against the CPU:
    counts, key min/max, histogram and count-min exact (the histogram
    and count-min rows on the hist1d kernel at these generation sizes),
    float64 sums within rtol 1e-12; warm repeats fold only the live
    run."""
    from geomesa_tpu_torch.stats.sketch import SketchFold
    rng = np.random.default_rng(32)
    n = 120_000
    col = (np.round(rng.uniform(-10, 10, n), 1) if attr_type == "double"
           else rng.integers(-1000, 1000, n))
    dtg = rng.integers(MS_2018, MS_2018 + 30 * DAY, n)
    slots = 1 << 14
    g, c = _attr_pair(cuda_device, attr_type, col, dtg, slots,
                      4 * slots * 20)
    before = hk.hist1d.launches
    for fold in (SketchFold(bins=64, hlo=-10.0, hhi=10.0, depth=4,
                            width=1024),
                 SketchFold(slo=MS_2018 + DAY, shi=MS_2018 + 5 * DAY,
                            bins=16, hlo=-5.0, hhi=5.0),
                 SketchFold(depth=2, width=64)):
        for _ in range(2):
            a, b = g.sketch_scan(fold), c.sketch_scan(fold)
            assert (a.count, a.kmin, a.kmax) == (b.count, b.kmin, b.kmax)
            for x, y in ((a.hist, b.hist), (a.cms, b.cms)):
                if y is None:
                    assert x is None
                else:
                    np.testing.assert_array_equal(x, y)
            np.testing.assert_allclose([a.vsum, a.vsumsq],
                                       [b.vsum, b.vsumsq], rtol=1e-12)
    assert hk.hist1d.launches > before


def test_v1_layout_scans_on_card_match_cpu(cuda_device):
    """A schema pinned to the v1 key layouts (the legacy curves) on the
    card against the same store on the CPU: the z3 and z2 scans launch
    their mask kernels over legacy-normalized boxes, with equal hits,
    before and after ``migrate_schema``."""
    spec = ("name:String,dtg:Date,*geom:Point;"
            "geomesa.index.versions='z3:1,z2:1'")
    rng = np.random.default_rng(41)
    m = 200_000
    rows = {"name": np.array(["a"] * m, dtype=object),
            "dtg": rng.integers(MS_2018, MS_2018 + 21 * DAY, m),
            "geom": (rng.uniform(-75.0, -73.0, m), rng.uniform(40.0, 42.0, m))}
    stores = []
    for dev in (cuda_device, "cpu"):
        ds = TpuDataStore(device=dev)
        ds.create_schema("ev", spec)
        ds.write("ev", rows)
        stores.append(ds)
    queries = ("BBOX(geom, -74.5, 40.5, -73.5, 41.5) AND dtg DURING "
               "2018-01-03T00:00:00Z/2018-01-10T00:00:00Z",
               "BBOX(geom, -74.2, 40.8, -73.9, 41.1)",
               "BBOX(geom, -180, -90, -74, 41)")
    for migrate in (False, True):
        z3_before, z2_before = z3_mask.launches, z2_mask.launches
        for ecql in queries:
            g, c = (ds.query_result("ev", ecql) for ds in stores)
            assert g.strategy.index == c.strategy.index
            np.testing.assert_array_equal(g.positions, c.positions)
        assert z3_mask.launches > z3_before
        assert z2_mask.launches > z2_before
        versions = {ds._store("ev").z3_index().version for ds in stores}
        assert versions == ({2} if migrate else {1})
        if not migrate:
            for ds in stores:
                ds.migrate_schema("ev")


def test_tombstoned_lean_heatmap_on_card_matches_plain(cuda_device):
    """A lean store with tombstones on the card against the same store on
    the CPU: the heatmap falls back from the push-down to the query path,
    whose density kernel (unit weights, float32) must equal the plain
    grid; the tile, Count and positions equal too."""
    spec = ("score:Double,dtg:Date,*geom:Point;geomesa.index.profile=lean,"
            "geomesa.lean.generation.slots=16384")
    rng = np.random.default_rng(43)
    chunks = [{"score": rng.uniform(0, 100, 30_000),
               "dtg": rng.integers(MS_2018, MS_2018 + 60 * DAY, 30_000),
               "geom": (rng.uniform(-20, 20, 30_000),
                        rng.uniform(-10, 10, 30_000))} for _ in range(3)]
    ids = [str(i) for i in rng.choice(90_000, 9_000, replace=False)]
    stores = []
    for dev in (cuda_device, "cpu"):
        ds = TpuDataStore(device=dev)
        ds.create_schema("s", spec)
        for c in chunks:
            ds.write("s", c)
        assert ds.delete("s", ids) == 9_000
        stores.append(ds)
    q = ("BBOX(geom, -5, -5, 5, 5) AND dtg DURING "
         "2018-01-03T00:00:00Z/2018-01-19T00:00:00Z")
    for query, env in ((q, (-5, -5, 5, 5)), ("INCLUDE", (-20, -10, 20, 10))):
        before = density_grid_kernel.launches
        g, c = (density_process(ds, "s", query, env, 64, 32)
                for ds in stores)
        assert density_grid_kernel.launches == before + 1
        np.testing.assert_array_equal(g, c)
    np.testing.assert_array_equal(stores[0].density_tile("s", 2, 1, 1),
                                  stores[1].density_tile("s", 2, 1, 1))
    for ecql in (q, "INCLUDE"):
        g, c = (ds.stats("s", ecql, "Count()").count for ds in stores)
        assert g == c
        g, c = (ds.query_result("s", ecql).positions for ds in stores)
        np.testing.assert_array_equal(g, c)
    assert stores[0].get_count("s") == 81_000


def test_mesh_lean_store_on_card_matches_cpu(cuda_device):
    """A lean store over ``device_mesh(1)`` on the card against the same
    store over a one-CPU mesh: every generation's columns live on the
    card, the accounted device bytes equal what was allocated for them,
    and positions, heatmaps, Count, the cell fold, the attribute
    candidates and a ring query on a mesh z3 store (through the z3 mask
    kernel) equal the CPU's."""
    from geomesa_tpu_torch.parallel import device_mesh
    slots = 1 << 12
    spec = ("actor:String:index=true,dtg:Date,*geom:Point;"
            "geomesa.index.profile=lean,"
            f"geomesa.lean.generation.slots={slots},"
            f"geomesa.lean.hbm.budget={slots * (44 + 20 + 44 + 20 * 3)}")
    rng = np.random.default_rng(47)
    chunks = [{"actor": rng.choice(["a", "b", "rare"], 20_000,
                                   p=[.6, .39, .01]).astype(object),
               "dtg": rng.integers(MS_2018, MS_2018 + 30 * DAY, 20_000),
               "geom": (rng.uniform(-20, 20, 20_000),
                        rng.uniform(-10, 10, 20_000))} for _ in range(4)]
    stores = []
    for mesh in (device_mesh(1), device_mesh(devices=["cpu"])):
        ds = TpuDataStore(device=mesh[0], mesh=mesh)
        ds.create_schema("s", spec)
        for c in chunks:
            ds.write("s", c)
        stores.append(ds)
    idx, cidx = (ds._store("s").index("z3") for ds in stores)
    assert idx.tier_counts() == cidx.tier_counts()
    assert idx.tier_counts()["host"] > 0
    for g in idx.generations:
        cols = [] if g.tier == "host" else g.bins + g.z + g.pos
        if g.tier == "full":
            cols += g.x + g.y + g.t
        assert all(c.device.type == "cuda" for c in cols)
    torch.cuda.synchronize()
    assert idx.device_bytes() == sum(
        c.numel() * c.element_size() for g in idx.generations
        if g.tier != "host"
        for c in g.bins + g.z + g.pos + (g.x + g.y + g.t
                                         if g.tier == "full" else []))
    q = ("BBOX(geom, -5, -5, 5, 5) AND dtg DURING "
         "2018-01-03T00:00:00Z/2018-01-19T00:00:00Z")
    for ecql in (q, "INCLUDE", "actor = 'rare'"):
        g, c = (ds.query_result("s", ecql) for ds in stores)
        assert g.strategy.index == c.strategy.index
        np.testing.assert_array_equal(g.positions, c.positions)
    for query, env in ((q, (-5, -5, 5, 5)), ("INCLUDE", (-20, -10, 20, 10))):
        g, c = (density_process(ds, "s", query, env, 64, 32)
                for ds in stores)
        np.testing.assert_array_equal(g, c)
    for stat in ("Count()", "Z3Histogram(geom,dtg,week,8)"):
        g, c = (ds.stats("s", "INCLUDE", stat) for ds in stores)
        assert g.to_json() == c.to_json()
    assert stores[0].compact("s") == stores[1].compact("s")
    # the ring query over a mesh z3 store launches the z3 mask kernel
    ms = TpuDataStore(device=cuda_device, mesh=device_mesh(1))
    ms.create_schema("p", "dtg:Date,*geom:Point")
    ms.write("p", {k: v for k, v in chunks[0].items() if k != "actor"})
    z3 = ms._store("p").index("z3")
    before = z3_mask.launches
    got = z3.query_ring([(-5, -5, 5, 5)], MS_2018, MS_2018 + 20 * DAY)
    assert z3_mask.launches > before
    np.testing.assert_array_equal(
        got, z3.query([(-5, -5, 5, 5)], MS_2018, MS_2018 + 20 * DAY))
