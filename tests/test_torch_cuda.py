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

from geomesa_tpu_torch.curve import z3_sfc
from geomesa_tpu_torch.index.z3 import Z3PointIndex
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
