"""Port parity: the z3 candidate mask (ops/z3_mask.py) against the JAX
package's Pallas kernel ``z3_mask_pallas``, run here in interpret mode.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is held against that plain version on the card by
tests/test_torch_cuda.py and by ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

from geomesa_tpu.curve import TimePeriod, max_offset, z3_sfc as j_z3_sfc
from geomesa_tpu.ops.pallas_kernels import z3_mask_pallas
from geomesa_tpu_torch.ops.z3_mask import z3_mask


def _case(n, seed, boxes, pad_to=None):
    """The inputs of tests/test_pallas_kernels.py's z3 mask case, at any
    N, optionally with never-matching [1, 1, 0, 0] padding boxes."""
    rng = np.random.default_rng(seed)
    sfc = j_z3_sfc(TimePeriod.WEEK)
    x = rng.uniform(-180, 180, n)
    y = rng.uniform(-90, 90, n)
    t = rng.uniform(0, float(max_offset(TimePeriod.WEEK)), n)
    z = np.asarray(sfc.index(x, y, t, xp=np)).astype(np.int64)
    ixy = np.array([[sfc.lon.normalize_scalar(b[0]),
                     sfc.lat.normalize_scalar(b[1]),
                     sfc.lon.normalize_scalar(b[2]),
                     sfc.lat.normalize_scalar(b[3])] for b in boxes],
                   dtype=np.int32).reshape(-1, 4)
    if pad_to is not None:
        ixy = np.concatenate(
            [ixy, np.tile(np.array([[1, 1, 0, 0]], np.int32),
                          (pad_to - len(ixy), 1))])
    it = np.asarray(sfc.time.normalize(t, xp=np)).astype(np.int64)
    tlo = rng.integers(0, int(it.max()) // 2, n).astype(np.int32)
    thi = (tlo + rng.integers(0, int(it.max()), n)).astype(np.int32)
    return z, ixy, tlo, thi


_BOXES = [(-60.0, -30.0, 20.0, 40.0), (100.0, 10.0, 140.0, 55.0)]


@pytest.mark.parametrize("n,boxes,pad_to", [
    (3000, _BOXES, None),              # the Pallas test's case
    (3000, _BOXES, 8),                 # padded to a pow2 box count
    (8192 + 37, _BOXES[:1], None),     # ragged past one (8, 1024) block
    (1, _BOXES, 2),                    # a single candidate
    (777, [], 1),                      # only a never-matching padded box
])
def test_z3_mask_cpu_matches_pallas(n, boxes, pad_to):
    z, ixy, tlo, thi = _case(n, n, boxes, pad_to)
    got = z3_mask(*(torch.from_numpy(a) for a in (z, ixy, tlo, thi)))
    want = np.asarray(z3_mask_pallas(z, ixy, tlo, thi))
    assert got.dtype == torch.bool and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    if boxes and n > 100:
        assert want.any() and not want.all()
    if not boxes:
        assert not want.any()


def test_z3_mask_checks_its_inputs():
    z, ixy, tlo, thi = (torch.from_numpy(a)
                        for a in _case(64, 1, _BOXES))
    with pytest.raises(TypeError):
        z3_mask(z.to(torch.int32), ixy, tlo, thi)
    with pytest.raises(TypeError):
        z3_mask(z, ixy.to(torch.int64), tlo, thi)
    with pytest.raises(ValueError):
        z3_mask(z, ixy.reshape(-1, 2), tlo, thi)
    with pytest.raises(ValueError):
        z3_mask(z, ixy, tlo[:-1], thi)
    with pytest.raises(ValueError):
        z3_mask(z[::2], ixy, tlo[::2], thi[::2])


def test_z3_mask_cpu_does_not_count_launches():
    before = z3_mask.launches
    z3_mask(*(torch.from_numpy(a) for a in _case(100, 2, _BOXES)))
    assert z3_mask.launches == before
