"""Port parity: the 1-D histogram of geomesa_tpu_torch (``hist1d``, whose
plain version runs on CPU tensors) against geomesa_tpu's
``hist1d_pallas`` (interpret mode on the CPU, as
tests/test_pallas_kernels.py runs it) and against ``np.bincount``.

Tolerances: unit weights are exact (every partial is an integer below
2^24, exact in float32) and compared bit for bit; random weights are
summed in float64 and rounded once by the plain version, in float32 tile
by tile by the TPU kernel, so they agree within rtol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomesa_tpu.ops.pallas_kernels import hist1d_pallas
from geomesa_tpu_torch.ops.hist1d_kernel import (
    MAX_SHARED_BYTES, THREADS, hist1d, hist1d_reference, launch_shape,
)


def _case(seed, n, n_bins, weights):
    rng = np.random.default_rng(seed)
    # ids a little past both ends: negative and >= n_bins add nothing
    bins = rng.integers(-7, n_bins + 7, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    w = (np.ones(n, np.float32) if weights == "unit"
         else rng.uniform(0.0, 3.0, n).astype(np.float32))
    return bins, w, mask


def _port(bins, w, mask, n_bins):
    return hist1d(torch.from_numpy(bins), torch.from_numpy(w),
                  torch.from_numpy(mask), n_bins).numpy()


def _jax(bins, w, mask, n_bins):
    return np.asarray(hist1d_pallas(jnp.asarray(bins), jnp.asarray(w),
                                    jnp.asarray(mask), n_bins))


def _bincount(bins, w, mask, n_bins):
    keep = mask & (bins >= 0) & (bins < n_bins)
    return np.bincount(bins[keep], weights=w[keep].astype(np.float64),
                       minlength=n_bins)


@pytest.mark.parametrize("n,n_bins", [
    (20_000, 64),       # the Histogram stat's bins on the mesh path
    (20_000, 1024),     # a Frequency width
    (9_001, 1100),      # ragged N; n_bins not a multiple of the 512 tile
    (4_097, 3000),
    (0, 64),
    (1, 1),
])
@pytest.mark.parametrize("weights", ["unit", "random"])
def test_hist1d_matches_jax_and_bincount(n, n_bins, weights):
    bins, w, mask = _case(n + n_bins, n, n_bins, weights)
    got = _port(bins, w, mask, n_bins)
    want = _jax(bins, w, mask, n_bins)
    oracle = _bincount(bins, w, mask, n_bins)
    assert got.dtype == np.float32 and got.shape == (n_bins,)
    if weights == "unit":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, oracle.astype(np.float32))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
        # the plain version sums in float64 and rounds once
        np.testing.assert_array_equal(got, oracle.astype(np.float32))


def test_hist1d_all_masked_out_and_out_of_range():
    bins = np.array([-1, 5, 6, 100, 2 ** 31 - 1, -(2 ** 31)], np.int32)
    w = np.ones(6, np.float32)
    got = _port(bins, w, np.ones(6, bool), 6)
    np.testing.assert_array_equal(got, [0, 0, 0, 0, 0, 1])
    np.testing.assert_array_equal(got, _jax(bins, w, np.ones(6, bool), 6))
    np.testing.assert_array_equal(_port(bins, w, np.zeros(6, bool), 6),
                                  np.zeros(6, np.float32))


def test_hist1d_wrapper_checks():
    b = torch.zeros(4, dtype=torch.int32)
    w = torch.ones(4, dtype=torch.float32)
    m = torch.ones(4, dtype=torch.bool)
    with pytest.raises(TypeError):
        hist1d(b.to(torch.int64), w, m, 4)
    with pytest.raises(TypeError):
        hist1d(b, w.double(), m, 4)
    with pytest.raises(TypeError):
        hist1d(b, w, m.to(torch.uint8), 4)
    with pytest.raises(TypeError):
        hist1d(b.numpy(), w, m, 4)
    with pytest.raises(ValueError):
        hist1d(b, w[:3], m, 4)
    with pytest.raises(ValueError):
        hist1d(b.reshape(2, 2), w.reshape(2, 2), m.reshape(2, 2), 4)
    with pytest.raises(ValueError):
        hist1d(torch.zeros(8, dtype=torch.int32)[::2], w, m, 4)
    with pytest.raises(ValueError):
        hist1d(b, w, m, 0)
    with pytest.raises(ValueError):
        hist1d(b, w.to("meta"), m, 4)
    with pytest.raises(ValueError):
        hist1d(b.to("meta"), w.to("meta"), m.to("meta"), 4)
    assert hist1d.launches == 0  # CPU calls never count


def test_hist1d_reference_is_the_cpu_path():
    bins, w, mask = _case(3, 5000, 300, "random")
    args = (torch.from_numpy(bins), torch.from_numpy(w),
            torch.from_numpy(mask), 300)
    assert torch.equal(hist1d(*args), hist1d_reference(*args))


@pytest.mark.parametrize("n_bins,copies", [
    (64, THREADS // 32),             # one replica per warp
    (1024, 8),
    (58_112, 1),                     # one copy fills the 227 KB exactly
    (58_113, 0),                     # wider: the global-atomic branch
    (65_536, 0),
])
def test_launch_shape(n_bins, copies):
    """The shared-memory layout the kernel gets: replicas of a narrow
    histogram, one copy of a wide one, none (global atomics) past the
    227 KB a block may hold."""
    blocks, got = launch_shape(16_000_000, n_bins, 132)
    assert got == copies
    assert got * 4 * n_bins <= MAX_SHARED_BYTES
    assert 1 <= blocks <= 132 * 4
    if copies:
        # the flush (n_bins global atomics per block) stays below N
        assert blocks * n_bins <= 16_000_000
    assert launch_shape(10, 64, 132)[0] == 1
