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
from geomesa_tpu_torch.ops.launch import STAGE_BYTES


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


@pytest.mark.parametrize("n_bins,cluster,copies", [
    (64, 1, THREADS // 32),         # one replica per warp
    (1024, 1, 4),
    (13_952, 1, 1),                 # the widest at two blocks an SM
    (28_544, 1, 1),                 # the widest one block holds (227 KB)
    (28_545, 2, 1),                 # one bin more: a cluster of two
    (65_536, 4, 1),                 # 64 KB of counts a block
    (446_464, 16, 1),               # the widest at two blocks an SM
    (446_465, 8, 1),                # one bin more: one block an SM
    (913_408, 16, 1),               # the widest a cluster holds (227 KB x 16)
    (913_409, 0, 0),                # one bin more: global atomics
])
def test_launch_shape(n_bins, cluster, copies):
    """The branch the kernel takes: replicas of a count and a float sum
    per bin in one block, counts spread over a cluster's distributed
    shared memory, global atomics past what a cluster of 16 holds."""
    n = 16_000_000
    shape = launch_shape(n, n_bins, _h100)
    assert (shape.cluster, shape.copies) == (cluster, copies)
    assert shape.smem <= MAX_SHARED_BYTES
    assert 1 <= shape.blocks <= _h100(shape.cluster, shape.smem)
    if cluster:
        assert shape.blocks % cluster == 0
        held = (8 * n_bins * copies if cluster == 1
                else 4 * -(-n_bins // cluster))
        assert held + STAGE_BYTES <= shape.smem
        # the flush (n_bins global atomics per block or cluster) stays
        # below N
        assert shape.blocks // cluster * n_bins <= n
    else:
        assert shape.smem == STAGE_BYTES
    # a few rows: one block, or one cluster
    assert launch_shape(10, n_bins, _h100).blocks == max(cluster, 1)


def test_launch_shape_follows_the_card():
    """A cluster size the card cannot hold is not chosen: without
    non-portable clusters (at most 8) the widest histograms go to global
    atomics, and the rest to the next cluster size that fits."""
    def portable(c, smem):
        return _h100(c, smem, max_cluster=8)
    assert launch_shape(16_000_000, 913_408, portable).cluster == 0
    assert launch_shape(16_000_000, 446_464, portable).cluster == 8
    assert launch_shape(16_000_000, 64, portable).cluster == 1
    # a card of 8 SMs holds fewer blocks
    small = launch_shape(16_000_000, 64, lambda c, s: _h100(c, s) // 132 * 8)
    assert small.blocks == _h100(1, small.smem) // 132 * 8
