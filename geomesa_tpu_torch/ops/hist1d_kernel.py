"""The 1-D histogram: a hand-written CUDA kernel and its plain version.

Replaces ``geomesa_tpu/ops/pallas_kernels.py: hist1d_pallas`` with the
same contract::

    hist1d(bins: int32[N], weights: float32[N], mask: bool[N], n_bins)
        -> float32[n_bins]

A row adds its weight to its bin when its mask is set and its bin id lies
in ``[0, n_bins)``; every other row adds nothing.

On CUDA tensors :func:`hist1d` launches ``csrc/hist1d.cu`` (built with
``nvcc`` at first use, see :mod:`geomesa_tpu_torch.ops.build`) or raises;
on CPU tensors it runs :func:`hist1d_reference`, the plain PyTorch version
of the same function.  ``hist1d.launches`` counts kernel launches.  What
bounds the kernel on the card, and its design, are noted in the CUDA
source; :func:`launch_shape` picks its grid and its shared-memory layout.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load

__all__ = ["hist1d", "hist1d_reference", "launch_shape"]

#: threads per block (the kernel's ``kThreads``)
THREADS = 512
#: shared memory one block may use, after the opt-in (227 KB)
MAX_SHARED_BYTES = 232_448
#: shared memory spent on the replicas of a narrow histogram
COPY_BUDGET_BYTES = 32 * 1024
BLOCKS_PER_SM = 4

_launch_fn = None


def _launcher():
    global _launch_fn
    if _launch_fn is None:
        fn = load("hist1d").hist1d_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        _launch_fn = fn
    return _launch_fn


def launch_shape(n: int, n_bins: int, sm_count: int) -> tuple[int, int]:
    """``(blocks, copies)`` of one launch over ``n`` rows.

    ``copies`` is the number of replicas of the histogram a block keeps in
    shared memory (one per group of warps, so few bins do not send a whole
    block to the same words), or 0 when one copy does not fit and the
    kernel adds straight into the output.  The grid fills the card a few
    blocks per SM, and in the shared-memory case holds the flush (``n_bins``
    global atomics per block) below ``n``."""
    row_bytes = 4 * n_bins
    if row_bytes > MAX_SHARED_BYTES:
        copies = 0
    else:
        copies = max(1, min(THREADS // 32, COPY_BUDGET_BYTES // row_bytes))
    blocks = min(sm_count * BLOCKS_PER_SM, -(-n // THREADS))
    if copies:
        blocks = min(blocks, max(1, n // n_bins))
    return blocks, copies


def _check(bins, weights, mask, n_bins: int) -> None:
    tensors = {"bins": bins, "weights": weights, "mask": mask}
    want = {"bins": torch.int32, "weights": torch.float32,
            "mask": torch.bool}
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"hist1d: {name} must be a tensor")
        if t.device != bins.device:
            raise ValueError(f"hist1d: {name} is on {t.device}, bins on "
                             f"{bins.device}")
        if not t.is_contiguous():
            raise ValueError(f"hist1d: {name} must be contiguous")
        if t.dtype != want[name]:
            raise TypeError(f"hist1d: {name} must be {want[name]}, got "
                            f"{t.dtype}")
        if t.dim() != 1 or t.shape != bins.shape:
            raise ValueError("hist1d: bins, weights and mask must be 1-D of "
                             "one length")
    if not 1 <= n_bins < 2 ** 31:
        raise ValueError(f"hist1d: bad n_bins {n_bins}")


def hist1d_reference(bins, weights, mask, n_bins: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the kept rows' weights summed
    per bin in float64 by one scatter-add, rounded to float32 once."""
    keep = mask & (bins >= 0) & (bins < n_bins)
    acc = torch.zeros(n_bins, dtype=torch.float64, device=bins.device)
    acc.index_add_(0, bins[keep].to(torch.int64),
                   weights[keep].to(torch.float64))
    return acc.to(torch.float32)


def hist1d(bins, weights, mask, n_bins: int) -> torch.Tensor:
    """Masked weighted 1-D histogram; float32 ``(n_bins,)``."""
    n_bins = int(n_bins)
    _check(bins, weights, mask, n_bins)
    if bins.device.type == "cpu":
        return hist1d_reference(bins, weights, mask, n_bins)
    if bins.device.type != "cuda":
        raise ValueError(f"hist1d: unsupported device {bins.device}")
    out = torch.zeros(n_bins, dtype=torch.float32, device=bins.device)
    n = int(bins.shape[0])
    if n == 0:
        return out
    sm_count = torch.cuda.get_device_properties(
        bins.device).multi_processor_count
    blocks, copies = launch_shape(n, n_bins, sm_count)
    with torch.cuda.device(bins.device):
        stream = torch.cuda.current_stream(bins.device).cuda_stream
        err = _launcher()(bins.data_ptr(), weights.data_ptr(),
                          mask.data_ptr(), n, n_bins, blocks, copies,
                          out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hist1d kernel launch failed: CUDA error {err}")
    hist1d.launches += 1
    return out


#: kernel launches since the count was last reset (CPU calls never count)
hist1d.launches = 0
