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
import functools
from typing import NamedTuple

import torch

from .build import load
from .launch import (
    BLOCK_ROWS, CLUSTER_SIZES, MAX_SHARED_BYTES, STAGE_BYTES, THREADS, WARPS,
    Resident, cdiv, pick_cluster,
)

__all__ = ["hist1d", "hist1d_reference", "launch_shape", "Hist1dShape",
           "MAX_SHARED_BYTES", "THREADS"]

#: shared memory spent on the replicas of a narrow histogram
COPY_BUDGET_BYTES = 32 * 1024


class Hist1dShape(NamedTuple):
    """One launch: ``copies`` replicas per block of a uint32 count and a
    float sum per bin (``cluster`` 1), unit weights counted in one
    histogram spread over a cluster of 2..16 blocks, or every row a
    global atomic into the output (``cluster`` 0); ``blocks`` in the grid; ``smem`` bytes of dynamic
    shared memory per block."""
    cluster: int
    blocks: int
    copies: int
    smem: int


def launch_shape(n: int, n_bins: int, resident: Resident) -> Hist1dShape:
    """The launch over ``n`` rows and ``n_bins`` bins.

    A histogram that fits one block's shared memory as a uint32 count and
    a float sum per bin is kept there, in ``copies`` replicas (one per
    group of warps, within 32 KB), so few bins do not send a whole block
    to the same words.  A wider one counts its unit weights in a
    cluster's distributed shared memory when
    :func:`~geomesa_tpu_torch.ops.launch.pick_cluster` finds a cluster
    that holds it, other weights adding straight into the output, as
    every row does when none does.  The grid fills what the card holds resident
    (``resident(cluster, smem)`` blocks), no more blocks than there are
    tiles of rows, and in the shared-memory branches holds the flush
    (``n_bins`` global atomics per block or cluster) below ``n``."""
    # one block keeps a uint32 count and a float sum per bin; a cluster
    # only the counts
    cluster, smem = pick_cluster(n_bins, 8, resident, sizes=(1,))
    if cluster == 0:
        cluster, smem = pick_cluster(n_bins, 4, resident,
                                     sizes=CLUSTER_SIZES[1:])
    if cluster == 0:
        blocks = max(1, min(resident(0, smem), cdiv(n, BLOCK_ROWS)))
        return Hist1dShape(0, blocks, 0, smem)
    copies = 1
    if cluster == 1:
        copies = max(1, min(WARPS, COPY_BUDGET_BYTES // (8 * n_bins)))
        smem = copies * 8 * n_bins + STAGE_BYTES
    units = max(1, min(resident(cluster, smem) // cluster,
                       cdiv(n, BLOCK_ROWS * cluster), n // n_bins))
    return Hist1dShape(cluster, units * cluster, copies, smem)


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = load("hist1d")
        fn = lib.hist1d_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        res = lib.hist1d_resident
        res.restype = ctypes.c_int
        res.argtypes = [ctypes.c_int, ctypes.c_int,
                        ctypes.POINTER(ctypes.c_int)]
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _resident(index: int, cluster: int, smem: int) -> int:
    """Blocks of that shape card ``index`` holds at once (the card's own
    occupancy query)."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _library().hist1d_resident(cluster, smem, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"hist1d occupancy query failed: CUDA error "
                           f"{err}")
    return blocks.value


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
    n = int(bins.shape[0])
    if n == 0:
        return torch.zeros(n_bins, dtype=torch.float32, device=bins.device)
    index = bins.device.index
    if index is None:
        index = torch.cuda.current_device()
    shape = _card_shape(index, n, n_bins)
    out = torch.zeros(n_bins, dtype=torch.float32, device=bins.device)
    vec = all(t.data_ptr() % 16 == 0 for t in (bins, weights, mask))
    with torch.cuda.device(bins.device):
        stream = torch.cuda.current_stream(bins.device).cuda_stream
        err = _library().hist1d_launch(
            bins.data_ptr(), weights.data_ptr(), mask.data_ptr(), n, n_bins,
            shape.cluster, shape.blocks, shape.copies, shape.smem, int(vec),
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hist1d kernel launch failed: CUDA error {err}")
    hist1d.launches += 1
    return out


@functools.lru_cache(maxsize=256)
def _card_shape(index: int, n: int, n_bins: int) -> Hist1dShape:
    return launch_shape(n, n_bins, functools.partial(_resident, index))


#: kernel launches since the count was last reset (CPU calls never count)
hist1d.launches = 0
