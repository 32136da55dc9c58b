"""The density histogram: a hand-written CUDA kernel and its plain version.

Replaces ``geomesa_tpu/ops/pallas_kernels.py: density_grid_pallas`` with
the same contract::

    density_grid_kernel(x, y, weights: float64[N], mask: bool[N],
                        env: (xmin, ymin, xmax, ymax), width, height)
        -> float32[height, width]

Each masked-in point is snapped to the grid by :func:`grid_snap`, and
its weight, cast to float32 as the JAX chip paths cast it, is summed into
its cell in float64; the sums are rounded to float32 at the end, as
``density_grid_sorted`` rounds them.

On CUDA tensors :func:`density_grid_kernel` launches
``csrc/density_grid.cu`` (built with ``nvcc`` at first use, see
:mod:`geomesa_tpu_torch.ops.build`) or raises; on CPU tensors it runs
:func:`density_grid_kernel_reference`, the plain PyTorch version of the
same function.  ``density_grid_kernel.launches`` counts kernel launches.
What bounds the kernel on the card, and its design, are noted in the CUDA
source; :func:`launch_shape` picks its branch and its grid.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .build import load
from .launch import BLOCK_ROWS, Resident, cdiv, pick_cluster

__all__ = ["density_grid_kernel", "density_grid_kernel_reference",
           "grid_snap", "launch_shape", "DensityShape"]

#: the partial counts of a block or cluster are written and read once more
#: by the reduce pass: keep at least this many rows per partial cell
ROWS_PER_PARTIAL_CELL = 2


class DensityShape(NamedTuple):
    """One launch: unit weights counted in uint32 with global atomics
    (``cluster`` 0), in a private grid per block (1) or in one spread over
    a cluster of 2..16 blocks; ``blocks`` in the grid; ``smem`` bytes of
    dynamic shared memory per block; ``parts`` count grids the reduce pass
    sums."""
    cluster: int
    blocks: int
    smem: int
    parts: int


def launch_shape(n: int, width: int, height: int,
                 resident: Resident) -> DensityShape:
    """The launch over ``n`` points and a ``width`` x ``height`` grid.

    Unit weights are counted in a uint32 grid privatised in one block's
    shared memory, or in a cluster's, when
    :func:`~geomesa_tpu_torch.ops.launch.pick_cluster` finds one that
    holds it, else with global integer atomics; other weights are summed
    with global float64 atomics.  The grid fills what the card holds
    resident (``resident(cluster, smem)``
    blocks), no more blocks than there are tiles of rows, and no more
    partial grids than ``n / (2 * cells)``, so the partials' write and
    reduce stay below the rows' own traffic."""
    cells = width * height
    cluster, smem = pick_cluster(cells, 4, resident)
    if cluster == 0:
        blocks = max(1, min(resident(0, smem), cdiv(n, BLOCK_ROWS)))
        return DensityShape(0, blocks, smem, 1)
    units = max(1, min(resident(cluster, smem) // cluster,
                       cdiv(n, BLOCK_ROWS * cluster),
                       n // (ROWS_PER_PARTIAL_CELL * cells)))
    return DensityShape(cluster, units * cluster, smem, units)


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = load("density_grid")
        fn = lib.density_grid_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_double, ctypes.c_double,
                       ctypes.c_double, ctypes.c_double,
                       ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        res = lib.density_grid_resident
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
        err = _library().density_grid_resident(cluster, smem,
                                               ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"density_grid occupancy query failed: CUDA "
                           f"error {err}")
    return blocks.value


def _check(x, y, weights, mask, env, width, height) -> None:
    tensors = {"x": x, "y": y, "weights": weights, "mask": mask}
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"density_grid_kernel: {name} must be a tensor")
        if t.device != x.device:
            raise ValueError(f"density_grid_kernel: {name} is on {t.device}, "
                             f"x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"density_grid_kernel: {name} must be "
                             "contiguous")
        want = torch.bool if name == "mask" else torch.float64
        if t.dtype != want:
            raise TypeError(f"density_grid_kernel: {name} must be {want}, "
                            f"got {t.dtype}")
        if t.dim() != 1 or t.shape != x.shape:
            raise ValueError("density_grid_kernel: x, y, weights and mask "
                             "must be 1-D of one length")
    if len(env) != 4:
        raise ValueError("density_grid_kernel: env must be (xmin, ymin, "
                         "xmax, ymax)")
    if not (width >= 1 and height >= 1 and width * height < 2 ** 31):
        raise ValueError(f"density_grid_kernel: bad grid {width}x{height}")


def _cell_size(env, width: int, height: int):
    """The envelope's origin and grid cell size, in float64 on the host
    (the kernel gets them as arguments)."""
    xmin, ymin, xmax, ymax = (float(v) for v in env)
    return xmin, ymin, (xmax - xmin) / width, (ymax - ymin) / height


def grid_snap(x, y, env, width: int, height: int):
    """GridSnap semantics (geomesa-utils GridSnap): int64 index of the
    cell containing each point; points outside the envelope are clamped.
    The clamp is taken in float64 before the conversion to an integer, as
    XLA's saturating float→int32 conversion followed by its clip
    amounts to (a point far outside a deep tile's envelope would
    overflow int32 otherwise)."""
    xmin, ymin, dx, dy = _cell_size(env, width, height)
    ix = torch.clamp(torch.floor((x - xmin) / dx), 0, width - 1)
    iy = torch.clamp(torch.floor((y - ymin) / dy), 0, height - 1)
    return ix.to(torch.int64), iy.to(torch.int64)


def density_grid_kernel_reference(x, y, weights, mask, env, width: int,
                                  height: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: snap (floor, clamp in
    float64), float32-cast weights summed in float64, rounded to a
    float32 (height, width) grid."""
    ix, iy = grid_snap(x, y, env, width, height)
    flat = (iy * width + ix)[mask]
    acc = torch.zeros(width * height, dtype=torch.float64, device=x.device)
    acc.index_add_(0, flat, weights[mask].to(torch.float32).to(torch.float64))
    return acc.to(torch.float32).reshape(height, width)


def density_grid_kernel(x, y, weights, mask, env, width: int,
                        height: int) -> torch.Tensor:
    """Weighted masked 2-D histogram over ``env``; float32 (height,
    width) grid."""
    width, height = int(width), int(height)
    _check(x, y, weights, mask, env, width, height)
    if x.device.type == "cpu":
        return density_grid_kernel_reference(x, y, weights, mask, env,
                                             width, height)
    if x.device.type != "cuda":
        raise ValueError(f"density_grid_kernel: unsupported device "
                         f"{x.device}")
    n = int(x.shape[0])
    if n == 0:
        return torch.zeros((height, width), dtype=torch.float32,
                           device=x.device)
    index = x.device.index
    if index is None:
        index = torch.cuda.current_device()
    shape = _card_shape(index, n, width, height)
    g = width * height
    # the zeroed float64 grid the global atomics add into; the counts
    # (uint32, held as int32): the global atomics' one zeroed grid, behind
    # the float64 grid in one zero fill, or the rows the blocks or clusters
    # write whole, counted in a zeroed cell behind the float64 grid; and
    # the float32 grid the reduce pass writes whole (the kernel allocates
    # nothing)
    if shape.cluster == 0:
        buf = torch.zeros(3 * g, dtype=torch.int32, device=x.device)
        acc, part = buf[:2 * g].view(torch.float64), buf[2 * g:]
    else:
        acc = torch.zeros(g + 1, dtype=torch.float64, device=x.device)
        part = torch.empty(shape.parts * g, dtype=torch.int32,
                           device=x.device)
    out = torch.empty(g, dtype=torch.float32, device=x.device)
    xmin, ymin, dx, dy = _cell_size(env, width, height)
    vec = all(t.data_ptr() % 16 == 0 for t in (x, y, weights, mask))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().density_grid_launch(
            x.data_ptr(), y.data_ptr(), weights.data_ptr(), mask.data_ptr(),
            n, xmin, ymin, dx, dy, width, height, shape.cluster,
            shape.blocks, shape.smem, int(vec), acc.data_ptr(),
            part.data_ptr(), shape.parts, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"density_grid kernel launch failed: CUDA "
                           f"error {err}")
    density_grid_kernel.launches += 1
    return out.reshape(height, width)


@functools.lru_cache(maxsize=256)
def _card_shape(index: int, n: int, width: int,
                height: int) -> DensityShape:
    return launch_shape(n, width, height,
                        functools.partial(_resident, index))


#: kernel launches since the count was last reset (CPU calls never count)
density_grid_kernel.launches = 0
