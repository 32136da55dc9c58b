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
source.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load

__all__ = ["density_grid_kernel", "density_grid_kernel_reference",
           "grid_snap"]

_launch_fn = None


def _launcher():
    global _launch_fn
    if _launch_fn is None:
        fn = load("density_grid").density_grid_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_double, ctypes.c_double,
                       ctypes.c_double, ctypes.c_double,
                       ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _launch_fn = fn
    return _launch_fn


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
    g = width * height
    # the float64 scratch grid the kernel sums into, and the float32 grid
    # its second pass writes whole (the kernel allocates nothing)
    acc = torch.zeros(g, dtype=torch.float64, device=x.device)
    out = torch.empty(g, dtype=torch.float32, device=x.device)
    xmin, ymin, dx, dy = _cell_size(env, width, height)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launcher()(x.data_ptr(), y.data_ptr(), weights.data_ptr(),
                          mask.data_ptr(), n, xmin, ymin, dx, dy, width,
                          height, acc.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"density_grid kernel launch failed: CUDA "
                           f"error {err}")
    density_grid_kernel.launches += 1
    return out.reshape(height, width)


#: kernel launches since the count was last reset (CPU calls never count)
density_grid_kernel.launches = 0
