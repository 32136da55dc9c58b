"""The z2 candidate mask: a hand-written CUDA kernel and its plain version.

Replaces ``geomesa_tpu/ops/pallas_kernels.py: z2_mask_pallas`` with the
same contract::

    z2_mask(z: int64[N], ixy: int32[R, 4]) -> bool[N]

On CUDA tensors :func:`z2_mask` launches ``csrc/z2_mask.cu`` (built with
``nvcc`` at first use, see :mod:`geomesa_tpu_torch.ops.build`) or raises;
on CPU tensors it runs :func:`z2_mask_reference`, the plain PyTorch
version of the same function.  ``z2_mask.launches`` counts kernel
launches.  What bounds the kernel on the card, and its design, are noted
in the CUDA source.
"""

from __future__ import annotations

import ctypes

import torch

from ..curve.zorder import deinterleave2
from .build import load

__all__ = ["z2_mask", "z2_mask_reference"]

#: most boxes one launch stages in shared memory (48 KiB of int4)
MAX_BOXES = 3072

_launch_fn = None


def _launcher():
    global _launch_fn
    if _launch_fn is None:
        fn = load("z2_mask").z2_mask_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        _launch_fn = fn
    return _launch_fn


def _check(z, ixy) -> None:
    for name, t in (("z", z), ("ixy", ixy)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"z2_mask: {name} must be a tensor")
        if not t.is_contiguous():
            raise ValueError(f"z2_mask: {name} must be contiguous")
    if ixy.device != z.device:
        raise ValueError(f"z2_mask: ixy is on {ixy.device}, z on {z.device}")
    if z.dtype != torch.int64:
        raise TypeError(f"z2_mask: z must be torch.int64, got {z.dtype}")
    if ixy.dtype != torch.int32:
        raise TypeError(f"z2_mask: ixy must be torch.int32, got {ixy.dtype}")
    if z.dim() != 1:
        raise ValueError("z2_mask: z must be 1-D")
    if ixy.dim() != 2 or ixy.shape[1] != 4:
        raise ValueError(f"z2_mask: ixy must be (R, 4), got "
                         f"{tuple(ixy.shape)}")


def z2_mask_reference(z, ixy) -> torch.Tensor:
    """Plain PyTorch Z2Filter.inBounds: int64 de-interleave, then the
    (N, R) broadcast of the box tests (``index/z2.py``'s unfused
    path)."""
    ix, iy = deinterleave2(z)
    ixy = ixy.to(torch.int64)
    return ((ix[:, None] >= ixy[None, :, 0])
            & (iy[:, None] >= ixy[None, :, 1])
            & (ix[:, None] <= ixy[None, :, 2])
            & (iy[:, None] <= ixy[None, :, 3])).any(dim=1)


def z2_mask(z, ixy) -> torch.Tensor:
    """Z2Filter.inBounds over R int-space boxes.

    ``z``: (N,) candidate z values; ``ixy``: (R, 4) int32 normalized
    [xlo, ylo, xhi, yhi].  Returns bool (N,).
    """
    _check(z, ixy)
    if z.device.type == "cpu":
        return z2_mask_reference(z, ixy)
    if z.device.type != "cuda":
        raise ValueError(f"z2_mask: unsupported device {z.device}")
    if ixy.shape[0] > MAX_BOXES:
        raise ValueError(f"z2_mask: {ixy.shape[0]} boxes, the kernel stages "
                         f"at most {MAX_BOXES}")
    n = int(z.shape[0])
    out = torch.empty(n, dtype=torch.uint8, device=z.device)
    if n:
        with torch.cuda.device(z.device):
            stream = torch.cuda.current_stream(z.device).cuda_stream
            err = _launcher()(z.data_ptr(), ixy.data_ptr(),
                              int(ixy.shape[0]), out.data_ptr(), n, stream)
        if err != 0:
            raise RuntimeError(f"z2_mask kernel launch failed: CUDA "
                               f"error {err}")
        z2_mask.launches += 1
    return out.view(torch.bool)


#: kernel launches since the count was last reset (CPU calls never count)
z2_mask.launches = 0
