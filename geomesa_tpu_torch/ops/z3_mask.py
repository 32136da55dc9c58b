"""The z3 candidate mask: a hand-written CUDA kernel and its plain version.

Replaces ``geomesa_tpu/ops/pallas_kernels.py: z3_mask_pallas`` with the
same contract::

    z3_mask(z: int64[N], ixy: int32[R, 4], tlo: int32[N], thi: int32[N]) -> bool[N]

On CUDA tensors :func:`z3_mask` launches ``csrc/z3_mask.cu`` (built with
``nvcc`` at first use, see :mod:`geomesa_tpu_torch.ops.build`) or raises;
on CPU tensors it runs :func:`z3_mask_reference`, the plain PyTorch
version of the same function.  Every call goes through the ``z3_scan``
gate (:mod:`~geomesa_tpu_torch.ops.gate`), which never gives way to the
plain version on a CUDA tensor.  ``z3_mask.launches`` counts kernel
launches.  What bounds the kernel on the card, and its design, are noted
in the CUDA source.
"""

from __future__ import annotations

import ctypes

import torch

from ..curve.zorder import deinterleave3
from .build import count_launch, load
from .gate import GATES

__all__ = ["z3_mask", "z3_mask_reference"]

#: most boxes one launch stages in shared memory (48 KiB of int4)
MAX_BOXES = 3072

_launch_fn = None


def _launcher():
    global _launch_fn
    if _launch_fn is None:
        fn = load("z3_mask").z3_mask_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_void_p]
        _launch_fn = fn
    return _launch_fn


def _check(z, ixy, tlo, thi) -> None:
    tensors = {"z": z, "ixy": ixy, "tlo": tlo, "thi": thi}
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"z3_mask: {name} must be a tensor")
        if t.device != z.device:
            raise ValueError(f"z3_mask: {name} is on {t.device}, z on "
                             f"{z.device}")
        if not t.is_contiguous():
            raise ValueError(f"z3_mask: {name} must be contiguous")
    want = {"z": torch.int64, "ixy": torch.int32, "tlo": torch.int32,
            "thi": torch.int32}
    for name, dt in want.items():
        if tensors[name].dtype != dt:
            raise TypeError(f"z3_mask: {name} must be {dt}, got "
                            f"{tensors[name].dtype}")
    if z.dim() != 1 or tlo.shape != z.shape or thi.shape != z.shape:
        raise ValueError("z3_mask: z, tlo and thi must be 1-D of one length")
    if ixy.dim() != 2 or ixy.shape[1] != 4:
        raise ValueError(f"z3_mask: ixy must be (R, 4), got "
                         f"{tuple(ixy.shape)}")
    if z.device.type == "cuda" and ixy.shape[0] > MAX_BOXES:
        # a caller's error, checked before the gate (which counts only
        # build and launch failures); the plain version has no such limit
        raise ValueError(f"z3_mask: {ixy.shape[0]} boxes, the kernel stages "
                         f"at most {MAX_BOXES}")


def z3_mask_reference(z, ixy, tlo, thi) -> torch.Tensor:
    """Plain PyTorch Z3Filter.inBounds: int64 de-interleave, then an
    (N, R) broadcast of the box tests, AND the per-candidate time
    bounds."""
    ix, iy, it = deinterleave3(z)
    ixy = ixy.to(torch.int64)
    in_box = ((ix[:, None] >= ixy[None, :, 0])
              & (iy[:, None] >= ixy[None, :, 1])
              & (ix[:, None] <= ixy[None, :, 2])
              & (iy[:, None] <= ixy[None, :, 3])).any(dim=1)
    return in_box & (it >= tlo) & (it <= thi)


def z3_mask(z, ixy, tlo, thi) -> torch.Tensor:
    """Z3Filter.inBounds over R int-space boxes.

    ``z``: (N,) candidate z values; ``ixy``: (R, 4) int32 normalized
    [xlo, ylo, xhi, yhi]; ``tlo``/``thi``: (N,) int32 per-candidate time
    offset bounds (already gathered per owning range).  Returns bool (N,).
    """
    _check(z, ixy, tlo, thi)
    return GATES["z3_scan"].dispatch(
        z.device, lambda: z3_mask_reference(z, ixy, tlo, thi),
        lambda: _launch(z, ixy, tlo, thi))


def _launch(z, ixy, tlo, thi) -> torch.Tensor:
    n = int(z.shape[0])
    out = torch.empty(n, dtype=torch.uint8, device=z.device)
    if n:
        with torch.cuda.device(z.device):
            stream = torch.cuda.current_stream(z.device).cuda_stream
            err = _launcher()(z.data_ptr(), ixy.data_ptr(),
                              int(ixy.shape[0]), tlo.data_ptr(),
                              thi.data_ptr(), out.data_ptr(), n, stream)
        if err != 0:
            raise RuntimeError(f"z3_mask kernel launch failed: CUDA "
                               f"error {err}")
        count_launch(z3_mask)
    return out.view(torch.bool)


#: kernel launches since the count was last reset (CPU calls never count)
z3_mask.launches = 0
