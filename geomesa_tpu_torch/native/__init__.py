"""Native (C++) host range decomposition, loaded with ctypes.

The port's copy of the JAX package's native sweep: the planner's range
decomposition hot loops (the role the reference outsources to the
external ``sfcurve`` JVM library, geomesa-z3/pom.xml:16-17) in
:mod:`geomesa_native.cpp`.  The shared library is compiled with the
system ``g++`` at first use — nothing is built at import — into
``build/geomesa_tpu_torch/`` at the root of the checkout (beside the
CUDA kernels, keyed by a hash of the source and the flags), and loaded
from there.

The native and numpy sweeps are semantically identical by construction
(same sweep, same emit order, same budget arithmetic): ``zranges`` and
the XZ curves' ``ranges`` take the native path when the library is
available and the numpy sweep otherwise, or when ``GEOMESA_TPU_NATIVE=0``
is set.  A failed build is never hidden: :func:`available` is False and
:func:`build_error` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from ..ops.build import BUILD_DIR

__all__ = ["available", "build_error", "build_seconds", "zranges_native",
           "xz_ranges_native"]

_SRC = Path(__file__).resolve().parent / "geomesa_native.cpp"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False
#: why the library is unavailable (None while it is, or not yet tried)
_ERROR: str | None = None
#: seconds the first load took, the compile included when it ran
_SECONDS: float | None = None


def _build() -> ctypes.CDLL:
    """Compile (unless a library of the same source and flags exists)
    and bind the library; raises with the compiler's output on failure."""
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libgeomesa_native-{tag}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(["g++", *_FLAGS, "-o", tmp, str(_SRC)],
                                  capture_output=True, text=True,
                                  timeout=120)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for {_SRC.name}:\n"
                                   f"{proc.stderr}")
            os.replace(tmp, lib_path)  # atomic under concurrent builders
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(lib_path))
    lib.gm_zranges.restype = ctypes.c_int64
    lib.gm_zranges.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
    ]
    lib.gm_xz_ranges.restype = ctypes.c_int64
    lib.gm_xz_ranges.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
    ]
    return lib


def _load() -> ctypes.CDLL | None:
    global _LIB, _TRIED, _ERROR, _SECONDS
    if _TRIED:
        return _LIB
    with _LOCK:
        if not _TRIED:
            if os.environ.get("GEOMESA_TPU_NATIVE", "1") == "0":
                _ERROR = "disabled by GEOMESA_TPU_NATIVE=0"
            else:
                t0 = time.perf_counter()
                try:
                    _LIB = _build()
                except (OSError, RuntimeError,
                        subprocess.SubprocessError) as e:
                    _ERROR = f"{type(e).__name__}: {e}"
                _SECONDS = time.perf_counter() - t0
            _TRIED = True
    return _LIB


def available() -> bool:
    """True when the native library compiled and loaded."""
    return _load() is not None


def build_error() -> str | None:
    """Why the library is not available (None when it is)."""
    _load()
    return _ERROR


def build_seconds() -> float | None:
    """Seconds the first load took, the compile included when it ran
    (None when the sweep is disabled)."""
    _load()
    return _SECONDS


def _i64ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f64ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _call_with_capacity(call, budget: int) -> np.ndarray | None:
    """Run a native range function with a modest initial buffer, growing
    once to the exact required capacity on a negative return.  The budget
    bounds the emit count, but huge 'unlimited' budgets must not
    preallocate proportionally."""
    cap = min(int(budget), 4096) + 16
    out = np.empty(2 * cap, dtype=np.int64)
    n = call(out, cap)
    if n < 0:
        cap = -n
        out = np.empty(2 * cap, dtype=np.int64)
        n = call(out, cap)
        if n < 0:
            return None
    return out[: 2 * n].reshape(-1, 2).copy()


def zranges_native(mins: np.ndarray, maxs: np.ndarray, dims: int, bits: int,
                   budget: int, depth_cap: int) -> np.ndarray | None:
    """Native Z2/Z3 range decomposition; None when the library is absent."""
    lib = _load()
    if lib is None:
        return None
    mins = np.ascontiguousarray(mins, dtype=np.int64)
    maxs = np.ascontiguousarray(maxs, dtype=np.int64)
    return _call_with_capacity(
        lambda out, cap: lib.gm_zranges(
            _i64ptr(mins), _i64ptr(maxs), mins.shape[0], dims, bits,
            budget, depth_cap, _i64ptr(out), cap),
        budget)


def xz_ranges_native(wmins: np.ndarray, wmaxs: np.ndarray, dims: int, g: int,
                     budget: int) -> np.ndarray | None:
    """Native XZ2/XZ3 range decomposition over normalized windows; None
    when the library is absent."""
    lib = _load()
    if lib is None:
        return None
    wmins = np.ascontiguousarray(wmins, dtype=np.float64)
    wmaxs = np.ascontiguousarray(wmaxs, dtype=np.float64)
    return _call_with_capacity(
        lambda out, cap: lib.gm_xz_ranges(
            _f64ptr(wmins), _f64ptr(wmaxs), wmins.shape[0], dims, g,
            budget, _i64ptr(out), cap),
        budget)
