"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` holds a plain C entry point.  It is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library at first use, keyed
by a hash of the source, the ``csrc/*.cuh`` headers and the flags, under
``build/geomesa_tpu_torch/`` at the root of the checkout, and bound with
``ctypes``.  Nothing is built at import time: the CPU-only test runs
import every module and build nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["KERNELS", "build", "build_all", "load", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "geomesa_tpu_torch"
#: every kernel source of the port (csrc/<name>.cu)
KERNELS = ("z3_mask", "z2_mask", "density_grid", "hist1d")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are built on the machine with the card")
    return found


def _start(name: str):
    """Start compiling ``csrc/<name>.cu`` unless a library of the same
    source and flags is already built: ``(lib, process, tmp)``, with
    ``process`` None when the library exists."""
    src = CSRC / f"{name}.cu"
    # the headers of csrc/ a source may include count towards its hash
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src.read_bytes() + headers
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{tag}.so"
    if lib.exists():
        return lib, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return lib, proc, tmp


def _finish(lib: Path, proc, tmp) -> Path:
    """Wait for a build started by :func:`_start`; raises with the
    compiler's output when it failed."""
    if proc is None:
        return lib
    try:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lib.name}:\n{err}")
        os.replace(tmp, lib)  # atomic: concurrent builds of one source agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags is already built; returns the library's path.  Raises with the
    compiler's output when the build fails."""
    return _finish(*_start(name))


def build_all() -> dict[str, Path]:
    """Build every kernel of :data:`KERNELS`: one ``nvcc`` per source, all
    started together."""
    started = {k: _start(k) for k in KERNELS}
    try:
        return {k: _finish(*s) for k, s in started.items()}
    finally:  # one failed: stop the compilers still running
        for _, proc, tmp in started.values():
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp is not None and os.path.exists(tmp):
                os.unlink(tmp)


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it on first use."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build(name)))
        return _loaded[name]
