"""The kernel-build watch: turn a compile on the query path into a metric.

The JAX package's watch counts XLA backend compiles, the silent
recompile that turns a 5 ms query into a 20 s one.  The port traces no
program: the only code it compiles is its hand-written CUDA kernels,
each built once by ``nvcc`` at first use (``ops/build.py``).  A build on
the query path is the port's version of that cliff, so the watch counts
each completed ``nvcc`` build into ``jax.compile.count``, feeds its wall
time to the ``jax.compile.ms`` timer and, when a trace is active, stamps
``jax.recompiles`` on the current span.  The metric keys are the JAX
package's, so one dashboard reads both packages.

Installation is idempotent and happens at ``geomesa_tpu_torch.obs``
import while ``geomesa.obs.recompile.track`` is on (the default).  The
JAX module's wrapped-jit fallback (``counting_jit``) has no counterpart:
the port has no jitted function to wrap (ROADMAP C).
"""

from __future__ import annotations

import threading

from ..metrics import JAX_COMPILE_COUNT, JAX_COMPILE_MS, registry as _metrics
from ..ops import build as _build

__all__ = ["install", "installed", "compile_count"]

_installed = False
_lock = threading.Lock()


def _on_build(library: str, seconds: float) -> None:
    _metrics.counter(JAX_COMPILE_COUNT).inc()
    _metrics.timer(JAX_COMPILE_MS).update(seconds * 1e3)
    from .trace import current_span
    sp = current_span()
    if sp is not None:
        sp.add_attr("jax.recompiles", 1)


def install() -> bool:
    """Listen to the kernel builds (idempotent).  Returns whether the
    watch is active, which it always is once installed."""
    global _installed
    with _lock:
        if not _installed:
            _build.add_build_listener(_on_build)
            _installed = True
        return True


def installed() -> bool:
    return _installed


def compile_count() -> int:
    """Kernel builds seen so far: diff two readings around a warm region
    to assert that nothing was built inside it."""
    return _metrics.counter(JAX_COMPILE_COUNT).count
