"""Kernel gates: one per hand-written kernel, the counterpart of the JAX
package's ``PallasGate`` and ``GATES`` (``geomesa_tpu/ops/
pallas_kernels.py``) and of its ``pallas_health``.

Every wrapper of a CUDA kernel routes its call through its gate
(:meth:`KernelGate.dispatch`), under the JAX package's kinds:
``z3_scan`` (``ops/z3_mask.py``), ``z2_scan`` (``ops/z2_mask.py``),
``density`` (``ops/density_kernel.py``) and ``hist1d``
(``ops/hist1d_kernel.py``).  A CPU tensor takes the plain version, and
only because it lies on the CPU; a CUDA tensor launches the kernel.

**Unlike the JAX gate, a gate never gives way to the plain version on a
CUDA tensor.**  A launch failure sets ``ok = False``, counts
``kernel.{kind}.failures``, logs, and re-raises; the next call launches
the kernel again.  ``ok`` is None until the kernel first launches, then
True after a launch, False after a failure.

The JAX gate's tuning record (``.pallas_tuning.json``) chooses between
the kernel and XLA; the port has no such choice to make, so it keeps no
tuning record (ROADMAP C).

Several processes: :meth:`KernelGate.agree_multihost` runs before a
collective whose shards launch the kernel.  The first time, each process
makes one tiny standalone probe launch and the processes agree on the
outcome; the agreed outcome is kept, so later calls enter no collective.
If any probe failed, every process raises together (then and on every
later call), so no peer is left stranded in the collective.  Leaving
the process group forgets the agreement.
"""

from __future__ import annotations

import logging
import threading

from .. import metrics as _metrics

__all__ = ["KernelGate", "GATES", "kernel_health", "KernelProbeFailed",
           "agree_kernel", "forget_agreements"]

_log = logging.getLogger("geomesa_tpu_torch.kernels")


class KernelProbeFailed(RuntimeError):
    """A kernel's probe launch failed on at least one process: raised on
    every process, before any of them enters the collective."""


class KernelGate:
    """Launch bookkeeping of one kernel (module doc)."""

    def __init__(self, kind: str):
        self.kind = kind
        #: None until the first launch; True after a launch succeeds,
        #: False after one fails (the next call launches again)
        self.ok: bool | None = None
        #: outcome of this process's multihost probe (None = not probed)
        self.probe_failed: bool | None = None
        #: the outcome agreed by every process (None = not agreed yet);
        #: the same on every process, so later calls skip alike
        self.agreed_ok: bool | None = None
        self._lock = threading.Lock()

    @property
    def failures_metric(self) -> str:
        return f"kernel.{self.kind}.failures"

    def dispatch(self, device, plain, launch):
        """Run ``plain()`` for a CPU tensor, ``launch()`` through the gate
        for a CUDA one; any other device raises."""
        if device.type == "cpu":
            return plain()
        if device.type != "cuda":
            raise ValueError(f"{self.kind}: unsupported device {device}")
        return self.launch(launch)

    def launch(self, launch):
        """Launch the kernel: a failure sets ``ok = False``, counts, logs
        and re-raises."""
        try:
            out = launch()
        except Exception as e:
            with self._lock:
                self.ok = False
            _metrics.registry.counter(self.failures_metric).inc()
            _log.warning("kernel %s failed (%s: %s); the error reaches the "
                         "caller and the next call launches again",
                         self.kind, type(e).__name__, e)
            raise
        if self.ok is not True:
            with self._lock:
                self.ok = True
        return out

    def agree_multihost(self, probe) -> None:
        """Before a collective that launches this kernel on every
        process: the first time, probe once per process and agree on the
        outcome; raise :class:`KernelProbeFailed` on every process if any
        probe failed.  The agreed outcome is kept, so later calls enter no
        collective.  The identity (no probe, no collective) with one
        process."""
        from ..parallel.multihost import agreed_int, process_count
        if process_count() == 1:
            return
        if self.agreed_ok is None:
            if self.probe_failed is None:
                try:
                    self.launch(probe)
                    self.probe_failed = False
                except Exception:
                    self.probe_failed = True
            self.agreed_ok = bool(agreed_int(int(not self.probe_failed),
                                             "min"))
        if not self.agreed_ok:
            raise KernelProbeFailed(
                f"the {self.kind} kernel's probe launch failed on at least "
                "one process; every process raises before the collective")


#: one gate per kernel, under the JAX package's kinds
GATES = {k: KernelGate(k) for k in ("z3_scan", "z2_scan", "density",
                                     "hist1d")}


def _probe(kind: str, device) -> None:
    """One tiny standalone launch of ``kind``'s kernel on ``device`` (no
    collective), through the wrapper's own argument checks, read back so
    that a fault surfaces here."""
    import torch
    from . import density_kernel, hist1d_kernel, z2_mask, z3_mask
    n = 8
    i64 = torch.zeros(n, dtype=torch.int64, device=device)
    i32 = torch.zeros(n, dtype=torch.int32, device=device)
    box = torch.zeros((1, 4), dtype=torch.int32, device=device)
    ones = torch.ones(n, dtype=torch.bool, device=device)
    if kind == "z3_scan":
        mod, args = z3_mask, (i64, box, i32, i32)
    elif kind == "z2_scan":
        mod, args = z2_mask, (i64, box)
    elif kind == "density":
        f64 = torch.zeros(n, dtype=torch.float64, device=device)
        mod, args = density_kernel, (f64, f64, f64 + 1.0, ones,
                                     (-1.0, -1.0, 1.0, 1.0), 4, 4)
    else:
        mod, args = hist1d_kernel, (i32, torch.ones(n, dtype=torch.float32,
                                                    device=device), ones, 8)
    mod._check(*args)
    mod._launch(*args).cpu()


def agree_kernel(kind: str, device) -> None:
    """Before a multihost collective whose shards launch ``kind``'s
    kernel on ``device``: :meth:`KernelGate.agree_multihost` with a
    standalone probe launch.  Nothing on the CPU, where no kernel
    launches (every process of a program sits on the same device type,
    so the call is entered alike everywhere)."""
    if device.type != "cuda":
        return
    GATES[kind].agree_multihost(lambda: _probe(kind, device))


def forget_agreements() -> None:
    """Drop every gate's probe outcome and agreed outcome: they held for
    the processes of a group that is gone (``shutdown_distributed``)."""
    for gate in GATES.values():
        gate.probe_failed = None
        gate.agreed_ok = None


def kernel_health() -> dict:
    """Each gate's state: ``{kind}_ok`` and ``{kind}_failures``."""
    snap = _metrics.registry.snapshot()
    out = {}
    for kind, gate in GATES.items():
        out[f"{kind}_ok"] = gate.ok
        out[f"{kind}_failures"] = snap.get(
            gate.failures_metric, {}).get("count", 0)
    return out
