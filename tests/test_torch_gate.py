"""The kernel gates (``geomesa_tpu_torch/ops/gate.py``), with fake
launchers: a launch failure re-raises, sets ``ok = False`` and counts
``kernel.{kind}.failures``; the next call launches again; no call on a
CUDA device reaches the plain version; each of the four wrappers goes
through its gate; and the multihost agreement raises on every process
when a probe failed anywhere, and is entered once.

The JAX package's ``PallasGate`` gives way to XLA after a failure; the
port's gate never does (ROADMAP C).  Launching checks of the real
kernels are in ``tests/test_torch_cuda.py`` (card only) and
``chip_smoke.py``.
"""

import pytest
import torch

from geomesa_tpu.ops import pallas_kernels as jpk
from geomesa_tpu_torch import metrics as tmetrics
from geomesa_tpu_torch.ops import density_kernel, gate, hist1d_kernel
from geomesa_tpu_torch.ops import z2_mask as z2m
from geomesa_tpu_torch.ops import z3_mask as z3m

CUDA = torch.device("cuda", 0)


@pytest.fixture
def fresh_gate():
    g = gate.KernelGate("unit")
    yield g


def _failures(g):
    return tmetrics.registry.counter(g.failures_metric).count


def test_gate_kinds_match_reference():
    assert set(gate.GATES) == set(jpk.GATES)


def test_cpu_takes_the_plain_version_only(fresh_gate):
    calls = []
    out = fresh_gate.dispatch(torch.device("cpu"), lambda: "plain",
                              lambda: calls.append(1))
    assert out == "plain" and not calls and fresh_gate.ok is None


def test_cuda_never_reaches_the_plain_version(fresh_gate):
    def plain():
        raise AssertionError("the plain version ran for a CUDA device")

    assert fresh_gate.dispatch(CUDA, plain, lambda: "kernel") == "kernel"
    assert fresh_gate.ok is True


def test_failure_reraises_counts_and_the_next_call_launches(fresh_gate):
    def plain():
        raise AssertionError("the plain version ran for a CUDA device")

    launches = []

    def failing():
        launches.append("fail")
        raise RuntimeError("z3_mask kernel launch failed: CUDA error 700")

    before = _failures(fresh_gate)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        fresh_gate.dispatch(CUDA, plain, failing)
    assert fresh_gate.ok is False
    assert _failures(fresh_gate) == before + 1

    def working():
        launches.append("ok")
        return "kernel"

    assert fresh_gate.dispatch(CUDA, plain, working) == "kernel"
    assert launches == ["fail", "ok"] and fresh_gate.ok is True


def test_other_devices_raise(fresh_gate):
    with pytest.raises(ValueError, match="unsupported device"):
        fresh_gate.dispatch(torch.device("meta"), lambda: 0, lambda: 1)


def test_health_has_no_tuning_entries():
    """The port keeps no tuning record: nothing routes a CUDA tensor
    elsewhere, so the health reports only ``ok`` and failures."""
    assert not hasattr(gate, "record_tuning")
    assert set(gate.kernel_health()) == {
        f"{k}_{f}" for k in gate.GATES for f in ("ok", "failures")}


@pytest.mark.parametrize("kind, call", [
    ("z3_scan", lambda: z3m.z3_mask(
        torch.zeros(4, dtype=torch.int64),
        torch.zeros((1, 4), dtype=torch.int32),
        torch.zeros(4, dtype=torch.int32),
        torch.zeros(4, dtype=torch.int32))),
    ("z2_scan", lambda: z2m.z2_mask(
        torch.zeros(4, dtype=torch.int64),
        torch.zeros((1, 4), dtype=torch.int32))),
    ("density", lambda: density_kernel.density_grid_kernel(
        torch.zeros(4, dtype=torch.float64),
        torch.zeros(4, dtype=torch.float64),
        torch.ones(4, dtype=torch.float64), torch.ones(4, dtype=torch.bool),
        (-1.0, -1.0, 1.0, 1.0), 4, 4)),
    ("hist1d", lambda: hist1d_kernel.hist1d(
        torch.zeros(4, dtype=torch.int32), torch.ones(4),
        torch.ones(4, dtype=torch.bool), 8)),
])
def test_each_wrapper_routes_through_its_gate(kind, call, monkeypatch):
    seen = []
    real = gate.KernelGate.dispatch

    def spy(self, device, plain, launch):
        seen.append((self.kind, device.type))
        return real(self, device, plain, launch)

    monkeypatch.setattr(gate.KernelGate, "dispatch", spy)
    out = call()
    assert seen == [(kind, "cpu")]
    assert isinstance(out, torch.Tensor)


def test_health_reports_every_gate():
    h = gate.kernel_health()
    for kind in gate.GATES:
        assert f"{kind}_ok" in h and f"{kind}_failures" in h


def test_multihost_agreement_raises_everywhere(monkeypatch):
    from geomesa_tpu_torch.parallel import multihost
    g = gate.KernelGate("unit")
    votes = []
    monkeypatch.setattr(multihost, "process_count", lambda: 2)

    def agreed(value, op="sum"):
        # this process voted ``value``; its peer's probe failed
        votes.append(value)
        return min(value, 0)

    monkeypatch.setattr(multihost, "agreed_int", agreed)
    with pytest.raises(gate.KernelProbeFailed):
        g.agree_multihost(lambda: None)
    assert votes == [1] and g.probe_failed is False
    # the agreed failure is kept: raised again with no second collective
    with pytest.raises(gate.KernelProbeFailed):
        g.agree_multihost(lambda: None)
    assert votes == [1] and g.agreed_ok is False
    # this process's own probe failing votes 0 (once: the outcome sticks)
    g2 = gate.KernelGate("unit")
    probes = []

    def bad_probe():
        probes.append(1)
        raise RuntimeError("launch failed")

    with pytest.raises(gate.KernelProbeFailed):
        g2.agree_multihost(bad_probe)
    with pytest.raises(gate.KernelProbeFailed):
        g2.agree_multihost(bad_probe)
    assert probes == [1] and votes[1:] == [0]


def test_multihost_agreement_is_entered_once(monkeypatch):
    """After the first agreement every process holds the same outcome,
    so later calls probe nothing and enter no collective."""
    from geomesa_tpu_torch.parallel import multihost
    g = gate.KernelGate("unit")
    votes, probes = [], []
    monkeypatch.setattr(multihost, "process_count", lambda: 2)

    def agreed(value, op="sum"):
        votes.append((value, op))
        return value

    monkeypatch.setattr(multihost, "agreed_int", agreed)
    for _ in range(3):
        g.agree_multihost(lambda: probes.append(1))
    assert probes == [1] and votes == [(1, "min")] and g.agreed_ok is True


def test_leaving_the_group_forgets_the_agreement(monkeypatch):
    """An agreement holds for one process group: after
    ``shutdown_distributed`` the next multihost call probes and agrees
    again with the new group's processes."""
    from geomesa_tpu_torch.parallel import multihost
    g = gate.GATES["hist1d"]
    monkeypatch.setattr(g, "agreed_ok", True)
    monkeypatch.setattr(g, "probe_failed", False)
    monkeypatch.setattr(multihost.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(multihost, "_DEVICE_GROUP", None)
    monkeypatch.setattr(multihost, "_DEVICE_BACKEND", None)
    multihost.shutdown_distributed()
    assert g.agreed_ok is None and g.probe_failed is None


@pytest.mark.parametrize("kind", sorted(gate.GATES))
def test_probe_arguments_pass_the_wrappers_checks(kind, monkeypatch):
    """The multihost probe's tiny launch: its arguments pass the
    wrapper's checks, and it launches (a CPU stand-in here) once."""
    mods = {"z3_scan": (z3m, z3m.z3_mask_reference),
            "z2_scan": (z2m, z2m.z2_mask_reference),
            "density": (density_kernel,
                        density_kernel.density_grid_kernel_reference),
            "hist1d": (hist1d_kernel, hist1d_kernel.hist1d_reference)}
    mod, ref = mods[kind]
    calls = []

    def fake(*args):
        calls.append(1)
        return ref(*args)

    monkeypatch.setattr(mod, "_launch", fake)
    gate._probe(kind, torch.device("cpu"))
    assert calls == [1]


def test_one_process_agreement_is_free():
    calls = []
    gate.KernelGate("unit").agree_multihost(lambda: calls.append(1))
    gate.agree_kernel("hist1d", torch.device("cpu"))
    assert calls == []
