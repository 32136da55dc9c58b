"""Port parity: gm-lint, ``geomesa_tpu_torch/analysis/`` against the JAX
package's ``geomesa_tpu/analysis/``.

Held: both analyzers give the same ``(line, check_id)`` lists, and
messages that differ only in the package name, on the shared fixtures
of ``tests/data/lint_fixtures`` (guarded-by, config-option, taxonomy)
and on a fault-point fixture; the torch translations of the host-sync
and recompile-hazard fixtures (written here, line for line, into
``tmp_path`` — never under ``geomesa_tpu_torch/``) flag the JAX test's
lines for every case with a counterpart; the pragma and baseline round
trips; the device-dispatch and ``lru_cache`` registries; the clean-tree
gate over ``geomesa_tpu_torch/`` (one in-process pass, no wall-clock
bound: its seconds are printed); the CLI, with at most two subprocess
passes over the whole tree; and an analyzer that loads neither torch,
numpy, jax nor anything of ``geomesa_tpu``.
"""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from geomesa_tpu.analysis import analyze as jax_analyze
from geomesa_tpu.analysis.checks import CHECKS as JAX_CHECKS
from geomesa_tpu.analysis.checks import check_by_id as jax_check
from geomesa_tpu_torch.analysis import (
    Baseline, BaselineError, Finding, all_checks, analyze,
)
from geomesa_tpu_torch.analysis.baseline import DEFAULT_BASELINE_PATH
from geomesa_tpu_torch.analysis.checks import check_by_id
from geomesa_tpu_torch.analysis.walker import (
    DISPATCH_MODULES, PACKAGE_ROOT, Project,
)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).parent / "data" / "lint_fixtures"
#: a subprocess pass over the whole tree takes ~8 s on an idle CPU;
#: the bound only keeps a hung child from holding the worker
CLI_TIMEOUT = 300


def _port(root, check_id, files):
    return analyze(root, checks=[check_by_id(check_id)], files=files)


def _jax(root, check_id, files):
    return jax_analyze(root, checks=[jax_check(check_id)], files=files)


def _same(port, jax):
    """Equal (line, check) lists, messages equal but for the package."""
    assert [(f.line, f.check_id) for f in port] == \
        [(f.line, f.check_id) for f in jax]
    assert [f.message.replace("geomesa_tpu_torch", "geomesa_tpu")
            for f in port] == [f.message for f in jax]


# -- parity on the shared fixtures ----------------------------------------
@pytest.mark.parametrize("name,check_id", [
    ("fixture_guarded.py", "guarded-by"),
    ("fixture_options.py", "config-option"),
    ("fixture_taxonomy.py", "taxonomy"),
])
def test_shared_fixture_parity(name, check_id):
    port = _port(FIXTURES, check_id, [FIXTURES / name])
    jax = _jax(FIXTURES, check_id, [FIXTURES / name])
    assert port, "the fixture's known-bad lines were not flagged"
    _same(port, jax)


FAULT_FIXTURE = '''\
from geomesa_tpu_torch.resilience import fault_point, maybe_fail


def arm():
    fault_point("device.dispach")
    fault_point("device.dispatch")
    maybe_fail("query.scan.devcie")
    maybe_fail("host.spill")
'''

FAULTS_DECLARATION = '''\
FAULT_POINTS = ("device.dispatch", "host.spill", "write.device")
'''


def test_fault_point_fixture_parity(tmp_path):
    (tmp_path / "arm.py").write_text(FAULT_FIXTURE)
    (tmp_path / "resilience").mkdir()
    (tmp_path / "resilience" / "faults.py").write_text(FAULTS_DECLARATION)
    files = [tmp_path / "arm.py", tmp_path / "resilience" / "faults.py"]
    port = _port(tmp_path, "fault-points", files)
    _same(port, _jax(tmp_path, "fault-points", files))
    # the two typos, the undocumented declared point, and each cataloged
    # point the declaration lacks
    assert [(f.file, f.line) for f in port][:2] == [("arm.py", 5),
                                                    ("arm.py", 7)]
    msgs = "\n".join(f.message for f in port)
    assert '"write.device" is declared but missing' in msgs
    assert '"pyramid.build" is cataloged' in msgs


def test_check_catalogs_match():
    assert [c.id for c in all_checks()] == [c.id for c in JAX_CHECKS]


# -- the torch translations of the host-sync and recompile fixtures -------
#: tests/data/lint_fixtures/fixture_host_sync.py, line for line: every
#: case with a counterpart sits on its JAX line, the torch-only cases
#: follow line 48
HOST_SYNC_FIXTURE = '''\
"""gm-lint fixture: the torch translation of the JAX host-sync fixture,
line for line.  PARSED by the analyzer tests, never imported — line
numbers are asserted exactly."""
import torch
import numpy as np
from geomesa_tpu_torch.ops.z3_mask import z3_mask

from geomesa_tpu_torch.obs import device_span


# a device dispatch: a def that returns a kernel wrapper's result
def _probe(z):
    return z3_mask(z, z, z, z)


def builder(n):
    def app(x):
        return x * n
    return app


def bad_item(values):
    return values.sum().item()                     # line 23: .item()


def bad_block(z):
    torch.cuda.synchronize()                       # line 27: synchronize


def bad_asarray(z):
    return np.asarray(_probe(z))                   # line 31: np.asarray


def no_builder_counterpart(z):
    return builder(3)(z).cpu()                     # line 35: not judged


def bad_cast(z):
    return int(torch.sum(z))                       # line 39: int()


def good_sanctioned(z):
    with device_span("query.scan.device", stage="probe"):
        return np.asarray(_probe(z))


def good_pragma(z):
    return np.asarray(_probe(z))  # gm-lint: disable=host-sync fixture-sanctioned sync


def bad_cpu(z):
    return _probe(z).cpu()                         # line 52: .cpu()


def bad_chain(z):
    return torch.nonzero(z).cpu().numpy()          # line 56: one finding


def bad_tolist(z):
    return _probe(z)[:4].tolist()                  # line 60: via a slice


def bad_to_cpu(z):
    return (_probe(z) & z).to("cpu")               # line 64: arithmetic


def bad_stream(stream, event):
    stream.synchronize()                           # line 68: a stream
    event.synchronize()                            # line 69: an event


def bad_bool(z):
    return bool(_probe(z).any())                   # line 73: bool()


def good_attribute_read(self, n):
    return self.bins[:n].cpu().numpy()


def good_parameter(values):
    return np.asarray(values.cpu().tolist())


def good_sanctioned_copy(z):
    with device_span("query.scan.device", stage="gather"):
        return torch.cat([_probe(z)]).cpu().numpy()
'''

#: tests/data/lint_fixtures/fixture_recompile.py, line for line; the
#: build/load cases follow line 35
RECOMPILE_FIXTURE = '''\
"""gm-lint fixture: the torch translation of the JAX recompile-hazard
fixture, line for line (parsed, never imported)."""
import functools
import time

from geomesa_tpu_torch.ops.build import load
from geomesa_tpu_torch.ops import build as kbuild
_MUTABLE_TABLE = {"cap": 8}


def _tweak():
    _MUTABLE_TABLE.update(cap=16)


@functools.lru_cache(maxsize=None)
def fold(x, cap=8):
    return x[: _MUTABLE_TABLE["cap"]] + cap        # line 17: capture


@functools.lru_cache(maxsize=None)
def pad(x, shape=[8, 8]):                          # line 21: default
    return x


@functools.lru_cache(maxsize=None)
def scale(x, k):
    return x * k


def callers(x):
    fold(x, cap=[1, 2])                            # line 31: unhashable
    fold(x, cap=time.time())                       # line 32: varying
    scale(x, [1, 2])                               # line 33: positional
    scale(x, time.time())                          # line 34: positional
    return scale(x, k=2)                           # fine: constant


KERNEL = "z3_mask"


def builds(name):
    load(name)                                     # line 42: per-call name
    load("z2_mask")                                # fine: a literal
    kbuild.build(name)                             # line 44: via the module
    return load(KERNEL)                            # fine: a module constant


def varying_key(obj):
    return scale(obj, id(obj))                     # line 49: id()
'''


def test_host_sync_torch_fixture(tmp_path):
    path = tmp_path / "host_sync.py"
    path.write_text(HOST_SYNC_FIXTURE)
    got = analyze(tmp_path, checks=[check_by_id("host-sync")], files=[path])
    jax_lines = [f.line for f in _jax(FIXTURES, "host-sync",
                                      [FIXTURES / "fixture_host_sync.py"])]
    assert jax_lines == [23, 27, 31, 35, 39]
    # line 35, the jit-builder idiom (a def returning a jitted program,
    # called as builder(3)(z)), has no torch counterpart: the port
    # builds no programs, so its line holds a case the check does not
    # judge.  Every other JAX line is flagged on the same line here.
    counterparts = [ln for ln in jax_lines if ln != 35]
    torch_only = [52, 56, 60, 64, 68, 69, 73]
    assert [f.line for f in got] == counterparts + torch_only, \
        [f.render() for f in got]
    by_line = {f.line: f.message for f in got}
    assert "(in `bad_item`)" in by_line[23]
    assert by_line[27].startswith("`torch.cuda.synchronize` outside")
    assert "(in `bad_block`)" in by_line[27]
    assert by_line[31].startswith("`np.asarray(...)` materializes")
    assert by_line[39].startswith("`int()` on a device value")
    assert by_line[52].startswith("`.cpu()` materializes")
    assert by_line[56].startswith("`.cpu()` materializes")
    assert by_line[60].startswith("`.tolist()` materializes")
    assert by_line[64].startswith('`.to("cpu")` materializes')
    assert by_line[68].startswith("`.synchronize()` outside")
    assert by_line[73].startswith("`bool()` on a device value")


def test_recompile_torch_fixture(tmp_path):
    path = tmp_path / "recompile.py"
    path.write_text(RECOMPILE_FIXTURE)
    got = analyze(tmp_path, checks=[check_by_id("recompile-hazard")],
                  files=[path])
    jax_got = _jax(FIXTURES, "recompile-hazard",
                   [FIXTURES / "fixture_recompile.py"])
    jax_lines = [f.line for f in jax_got]
    assert jax_lines == [17, 21, 31, 32, 33, 34]
    # every JAX case has its lru_cache counterpart on the same line; the
    # kernel-name and id() cases are the port's own
    assert [f.line for f in got] == jax_lines + [42, 44, 49], \
        [f.render() for f in got]
    assert "closes over module global `_MUTABLE_TABLE`" in got[0].message
    assert "unhashable default" in got[1].message
    assert "varies per call" in got[3].message
    assert "argument `k`" in got[4].message
    assert "varies per call" in got[5].message
    assert all("kernel `load`" in f.message or "kernel `build`" in f.message
               for f in got[6:8])
    assert "argument `k` of cached `scale` varies" in got[8].message


def test_recompile_positional_mapping_stops_at_star(tmp_path):
    """Positions past a *splat are statically unknowable — they must
    not be mapped onto parameter names."""
    (tmp_path / "s.py").write_text(
        "import functools\n"
        "\n"
        "\n"
        "\n"
        "\n"
        "@functools.lru_cache(maxsize=None)\n"
        "def scale(x, k):\n"
        "    return x * k\n"
        "\n"
        "\n"
        "def caller(xs, x):\n"
        "    scale(*xs, [1, 2])\n"
        "    return scale(x, [1, 2])\n")
    got = analyze(tmp_path, checks=[check_by_id("recompile-hazard")],
                  files=[tmp_path / "s.py"])
    assert [f.line for f in got] == [13], [f.render() for f in got]


# -- the registries --------------------------------------------------------
def test_dispatch_registry_of_the_kernel_wrappers():
    project = Project(PACKAGE_ROOT,
                      files=[PACKAGE_ROOT / rel for rel in DISPATCH_MODULES])
    reg = {m.rel: m.dispatch_fns for m in project.modules}
    assert {"z3_mask", "z3_mask_reference"} <= reg["ops/z3_mask.py"]
    assert {"z2_mask", "z2_mask_reference"} <= reg["ops/z2_mask.py"]
    assert {"density_grid_kernel", "density_grid_kernel_reference",
            "grid_snap"} <= reg["ops/density_kernel.py"]
    # a wrapper that returns another wrapper's result, across the edge
    assert "density_grid_auto" in reg["ops/density.py"]
    assert {"hist1d", "hist1d_reference"} <= reg["ops/hist1d_kernel.py"]
    assert {"searchsorted2", "expand_ranges", "pack_wire",
            "pack_coded"} <= reg["ops/search.py"]
    # host helpers are no dispatch: launch shapes, capacities, codes
    assert not reg["ops/launch.py"]
    assert not {"gather_capacity", "coded_pos_bits", "split_coded",
                "pad_pow2", "run_packed_query"} & reg["ops/search.py"]
    assert "launch_shape" not in reg["ops/density_kernel.py"]


def test_dispatches_resolve_through_imports_and_package_init(tmp_path):
    """A def returning a kernel wrapper's result is a dispatch, seen
    through an import from the port's own tree (the walked set does not
    hold ops/) and through a package ``__init__``'s relative import."""
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "kern.py").write_text(
        "from geomesa_tpu_torch.ops.search import expand_ranges\n\n\n"
        "def fast(s, c):\n    idx, valid, rid = expand_ranges(s, c, 8)\n"
        "    return idx\n")
    (pkg / "__init__.py").write_text(
        "import numpy as np\n"
        "from .kern import fast\n\n\n"
        "def use(s, c):\n"
        "    return np.asarray(fast(s, c))\n")
    findings = analyze(tmp_path, checks=[check_by_id("host-sync")])
    assert [(f.file, f.line) for f in findings] == [("pkg/__init__.py", 6)]


def test_lru_cache_registry_covers_the_port_sites():
    rels = ["ops/density_kernel.py", "ops/hist1d_kernel.py", "curve/sfc.py",
            "index/z2.py", "security/visibility.py"]
    project = Project(PACKAGE_ROOT, files=[PACKAGE_ROOT / r for r in rels])
    cached = {m.rel: set(m.cached_fns) for m in project.modules}
    assert cached == {
        "ops/density_kernel.py": {"_resident", "_card_shape"},
        "ops/hist1d_kernel.py": {"_resident", "_card_shape"},
        "curve/sfc.py": {"z2_sfc", "z3_sfc"},
        "index/z2.py": {"_world_cell_boundaries"},
        "security/visibility.py": {"parse_visibility"},
    }
    findings = [f for m in project.modules
                for f in check_by_id("recompile-hazard").run(m, project)
                if f is not None]
    assert findings == [], [f.render() for f in findings]


# -- pragmas and baselines -------------------------------------------------
def test_pragma_same_line_standalone_and_file(tmp_path):
    bad = 'OPTION = "geomesa.not.a.real.option"\n'
    (tmp_path / "plain.py").write_text(bad)
    (tmp_path / "sameline.py").write_text(
        'OPTION = "geomesa.not.a.real.option"'
        "  # gm-lint: disable=config-option fixture reason\n")
    (tmp_path / "above.py").write_text(
        "# gm-lint: disable=config-option fixture reason\n" + bad)
    (tmp_path / "whole.py").write_text(
        "# gm-lint: disable-file=config-option fixture reason\n"
        + bad + bad)
    (tmp_path / "wrong.py").write_text(
        'OPTION = "geomesa.not.a.real.option"'
        "  # gm-lint: disable=host-sync wrong check\n")
    (tmp_path / "doc.py").write_text(
        '"""Suppress with `# gm-lint: disable-file=config-option`.\n'
        '"""\n' + bad)
    got = {name: [f.line for f in _port(tmp_path, "config-option",
                                         [tmp_path / name])]
           for name in ("plain.py", "sameline.py", "above.py", "whole.py",
                        "wrong.py", "doc.py")}
    assert got == {"plain.py": [1], "sameline.py": [], "above.py": [],
                   "whole.py": [], "wrong.py": [1], "doc.py": [3]}
    for name, lines in got.items():
        assert lines == [f.line for f in _jax(
            tmp_path, "config-option", [tmp_path / name])], name


def test_baseline_round_trip(tmp_path):
    findings = _port(FIXTURES, "config-option",
                     [FIXTURES / "fixture_options.py"])
    assert findings
    ledger = Baseline.from_findings(findings, "fixture debt, tracked")
    path = tmp_path / "baseline.json"
    ledger.save(path)
    loaded = Baseline.load(path)
    new, baselined, stale = loaded.split(findings)
    assert new == [] and len(baselined) == len(findings) and stale == []
    # baselines match on (check, file, message) — line drift is fine
    drifted = [Finding(f.file, f.line + 40, f.check_id, f.message)
               for f in findings]
    assert loaded.split(drifted)[0] == []


def test_baseline_rejects_missing_justification(tmp_path):
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"version": 1, "entries": [
        {"check": "host-sync", "file": "x.py", "message": "m",
         "justification": "  "}]}))
    with pytest.raises(BaselineError, match="justification"):
        Baseline.load(path)


def test_baseline_does_not_absorb_new_identical_violation(tmp_path):
    (tmp_path / "m.py").write_text(
        "import torch\n\n\ndef a(x):\n    torch.cuda.synchronize()\n\n\n"
        "def b(x):\n    torch.cuda.synchronize()\n")
    found = _port(tmp_path, "host-sync", [tmp_path / "m.py"])
    assert len(found) == 2 and found[0].message != found[1].message
    ledger = Baseline.from_findings([found[0]], "tracked fixture debt")
    new, baselined, _ = ledger.split(found)
    assert new == [found[1]] and baselined == [found[0]]


# -- the clean-tree gate ---------------------------------------------------
@pytest.fixture(scope="module")
def port_tree():
    """One in-process pass over geomesa_tpu_torch/ for the whole file."""
    t0 = time.perf_counter()
    findings = analyze(PACKAGE_ROOT)
    return findings, time.perf_counter() - t0


BLOCK_SITES = {"index/attr_lean.py", "index/z3_lean.py",
               "parallel/attr_lean.py", "parallel/lean.py"}


def test_port_tree_is_clean(port_tree):
    findings, seconds = port_tree
    new, baselined, stale = Baseline.load().split(findings)
    print(f"\ngm-lint (port): {len(findings)} finding(s) "
          f"({len(baselined)} baselined) over geomesa_tpu_torch/ in "
          f"{seconds:.2f}s")
    assert new == [], "\n".join(f.render() for f in new)
    assert stale == []
    blocks = {f.file for f in baselined if f.message.endswith("(in `block`)")
              and f.message.startswith("`torch.cuda.synchronize`")}
    assert blocks == BLOCK_SITES


def test_port_baseline_entries_are_justified():
    ledger = Baseline.load()          # raises on unjustified entries
    assert DEFAULT_BASELINE_PATH.parent == PACKAGE_ROOT / "analysis"
    assert json.loads(DEFAULT_BASELINE_PATH.read_text())["version"] == 1
    for (check, file, msg), just in ledger.entries.items():
        assert len(just) > 20, (check, file)
        # every entry names its JAX counterpart site
        assert "geomesa_tpu/" in just, (check, file, msg)
    assert {f for (_, f, m) in ledger.entries
            if m.endswith("(in `block`)")} == BLOCK_SITES


def test_the_restored_holds_pragmas_are_comments():
    """The two guarded-by repairs are pragmas on the methods the JAX
    tree marks; the port's tree then reports no guarded-by finding."""
    for rel, method in (("index/partial_cache.py", "_cached_bytes"),
                        ("obs/heat.py", "_evict_coldest")):
        lines = (PACKAGE_ROOT / rel).read_text().splitlines()
        at = next(i for i, ln in enumerate(lines)
                  if ln.strip().startswith(f"def {method}("))
        assert lines[at - 1].strip().startswith(
            "# gm-lint: holds: self._lock"), rel



@pytest.mark.parametrize("tier", ["keys", "full"])
def test_lean_density_copies_inside_its_device_span(tier):
    """The lean density's keys- and full-tier grids dispatch and copy
    back inside the ``query.scan.device`` span (tier=keys, tier=full)
    the JAX index opens there, so both packages record the same device
    spans, and the grids stay equal.  The keys tier's copy was a
    host-sync finding; the full tier's, a copy of a local name, is one
    the rule misses by design and reading the JAX site found."""
    import numpy as np

    from geomesa_tpu import obs as jax_obs
    from geomesa_tpu.index import z3_lean as jax_lean
    from geomesa_tpu_torch import obs as port_obs
    from geomesa_tpu_torch.index import z3_lean as port_lean

    ms, day = 1514764800000, 86_400_000
    rng = np.random.default_rng(23)
    x, y = rng.uniform(-75, -73, 8192), rng.uniform(40, 42, 8192)
    t = rng.integers(ms, ms + 14 * day, 8192)
    box, env = [(-74.5, 40.5, -73.5, 41.5)], (-75.0, 40.0, -73.0, 42.0)

    def run(obs, idx):
        idx.append(x, y, t)
        with obs.tracer.capture() as cap:
            with obs.span("query"):
                grid = idx.density(box, ms + day, ms + 9 * day, env, 32, 32)
        return grid, sorted((s.attributes.get("tier") or "",
                             s.attributes.get("stage") or "")
                            for tr in cap.traces() for s in tr.spans
                            if s.name == "query.scan.device")

    payload = tier == "full"
    jg, js = run(jax_obs, jax_lean.LeanZ3Index(
        period="week", generation_slots=4096, payload_on_device=payload))
    pg, ps = run(port_obs, port_lean.LeanZ3Index(
        period="week", generation_slots=4096, payload_on_device=payload,
        device="cpu"))
    assert (tier, "") in ps
    assert ps == js
    np.testing.assert_array_equal(pg, jg)


# -- the CLI: at most two subprocess passes over the whole tree -----------
def _cli(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "geomesa_tpu_torch.analysis", *args],
        capture_output=True, text=True, cwd=ROOT, env=env,
        timeout=CLI_TIMEOUT)


def test_cli_fail_on_new_over_the_tree_under_ascii_locale():
    """Full pass 1 of 2: the gate as the chip script runs it, under
    LC_ALL=C (every analyzer read pins utf-8)."""
    env = dict(os.environ, LC_ALL="C", LANG="C", PYTHONCOERCECLOCALE="0",
               PYTHONUTF8="0")
    proc = _cli("--fail-on-new", env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "# 0 finding(s), 6 check(s)" in proc.stdout
    assert "stale" not in proc.stdout


def test_write_baseline_keeps_justifications(tmp_path):
    """Full pass 2 of 2: a full-run rewrite keeps every written
    justification (a subset write is refused: below)."""
    path = tmp_path / "b.json"
    shutil.copy(DEFAULT_BASELINE_PATH, path)
    proc = _cli("--write-baseline", "generic new-entry reason",
                "--baseline", str(path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(path.read_text()) == \
        json.loads(DEFAULT_BASELINE_PATH.read_text())


def test_cli_findings_exit_one_and_json_format():
    proc = _cli("--check", "config-option", "--format", "json",
                str(FIXTURES / "fixture_options.py"))
    assert proc.returncode == 1
    out = json.loads(proc.stdout)
    assert out["checks"] == ["config-option"]
    assert [f["line"] for f in out["findings"]] == [4, 8]
    assert all(f["check"] == "config-option" for f in out["findings"])
    assert out["elapsed_s"] >= 0


def test_cli_list_checks_and_unknown_check():
    proc = _cli("--list-checks", "--format", "json")
    assert proc.returncode == 0
    assert [c["id"] for c in json.loads(proc.stdout)] == \
        [c.id for c in JAX_CHECKS]
    assert _cli("--check", "nope").returncode == 2


def test_cli_own_tree_is_a_usage_error():
    proc = _cli(str(PACKAGE_ROOT / "analysis" / "walker.py"))
    assert proc.returncode == 2
    assert "excluded" in proc.stderr


def test_cli_refuses_a_subset_baseline_write(tmp_path):
    path = tmp_path / "b.json"
    proc = _cli("--write-baseline", "r", "--baseline", str(path),
                str(FIXTURES / "fixture_options.py"))
    assert proc.returncode == 2 and not path.exists()


def test_cli_rejects_an_unjustified_baseline(tmp_path):
    path = tmp_path / "b.json"
    path.write_text(json.dumps({"version": 1, "entries": [
        {"check": "host-sync", "file": "x.py", "message": "m"}]}))
    proc = _cli("--fail-on-new", "--baseline", str(path),
                str(FIXTURES / "fixture_options.py"))
    assert proc.returncode == 2
    assert "justification" in proc.stderr


def test_cli_single_file_and_subpackage_reroot(tmp_path):
    """A bare file, or a subpackage directory, reports paths relative to
    its package root (the baseline key space), and a subset run calls no
    entry stale."""
    pkg = tmp_path / "pkg"
    (pkg / "index").mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "index" / "__init__.py").write_text("")
    (pkg / "index" / "lean.py").write_text(
        "import torch\n\n\ndef block(self):\n"
        "    torch.cuda.synchronize()\n")
    target = pkg / "index" / "lean.py"
    proc = _cli("--check", "host-sync", "--format", "json", str(target))
    assert proc.returncode == 1
    assert [f["file"] for f in json.loads(proc.stdout)["findings"]] == \
        ["index/lean.py"]
    ledger = tmp_path / "b.json"
    Baseline.from_findings(
        _port(pkg, "host-sync", [target]) + [
            Finding("other.py", 1, "host-sync", "gone")],
        "fixture barrier, measured").save(ledger)
    for arg in (str(target), str(pkg / "index")):
        proc = _cli("--fail-on-new", "--baseline", str(ledger), arg)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "stale" not in proc.stdout


def test_analyzer_loads_no_torch_numpy_jax_or_reference():
    code = (
        "import sys\n"
        "import geomesa_tpu_torch.analysis as a\n"
        "from geomesa_tpu_torch.analysis.checks import CHECKS\n"
        "from geomesa_tpu_torch.analysis.__main__ import main\n"
        "assert len(CHECKS) == 6\n"
        f"a.analyze({str(FIXTURES)!r})\n"
        "assert main(['--list-checks']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'numpy', 'jax', 'geomesa_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=CLI_TIMEOUT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"
