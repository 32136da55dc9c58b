"""gm-lint: AST-based invariant analysis for the geomesa_tpu_torch tree.

The JAX package's analyzer (``geomesa_tpu.analysis``) ported to the
port's own tree and contracts: the same CLI, check ids, pragma and
baseline grammar and exit codes, with a baseline of its own.  A Python
reproduction has no compiler to lean on, and the runtime lints only see
what one test cycle happens to execute; this package encodes the
codebase's OWN invariants as checks over the whole tree:

* ``host-sync`` — no silent device→host synchronizations (``.item()``,
  ``.cpu()``/``.numpy()``/``.tolist()`` on device expressions,
  ``torch.cuda.synchronize``) in the hot scan paths outside sanctioned
  ``device_span`` sites;
* ``recompile-hazard`` — kernel ``build``/``load`` sites named
  statically, and ``functools.lru_cache`` defs free of unhashable or
  per-call-varying arguments and of closures over mutable module
  globals;
* ``guarded-by`` — attributes declared ``#: guarded-by: self._lock``
  are only touched under a matching ``with self._lock:`` scope;
* ``config-option`` — every ``"geomesa.*"`` option literal resolves to
  a declaration in ``config.py`` and is documented under ``docs/``;
* ``taxonomy`` — metric and span name literals obey the
  ``METRIC_NAMESPACES`` contract and the ``docs/observability.md``
  span taxonomy;
* ``fault-points`` — fault-point name literals and ``FAULT_POINTS``
  match the ``docs/resilience.md`` catalog.

The analyzer is **pure stdlib** (``ast`` + ``tokenize`` + ``json``):
importing or running it never pulls in ``torch``/``numpy`` (the
package ``__init__`` resolves its exports lazily for that), so it works
on a machine with no accelerator stack.  Findings suppress via inline
pragmas (``# gm-lint: disable=<check>[ reason]``) or via the committed
``baseline.json`` whose every entry carries a written justification.

CLI: ``python -m geomesa_tpu_torch.analysis [--fail-on-new]
[--list-checks] [--check <id>] [--format json] [paths...]`` — see
``__main__.py`` and docs/static_analysis.md.
"""

from __future__ import annotations

from .model import Finding, findings_to_json
from .baseline import Baseline, BaselineError
from .walker import Project, analyze, iter_python_files

__all__ = ["Finding", "findings_to_json", "Baseline", "BaselineError",
           "Project", "analyze", "iter_python_files", "all_checks"]


def all_checks():
    """The registered check instances, in documented order."""
    from .checks import CHECKS
    return list(CHECKS)
