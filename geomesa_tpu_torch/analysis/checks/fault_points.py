"""Check ``fault-points``: fault-injection point NAME LITERALS match
the documented catalog — statically, before any chaos test runs.

Fault points (resilience/faults.py) are named yield/injection sites
armed by operator config (``geomesa.resilience.fault.points``), so
their names are an operator API exactly like span names: a typoed
``fault_point("device.dispach")`` call would silently never fire and a
chaos run against it would prove nothing.  This check validates, from
the AST:

* every string literal reaching ``fault_point()`` /
  ``maybe_fail()`` appears in the ``docs/resilience.md``
  ``## Fault-point catalog`` table (first backticked cell per row);
* the ``FAULT_POINTS`` declaration tuple in ``resilience/faults.py``
  and the catalog agree EXACTLY in both directions — a point declared
  but undocumented, or documented but undeclared, is a finding.

When the catalog table is absent (docs/ not shipped, e.g. an
installed wheel), the check skips rather than flag every site.
"""

from __future__ import annotations

import ast

__all__ = ["FaultPointCheck"]

_FAULT_CALLS = {"fault_point", "maybe_fail"}


class FaultPointCheck:
    id = "fault-points"
    description = ("fault_point()/maybe_fail() name literals and the "
                   "FAULT_POINTS declaration match the "
                   "docs/resilience.md fault-point catalog")

    def run(self, mod, project):
        catalog = set(project.fault_points)
        if not catalog:
            return
        # the declaration tuple is the code-side ground truth — hold
        # it and the catalog to each other exactly
        if mod.rel == "resilience/faults.py":
            for node in mod.tree.body:
                if isinstance(node, ast.Assign) \
                        and any(isinstance(t, ast.Name)
                                and t.id == "FAULT_POINTS"
                                for t in node.targets) \
                        and isinstance(node.value, (ast.Tuple, ast.List)):
                    declared = [e.value for e in node.value.elts
                                if isinstance(e, ast.Constant)]
                    for name in declared:
                        if name not in catalog:
                            yield mod.finding(
                                self.id, node,
                                f'fault point "{name}" is declared but '
                                f"missing from the docs/resilience.md "
                                f"fault-point catalog — add the row "
                                f"(fault-point names are an operator "
                                f"API)")
                    for name in sorted(catalog - set(declared)):
                        yield mod.finding(
                            self.id, node,
                            f'fault point "{name}" is cataloged in '
                            f"docs/resilience.md but not declared in "
                            f"FAULT_POINTS — remove the row or declare "
                            f"the point")
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None)
            if name not in _FAULT_CALLS:
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
                    and arg.value not in catalog:
                yield mod.finding(
                    self.id, arg,
                    f'fault point "{arg.value}" is not in the '
                    f"docs/resilience.md fault-point catalog — add the "
                    f"row or fix the name (an unknown point never "
                    f"fires, so a chaos run against it proves nothing)")
