"""Check ``config-option``: every ``"geomesa.*"`` option literal in
the tree resolves to a declaration in ``config.py`` and is documented
under ``docs/``.

The reference's option surface is a single generated page because
every knob is a declared ``SystemProperty``; here a typo'd literal
(a compaction factor spelled geomesa.lean.compactoin.factor, say)
would silently read a default forever.  The declaration registry is
``config.py``'s ``SystemProperty("...")`` (tier-1 process properties)
and ``SchemaOption("...")`` (tier-2 per-schema user-data keys) calls —
the same registry the runtime strict mode (``geomesa.config.strict``)
warns against, so the static and runtime halves can never drift.

A literal is in scope when it LOOKS like an option name
(``geomesa.`` followed by dotted lower-case segments, the whole
string); prose in docstrings never matches.  Declaration-site
literals in ``config.py`` itself are exempt.  Dynamically-built names
(f-strings) are out of static reach — the runtime strict mode covers
those.
"""

from __future__ import annotations

import ast
import re

from ..walker import _dotted

__all__ = ["ConfigOptionCheck"]

_OPTION_RE = re.compile(r"^geomesa(\.[a-z0-9_]+)+$")


class ConfigOptionCheck:
    id = "config-option"
    description = ('every "geomesa.*" string literal resolves to a '
                   "SystemProperty/SchemaOption declared in config.py "
                   "and is documented under docs/")

    def run(self, mod, project):
        decl_lines = self._declaration_lines(mod) \
            if mod.rel == "config.py" else frozenset()
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and _OPTION_RE.match(node.value)):
                continue
            if node.lineno in decl_lines:
                continue
            name = node.value
            if name not in project.declared_options:
                yield mod.finding(
                    self.id, node,
                    f'option literal "{name}" is not declared in '
                    f"config.py — declare a SystemProperty/SchemaOption "
                    f"(or fix the typo)")
            elif project.docs_text and name not in project.docs_text:
                yield mod.finding(
                    self.id, node,
                    f'option "{name}" is declared but appears nowhere '
                    f"under docs/ — document it "
                    f"(docs/configuration.md)")

    @staticmethod
    def _declaration_lines(mod) -> frozenset:
        """Line spans of SystemProperty/SchemaOption declaration
        calls in config.py (their name literals are the registry, not
        uses)."""
        out = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) \
                    and _dotted(node.func) in ("SystemProperty",
                                               "SchemaOption"):
                out.update(range(node.lineno,
                                 (node.end_lineno or node.lineno) + 1))
        return frozenset(out)
