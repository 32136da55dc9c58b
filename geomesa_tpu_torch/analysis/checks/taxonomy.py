"""Check ``taxonomy``: metric and span NAME LITERALS obey the
documented contracts — statically, before any test cycle runs.

The runtime metric lint (tests/test_zzz_metric_lint.py) walks the
registry AFTER the suite, so it only judges keys some test emitted;
this check supersedes that cycle-dependent half by validating every
name at its source:

* **metrics** — string literals reaching ``counter()`` / ``timer()``
  / ``gauge()`` / ``histogram()`` / ``obs_count()`` calls, plus the
  canonical name constants in ``metrics.py``, must match the
  ``METRIC_NAMESPACES`` contract (first segment in the namespace
  tuple, dot-separated ``[A-Za-z0-9_:-]`` segments).  The namespace
  tuple is parsed from ``metrics.py`` by AST — the check can never
  drift from the runtime contract;
* **spans** — name literals reaching ``span()`` / ``obs_span()`` /
  ``device_span()`` / ``tracer.span()`` must appear in the
  ``docs/observability.md`` span-taxonomy table (``<x>`` table
  placeholders match exactly one name segment).

F-strings resolve each ``{...}`` hole to one wildcard segment, and a
plain ``name`` argument resolves through (a) the module's canonical
constants / imports of ``metrics.py`` constants, and (b) a
single-constant local assignment in the enclosing function (the
``base = f"heat.{scope}"`` idiom).  Names that stay unresolvable
(params, computed) are skipped — the runtime walk still covers those;
this check's job is making every LITERAL correct by construction.
"""

from __future__ import annotations

import ast
import re

__all__ = ["TaxonomyCheck"]

_METRIC_CALLS = {"counter", "timer", "gauge", "histogram"}
_SPAN_CALLS = {"span", "obs_span", "device_span"}
#: one resolved wildcard segment (an f-string hole / a `<kind>` doc
#: placeholder)
_WILD = "\x00"
_SEG_RE = re.compile(r"^[A-Za-z0-9_:\-]+$")


def _pattern_of(node, consts: dict, local_consts: dict) -> str | None:
    """The name pattern of an argument expression: literal text with
    ``_WILD`` for unresolvable holes; None when nothing resolves."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant):
                parts.append(str(v.value))
            elif isinstance(v, ast.FormattedValue):
                inner = _pattern_of(v.value, consts, local_consts)
                parts.append(inner if inner is not None else _WILD)
        return "".join(parts)
    if isinstance(node, ast.Name):
        return local_consts.get(node.id, consts.get(node.id))
    return None


def _segments_ok(pattern: str) -> bool:
    return all(seg == _WILD or _SEG_RE.match(seg)
               for seg in pattern.split("."))


def _matches_doc(pattern: str, doc_patterns: list[str]) -> bool:
    """Does a used span pattern match some taxonomy row?  Both sides
    normalize placeholders to one-segment wildcards."""
    used = pattern.split(".")
    for doc in doc_patterns:
        ref = doc.split(".")
        if len(ref) != len(used):
            continue
        if all(u == _WILD or r.startswith("<") or u == r
               for u, r in zip(used, ref)):
            return True
    return False


def _module_consts(mod, project) -> dict[str, str]:
    """UPPER_CASE string constants of the module plus any imported
    from the tree's modules (the metrics.py canonical names)."""
    out: dict[str, str] = {}

    def harvest(tree, into):
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, str):
                into[node.targets[0].id] = node.value.value

    harvest(mod.tree, out)
    for local, (src, name) in mod.imports.items():
        src_mod = project.by_modname.get(src)
        if src_mod is None:
            continue
        src_consts: dict[str, str] = {}
        harvest(src_mod.tree, src_consts)
        if name in src_consts:
            out[local] = src_consts[name]
    return out


def _function_local_consts(fn, consts) -> dict[str, str]:
    """Single-assignment string locals of one function (the
    ``base = f"heat.{scope}"`` resolution; reassigned names drop)."""
    seen: dict[str, str | None] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            val = _pattern_of(node.value, consts, {})
            seen[name] = val if name not in seen else None
    return {k: v for k, v in seen.items() if v is not None}


class TaxonomyCheck:
    id = "taxonomy"
    description = ("metric name literals obey METRIC_NAMESPACES; span "
                   "name literals appear in the docs/observability.md "
                   "span taxonomy")

    def run(self, mod, project):
        if not project.metric_namespaces:
            return
        consts = _module_consts(mod, project)
        # canonical metric-name constants declare the contract's
        # ground truth — validate them at the source (metrics.py and
        # anywhere else an UPPER_CASE dotted name constant lives)
        if mod.rel == "metrics.py":
            for node in mod.tree.body:
                if isinstance(node, ast.Assign) \
                        and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and node.targets[0].id.isupper() \
                        and isinstance(node.value, ast.Constant) \
                        and isinstance(node.value.value, str) \
                        and "." in node.value.value:
                    yield from self._judge_metric(
                        mod, node.value, node.value.value, project)
        # call sites, with per-function local resolution
        fns = [n for n in ast.walk(mod.tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        covered: set[int] = set()
        for fn in fns:
            local = _function_local_consts(fn, consts)
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and id(node) not in covered:
                    covered.add(id(node))
                    yield from self._judge_call(mod, node, project,
                                                consts, local)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and id(node) not in covered:
                yield from self._judge_call(mod, node, project, consts, {})

    def _judge_call(self, mod, call, project, consts, local):
        f = call.func
        kind = None
        if isinstance(f, ast.Attribute):
            if f.attr in _METRIC_CALLS \
                    and not (isinstance(f.value, ast.Name)
                             and f.value.id == "self"):
                kind = "metric"
            elif f.attr == "span":
                kind = "span"
        elif isinstance(f, ast.Name):
            if f.id in _SPAN_CALLS:
                kind = "span"
            elif f.id == "obs_count":
                kind = "metric"
        if kind is None or not call.args:
            return
        pattern = _pattern_of(call.args[0], consts, local)
        if pattern is None:
            return
        if kind == "metric":
            yield from self._judge_metric(mod, call.args[0], pattern,
                                          project)
        else:
            # no span table (docs/ absent, e.g. an installed wheel):
            # skip rather than flag every span in the tree
            if project.span_patterns \
                    and not _matches_doc(pattern, project.span_patterns):
                shown = pattern.replace(_WILD, "<…>")
                yield mod.finding(
                    self.id, call.args[0],
                    f'span name "{shown}" is not in the '
                    f"docs/observability.md span taxonomy — add the "
                    f"row (span names are an operator API) or fix the "
                    f"name")

    def _judge_metric(self, mod, node, pattern, project):
        shown = pattern.replace(_WILD, "<…>")
        first = pattern.split(".", 1)[0]
        if first == _WILD:
            # dynamically-prefixed name (f"{prefix}.hits"): namespace
            # judgment is out of static reach — the runtime registry
            # walk covers it (module doc)
            return
        if first not in project.metric_namespaces or "." not in pattern:
            yield mod.finding(
                self.id, node,
                f'metric name "{shown}" is outside the documented '
                f"namespaces {project.metric_namespaces} — fix the key "
                f"or extend METRIC_NAMESPACES AND "
                f"docs/observability.md")
        elif not _segments_ok(pattern):
            yield mod.finding(
                self.id, node,
                f'metric name "{shown}" has a malformed segment — '
                f"segments are dot-separated [A-Za-z0-9_:-]")
