"""Check ``guarded-by``: annotated shared state is only touched under
its lock.

The obs layer is full of process-wide singletons mutated from query,
writer, scraper, and reporter threads at once (``HeatTracker``,
``JobRegistry``, the metric registry, the partial caches), and an
unlocked touch of one is a race no single-threaded test sees.  This
check closes the class: an attribute declared

    #: guarded-by: self._lock
    self._entries = {}

(the declaration comment on the line above — or the same line as —
the attribute's first assignment, anywhere in the class) may
afterwards only be read/written/deleted lexically inside a matching

    with self._lock:

block.  Two sanctioned escapes:

* ``__init__`` is exempt — the object is not yet shared while it is
  being built;
* a method that RUNS with the lock already held by its caller (the
  ``_evict_coldest`` idiom) declares it with ``# gm-lint: holds:
  self._lock`` on (or directly above) its ``def`` line, which exempts
  that method for that lock.

The analysis is lexical (a ``with`` in a caller does not sanction a
callee) — exactly the locality the error-prone ``@GuardedBy``
discipline enforces, and the reason the escape hatch is an explicit
annotation instead of inference.
"""

from __future__ import annotations

import ast
import re

__all__ = ["LockDisciplineCheck"]

_DECL_RE = re.compile(r"#:?\s*guarded-by:\s*self\.(\w+)")
_HOLDS_RE = re.compile(r"#\s*gm-lint:\s*holds:\s*self\.(\w+)")


def _self_assign_lines(cls) -> list[tuple[int, str]]:
    """Sorted ``(line, attr)`` of every ``self.X = ...`` (plain,
    annotated, augmented) anywhere in the class."""
    out: list[tuple[int, str]] = []
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets = [node.target]
        else:
            continue
        for t in targets:
            if isinstance(t, ast.Attribute) \
                    and isinstance(t.value, ast.Name) \
                    and t.value.id == "self":
                out.append((t.lineno, t.attr))
    return sorted(out)


def _declarations(mod, cls) -> dict[str, str]:
    """``{attr: lock_attr}`` declared inside ``cls``'s span.  Reads
    REAL comment tokens only (``mod.comments`` — grammar quoted in a
    docstring declares nothing) and binds each declaration to the
    next ``self.X`` assignment by AST, so a comment block of any
    length between declaration and attribute still binds."""
    out: dict[str, str] = {}
    assigns = _self_assign_lines(cls)
    for i in range(cls.lineno, (cls.end_lineno or cls.lineno) + 1):
        text = mod.comments.get(i)
        if text is None:
            continue
        m = _DECL_RE.search(text)
        if m is None:
            continue
        attr = next((a for ln, a in assigns if ln >= i), None)
        if attr is not None:
            out[attr] = m.group(1)
    return out


def _holds(mod, fn) -> set[str]:
    """Locks a method declares as already held (comment token on the
    ``def`` line or the line above)."""
    out: set[str] = set()
    for i in (fn.lineno - 1, fn.lineno):
        m = _HOLDS_RE.search(mod.comments.get(i, ""))
        if m:
            out.add(m.group(1))
    return out


def _lock_ranges(fn, lock: str) -> list[tuple[int, int]]:
    out = []
    for node in ast.walk(fn):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                ce = item.context_expr
                if isinstance(ce, ast.Attribute) and ce.attr == lock \
                        and isinstance(ce.value, ast.Name) \
                        and ce.value.id == "self":
                    out.append((node.lineno,
                                node.end_lineno or node.lineno))
                    break
    return out


class LockDisciplineCheck:
    id = "guarded-by"
    description = ("attributes declared `#: guarded-by: self._lock` "
                   "only touched inside a matching `with self._lock:` "
                   "scope")

    def run(self, mod, project):
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                yield from self._check_class(mod, node)

    def _check_class(self, mod, cls):
        guarded = _declarations(mod, cls)
        if not guarded:
            return
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name == "__init__":
                continue
            held = _holds(mod, fn)
            ranges = {lock: _lock_ranges(fn, lock)
                      for lock in set(guarded.values())}
            reported: set[tuple] = set()
            for sub in ast.walk(fn):
                if not (isinstance(sub, ast.Attribute)
                        and isinstance(sub.value, ast.Name)
                        and sub.value.id == "self"
                        and sub.attr in guarded):
                    continue
                lock = guarded[sub.attr]
                if lock in held:
                    continue
                if any(lo <= sub.lineno <= hi for lo, hi in ranges[lock]):
                    continue
                key = (fn.name, sub.attr, sub.lineno)
                if key in reported:
                    continue
                reported.add(key)
                yield mod.finding(
                    self.id, sub,
                    f"`{cls.name}.{fn.name}` touches `self.{sub.attr}` "
                    f"(guarded-by self.{lock}) outside `with "
                    f"self.{lock}:` — lock it, or mark the method "
                    f"`# gm-lint: holds: self.{lock}` if the caller "
                    f"holds it")
