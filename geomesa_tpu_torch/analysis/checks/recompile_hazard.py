"""Check ``recompile-hazard``: the port's compile and cache sites free
of the silent-rebuild traps.

The port traces no program.  What it compiles is its CUDA kernels:
``ops/build.py``'s ``build`` and ``load`` run ``nvcc`` once per source
(the kernel-build watch, obs/recompile.py, counts each build into the
``jax.compile.*`` keys), and ``functools.lru_cache`` defs memoize the
launch shapes and curve tables built around them.  This check reads
the hazards off the source:

* **a per-call kernel name** — a ``build``/``load`` call whose name is
  not a string literal or a module-level string constant can build a
  new library on any call (the "every query compiles" cliff);
* **unhashable cache arguments** — a list/dict/set display defaulted
  in, or passed to, an ``lru_cache`` def raises ``TypeError`` at the
  call (every argument of a cached def is part of its key);
* **per-call-varying cache arguments** — an argument computed from
  ``time``/``random``/``uuid``/``id(...)`` misses the cache on every
  call and grows it without bound;
* **mutable-global capture** — a cached def reading a module global
  that is (a) bound to a mutable literal AND mutated somewhere in the
  module, or (b) reassigned via ``global``: the cache keeps the first
  result, so later mutation silently diverges.

Call-site arguments map onto parameter names positionally (up to a
``*splat``) and by keyword, for cached defs of the module and imported
ones.  ``build``/``load`` calls are the ones that resolve to
``ops/build.py`` through an import edge (``from ..ops.build import
load``, or ``build.load`` after ``from ..ops import build``); the
module's own forwarding of its ``name`` parameter is the definition,
not a use.
"""

from __future__ import annotations

import ast
import builtins

from ..walker import _dotted, is_cache_decorator

__all__ = ["RecompileHazardCheck"]

_UNHASHABLE = (ast.List, ast.Dict, ast.Set, ast.DictComp, ast.SetComp,
               ast.ListComp)

#: call roots whose results differ per call — a cache argument
#: computed from one misses every call
_VARYING_ROOTS = ("time.", "random.", "uuid.", "datetime.", "os.urandom",
                  "id", "perf_counter", "monotonic")

_BUILTINS = frozenset(dir(builtins))

#: the kernel build module (package-relative dotted name) and the
#: entry points that compile
_BUILD_MODULE = "ops.build"
_BUILD_FNS = {"build", "load"}


def _is_varying_call(node) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            dotted = _dotted(sub.func)
            if any(dotted == r.rstrip(".") or dotted.startswith(r)
                   for r in _VARYING_ROOTS):
                return True
    return False


def _local_names(fn) -> set[str]:
    """Parameters + every name the function binds (assignment,
    comprehension, with/for targets) — reads outside this set are
    global/closure reads."""
    out = {a.arg for a in (fn.args.posonlyargs + fn.args.args
                           + fn.args.kwonlyargs)}
    if fn.args.vararg:
        out.add(fn.args.vararg.arg)
    if fn.args.kwarg:
        out.add(fn.args.kwarg.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) \
                and isinstance(node.ctx, (ast.Store, ast.Del)):
            out.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.ImportFrom) or isinstance(node, ast.Import):
            for alias in node.names:
                out.add((alias.asname or alias.name).split(".")[0])
    return out


_MUTATORS = {"append", "extend", "insert", "update", "setdefault", "pop",
             "popitem", "clear", "add", "discard", "remove", "__setitem__"}


def _module_global_hazards(tree) -> dict[str, str]:
    """Module-level names that are mutation hazards: name -> why."""
    mutable_literal: set[str] = set()
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = [t for t in node.targets if isinstance(t, ast.Name)]
            value = node.value
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            targets, value = [node.target], node.value
        else:
            continue
        for t in targets:
            if isinstance(value, _UNHASHABLE) or (
                    isinstance(value, ast.Call)
                    and _dotted(value.func) in ("list", "dict", "set")):
                mutable_literal.add(t.id)
    hazards: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Global):
            for name in node.names:
                hazards[name] = "reassigned via `global`"
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATORS \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id in mutable_literal:
            hazards.setdefault(node.func.value.id,
                               "a mutable literal mutated in-module")
        elif isinstance(node, (ast.Subscript, ast.AugAssign)):
            target = node.target if isinstance(node, ast.AugAssign) \
                else node.value
            if isinstance(target, ast.Name) \
                    and target.id in mutable_literal \
                    and (isinstance(node, ast.AugAssign)
                         or isinstance(node.ctx, (ast.Store, ast.Del))):
                hazards.setdefault(target.id,
                                   "a mutable literal mutated in-module")
    return hazards


def _module_str_constants(tree) -> set[str]:
    """Module-level names bound once to a string literal."""
    seen: dict[str, bool] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            ok = isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str)
            seen[name] = ok and name not in seen
    return {k for k, v in seen.items() if v}


def _is_build_module(src: str) -> bool:
    return src == _BUILD_MODULE or src.endswith("." + _BUILD_MODULE)


def _build_call_name(mod, call) -> str | None:
    """``build``/``load`` when ``call`` reaches ops/build.py's entry
    point through an import edge, else None."""
    f = call.func
    if isinstance(f, ast.Name):
        edge = mod.imports.get(f.id)
        if edge is not None and edge[1] in _BUILD_FNS \
                and _is_build_module(edge[0]):
            return edge[1]
    elif isinstance(f, ast.Attribute) and f.attr in _BUILD_FNS \
            and isinstance(f.value, ast.Name):
        edge = mod.imports.get(f.value.id)
        if edge is not None and _is_build_module(f"{edge[0]}.{edge[1]}"):
            return f.attr
    return None


class RecompileHazardCheck:
    id = "recompile-hazard"
    description = ("kernel build/load sites with a per-call name; "
                   "lru_cache defs with unhashable or per-call-varying "
                   "arguments, or closing over mutable module globals")

    def run(self, mod, project):
        hazards = _module_global_hazards(mod.tree)
        constants = _module_str_constants(mod.tree)
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_def(mod, node, hazards)
            elif isinstance(node, ast.Call):
                yield from self._check_build(mod, node, constants)
                yield from self._check_call(mod, node, project)

    def _check_build(self, mod, call, constants):
        which = _build_call_name(mod, call)
        if which is None or not call.args:
            return
        name = call.args[0]
        if isinstance(name, ast.Constant) and isinstance(name.value, str):
            return
        if isinstance(name, ast.Name) and name.id in constants:
            return
        yield mod.finding(
            self.id, name,
            f"kernel `{which}` with a name that is not a literal or a "
            f"module constant — a per-call name can build a new library "
            f"on any call; name the kernel statically")

    def _check_def(self, mod, fn, hazards):
        if not any(is_cache_decorator(d) for d in fn.decorator_list):
            return
        # unhashable defaults: every parameter is part of the cache key
        pos = fn.args.posonlyargs + fn.args.args
        defaults = fn.args.defaults
        pairs = list(zip(pos[len(pos) - len(defaults):], defaults)) + [
            (a, d) for a, d in zip(fn.args.kwonlyargs, fn.args.kw_defaults)
            if d is not None]
        for arg, default in pairs:
            if isinstance(default, _UNHASHABLE):
                yield mod.finding(
                    self.id, default,
                    f"argument `{arg.arg}` of cached `{fn.name}` has an "
                    f"unhashable default — lru_cache arguments must be "
                    f"hashable")
        # mutable-global capture by the cached body
        local = _local_names(fn)
        reported: set[str] = set()
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load) \
                    and sub.id in hazards and sub.id not in local \
                    and sub.id not in _BUILTINS \
                    and sub.id not in reported:
                reported.add(sub.id)
                yield mod.finding(
                    self.id, sub,
                    f"cached `{fn.name}` closes over module global "
                    f"`{sub.id}` ({hazards[sub.id]}) — the cache keeps "
                    f"the first result; later mutation silently diverges")

    def _check_call(self, mod, call, project):
        if not isinstance(call.func, ast.Name):
            return
        params = project.cached_params_of(mod, call.func.id)
        if params is None:
            return
        # keyword AND positional values landing on cached parameters
        sites = [(kw.arg, kw.value) for kw in call.keywords if kw.arg]
        for i, a in enumerate(call.args):
            if isinstance(a, ast.Starred):
                break  # positions past a *splat are unknowable
            if i < len(params):
                sites.append((params[i], a))
        for name, value in sites:
            if isinstance(value, _UNHASHABLE):
                yield mod.finding(
                    self.id, value,
                    f"unhashable value for argument `{name}` of cached "
                    f"`{call.func.id}` — lru_cache raises TypeError; pass "
                    f"a tuple/scalar")
            elif _is_varying_call(value):
                yield mod.finding(
                    self.id, value,
                    f"argument `{name}` of cached `{call.func.id}` varies "
                    f"per call (time/random/id source) — every call "
                    f"misses the cache and grows it; bucket or hoist the "
                    f"value")
