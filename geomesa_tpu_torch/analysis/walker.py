"""Shared project walker: parse every module once, build the
cross-module context the checks share, run the checks.

Two passes, because several checks need whole-tree knowledge before
any file can be judged:

* **pass 1** parses each ``.py`` into a :class:`SourceModule` (AST +
  raw lines + pragmas) and harvests per-module facts —
  ``functools.lru_cache`` defs with their parameter names, import
  edges, and option declarations from ``config.py``;
* **pass 2** grows the device-dispatch registry (below) over the
  parsed modules through their ``from X import y`` edges, so a module
  knows which of its own and imported names are device dispatches,
  then runs every check over every module.

The device-dispatch registry is what host-sync reads: the port traces
no program, so where the JAX analyzer knows its jitted functions, this
one knows the kernel wrappers of ``ops/`` (:data:`DISPATCH_MODULES`)
and, transitively, every def whose return value is one of their
results.  A wrapper module's def is a dispatch when its return
annotation names ``Tensor`` or a value it returns comes from a
``torch.`` call or another dispatch (directly or through a local
name); elsewhere a def is a dispatch when a value it returns comes
from a dispatch.  Imports of a wrapper module that the walked set does
not hold (a fixture importing ``geomesa_tpu_torch.ops.z3_mask``)
resolve against this package's own tree.

Contract sources (the metric-namespace tuple, the span taxonomy
table, option declarations, docs text) load from the ANALYZED root
when present and fall back to this package's own tree — so fixture
directories in tests are judged against the real contracts while the
real tree stays self-describing.  The span and fault catalogs are the
repository's shared ``docs/``, read and never written.  Everything
here is stdlib-only: ``ast`` is the entire front end.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from .model import Finding, _comment_tokens, parse_pragmas

__all__ = ["SourceModule", "Project", "analyze", "iter_python_files",
           "PACKAGE_ROOT", "REPO_ROOT", "DISPATCH_MODULES"]

#: this package's parent (the geomesa_tpu_torch package dir) and the
#: repo root above it — the contract-source fallbacks
PACKAGE_ROOT = Path(__file__).resolve().parent.parent
REPO_ROOT = PACKAGE_ROOT.parent

#: never walked: bytecode caches (by name) and THE ANALYZER'S OWN
#: package (by resolved path — a bare-name skip would silently exempt
#: any future subpackage that happens to be called analysis/)
_SKIP_DIRS = {"__pycache__"}
ANALYSIS_DIR = Path(__file__).resolve().parent

#: the hot-path subtrees check host-sync guards: the lean index
#: families, the device kernels, the curve encoders, and the sharded
#: scan variants
HOT_PATH_PARTS = ("index", "ops", "curve", "parallel")

#: the kernel-wrapper modules that seed the device-dispatch registry
#: (package-relative paths)
DISPATCH_MODULES = ("ops/z3_mask.py", "ops/z2_mask.py", "ops/density.py",
                    "ops/density_kernel.py", "ops/hist1d_kernel.py",
                    "ops/search.py", "ops/launch.py")


def _in_analysis_dir(path: Path) -> bool:
    try:
        Path(path).resolve().relative_to(ANALYSIS_DIR)
        return True
    except ValueError:
        return False


def iter_python_files(root: Path):
    root = Path(root)
    if root.is_file():
        yield root
        return
    for p in sorted(root.rglob("*.py")):
        if any(part in _SKIP_DIRS for part in p.relative_to(root).parts) \
                or _in_analysis_dir(p):
            continue
        yield p


class SourceModule:
    """One parsed file plus everything checks ask of it repeatedly."""

    def __init__(self, path: Path, root: Path):
        self.path = Path(path)
        self.root = Path(root)
        try:
            self.rel = self.path.relative_to(self.root).as_posix()
        except ValueError:
            self.rel = self.path.name
        self.text = self.path.read_text(encoding="utf-8")
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=str(self.path))
        # ONE tokenize pass feeds both the pragma map and the comment
        # map (tokenizing is a large share of analyzer wall time)
        tokens = _comment_tokens(self.lines)
        self.pragmas = parse_pragmas(self.lines, tokens=tokens)
        #: {line: comment text} — REAL comment tokens only, so grammar
        #: quoted in docstrings never reads as an annotation
        self.comments = {i: text for i, text, _ in tokens}
        # dotted module name rooted at the package (import resolution)
        stem = self.rel[:-3] if self.rel.endswith(".py") else self.rel
        parts = stem.split("/")
        self.is_package = parts[-1] == "__init__"
        if self.is_package:
            parts = parts[:-1]
        prefix = [self.root.name] if self.root.name else []
        self.modname = ".".join(prefix + parts) if parts else self.root.name
        # facts pass 1 fills in (walker-owned, check-shared)
        self.dispatch_fns: set[str] = set()
        self.cached_fns: dict[str, list[str]] = {}  # name -> pos params
        self.imports: dict[str, tuple[str, str]] = {}  # local -> (mod, name)

    @property
    def is_wrapper_module(self) -> bool:
        return self.rel in DISPATCH_MODULES

    def finding(self, check_id: str, node_or_line, message: str
                ) -> Finding | None:
        """A finding unless a pragma suppresses it."""
        line = getattr(node_or_line, "lineno", node_or_line)
        if self.pragmas.suppresses(check_id, line):
            return None
        return Finding(self.rel, int(line), check_id, message)


# -- dispatch recognition (shared by host-sync and recompile-hazard) ------
def _dotted(node) -> str:
    """``a.b.c`` for a Name/Attribute chain, else ''."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


#: methods whose result is on the host: an expression past one of them
#: is no longer a device value
HOST_METHODS = {"cpu", "numpy", "tolist", "item"}


def is_to_cpu(call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")``."""
    if not (isinstance(call, ast.Call)
            and isinstance(call.func, ast.Attribute)
            and call.func.attr == "to"):
        return False
    args = list(call.args[:1]) + [k.value for k in call.keywords
                                  if k.arg == "device"]
    return any(isinstance(a, ast.Constant) and a.value == "cpu"
               for a in args)


def is_host_copy(call) -> bool:
    """A call that moves its receiver to the host (``.cpu()``,
    ``.numpy()``, ``.tolist()``, ``.item()``, ``.to("cpu")``)."""
    return isinstance(call, ast.Call) and (
        (isinstance(call.func, ast.Attribute)
         and call.func.attr in HOST_METHODS and not call.args)
        or is_to_cpu(call))


def device_rooted(node, dispatches: set, names: frozenset = frozenset(),
                  torch_calls: bool = True) -> bool:
    """Is ``node`` a device value by its syntax: a chain of method
    calls, attribute reads and subscripts whose root is a ``torch.``
    call (unless ``torch_calls`` is off) or a call to a known dispatch
    (or, for ``names``, a local name bound to one)?  Arithmetic is
    device when an operand is; a chain through a host copy
    (``.cpu()`` …) is a host value, and a chain rooted in any other
    name — ``self.bins[:n]``, a parameter — is not judged (module doc
    of checks/host_sync.py)."""
    def rooted(n):
        return device_rooted(n, dispatches, names, torch_calls)

    while True:
        if isinstance(node, ast.Call):
            if is_host_copy(node):
                return False
            if isinstance(node.func, ast.Name):
                return node.func.id in dispatches
            if torch_calls and _dotted(node.func).startswith("torch."):
                return True
            if isinstance(node.func, ast.Attribute):
                node = node.func.value      # a method: judge its receiver
                continue
            return False
        if isinstance(node, (ast.Attribute, ast.Subscript)):
            node = node.value
            continue
        if isinstance(node, ast.Name):
            return node.id in names
        if isinstance(node, ast.UnaryOp):
            node = node.operand
            continue
        if isinstance(node, ast.BinOp):
            return rooted(node.left) or rooted(node.right)
        if isinstance(node, ast.Compare):
            return any(rooted(n) for n in [node.left, *node.comparators])
        if isinstance(node, ast.BoolOp):
            return any(rooted(n) for n in node.values)
        return False


def _own_nodes(fn) -> list:
    """The nodes of ``fn``'s own body: nested defs, lambdas and classes
    are other scopes (their returns are not ``fn``'s)."""
    out, todo = [], list(fn.body)
    while todo:
        node = todo.pop()
        out.append(node)
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda, ast.ClassDef)):
                todo.append(child)
    return out


def free_defs(tree) -> list:
    """Every def of a module that is not a method: module-level
    functions and the closures nested in any def.  Methods are called
    through an attribute, which no bare-name registry can see.  Defs are
    statements, so only statement bodies are visited."""
    out = []

    def visit(stmts, in_class):
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if not in_class:
                    out.append(st)
                visit(st.body, False)
            elif isinstance(st, ast.ClassDef):
                visit(st.body, True)
            else:   # if/for/while/with/try/match and their clauses
                for field in ("body", "orelse", "finalbody", "handlers",
                              "cases"):
                    visit(getattr(st, field, None) or (), in_class)

    visit(tree.body, False)
    return out


class _ReturnFacts:
    """What :func:`returns_device` asks of one def, collected once:
    its bindings ``(value, target names)`` and its returned values."""

    __slots__ = ("annotated_tensor", "bindings", "returns")

    def __init__(self, fn):
        self.annotated_tensor = fn.returns is not None \
            and _dotted(fn.returns).split(".")[-1] == "Tensor"
        self.bindings, self.returns = [], []
        for node in _own_nodes(fn):
            if isinstance(node, ast.Return) and node.value is not None:
                self.returns.extend(node.value.elts
                                    if isinstance(node.value, ast.Tuple)
                                    else [node.value])
            elif isinstance(node, (ast.Assign, ast.AnnAssign,
                                   ast.AugAssign)) \
                    and node.value is not None:
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                names = [n.id for t in targets for n in ast.walk(t)
                         if isinstance(n, ast.Name)]
                self.bindings.append((node.value, names))


def returns_device(facts: _ReturnFacts, dispatches: set,
                   wrapper: bool) -> bool:
    """Does some ``return`` of a def hand back a device value?  In a
    kernel-wrapper module (``wrapper``) a ``torch.`` call counts as a
    device source and a ``Tensor`` return annotation decides; elsewhere
    only a dispatch's result does.  A returned local name counts when
    any of its bindings in the def is such a value."""
    if wrapper and facts.annotated_tensor:
        return True
    if not facts.returns:
        return False
    names = frozenset(n for value, targets in facts.bindings
                      if device_rooted(value, dispatches,
                                       torch_calls=wrapper)
                      for n in targets)
    return any(device_rooted(r, dispatches, names, torch_calls=wrapper)
               for r in facts.returns)


_CACHE_NAMES = {"functools.lru_cache", "lru_cache", "functools.cache",
                "cache"}


def is_cache_decorator(dec) -> bool:
    """``@functools.lru_cache``, ``@functools.lru_cache(maxsize=…)``,
    ``@functools.cache`` (and their bare imports)."""
    if isinstance(dec, ast.Call):
        dec = dec.func
    return _dotted(dec) in _CACHE_NAMES


def _harvest_module_facts(mod: SourceModule) -> None:
    """Pass 1: cached defs and import edges (the dispatch registry
    needs the edges of every module, so :class:`Project` resolves it
    afterwards)."""
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if any(is_cache_decorator(d) for d in node.decorator_list):
                mod.cached_fns[node.name] = [
                    a.arg for a in (node.args.posonlyargs
                                    + node.args.args)]
        elif isinstance(node, ast.ImportFrom) and node.module is not None \
                or isinstance(node, ast.ImportFrom) and node.level:
            base = _resolve_relative(mod.modname, node.module, node.level,
                                     mod.is_package)
            for alias in node.names:
                if alias.name != "*":
                    mod.imports[alias.asname or alias.name] = (
                        base, alias.name)


def _resolve_relative(modname: str, module: str | None, level: int,
                      is_package: bool = False) -> str:
    """Absolute dotted target of a (possibly relative) import-from.

    A regular module's one-dot base is its parent package; a package
    ``__init__`` (whose modname IS the package) climbs one level less —
    ``from .x import y`` there stays inside the package itself."""
    if not level:
        return module or ""
    parts = modname.split(".")
    drop = level - 1 if is_package else level
    base = parts[:len(parts) - drop] if drop <= len(parts) else []
    return ".".join(base + ([module] if module else []))


# -- the project ----------------------------------------------------------
class Project:
    """Everything the checks share: parsed modules plus the
    cross-module fact tables (module doc)."""

    def __init__(self, root: Path, files=None):
        self.root = Path(root).resolve()
        self.package_mode = (self.root / "config.py").exists() \
            and (self.root / "metrics.py").exists()
        paths = list(files) if files is not None \
            else list(iter_python_files(self.root))
        self.modules = [SourceModule(p, self.root) for p in paths]
        self.by_modname = {m.modname: m for m in self.modules}
        for m in self.modules:
            _harvest_module_facts(m)
        #: wrapper modules parsed from this package's own tree because
        #: the walked set does not hold them (fixture imports)
        self._fallback: dict[str, SourceModule | None] = {}
        self._grow(self.modules)
        self.declared_options = self._collect_options()
        self.docs_text = self._read_docs()
        self.metric_namespaces = self._metric_namespaces()
        self.span_patterns = self._span_patterns()
        self.fault_points = self._fault_points()

    # -- device-dispatch resolution (host-sync) ----------------------
    def _module(self, modname: str) -> SourceModule | None:
        """A walked module by dotted name, else a kernel-wrapper module
        of this package's own tree (parsed once)."""
        mod = self.by_modname.get(modname)
        if mod is not None or modname in self._fallback:
            return mod if mod is not None else self._fallback[modname]
        head, _, rest = modname.partition(".")
        rel = rest.replace(".", "/") + ".py"
        self._fallback[modname] = None
        if head == PACKAGE_ROOT.name and rel in DISPATCH_MODULES:
            found = SourceModule(PACKAGE_ROOT / rel, PACKAGE_ROOT)
            _harvest_module_facts(found)
            self._fallback[modname] = found
            self._grow([found])
        return self._fallback[modname]

    def device_names(self, mod: SourceModule) -> set[str]:
        """Dispatch names ``mod`` can call by a bare name: its own plus
        imported ones resolved across the walked set."""
        out = set(mod.dispatch_fns)
        for local, (src, name) in mod.imports.items():
            src_mod = self._module(src)
            if src_mod is not None and name in src_mod.dispatch_fns:
                out.add(local)
        return out

    def _grow(self, modules) -> None:
        """Grow the registry over ``modules``' defs until no def joins
        it (a wrapper returning another's result, a def returning a
        def's that returns a wrapper's, across import edges)."""
        facts = [(m, [(d.name, _ReturnFacts(d)) for d in free_defs(m.tree)])
                 for m in modules]
        while True:
            grew = False
            for m, defs in facts:
                known = self.device_names(m)
                for name, f in defs:
                    if name not in m.dispatch_fns and returns_device(
                            f, known, m.is_wrapper_module):
                        m.dispatch_fns.add(name)
                        known.add(name)
                        grew = True
            if not grew:
                return

    def cached_params_of(self, mod: SourceModule, name: str
                         ) -> list[str] | None:
        """Positional parameter names of an ``lru_cache`` def called by
        ``name`` in ``mod`` (own or imported); None when not cached."""
        if name in mod.cached_fns:
            return mod.cached_fns[name]
        edge = mod.imports.get(name)
        if edge is not None:
            src_mod = self.by_modname.get(edge[0])
            if src_mod is not None:
                return src_mod.cached_fns.get(edge[1])
        return None

    def is_hot_path(self, mod: SourceModule) -> bool:
        """Hot-path scope for host-sync: the named subtrees inside the
        package; every file when analyzing an explicit fixture dir."""
        if not self.package_mode:
            return True
        return any(part in HOT_PATH_PARTS
                   for part in mod.rel.split("/")[:-1])

    # -- contract sources --------------------------------------------
    def _contract_file(self, rel: str) -> Path | None:
        for base in (self.root, PACKAGE_ROOT):
            p = base / rel
            if p.exists():
                return p
        return None

    def _collect_options(self) -> set[str]:
        """Names declared ``SystemProperty("...", ...)`` or
        ``SchemaOption("...", ...)`` in the analyzed tree's config.py
        (no fallback: fixture trees DECLARE nothing, so their option
        literals are judged undeclared — deliberately)."""
        cfg = next((m for m in self.modules if m.rel == "config.py"), None)
        if cfg is None and not self.package_mode:
            return set()
        out: set[str] = set()
        if cfg is not None:
            tree = cfg.tree
        else:
            tree = ast.parse((self.root / "config.py")
                             .read_text(encoding="utf-8"))
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) \
                    and _dotted(node.func) in ("SystemProperty",
                                               "SchemaOption") \
                    and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                out.add(node.args[0].value)
        return out

    def _read_docs(self) -> str:
        for base in (self.root.parent, REPO_ROOT):
            docs = base / "docs"
            if docs.is_dir():
                return "\n".join(p.read_text(encoding="utf-8")
                                 for p in sorted(docs.glob("*.md")))
        return ""

    def _metric_namespaces(self) -> tuple:
        mod = next((m for m in self.modules if m.rel == "metrics.py"),
                   None)
        if mod is not None:  # already parsed — reuse the AST
            tree = mod.tree
        else:
            p = self._contract_file("metrics.py")
            if p is None:
                return ()
            tree = ast.parse(p.read_text(encoding="utf-8"))
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) \
                    and any(isinstance(t, ast.Name)
                            and t.id == "METRIC_NAMESPACES"
                            for t in node.targets) \
                    and isinstance(node.value, (ast.Tuple, ast.List)):
                return tuple(e.value for e in node.value.elts
                             if isinstance(e, ast.Constant))
        return ()

    def _doc_table(self, doc_name: str, section: str) -> list[str]:
        """First backticked cell of each table row in ``## section`` of
        ``docs/doc_name`` (the analyzed root's docs, else the repo's)."""
        for base in (self.root.parent, REPO_ROOT):
            doc = base / "docs" / doc_name
            if doc.exists():
                break
        else:
            return []
        out: list[str] = []
        in_section = False
        for line in doc.read_text(encoding="utf-8").splitlines():
            if line.startswith("## "):
                in_section = line.strip() == f"## {section}"
                continue
            if in_section and line.startswith("|"):
                m = re.match(r"\|\s*`([^`]+)`\s*\|", line)
                if m:
                    out.append(m.group(1))
        return out

    def _span_patterns(self) -> list[str]:
        """Span names from the docs/observability.md taxonomy table;
        ``<x>`` placeholders become one-segment wildcards at match
        time."""
        return self._doc_table("observability.md", "Span taxonomy")

    def _fault_points(self) -> list[str]:
        """Fault-point names from the docs/resilience.md catalog table —
        the ground truth the fault-points check holds ``fault_point()``
        call literals and the ``FAULT_POINTS`` declaration to."""
        return self._doc_table("resilience.md", "Fault-point catalog")


def package_root_of(path: Path) -> Path:
    """The topmost enclosing package directory of a file (the dir
    findings and baseline keys are relative to), else its parent."""
    base = Path(path).resolve().parent
    while (base / "__init__.py").exists() \
            and (base.parent / "__init__.py").exists():
        base = base.parent
    return base


def analyze(root: Path | str, checks=None, files=None,
            select=None) -> list[Finding]:
    """Run ``checks`` (default: all registered) over ``root``; returns
    findings sorted by (file, line, check).  ``files`` restricts which
    files are PARSED (self-contained fixture sets); ``select``
    restricts which modules are JUDGED while the whole root still
    parses for cross-module context (the CLI's single-file mode)."""
    from .checks import CHECKS
    root = Path(root)
    if root.is_file():
        # a bare file must still report paths relative to its package
        # root — else baseline keys like index/z3_lean.py never match
        select = {root.resolve()}
        root = package_root_of(root)
    elif root.is_dir() and (root / "__init__.py").exists() \
            and files is None and select is None:
        # same re-rooting for a SUBPACKAGE directory: judge its files,
        # but parse (and key against) the whole enclosing package
        top = package_root_of(root / "__init__.py")
        if top != root.resolve():
            select = {p.resolve() for p in iter_python_files(root)}
            root = top
    project = Project(root, files=files)
    use = list(CHECKS) if checks is None else list(checks)
    judged = project.modules if select is None else \
        [m for m in project.modules if m.path.resolve() in select]
    findings: list[Finding] = []
    for mod in judged:
        for check in use:
            findings.extend(f for f in check.run(mod, project)
                            if f is not None)
    findings.sort(key=lambda f: (f.file, f.line, f.check_id, f.message))
    return findings
