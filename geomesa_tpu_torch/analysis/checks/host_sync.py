"""Check ``host-sync``: no silent device→host synchronizations in hot
scan paths outside sanctioned ``device_span`` sites.

The store's observability contract (docs/observability.md) is that
every device round-trip in a scan path is wrapped in
``obs.device_span`` — the synchronizing copy's wall time IS the span's
``device_ms`` and rolls up to the root span, so "where does device
time go" is answerable.  A bare ``z3_mask(...).cpu()`` in a hot path
is a silent sync: it blocks the query on the card without attributing
a microsecond anywhere.

Flagged, in hot-path modules (``index/``, ``ops/``, ``curve/``,
``parallel/``), lexically OUTSIDE any ``with device_span(...):``
block:

* ``x.item()`` — always a transfer;
* ``torch.cuda.synchronize(...)`` and ``.synchronize()`` on a stream or
  an event — the counterparts of ``block_until_ready``;
* ``.cpu()`` / ``.numpy()`` / ``.tolist()`` / ``.to("cpu")`` whose
  receiver is a DEVICE EXPRESSION: a chain of method calls, attribute
  reads and subscripts rooted in a call to a known device dispatch (the
  walker's registry of kernel wrappers and the defs that return their
  results, resolved across import edges) or in a ``torch.`` call;
* ``np.asarray(E)`` / ``np.array(E)`` over a device expression;
* ``int(E)`` / ``float(E)`` / ``bool(E)`` over a device expression
  (implicit ``__int__``/``__bool__`` syncs).

A chain is judged once, at its first host copy: ``torch.x(...).cpu()
.numpy()`` is one finding, at the ``.cpu()``.  Attribute reads and
slices of a name (``self.bins[:n].cpu().numpy()``) are deliberately
NOT flagged — spilled host runs hold tensors and numpy columns under
the same attribute names, and a type-blind ``.cpu()`` rule would flag
dozens of host reads in those four directories; the call-rooted rule
is the precision/recall trade this codebase needs, as in the JAX
analyzer.
"""

from __future__ import annotations

import ast

from ..walker import _dotted, device_rooted, is_to_cpu

__all__ = ["HostSyncCheck"]

_CAST_FNS = {"int", "float", "bool"}
_NP_SYNC_FNS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
_COPY_METHODS = {"cpu", "numpy", "tolist"}


def _device_span_ranges(tree) -> list[tuple[int, int]]:
    """(start, end) line ranges of ``with device_span(...):`` bodies —
    the sanctioned sync sites."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                ce = item.context_expr
                if isinstance(ce, ast.Call) \
                        and _dotted(ce.func).endswith("device_span"):
                    out.append((node.lineno,
                                node.end_lineno or node.lineno))
                    break
    return out


def _in_ranges(line: int, ranges) -> bool:
    return any(lo <= line <= hi for lo, hi in ranges)


def _function_spans(tree) -> list[tuple[int, int, str]]:
    """``(start, end, name)`` for every def — innermost match names a
    finding's site so the line-independent baseline key stays UNIQUE
    per violation (a new identical sync in another function of a
    baselined file must NOT match the old entry)."""
    return [(n.lineno, n.end_lineno or n.lineno, n.name)
            for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _site_of(line: int, spans) -> str:
    name, width = "<module>", None
    for lo, hi, fn in spans:
        if lo <= line <= hi and (width is None or hi - lo < width):
            name, width = fn, hi - lo
    return name


class HostSyncCheck:
    id = "host-sync"
    description = ("device→host syncs (.item(), .cpu()/.numpy()/.tolist()/"
                   "np.asarray/int()/float()/bool() on device values, "
                   "torch.cuda.synchronize and stream/event "
                   ".synchronize()) in hot scan paths outside device_span")

    def run(self, mod, project):
        if not project.is_hot_path(mod):
            return
        fns = project.device_names(mod)
        sanctioned = _device_span_ranges(mod.tree)
        spans = _function_spans(mod.tree)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) \
                    or _in_ranges(node.lineno, sanctioned):
                continue
            site = f" (in `{_site_of(node.lineno, spans)}`)"
            f = node.func
            method = f.attr if isinstance(f, ast.Attribute) else None
            if method == "item" and not node.args:
                yield mod.finding(
                    self.id, node,
                    "`.item()` forces a device→host transfer in a hot "
                    "path — materialize under obs.device_span (or keep "
                    "the value on device)" + site)
                continue
            dotted = _dotted(f)
            if method == "synchronize":
                what = "torch.cuda.synchronize" \
                    if dotted == "torch.cuda.synchronize" \
                    else ".synchronize()"
                yield mod.finding(
                    self.id, node,
                    f"`{what}` outside obs.device_span — the blocked "
                    f"wall time is invisible to trace attribution" + site)
                continue
            if (method in _COPY_METHODS and not node.args
                    or is_to_cpu(node)):
                if device_rooted(f.value, fns):
                    shown = ".to(\"cpu\")" if method == "to" \
                        else f".{method}()"
                    yield mod.finding(
                        self.id, node,
                        f"`{shown}` materializes a device dispatch outside "
                        f"obs.device_span — the sync is real but "
                        f"unattributed; wrap the dispatch in "
                        f"device_span{site}")
                continue
            if not node.args:
                continue
            arg = node.args[0]
            if dotted in _NP_SYNC_FNS and device_rooted(arg, fns):
                yield mod.finding(
                    self.id, node,
                    f"`{dotted}(...)` materializes a device dispatch "
                    f"outside obs.device_span — the sync is real but "
                    f"unattributed; wrap the dispatch in "
                    f"device_span{site}")
            elif isinstance(f, ast.Name) and f.id in _CAST_FNS \
                    and device_rooted(arg, fns):
                yield mod.finding(
                    self.id, node,
                    f"`{f.id}()` on a device value implicitly syncs in "
                    f"a hot path — materialize under obs.device_span "
                    f"first{site}")
