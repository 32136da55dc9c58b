"""Visibility expressions: boolean auth labels on features.

The port's copy of the JAX package's ``security/visibility.py``.

Re-implementation of the reference's VisibilityEvaluator
(geomesa-security/.../security/VisibilityEvaluator.scala:22-142), which
parses Accumulo-style visibility strings — ``a&b``, ``a|b``, parens,
quoted tokens — and evaluates them against a caller's authorization set.
The grammar (precedence: ``&`` binds tighter than ``|`` is NOT how
Accumulo works — Accumulo requires explicit parens when mixing operators,
and so does the reference; we enforce the same rule).

The columnar twist: feature visibilities are low-cardinality, so
:func:`visibility_mask` dictionary-encodes the visibility column,
evaluates each distinct expression once, and gathers a boolean mask —
O(unique) parses for O(N) features.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

__all__ = ["VisibilityExpression", "parse_visibility", "visibility_mask"]

_TOKEN = re.compile(r"\s*(?:(?P<and>&)|(?P<or>\|)|(?P<open>\()|(?P<close>\))"
                    r"|(?P<quoted>\"(?:[^\"\\]|\\.)*\")"
                    r"|(?P<value>[A-Za-z0-9_\-.:/]+))")


@dataclass(frozen=True)
class _Node:
    kind: str              # "value" | "and" | "or"
    value: str | None = None
    children: tuple = ()

    def evaluate(self, auths: frozenset) -> bool:
        if self.kind == "value":
            return self.value in auths
        if self.kind == "and":
            return all(c.evaluate(auths) for c in self.children)
        return any(c.evaluate(auths) for c in self.children)


@dataclass(frozen=True)
class VisibilityExpression:
    """A parsed visibility expression; empty string = visible to all."""

    raw: str
    root: _Node | None

    def evaluate(self, auths) -> bool:
        if self.root is None:
            return True
        return self.root.evaluate(frozenset(auths))


def _tokenize(text: str):
    pos, out = 0, []
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m or m.end() == m.start():
            raise ValueError(f"invalid visibility at {text[pos:pos+10]!r}")
        kind = m.lastgroup
        tok = m.group(kind)
        if kind == "quoted":
            tok = tok[1:-1].replace('\\"', '"').replace("\\\\", "\\")
            kind = "value"
        out.append((kind, tok))
        pos = m.end()
    return out


def _parse(tokens, i):
    """term ( (&|'|') term )* — mixing & and | without parens is an error,
    matching VisibilityEvaluator.scala's grammar."""
    terms, ops = [], []
    term, i = _parse_term(tokens, i)
    terms.append(term)
    while i < len(tokens) and tokens[i][0] in ("and", "or"):
        ops.append(tokens[i][0])
        i += 1
        term, i = _parse_term(tokens, i)
        terms.append(term)
    if not ops:
        return terms[0], i
    if len(set(ops)) > 1:
        raise ValueError("cannot mix & and | without parentheses")
    return _Node(ops[0], children=tuple(terms)), i


def _parse_term(tokens, i):
    if i >= len(tokens):
        raise ValueError("unexpected end of visibility expression")
    kind, tok = tokens[i]
    if kind == "value":
        return _Node("value", value=tok), i + 1
    if kind == "open":
        node, i = _parse(tokens, i + 1)
        if i >= len(tokens) or tokens[i][0] != "close":
            raise ValueError("unbalanced parentheses in visibility")
        return node, i + 1
    raise ValueError(f"unexpected token {tok!r} in visibility")


@lru_cache(maxsize=4096)
def parse_visibility(text: str) -> VisibilityExpression:
    text = (text or "").strip()
    if not text:
        return VisibilityExpression("", None)
    tokens = _tokenize(text)
    root, i = _parse(tokens, 0)
    if i != len(tokens):
        raise ValueError(f"trailing tokens in visibility {text!r}")
    return VisibilityExpression(text, root)


def visibility_mask(vis_column, auths) -> np.ndarray:
    """Boolean mask over a column of visibility strings for an auth set.

    Dictionary-encodes the (low-cardinality) column and evaluates each
    distinct expression once — the columnar replacement for the row-wise
    VisibilityFilter the reference applies in its iterators.
    """
    vis = np.asarray(vis_column, dtype=object)
    auths_f = frozenset(auths)
    uniq, inverse = np.unique(vis.astype(str), return_inverse=True)
    allowed = np.array(
        [parse_visibility(u).evaluate(auths_f) for u in uniq], dtype=bool)
    return allowed[inverse].reshape(vis.shape)
