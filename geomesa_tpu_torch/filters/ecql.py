"""ECQL text parser: the query language front door.

A recursive-descent parser for the subset of (E)CQL the reference's users
actually write (GeoTools ECQL is the reference's parser; the grammar here
covers the predicates its planner understands — spatial, temporal,
comparison, logical).  Examples:

    BBOX(geom, -10, 35, 15, 52) AND dtg DURING 2018-01-01T00:00:00Z/2018-01-08T00:00:00Z
    INTERSECTS(geom, POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0)))
    name = 'alice' OR age >= 21
    vessel_id IN ('a', 'b') AND NOT flag = 'x'
"""

from __future__ import annotations

import datetime as _dt
import re

from ..geometry.wkt import geometry_from_wkt
from .ast import (
    And, BBox, Between, Contains, During, DWithin, Exclude, Filter,
    GeomEquals, IdFilter, In, Include, Intersects, Like, Not, Or,
    PropertyCompare, Within, Touches, Crosses, Overlaps,
)

__all__ = ["parse_ecql", "parse_iso_ms"]

_TOKEN_RE = re.compile(
    r"""
    \s*(?:
        (?P<string>'(?:[^']|'')*')
      | (?P<datetime>\d{4}-\d{2}-\d{2}T[\d:.]+Z?)
      | (?P<number>-?\d+\.?\d*(?:[eE][+-]?\d+)?)
      | (?P<op><=|>=|<>|!=|=|<|>)
      | (?P<punct>[(),/])
      | (?P<qword>"[^"]*")
      | (?P<word>[$A-Za-z_][A-Za-z0-9_.:\[\]]*)
    )""",
    re.VERBOSE,
)

_KEYWORDS = {
    "AND", "OR", "NOT", "IN", "LIKE", "ILIKE", "BETWEEN", "DURING", "BEFORE",
    "AFTER", "INCLUDE", "EXCLUDE", "BBOX", "INTERSECTS", "CONTAINS", "WITHIN",
    "DWITHIN", "DISJOINT", "EQUALS", "BEYOND", "IS", "NULL", "TEQUALS",
    "TOUCHES", "CROSSES", "OVERLAPS",
}

_GEOM_WORDS = {
    "POINT", "LINESTRING", "POLYGON", "MULTIPOINT", "MULTILINESTRING",
    "MULTIPOLYGON",
}


def _iso_ms(s: str) -> int:
    s = s.strip()
    if s.endswith("Z"):
        s = s[:-1]
    dt = _dt.datetime.fromisoformat(s).replace(tzinfo=_dt.timezone.utc)
    epoch = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
    delta = dt - epoch
    return delta.days * 86_400_000 + delta.seconds * 1000 + delta.microseconds // 1000


def parse_iso_ms(s: str) -> int:
    """ISO-8601 (UTC assumed) → epoch millis."""
    return _iso_ms(s)


class _Tokens:
    def __init__(self, text: str):
        self.text = text
        self.toks: list[tuple[str, str]] = []
        pos = 0
        while pos < len(text):
            if text[pos].isspace():
                pos += 1
                continue
            m = _TOKEN_RE.match(text, pos)
            if not m:
                raise ValueError(f"cannot tokenize ECQL at: {text[pos:pos+30]!r}")
            kind = m.lastgroup
            val = m.group(kind)
            if kind == "qword":
                # double-quoted property name (json-path props, reserved
                # words as attributes): stays a distinct token kind so
                # keyword matching never applies to it
                val = val[1:-1]
            self.toks.append((kind, val))
            pos = m.end()
        self.i = 0

    def peek(self, ahead: int = 0):
        j = self.i + ahead
        return self.toks[j] if j < len(self.toks) else (None, None)

    def next(self):
        tok = self.peek()
        self.i += 1
        return tok

    def expect(self, value: str):
        kind, val = self.next()
        if val is None or (val != value and val.upper() != value):
            got = "end of input" if val is None else repr(val)
            raise ValueError(f"expected {value!r}, got {got} in {self.text!r}")
        return val

    def at_word(self, word: str) -> bool:
        kind, val = self.peek()
        return kind == "word" and val.upper() == word


def parse_ecql(text: str) -> Filter:
    text = text.strip()
    if not text or text.upper() == "INCLUDE":
        return Include
    if text.upper() == "EXCLUDE":
        return Exclude
    toks = _Tokens(text)
    f = _parse_or(toks)
    if toks.peek()[0] is not None:
        raise ValueError(f"unexpected trailing tokens in {text!r}")
    return f


def _parse_or(toks: _Tokens) -> Filter:
    parts = [_parse_and(toks)]
    while toks.at_word("OR"):
        toks.next()
        parts.append(_parse_and(toks))
    return parts[0] if len(parts) == 1 else Or(tuple(parts))


def _parse_and(toks: _Tokens) -> Filter:
    parts = [_parse_unary(toks)]
    while toks.at_word("AND"):
        toks.next()
        parts.append(_parse_unary(toks))
    return parts[0] if len(parts) == 1 else And(tuple(parts))


def _parse_unary(toks: _Tokens) -> Filter:
    if toks.at_word("NOT"):
        toks.next()
        return Not(_parse_unary(toks))
    kind, val = toks.peek()
    if kind == "punct" and val == "(":
        toks.next()
        inner = _parse_or(toks)
        toks.expect(")")
        return inner
    return _parse_predicate(toks)


def _parse_wkt(toks: _Tokens):
    """Re-assemble a WKT literal from tokens (numbers, parens, commas)."""
    kind, word = toks.next()
    if kind != "word" or word.upper() not in _GEOM_WORDS:
        raise ValueError(f"expected WKT geometry, got {word!r}")
    parts = [word.upper()]
    depth = 0
    while True:
        kind, val = toks.peek()
        if kind is None:
            break
        if kind == "punct" and val == "(":
            depth += 1
            parts.append("(")
            toks.next()
        elif kind == "punct" and val == ")":
            if depth == 0:
                break
            depth -= 1
            parts.append(")")
            toks.next()
            if depth == 0:
                break
        elif kind == "punct" and val == ",":
            parts.append(",")
            toks.next()
        elif kind == "number":
            parts.append(val)
            toks.next()
        else:
            break
    return geometry_from_wkt(" ".join(parts))


def _literal(kind: str, val: str):
    if kind == "string":
        return val[1:-1].replace("''", "'")
    if kind == "number":
        f = float(val)
        return int(f) if f.is_integer() and "." not in val and "e" not in val.lower() else f
    if kind == "datetime":
        return _iso_ms(val)
    if kind == "word" and val.lower() in ("true", "false"):
        # boolean literals (the CQL spec's booleanValueExpression)
        return val.lower() == "true"
    raise ValueError(f"expected literal, got {val!r}")


def _parse_literal_list(toks: _Tokens, what: str) -> list:
    """Parse '( literal, literal, … )' after IN."""
    toks.expect("(")
    values = []
    while True:
        k, v = toks.next()
        values.append(_literal(k, v))
        k, v = toks.next()
        if v == ")":
            break
        if v != ",":
            raise ValueError(f"bad {what} list near {v!r}")
    return values


def _parse_predicate(toks: _Tokens) -> Filter:
    kind, val = toks.next()
    if kind not in ("word", "qword"):
        raise ValueError(f"expected predicate, got {val!r}")
    if kind == "qword":
        # quoted: always a property name, never a keyword
        return _parse_property_predicate(toks, val)
    upper = val.upper()

    if upper == "INCLUDE":
        return Include
    if upper == "EXCLUDE":
        return Exclude

    if upper == "IN":
        # bare IN list = feature-id filter (GeoTools convention)
        return IdFilter(tuple(str(v) for v in _parse_literal_list(toks, "id")))

    if upper == "BBOX":
        toks.expect("(")
        _, prop = toks.next()
        nums = []
        for _ in range(4):
            toks.expect(",")
            nums.append(float(toks.next()[1]))
        # optional CRS argument, ignored
        if toks.peek()[1] == ",":
            toks.next()
            toks.next()
        toks.expect(")")
        return BBox(prop, *nums)

    if upper in ("INTERSECTS", "CONTAINS", "WITHIN", "DISJOINT", "EQUALS",
                 "TOUCHES", "CROSSES", "OVERLAPS"):
        toks.expect("(")
        _, prop = toks.next()
        toks.expect(",")
        geom = _parse_wkt(toks)
        toks.expect(")")
        if upper == "DISJOINT":  # exact complement of INTERSECTS
            return Not(Intersects(prop, geom))
        if upper == "EQUALS":
            return GeomEquals(prop, geom)
        cls = {"INTERSECTS": Intersects, "CONTAINS": Contains,
               "WITHIN": Within, "TOUCHES": Touches, "CROSSES": Crosses,
               "OVERLAPS": Overlaps}[upper]
        return cls(prop, geom)

    if upper in ("DWITHIN", "BEYOND"):
        toks.expect("(")
        _, prop = toks.next()
        toks.expect(",")
        geom = _parse_wkt(toks)
        toks.expect(",")
        dist = float(toks.next()[1])
        # optional units, either ", kilometers" (ECQL) or a bare word —
        # converted to meters via the reference's multiplier
        # (GeometryProcessing.metersMultiplier); no units = degrees
        meters = False
        if toks.peek()[1] == ",":
            toks.next()
        if toks.peek()[0] == "word" and toks.peek()[1].upper() not in _KEYWORDS:
            unit = toks.next()[1].lower()
            mult = {"meters": 1.0, "kilometers": 1000.0, "feet": 0.3048,
                    "statute": None, "nautical": None}.get(unit, 1.0)
            if mult is None:  # two-word units: 'statute miles' etc.
                word2 = toks.next()[1].lower()
                mult = {"statute miles": 1609.347,
                        "nautical miles": 1852.0}.get(f"{unit} {word2}", 1.0)
            dist *= mult
            meters = True
        toks.expect(")")
        dw = DWithin(prop, geom, dist, meters=meters)
        return Not(dw) if upper == "BEYOND" else dw

    # property-led predicates
    return _parse_property_predicate(toks, val)


def _parse_property_predicate(toks: _Tokens, prop: str) -> Filter:
    kind, val = toks.next()
    if kind == "word":
        upper = val.upper()
        if upper == "DURING":
            _, lo = toks.next()
            toks.expect("/")
            _, hi = toks.next()
            return During(prop, _iso_ms(lo), _iso_ms(hi))
        if upper in ("BEFORE", "AFTER", "TEQUALS"):
            _, t = toks.next()
            ms = _iso_ms(t)
            if upper == "BEFORE":
                return During(prop, None, ms - 1)
            if upper == "AFTER":
                return During(prop, ms + 1, None)
            return During(prop, ms, ms)
        if upper == "IN":
            return In(prop, tuple(_parse_literal_list(toks, "IN")))
        if upper in ("LIKE", "ILIKE"):
            k, v = toks.next()
            return Like(prop, _literal(k, v), case_insensitive=(upper == "ILIKE"))
        if upper == "BETWEEN":
            k, v = toks.next()
            lo = _literal(k, v)
            if not toks.at_word("AND"):
                raise ValueError("BETWEEN requires AND")
            toks.next()
            k, v = toks.next()
            return Between(prop, lo, _literal(k, v))
        if upper == "IS":
            # IS [NOT] NULL → not supported as storage has no nulls yet;
            # IS NULL matches nothing, IS NOT NULL matches everything
            if toks.at_word("NOT"):
                toks.next()
                toks.expect("NULL")
                return Include
            toks.expect("NULL")
            return Exclude
        raise ValueError(f"unsupported predicate {val!r} after {prop!r}")
    if kind == "op":
        op = "<>" if val == "!=" else val
        k, v = toks.next()
        lit = _literal(k, v)
        # date comparisons normalize onto During intervals
        if k == "datetime":
            if op == "=":
                return During(prop, lit, lit)
            if op == "<":
                return During(prop, None, lit - 1)
            if op == "<=":
                return During(prop, None, lit)
            if op == ">":
                return During(prop, lit + 1, None)
            if op == ">=":
                return During(prop, lit, None)
        return PropertyCompare(prop, op, lit)
    raise ValueError(f"cannot parse predicate starting at {prop!r}")
