"""Converter transform expressions, evaluated vectorized over columns.

The reference's converter expression language (geomesa-convert-common/
.../transforms/Expression.scala + ExpressionParser: ``$N`` field refs,
function calls, literals) re-designed for columnar evaluation: every
expression maps a dict of input columns to an output column in one numpy
operation — no per-record interpretation.

Grammar:  expr := func '(' expr (',' expr)* ')' | '$' ref | literal
Functions cover the reference's common registry (date/geo/string/id/math).

The port's copy of the JAX package's ``io/expressions.py``: the same
grammar and functions, over numpy columns on the host.  ``uuidZ3`` takes
its z3 prefix from :func:`~geomesa_tpu_torch.utils.feature_id.
z3_feature_ids` and ``projectFrom`` reprojects through
:mod:`~geomesa_tpu_torch.geometry.crs`.
"""

from __future__ import annotations

import hashlib
import re
import uuid as _uuid

import numpy as np

__all__ = ["parse_expression", "Expression", "expr_refs"]

# the $-reference charset; keep in sync with the tokenizer's dollar group
_REF_RE = re.compile(r"\$([A-Za-z0-9_./@-]+)")


def expr_refs(expr_text: str) -> list[str]:
    """All ``$name`` column references in a transform expression."""
    return _REF_RE.findall(expr_text or "")


class Expression:
    def evaluate(self, cols: dict) -> np.ndarray:
        raise NotImplementedError


class _Ref(Expression):
    def __init__(self, name: str):
        self.name = name

    def evaluate(self, cols):
        return np.asarray(cols[self.name])


class _Lit(Expression):
    def __init__(self, value):
        self.value = value

    def evaluate(self, cols):
        n = len(next(iter(cols.values()))) if cols else 1
        return np.full(n, self.value, dtype=object if isinstance(self.value, str) else None)


class _Call(Expression):
    def __init__(self, fn: str, args: list):
        self.fn = fn
        self.args = args

    def evaluate(self, cols):
        impl = _FUNCTIONS.get(self.fn)
        if impl is None:
            raise ValueError(f"unknown converter function {self.fn!r}")
        return impl(cols, *self.args)


def _num(cols, e, dtype):
    v = e.evaluate(cols)
    if v.dtype == object or v.dtype.kind in ("U", "S"):
        return np.asarray([dtype(x) for x in v])
    return v.astype(dtype)


def _strcol(cols, e):
    v = e.evaluate(cols)
    return v.astype(str) if v.dtype != object else np.asarray([str(x) for x in v])


def _fn_date(cols, fmt_e, val_e):
    fmt = fmt_e.value if isinstance(fmt_e, _Lit) else None
    raw = val_e.evaluate(cols)
    # the delimited reader may already have inferred a timestamp column
    if raw.dtype.kind == "M":
        return raw.astype("M8[ms]").astype(np.int64)
    vals = _strcol(cols, val_e)
    import pandas as pd
    # java SimpleDateFormat-style patterns → strftime
    if fmt:
        fmt = (fmt.replace("yyyy", "%Y").replace("MM", "%m").replace("dd", "%d")
               .replace("HH", "%H").replace("mm", "%M").replace("ss", "%S")
               .replace("SSS", "%f").replace("'T'", "T").replace("'Z'", "Z"))
        ts = pd.to_datetime(vals, format=fmt, utc=True)
    else:
        ts = pd.to_datetime(vals, utc=True)
    # resolution-robust: pandas may infer s/ms/ns units depending on the
    # format (date-only patterns parse at second resolution in pandas 2);
    # drop the UTC tz before the numpy view (values are already UTC)
    return (ts.tz_localize(None).to_numpy()
            .astype("datetime64[ms]").astype(np.int64))


def _fn_isodate(cols, val_e):
    return _fn_date(cols, _Lit(None), val_e)


def _fn_millis(cols, e):
    return _num(cols, e, np.int64)


def _fn_seconds(cols, e):
    return _num(cols, e, np.int64) * 1000


def _fn_point(cols, x_e, y_e):
    return (_num(cols, x_e, np.float64), _num(cols, y_e, np.float64))


def _fn_geometry(cols, wkt_e):
    from ..geometry.wkt import geometry_from_wkt
    return np.asarray([geometry_from_wkt(w) for w in _strcol(cols, wkt_e)],
                      dtype=object)


def _fn_concat(cols, *es):
    parts = [_strcol(cols, e) for e in es]
    out = parts[0]
    for p in parts[1:]:
        out = np.char.add(out.astype(str), p.astype(str))
    return out.astype(object)


def _fn_md5(cols, e):
    return np.asarray([hashlib.md5(str(v).encode()).hexdigest()
                       for v in e.evaluate(cols)], dtype=object)


def _fn_uuid(cols):
    n = len(next(iter(cols.values()))) if cols else 1
    return np.asarray([str(_uuid.uuid4()) for _ in range(n)], dtype=object)


def _fn_uuid_z3(cols, x_e, y_e, dtg_e, period_e=None):
    """uuidZ3($x, $y, $dtg [, 'week']) — version-4 UUIDs with a z3-prefix
    for write locality (Z3FeatureIdGenerator,
    utils/uuid/Z3FeatureIdGenerator.scala).  Columnar signature: the
    reference passes a geometry; here x/y ride as separate columns.  The
    optional period literal must match the target schema's
    ``geomesa.z3.interval`` so id prefixes sort like the index keys."""
    from ..utils.feature_id import z3_feature_ids

    x = _num(cols, x_e, np.float64)
    y = _num(cols, y_e, np.float64)
    t = _num(cols, dtg_e, np.int64)
    period = period_e.value if period_e is not None else "week"
    return np.asarray(z3_feature_ids(x, y, t, period=period), dtype=object)


def _fn_wkt_geom(kind: str):
    """Typed WKT parser functions (GeometryFunctionFactory: polygon(),
    linestring(), …): parse and verify the geometry kind."""
    def fn(cols, wkt_e):
        from ..geometry.wkt import geometry_from_wkt
        wkts = _strcol(cols, wkt_e)
        out = np.empty(len(wkts), dtype=object)
        for i, w in enumerate(wkts):
            g = geometry_from_wkt(w)
            got = type(g).__name__.lower()
            if got != kind:
                raise ValueError(f"{kind}() parsed a {got}: {w!r}")
            out[i] = g
        return out
    return fn


def _fn_strip(cols, e, chars_e=None):
    vals = _strcol(cols, e)
    chars = chars_e.value if chars_e is not None else None
    return np.asarray([v.strip(chars) for v in vals], dtype=object)


def _fn_printf(cols, fmt_e, *es):
    """printf('%s-%s', $1, $2) — java-format % conversions per row."""
    fmt = fmt_e.value
    parts = [e.evaluate(cols) for e in es]
    n = len(parts[0]) if parts else (
        len(next(iter(cols.values()))) if cols else 1)
    return np.asarray([fmt % tuple(p[i] for p in parts)
                       for i in range(n)], dtype=object)


def _fn_with_default(cols, e, default_e):
    vals = e.evaluate(cols)
    default = default_e.evaluate(cols)
    out = np.array(vals, dtype=object, copy=True)
    missing = np.asarray([v is None or v != v if isinstance(v, float)
                          else v is None for v in vals], dtype=bool)
    out[missing] = default[missing] if np.ndim(default) else default
    return out


def _fn_require(cols, e):
    vals = e.evaluate(cols)
    bad = [i for i, v in enumerate(vals) if v is None or v == ""]
    if bad:
        raise ValueError(
            f"require() failed for {len(bad)} record(s), first at row {bad[0]}")
    return vals


def _fn_list(cols, e, delim_e=None):
    delim = delim_e.value if delim_e is not None else ","
    vals = _strcol(cols, e)
    # 1-D object array of python lists (equal-length splits would
    # otherwise collapse into a 2-D array)
    out = np.empty(len(vals), dtype=object)
    for i, v in enumerate(vals):
        out[i] = v.split(delim)
    return out


def _fn_list_item(cols, e, idx_e):
    idx = int(idx_e.value)
    # short rows yield None instead of aborting the batch (ragged CSVs)
    return np.asarray(
        [v[idx] if isinstance(v, (list, tuple)) and -len(v) <= idx < len(v)
         else None for v in e.evaluate(cols)], dtype=object)


def _fn_mkstring(cols, delim_e, *es):
    """mkstring('|', $a, $b) — delimiter-joined row values.  Arguments
    evaluate once per column (not per row)."""
    delim = delim_e.value
    parts = [e.evaluate(cols) for e in es]
    n = len(parts[0]) if parts else 0
    return np.asarray([delim.join(str(p[i]) for p in parts)
                       for i in range(n)], dtype=object)


def _binop_math(op, identity=None):
    def fn(cols, *es):
        acc = _num(cols, es[0], np.float64)
        for e in es[1:]:
            acc = op(acc, _num(cols, e, np.float64))
        return acc
    return fn




def _fn_named_date(fmt):
    """Named date-format parser (the reference's joda-named formats,
    DateFunctionFactory.scala: basicDate, isoLocalDate, ...)."""
    def parse(cols, e):
        return _fn_date(cols, _Lit(fmt), e)
    return parse


def _fn_date_to_string(cols, fmt_e, e):
    """Format epoch-ms dates back to strings (dateToString)."""
    import pandas as pd
    fmt = (fmt_e.value
           .replace("yyyy", "%Y").replace("MM", "%m").replace("dd", "%d")
           .replace("HH", "%H").replace("mm", "%M").replace("ss", "%S")
           .replace("SSS", "%f").replace("'T'", "T").replace("'Z'", "Z"))
    ms = np.asarray(e.evaluate(cols), dtype=np.int64)
    ts = pd.to_datetime(ms, unit="ms", utc=True)
    if "%f" in fmt:
        # strftime %f renders 6-digit microseconds but the SSS pattern
        # asked for millis — and a literal may FOLLOW it (….SSS'Z'), so
        # an endswith('000') fixup misses; render the millis ourselves
        fmt = fmt.replace("%f", "{MILLIS}")
        out = [v.replace("{MILLIS}", f"{int(m) % 1000:03d}")
               for v, m in zip(ts.strftime(fmt), ms)]
    else:
        out = ts.strftime(fmt)
    return np.asarray(list(out), dtype=object)


def _fn_project_from(cols, epsg_e, xy_e):
    """Reproject a point column from the given EPSG code to 4326
    (projectFrom, GeometryFunctionFactory.scala)."""
    from ..geometry.crs import transform
    xy = xy_e.evaluate(cols)
    if not isinstance(xy, tuple):
        raise ValueError("projectFrom expects a point() argument")
    x, y = xy
    return transform(np.asarray(x, np.float64), np.asarray(y, np.float64),
                     str(epsg_e.value), "EPSG:4326")


def _fn_parse_list(cols, type_e, e, delim_e=None):
    """parseList('int', $0[, ';']) — typed list column
    (CollectionFunctionFactory.scala)."""
    delim = delim_e.value if delim_e is not None else ","
    cast = {"int": int, "integer": int, "long": int, "float": float,
            "double": float, "string": str, "str": str,
            "bool": lambda v: v.lower() in ("true", "1"),
            "boolean": lambda v: v.lower() in ("true", "1")}[
        str(type_e.value).lower()]
    return np.asarray(
        [[cast(p.strip()) for p in str(v).split(delim) if p.strip()]
         if v is not None and str(v).strip() else []
         for v in e.evaluate(cols)], dtype=object)


def _fn_parse_map(cols, types_e, e, kv_delim_e=None, delim_e=None):
    """parseMap('string->int', $0[, '->'[, ',']]) — typed dict column."""
    kv = kv_delim_e.value if kv_delim_e is not None else "->"
    delim = delim_e.value if delim_e is not None else ","
    vt = str(types_e.value).split("->")[-1].strip().lower()
    cast = {"int": int, "integer": int, "long": int, "float": float,
            "double": float, "string": str, "str": str}.get(vt, str)
    out = []
    for v in e.evaluate(cols):
        d = {}
        if v is not None and str(v).strip():
            for part in str(v).split(delim):
                if kv in part:
                    k, _, val = part.partition(kv)
                    d[k.strip()] = cast(val.strip())
        out.append(d)
    return np.asarray(out, dtype=object)


def _fn_map_value(cols, map_e, key_e):
    key = key_e.value if isinstance(key_e, _Lit) else None
    maps = map_e.evaluate(cols)
    if key is not None:
        return np.asarray([m.get(key) if isinstance(m, dict) else None
                           for m in maps], dtype=object)
    keys = key_e.evaluate(cols)
    return np.asarray(
        [m.get(k) if isinstance(m, dict) else None
         for m, k in zip(maps, keys)], dtype=object)


_FUNCTIONS = {
    "toint": lambda cols, e: _num(cols, e, np.int32),
    "tolong": lambda cols, e: _num(cols, e, np.int64),
    "todouble": lambda cols, e: _num(cols, e, np.float64),
    "tofloat": lambda cols, e: _num(cols, e, np.float32),
    "tostring": lambda cols, e: _strcol(cols, e).astype(object),
    "trim": lambda cols, e: np.char.strip(_strcol(cols, e)).astype(object),
    "lowercase": lambda cols, e: np.char.lower(_strcol(cols, e)).astype(object),
    "uppercase": lambda cols, e: np.char.upper(_strcol(cols, e)).astype(object),
    "date": _fn_date,
    "isodate": _fn_isodate,
    "datetime": _fn_isodate,
    "millistodate": _fn_millis,
    "secstodate": _fn_seconds,
    "point": _fn_point,
    "geometry": _fn_geometry,
    "concat": _fn_concat,
    "concatenate": _fn_concat,
    "md5": _fn_md5,
    "uuid": lambda cols: _fn_uuid(cols),
    "cachelookup": lambda cols, name_e, key_e, field_e: _fn_cache_lookup(
        cols, name_e, key_e, field_e),
    # strings (StringFunctionFactory.scala registry)
    "capitalize": lambda cols, e: np.asarray(
        [v.capitalize() for v in _strcol(cols, e)], dtype=object),
    "strlen": lambda cols, e: np.asarray(
        [len(v) for v in _strcol(cols, e)], dtype=np.int32),
    "length": lambda cols, e: np.asarray(
        [len(v) for v in _strcol(cols, e)], dtype=np.int32),
    "strip": _fn_strip,
    "stripquotes": lambda cols, e: np.asarray(
        [v.strip("'\"") for v in _strcol(cols, e)], dtype=object),
    "stripprefix": lambda cols, e, p: np.asarray(
        [v[len(p.value):] if v.startswith(p.value) else v
         for v in _strcol(cols, e)], dtype=object),
    "stripsuffix": lambda cols, e, s: np.asarray(
        [v[: -len(s.value)] if v.endswith(s.value) else v
         for v in _strcol(cols, e)], dtype=object),
    "replace": lambda cols, e, a, b: np.asarray(
        [v.replace(a.value, b.value) for v in _strcol(cols, e)],
        dtype=object),
    "remove": lambda cols, e, a: np.asarray(
        [v.replace(a.value, "") for v in _strcol(cols, e)], dtype=object),
    "regexreplace": lambda cols, pat, rep, e: np.asarray(
        [re.sub(pat.value, rep.value, v) for v in _strcol(cols, e)],
        dtype=object),
    "substr": lambda cols, e, a, b: np.asarray(
        [v[int(a.value):int(b.value)] for v in _strcol(cols, e)],
        dtype=object),
    "substring": lambda cols, e, a, b: np.asarray(
        [v[int(a.value):int(b.value)] for v in _strcol(cols, e)],
        dtype=object),
    "mkstring": lambda cols, d, *es: _fn_mkstring(cols, d, *es),
    "emptytonull": lambda cols, e: np.asarray(
        [None if v is None or str(v).strip() == "" else v
         for v in e.evaluate(cols)], dtype=object),
    "printf": _fn_printf,
    # math (MathFunctionFactory.scala)
    "add": _binop_math(np.add),
    "subtract": _binop_math(np.subtract),
    "multiply": _binop_math(np.multiply),
    "divide": _binop_math(np.divide),
    "mean": lambda cols, *es: np.mean(
        [_num(cols, e, np.float64) for e in es], axis=0),
    "min": lambda cols, *es: np.min(
        [_num(cols, e, np.float64) for e in es], axis=0),
    "max": lambda cols, *es: np.max(
        [_num(cols, e, np.float64) for e in es], axis=0),
    # misc (MiscFunctionFactory.scala)
    "withdefault": _fn_with_default,
    "require": _fn_require,
    "inttoboolean": lambda cols, e: _num(cols, e, np.int64) != 0,
    "lineno": lambda cols: np.arange(
        len(next(iter(cols.values()))) if cols else 0, dtype=np.int64),
    "linenumber": lambda cols: np.arange(
        len(next(iter(cols.values()))) if cols else 0, dtype=np.int64),
    "base64encode": lambda cols, e: np.asarray(
        [__import__("base64").b64encode(str(v).encode()).decode()
         for v in e.evaluate(cols)], dtype=object),
    "base64decode": lambda cols, e: np.asarray(
        [__import__("base64").b64decode(str(v)).decode()
         for v in e.evaluate(cols)], dtype=object),
    # collections (CollectionFunctionFactory.scala)
    "list": _fn_list,
    "listitem": _fn_list_item,
    "parselist": _fn_parse_list,
    "parsemap": _fn_parse_map,
    "mapvalue": _fn_map_value,
    # named date formats + helpers (DateFunctionFactory.scala)
    "now": lambda cols: np.full(
        len(next(iter(cols.values()))) if cols else 1,
        np.int64(__import__("time").time() * 1000)),
    "datetostring": _fn_date_to_string,
    "basicdate": _fn_named_date("yyyyMMdd"),
    "basicisodate": _fn_named_date("yyyyMMdd"),
    "basicdatetime": _fn_named_date("yyyyMMdd'T'HHmmss.SSSZ"),
    "basicdatetimenomillis": _fn_named_date("yyyyMMdd'T'HHmmssZ"),
    "isolocaldate": _fn_named_date("yyyy-MM-dd"),
    "isolocaldatetime": _fn_named_date("yyyy-MM-dd'T'HH:mm:ss"),
    "isooffsetdatetime": _fn_named_date(None),
    "datehourminutesecondmillis": _fn_named_date(
        "yyyy-MM-dd'T'HH:mm:ss.SSS"),
    # cast aliases (CastFunctionFactory.scala)
    "stringtoint": lambda cols, e: _num(cols, e, np.int32),
    "stringtointeger": lambda cols, e: _num(cols, e, np.int32),
    "stringtolong": lambda cols, e: _num(cols, e, np.int64),
    "stringtofloat": lambda cols, e: _num(cols, e, np.float32),
    "stringtodouble": lambda cols, e: _num(cols, e, np.float64),
    "stringtobool": lambda cols, e: np.asarray(
        [str(v).strip().lower() in ("true", "1", "t")
         for v in e.evaluate(cols)]),
    "stringtoboolean": lambda cols, e: np.asarray(
        [str(v).strip().lower() in ("true", "1", "t")
         for v in e.evaluate(cols)]),
    "stringtobytes": lambda cols, e: np.asarray(
        [str(v).encode("utf-8") for v in e.evaluate(cols)], dtype=object),
    "string2bytes": lambda cols, e: np.asarray(
        [str(v).encode("utf-8") for v in e.evaluate(cols)], dtype=object),
    # geometry (GeometryFunctionFactory.scala)
    "projectfrom": _fn_project_from,
    # ids (IdFunctionFactory / Z3FeatureIdGenerator)
    "uuidz3": _fn_uuid_z3,
    "uuidz3centroid": _fn_uuid_z3,  # centroid variant: caller passes the
                                    # centroid coords (we are columnar)
    # typed WKT constructors (GeometryFunctionFactory)
    "polygon": _fn_wkt_geom("polygon"),
    "linestring": _fn_wkt_geom("linestring"),
    "multipoint": _fn_wkt_geom("multipoint"),
    "multilinestring": _fn_wkt_geom("multilinestring"),
    "multipolygon": _fn_wkt_geom("multipolygon"),
}


def _fn_cache_lookup(cols, name_e, key_e, field_e):
    """cacheLookup('cache', $key, 'field') — enrichment join per row
    (EnrichmentCacheFunctionFactory.scala analog)."""
    from .enrichment import lookup_cache

    name = name_e.evaluate(cols)
    field = field_e.evaluate(cols)
    # literal args evaluate to scalars; key is usually a column
    name = name if isinstance(name, str) else str(np.asarray(name).flat[0])
    field = field if isinstance(field, str) else str(np.asarray(field).flat[0])
    cache = lookup_cache(name)
    keys = key_e.evaluate(cols)
    if np.ndim(keys) == 0:
        return cache.get(keys, field)
    return np.asarray([cache.get(k, field) for k in keys], dtype=object)

_TOKEN = re.compile(r"""\s*(?:
      (?P<dollar>\$[A-Za-z0-9_./@-]+)
    | (?P<string>'(?:[^']|'')*')
    | (?P<number>-?\d+\.?\d*)
    | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
    | (?P<punct>[(),])
)""", re.VERBOSE)


def parse_expression(text: str) -> Expression:
    toks = []
    pos = 0
    while pos < len(text):
        if text[pos].isspace():
            pos += 1
            continue
        m = _TOKEN.match(text, pos)
        if not m:
            raise ValueError(f"bad expression at {text[pos:pos+20]!r}")
        toks.append((m.lastgroup, m.group(m.lastgroup)))
        pos = m.end()
    expr, i = _parse(toks, 0)
    if i != len(toks):
        raise ValueError(f"trailing tokens in expression {text!r}")
    return expr


def _parse(toks, i):
    kind, val = toks[i]
    if kind == "dollar":
        return _Ref(val[1:]), i + 1
    if kind == "string":
        return _Lit(val[1:-1].replace("''", "'")), i + 1
    if kind == "number":
        f = float(val)
        return _Lit(int(f) if f.is_integer() and "." not in val else f), i + 1
    if kind == "name":
        fn = val.lower()
        if i + 1 < len(toks) and toks[i + 1][1] == "(":
            args = []
            j = i + 2
            if toks[j][1] != ")":
                while True:
                    arg, j = _parse(toks, j)
                    args.append(arg)
                    if toks[j][1] == ")":
                        break
                    if toks[j][1] != ",":
                        raise ValueError("expected ',' in argument list")
                    j += 1
            return _Call(fn, args), j + 1
        raise ValueError(f"bare name {val!r} in expression")
    raise ValueError(f"unexpected token {val!r}")
