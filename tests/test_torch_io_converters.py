"""Port parity: the converter framework (``io/converters.py``,
``io/expressions.py``, ``io/enrichment.py``), ``geometry/geojson.py``
and the text and shapefile exports of ``io/export.py``, through
geomesa_tpu_torch against geomesa_tpu on the same inputs.

Case for case the JAX oracles ``tests/test_io.py`` and
``tests/test_converter_hardening.py``: each converter config runs in both
packages and the batches (ids, columns, packed geometries), the
``EvaluationContext`` counters and error messages, a raised error's type
and message, and the ``log`` mode's records on the logger
``geomesa_tpu.convert`` must be equal; each transform expression gives
the same column; CSV, GeoJSON and shapefile exports are the same bytes.
``uuid()`` is random in both packages: its form is compared, and
``uuidZ3``'s z3 prefix (its first eight bytes)."""

import hashlib
import json
import logging
import types

import numpy as np
import pytest

import geomesa_tpu.features.batch as jbatch
import geomesa_tpu.features.feature_type as jft
import geomesa_tpu.geometry.geojson as jgeojson
import geomesa_tpu.geometry.types as jtypes
import geomesa_tpu.io.converters as jconv
import geomesa_tpu.io.enrichment as jenrich
import geomesa_tpu.io.export as jexport
import geomesa_tpu.io.expressions as jexpr
import geomesa_tpu.io.formats as jformats
import geomesa_tpu_torch.features.batch as tbatch
import geomesa_tpu_torch.features.feature_type as tft
import geomesa_tpu_torch.geometry.geojson as tgeojson
import geomesa_tpu_torch.geometry.types as ttypes
import geomesa_tpu_torch.io.converters as tconv
import geomesa_tpu_torch.io.enrichment as tenrich
import geomesa_tpu_torch.io.export as texport
import geomesa_tpu_torch.io.expressions as texpr
import geomesa_tpu_torch.io.formats as tformats

J = types.SimpleNamespace(ft=jft, batch=jbatch, conv=jconv, expr=jexpr,
                          export=jexport, formats=jformats, types=jtypes,
                          geojson=jgeojson, enrich=jenrich)
T = types.SimpleNamespace(ft=tft, batch=tbatch, conv=tconv, expr=texpr,
                          export=texport, formats=tformats, types=ttypes,
                          geojson=tgeojson, enrich=tenrich)

PEOPLE = "name:String,age:Int,dtg:Date,*geom:Point"
MS_2018 = 1514764800000


def _same(a, b):
    """Equal values: tuples part for part, object arrays by ``repr`` of
    each value (geometries, lists, dicts, None), the rest dtype and
    values."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    if a.dtype == object:
        assert [repr(v) for v in a.tolist()] == [repr(v) for v in b.tolist()]
    else:
        np.testing.assert_array_equal(a, b)


def _same_batch(tb, jb):
    assert len(tb) == len(jb)
    _same(tb.ids, jb.ids)
    assert tb.ids_explicit == jb.ids_explicit
    assert sorted(tb.columns) == sorted(jb.columns)
    for k, col in jb.columns.items():
        _same(tb.columns[k], col)
    assert (tb.geoms is None) == (jb.geoms is None)
    if jb.geoms is not None:
        for f in ("kinds", "coords", "ring_offsets", "part_ring_offsets",
                  "geom_part_offsets", "bbox"):
            np.testing.assert_array_equal(getattr(tb.geoms, f),
                                          getattr(jb.geoms, f))


def _same_outcome(fn):
    """Run ``fn(ns)`` in both packages: equal results, or the same error
    type and message.  Returns the port's result."""
    out = {}
    for key, ns in (("jax", J), ("port", T)):
        try:
            out[key] = ("ok", fn(ns))
        except Exception as e:  # noqa: BLE001 — compared below
            out[key] = ("raised", (type(e).__name__, str(e)))
    assert out["port"][0] == out["jax"][0], out
    if out["jax"][0] == "raised":
        assert out["port"][1] == out["jax"][1]
    return out["port"]


# -- converters (test_io.py, test_converter_hardening.py) -----------------

CSV = """2018-01-01 10:00:00,alice,42,-74.1,40.7
2018-01-01 11:30:00,bob,7,2.35,48.85
2018-01-02 09:15:00,carol,99,139.7,35.6
"""
GOOD = "id1,alice,30,1514764800000,-74.0,40.7\n"
BAD_INT = "id2,bob,notanumber,1514764800000,-74.1,40.8\n"
GOOD2 = "id3,carol,41,1514851200000,-73.9,40.6\n"
ZROWS = (GOOD + "id4,dan,20,1514764800000,-374.0,40.0\n"
         + "id5,eve,21,1514764800000,-74.0,95.0\n"
         + "id6,fay,22,-5,-74.0,40.0\n" + GOOD2)


def _hardening(**opts):
    return {"type": "csv", "id-field": "$0",
            "fields": [{"name": "name", "transform": "toString($1)"},
                       {"name": "age", "transform": "toInt($2)"},
                       {"name": "dtg", "transform": "toLong($3)"},
                       {"name": "geom", "transform": "point($4, $5)"}],
            "options": opts}


def _json_rows(*rows):
    return "\n".join(json.dumps(r) for r in rows)


GEOJSON_FC = json.dumps({"type": "FeatureCollection", "features": [
    {"type": "Feature", "id": "f1",
     "geometry": {"type": "Point", "coordinates": [1.0, 2.0]},
     "properties": {"title": "spot"}},
    {"type": "Feature", "id": "f2",
     "geometry": {"type": "Point", "coordinates": [-3.5, 4.25]},
     "properties": {"title": "other", "extra": 3}}]})

CASES = {
    "csv": (PEOPLE, {
        "type": "delimited-text", "format": "CSV", "id-field": "md5($1)",
        "fields": [
            {"name": "dtg", "transform": "date('yyyy-MM-dd HH:mm:ss', $0)"},
            {"name": "name", "transform": "$1"},
            {"name": "age", "transform": "toInt($2)"},
            {"name": "geom", "transform": "point($3, $4)"}]}, CSV),
    "csv-header": (PEOPLE, {
        "type": "csv", "options": {"header": True},
        "fields": [{"name": "name", "transform": "uppercase($who)"},
                   {"name": "age", "transform": "toInt($2)"},
                   {"name": "dtg", "transform": "isoDate($when)"},
                   {"name": "geom", "transform": "point($x, $y)"}]},
        "when,who,a,x,y\n2018-01-01T00:00:00Z,ann,5,1.5,2.5\n"
        "2018-01-03T12:00:00Z,ben,6,-1.5,-2.5\n"),
    "tsv-skip-lines": (PEOPLE, {
        "type": "tsv", "options": {"skip-lines": 1},
        "fields": [{"name": "name", "transform": "$0"},
                   {"name": "age", "transform": "lineNo()"},
                   {"name": "dtg", "transform": "basicDate($1)"},
                   {"name": "geom", "transform": "point($2, $3)"}]},
        "header\tline\tx\ty\nann\t20180105\t1.0\t2.0\n"
        "ben\t20180203\t3.0\t4.0\n"),
    "json": (PEOPLE, {
        "type": "json",
        "fields": [{"name": "dtg", "transform": "millisToDate($ts)"},
                   {"name": "name", "transform": "$user.name"},
                   {"name": "age", "transform": "toInt($age)"},
                   {"name": "geom", "transform": "point($lon, $lat)"}]},
        _json_rows({"ts": MS_2018, "user": {"name": "a"}, "age": 1,
                    "lon": 0.5, "lat": 1.5},
                   {"ts": MS_2018 + 1, "user": {"name": "b"}, "age": 2,
                    "lon": 2.5, "lat": 3.5})),
    "json-array": (PEOPLE, {
        "type": "json", "id-field": "concat('p-', $user.name)",
        "fields": [{"name": "dtg", "transform": "secsToDate($ts)"},
                   {"name": "name", "transform": "$user.name"},
                   {"name": "geom", "transform": "point($lon, $lat)"}]},
        json.dumps([{"ts": 1514764800, "user": {"name": "c"}, "lon": 9.0,
                     "lat": 8.0}])),
    "geojson": ("title:String,*geom:Point", {
        "type": "geojson",
        "fields": [{"name": "title", "transform": "$title"},
                   {"name": "geom", "transform": "$geometry"}]}, GEOJSON_FC),
    "geojson-id": ("title:String,*geom:Point", {
        "type": "geojson", "id-field": "$id",
        "fields": [{"name": "title", "transform": "$title"},
                   {"name": "geom", "transform": "$geometry"}]}, GEOJSON_FC),
    "error-mode-skip": (PEOPLE, {
        "type": "csv", "fields": [{"name": "age", "transform": "toInt($1)"}],
        "options": {"error-mode": "skip"}}, "x,notanumber\n"),
    "error-mode-raise": (PEOPLE, {
        "type": "csv", "fields": [{"name": "age", "transform": "toInt($1)"}],
        "options": {"error-mode": "raise"}}, "x,notanumber\n"),
    "skip-salvages": (PEOPLE, _hardening(**{"error-mode": "skip"}),
                      GOOD + BAD_INT + GOOD2),
    "raise-propagates": (PEOPLE, _hardening(**{"error-mode": "raise"}),
                         GOOD + BAD_INT),
    "ragged-skip": (PEOPLE, _hardening(), GOOD + "id9,x,1\n" + GOOD2),
    "ragged-raise": (PEOPLE, _hardening(**{"error-mode": "raise"}),
                     GOOD + "id9,x,1\n" + GOOD2),
    "z-index": (PEOPLE, _hardening(validators=["z-index"]), ZROWS),
    "has-geo": (PEOPLE, _hardening(validators=["has-geo"]),
                GOOD + "id7,g,1,1514764800000,NaN,NaN\n"),
    "validator-raise": (PEOPLE, _hardening(**{"error-mode": "raise"},
                                           validators=["z-index"]),
                        GOOD + "id4,dan,20,1514764800000,-374.0,40.0\n"),
    "has-dtg-null": (PEOPLE, {
        "type": "json",
        "fields": [{"name": "name", "transform": "toString($title)"},
                   {"name": "dtg", "transform": "toLong($when)"},
                   {"name": "geom", "transform": "point($x, $y)"}],
        "options": {"validators": ["has-dtg"]}},
        '{"title": "a", "when": 1514764800000, "x": 1.0, "y": 2.0}\n'
        '{"title": "b", "when": null, "x": 1.0, "y": 2.0}\n'),
    "unknown-validator": (PEOPLE, _hardening(validators=["bogus"]), GOOD),
    "assembly-fails": (PEOPLE, {
        "type": "csv", "fields": [{"name": "geom",
                                   "transform": "geometry($0)"}]},
        "LINESTRING (0 0; 1 1)\n"),
    "cache-lookup": (PEOPLE, {
        "type": "csv", "id-field": "$0",
        "caches": {"ages": {"type": "inline",
                            "data": {"a": {"age": 30}, "b": {"age": 40}}}},
        "fields": [{"name": "name", "transform": "$0"},
                   {"name": "age",
                    "transform": "toInt(cacheLookup('ages', $0, 'age'))"},
                   {"name": "geom", "transform": "point($1, $2)"}]},
        "a,1.0,2.0\nb,3.0,4.0\n"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_converter_matches_reference(case):
    spec, config, source = CASES[case]

    def run(ns):
        sft = ns.ft.parse_spec("people", spec)
        ec = ns.conv.EvaluationContext()
        batch = ns.conv.converter_from_config(sft, config).convert(source,
                                                                   ec)
        return batch, (ec.success, ec.failure, list(ec.errors))

    jout = {}
    for key, ns in (("jax", J), ("port", T)):
        try:
            jout[key] = ("ok", run(ns))
        except Exception as e:  # noqa: BLE001 — compared below
            jout[key] = ("raised", (type(e).__name__, str(e)))
    assert jout["port"][0] == jout["jax"][0], jout
    if jout["jax"][0] == "raised":
        assert jout["port"][1] == jout["jax"][1]
        return
    (tb, tec), (jb, jec) = jout["port"][1], jout["jax"][1]
    _same_batch(tb, jb)
    assert tec == jec


def test_csv_converter_oracle_values():
    """test_io.py::test_csv_converter's values, in the port."""
    spec, config, source = CASES["csv"]
    ec = tconv.EvaluationContext()
    batch = tconv.converter_from_config(tft.parse_spec("people", spec),
                                        config).convert(source, ec)
    assert len(batch) == 3 and ec.success == 3 and ec.failure == 0
    assert batch.column("name")[1] == "bob" and batch.column("age")[2] == 99
    np.testing.assert_allclose(batch.geom_xy()[0], [-74.1, 2.35, 139.7])
    assert batch.column("dtg")[0] == MS_2018 + 10 * 3_600_000
    assert batch.ids[0] == hashlib.md5(b"alice").hexdigest()


def test_log_mode_salvages_and_logs(caplog):
    """The ``log`` mode's warnings, on the logger both packages use."""
    records = {}
    for key, ns in (("jax", J), ("port", T)):
        caplog.clear()
        ec = ns.conv.EvaluationContext()
        with caplog.at_level(logging.WARNING, logger="geomesa_tpu.convert"):
            conv = ns.conv.converter_from_config(
                ns.ft.parse_spec("people", PEOPLE),
                _hardening(**{"error-mode": "log"}, validators=["z-index"]))
            batch = conv.convert(GOOD + BAD_INT + ZROWS, ec)
        records[key] = ([(r.name, r.levelname, r.getMessage())
                         for r in caplog.records],
                        len(batch), ec.failure, ec.errors)
    assert records["port"] == records["jax"]
    assert any("row-by-row" in m for _, _, m in records["port"][0])
    assert any("validators dropped" in m for _, _, m in records["port"][0])


@pytest.mark.parametrize("trial", range(5))
def test_fuzz_malformed_rows_match_reference(trial):
    """Random corruption of a clean CSV (test_converter_hardening.py's
    fuzz): skip mode never raises, and both packages keep and count the
    same rows."""
    rng = np.random.default_rng(61 + trial)
    base = [f"id{i},user{i},{20 + i % 50},{MS_2018 + i * 1000},"
            f"{-75 + (i % 100) * 0.01},{40 + (i % 100) * 0.01}"
            for i in range(200)]
    corruptions = [
        lambda r: r.replace(",", ";;", 1),
        lambda r: r.rsplit(",", 2)[0] + ",NaN,NaN",
        lambda r: r.replace("user", "\x00bin", 1),
        lambda r: ",".join(r.split(",")[:3]),
        lambda r: r + ",extra,cols",
        lambda r: r.replace(str(MS_2018), "not-a-time", 1),
    ]
    rows = list(base)
    for _ in range(20):
        i = rng.integers(0, len(rows))
        rows[i] = corruptions[rng.integers(0, len(corruptions))](rows[i])
    text = "\n".join(rows) + "\n"
    out = []
    for ns in (J, T):
        ec = ns.conv.EvaluationContext()
        conv = ns.conv.converter_from_config(
            ns.ft.parse_spec("people", PEOPLE),
            _hardening(**{"error-mode": "skip"}, validators=["z-index"]))
        out.append((conv.convert(text, ec), ec))
    (jb, jec), (tb, tec) = out
    _same_batch(tb, jb)
    assert (tec.success, tec.failure, tec.errors) == \
        (jec.success, jec.failure, jec.errors)
    assert len(tb) == tec.success and tec.success + tec.failure >= 180


def test_unknown_type_rejected_alike():
    _same_outcome(lambda ns: ns.conv.converter_from_config(
        ns.ft.parse_spec("people", PEOPLE), {"type": "nope"}))


def test_only_referenced_columns_are_converted():
    """The port's delimited reader turns only the referenced raw columns
    (and the first) into numpy; the batch is the reference's."""
    sft = tft.parse_spec("people", PEOPLE)
    conv = tconv.converter_from_config(sft, {
        "type": "csv", "options": {"header": True},
        "fields": [{"name": "name", "transform": "$b"},
                   {"name": "age", "transform": "toInt($3)"}]})
    raw = conv.raw_columns("a,b,c,d,e\nx,y,z,7,w\n")
    assert sorted(raw) == ["0", "1", "3", "a", "b", "d"]
    jconvr = jconv.converter_from_config(
        jft.parse_spec("people", PEOPLE), conv.config)
    _same_batch(conv.convert("a,b,c,d,e\nx,y,z,7,w\n"),
                jconvr.convert("a,b,c,d,e\nx,y,z,7,w\n"))


# -- expressions (test_io.py's registry, edge cases and round 2) ----------

_S = {"s": np.array(["  'Hello'  ", "  World  "], dtype=object)}
_NUM = {"a": np.array([1.0, 2.0]), "b": np.array([3.0, 5.0])}
_MIX = {"a": np.array(["x", "y"], dtype=object), "b": np.array([1, 2])}
_V = {"v": np.array(["a", "", None], dtype=object)}
_CSV = {"csv": np.array(["a,b,c", "d,e,f"], dtype=object)}
_R2 = {"d": np.array(["20180105", "20180203"], dtype=object),
       "l": np.array(["1;2;3", "4"], dtype=object),
       "m": np.array(["a->1,b->2", ""], dtype=object),
       "n": np.array(["7", "8"], dtype=object)}
_T = {"t": np.array([1515110400123, 1515110400000], dtype=np.int64)}
_XY = {"x": np.array([-74.0, 30.0]), "y": np.array([40.7, -10.0]),
       "t": np.array([MS_2018, MS_2018 + 86_400_000])}

EXPRESSIONS = [
    ("stripQuotes(trim($s))", _S), ("capitalize(lowercase(trim($s)))", _S),
    ("strlen(trim($s))", _S), ("length($s)", _S),
    ("replace(trim($s), 'l', 'L')", _S), ("remove(trim($s), 'o')", _S),
    ("regexReplace('[lo]+', '_', trim($s))", _S),
    ("substr(trim($s), 1, 4)", _S), ("substring($s, 2, 5)", _S),
    ("stripPrefix(trim($s), 'W')", _S), ("stripSuffix(trim($s), 'd')", _S),
    ("strip($s)", _S), ("strip(trim($s), '''')", _S),
    ("uppercase($s)", _S), ("toString($s)", _S),
    ("concat($s, '-', $s)", _S), ("concatenate('a', 'b')", _S),
    ("md5($s)", _S), ("base64Decode(base64Encode($s))", _S),
    ("printf('%s-%s', $a, $b)", _MIX), ("mkstring('|', $a, $b)", _MIX),
    ("printf('hello')", {"x": np.array([1, 2, 3])}),
    ("add($a, $b, 1)", _NUM), ("subtract($b, $a)", _NUM),
    ("multiply($a, $b)", _NUM), ("divide($b, $a)", _NUM),
    ("mean($a, $b)", _NUM), ("min($a, $b)", _NUM), ("max($a, $b)", _NUM),
    ("toInt($a)", _NUM), ("toLong($a)", _NUM), ("toFloat($a)", _NUM),
    ("toDouble($b)", _NUM), ("intToBoolean($x)", {"x": np.array([0, 3])}),
    ("emptyToNull($v)", _V), ("withDefault($v, 'dflt')", _V),
    ("withDefault($v, 'd')", {"v": np.array([], dtype=object)}),
    ("require($v)", _V), ("require($s)", _S), ("lineNo()", _V),
    ("lineNumber()", _V), ("list($csv)", _CSV),
    ("listItem(list($csv), 1)", _CSV),
    ("listItem(list($csv), 2)",
     {"csv": np.array(["a,b,c", "d,e"], dtype=object)}),
    ("basicDate($d)", _R2), ("basicIsoDate($d)", _R2),
    ("dateToString('yyyy-MM-dd', basicDate($d))", _R2),
    ("isoLocalDate($d)", {"d": np.array(["2018-01-05"], dtype=object)}),
    ("isoLocalDateTime($d)",
     {"d": np.array(["2018-01-05T10:11:12"], dtype=object)}),
    ("dateHourMinuteSecondMillis($d)",
     {"d": np.array(["2018-01-05T10:11:12.345"], dtype=object)}),
    ("isoOffsetDateTime($d)",
     {"d": np.array(["2018-01-05T10:11:12+02:00"], dtype=object)}),
    ("date('yyyy-MM-dd''T''HH:mm:ss', $d)",
     {"d": np.array(["2018-01-05T10:11:12"], dtype=object)}),
    ("dateToString('yyyy-MM-dd''T''HH:mm:ss.SSS''Z''', $t)", _T),
    ("dateToString('HH:mm', $t)", _T), ("millisToDate($t)", _T),
    ("parseList('int', $l, ';')", _R2), ("parseList('string', $n)", _R2),
    ("mapValue(parseMap('string->int', $m), 'b')", _R2),
    ("parseMap('string->double', $m)", _R2),
    ("stringToLong($n)", _R2), ("stringToInt($n)", _R2),
    ("stringToFloat($n)", _R2), ("stringToDouble($n)", _R2),
    ("stringToBoolean($n)",
     {"n": np.array(["true", "0"], dtype=object)}),
    ("stringToBool($n)", {"n": np.array(["t", "no"], dtype=object)}),
    ("string2bytes($n)", _R2), ("stringToBytes($n)", _R2),
    ("projectFrom('EPSG:3857', point($x, $y))",
     {"x": np.array([0.0, 1e6]), "y": np.array([0.0, -2e6])}),
    ("projectFrom('EPSG:3857', $x)", {"x": np.array([0.0])}),
    ("point($x, $y)", _XY), ("uuidZ3($x, $y, $t, 'day')", _XY),
    ("linestring($w)",
     {"w": np.array(["LINESTRING (0 0, 1 1)"], dtype=object)}),
    ("polygon($w)", {"w": np.array(["LINESTRING (0 0, 1 1)"],
                                   dtype=object)}),
    ("multipoint($w)",
     {"w": np.array(["MULTIPOINT ((0 0), (1 1))"], dtype=object)}),
    ("geometry($w)",
     {"w": np.array(["POLYGON ((0 0, 1 0, 1 1, 0 0))"], dtype=object)}),
    ("nosuchfunction($x)", _XY), ("toInt($missing)", _XY),
]


@pytest.mark.parametrize("text,cols", EXPRESSIONS,
                         ids=[e[0] for e in EXPRESSIONS])
def test_expression_matches_reference(text, cols):
    def run(ns):
        out = ns.expr.parse_expression(text).evaluate(cols)
        if text.startswith("uuidZ3"):
            # random below the z3 prefix: compare the first eight bytes
            return np.asarray([s[:18] for s in out], dtype=object)
        return out

    res = {}
    for key, ns in (("jax", J), ("port", T)):
        try:
            res[key] = ("ok", run(ns))
        except Exception as e:  # noqa: BLE001 — compared below
            res[key] = ("raised", (type(e).__name__, str(e)))
    assert res["port"][0] == res["jax"][0], res
    if res["jax"][0] == "raised":
        assert res["port"][1] == res["jax"][1]
    else:
        _same(res["port"][1], res["jax"][1])


@pytest.mark.parametrize("text", ["$a(", "f(,)", "name", "'x' 'y'",
                                  "f($a $b)", "#"])
def test_bad_expression_text_raises_alike(text):
    _same_outcome(lambda ns: ns.expr.parse_expression(text))


def test_random_functions_keep_their_form():
    cols = {"x": np.zeros(3)}
    for ns in (J, T):
        ids = ns.expr.parse_expression("uuid()").evaluate(cols)
        assert len(set(ids)) == 3 and all(len(s) == 36 and s[14] == "4"
                                          for s in ids)
        now = ns.expr.parse_expression("now()").evaluate(cols)
        assert now.dtype == np.int64 and len(now) == 3
        assert now[0] > 1_600_000_000_000
    # uuidZ3: uuid-shaped, distinct, the reference's z3 prefix
    tz = texpr.parse_expression("uuidZ3($x, $y, $t)").evaluate(_XY)
    jz = jexpr.parse_expression("uuidZ3($x, $y, $t)").evaluate(_XY)
    assert len(set(tz)) == 2 and all(len(s) == 36 for s in tz)
    assert [s[:18] for s in tz] == [s[:18] for s in jz]


def test_expr_refs_and_single_column_eval():
    text = "mkstring('|', $a, $b.c, $d/e, $@f)"
    assert texpr.expr_refs(text) == jexpr.expr_refs(text)
    calls = {"n": 0}
    orig = texpr._Ref.evaluate

    def counting(self, cols):
        calls["n"] += 1
        return orig(self, cols)

    texpr._Ref.evaluate = counting
    try:
        cols = {"a": np.array(["x"] * 100, dtype=object),
                "b": np.array(["y"] * 100, dtype=object)}
        out = texpr.parse_expression("mkstring('|', $a, $b)").evaluate(cols)
    finally:
        texpr._Ref.evaluate = orig
    assert list(out)[:1] == ["x|y"] and calls["n"] == 2


def test_enrichment_caches_match_reference(tmp_path):
    csv = tmp_path / "ages.csv"
    csv.write_text("id,age,city\na,30,X\nb,40,Y\n")
    cols = {"k": np.array(["a", "b", "c"], dtype=object)}
    out = []
    for ns in (J, T):
        ns.enrich.clear_caches()
        ns.enrich.register_cache(
            "ages", ns.enrich.cache_from_config(
                {"type": "csv", "path": str(csv), "key-column": "id"}))
        try:
            got = [ns.expr.parse_expression(
                f"cacheLookup('ages', $k, '{f}')").evaluate(cols)
                for f in ("age", "city")]
            # a converter's own caches take precedence over the registry
            conv = ns.conv.converter_from_config(
                ns.ft.parse_spec("p", "name:String,*geom:Point"), {
                    "type": "csv",
                    "caches": {"ages": {"type": "inline",
                                        "data": {"a": {"age": "inline"}}}},
                    "fields": [{"name": "name", "transform":
                                "cacheLookup('ages', $0, 'age')"},
                               {"name": "geom",
                                "transform": "point($1, $2)"}]})
            got.append(conv.convert("a,1,2\nb,3,4\n").column("name"))
            with pytest.raises(KeyError, match="no enrichment cache"):
                ns.enrich.lookup_cache("missing")
            with pytest.raises(ValueError, match="unknown enrichment"):
                ns.enrich.cache_from_config({"type": "redis"})
        finally:
            ns.enrich.clear_caches()
        out.append(got)
    for j, t in zip(*out):
        _same(t, j)
    assert list(out[1][2]) == ["inline", None]


# -- geometry/geojson.py ---------------------------------------------------

def _geometries(ns):
    ring = [(0.0, 0.0), (4.0, 0.0), (4.0, 3.0), (0.0, 3.0), (0.0, 0.0)]
    hole = [(1.0, 1.0), (2.0, 1.0), (2.0, 2.0), (1.0, 1.0)]
    line = np.array([(-1.5, 2.0), (3.0, -4.125)])
    t = ns.types
    return [t.Point(1.5, -2.0), t.LineString(line),
            t.Polygon(ring, (np.array(hole),)),
            t.MultiPoint(np.array([(1.0, 2.0), (3.0, 4.0)])),
            t.MultiLineString((t.LineString(line),
                               t.LineString(line + 1.0))),
            t.MultiPolygon((t.Polygon(ring), t.Polygon(hole)))]


def test_geojson_codec_matches_reference():
    for tg, jg in zip(_geometries(T), _geometries(J)):
        d = tgeojson.geometry_to_geojson(tg)
        assert json.dumps(d) == json.dumps(jgeojson.geometry_to_geojson(jg))
        assert repr(tgeojson.geojson_to_geometry(d)) == \
            repr(jgeojson.geojson_to_geometry(d))
    for bad in ({"type": "GeometryCollection", "geometries": []},):
        _same_outcome(lambda ns: ns.geojson.geojson_to_geometry(bad))


# -- exports (test_io.py) ----------------------------------------------------

def _point_batch(ns):
    return ns.batch.FeatureBatch.from_dict(
        ns.ft.parse_spec("people", PEOPLE),
        {"name": np.array(["a", "b,\"q\"", None], dtype=object),
         "age": [1, 2, 3],
         "dtg": np.array([MS_2018, MS_2018 + 100_000, MS_2018 + 123]),
         "geom": (np.array([0.0, 1.0, -74.0123456789]),
                  np.array([2.0, 3.0, 40.5]))},
        ids=["f1", "f2", "f3"])


def _polygon_batch(ns):
    t = ns.types
    hole = t.Polygon([(0, 0), (10, 0), (10, 10), (0, 10)],
                     (np.array([(4, 4), (6, 4), (6, 6), (4, 6)], float),))
    plain = t.Polygon([(20, 20), (24, 20), (24, 24), (20, 24)])
    return ns.batch.FeatureBatch.from_dict(
        ns.ft.parse_spec("areas", "name:String,v:Double,*geom:Polygon"),
        {"name": np.array(["holed", "plain"], dtype=object),
         "v": [1.25, -3.5], "geom": [hole, plain]})


@pytest.mark.parametrize("batch", ["points", "polygons"])
@pytest.mark.parametrize("fmt", ["to_csv", "to_geojson"])
def test_text_export_bytes_equal(fmt, batch):
    make = _point_batch if batch == "points" else _polygon_batch
    got = getattr(texport, fmt)(make(T))
    assert got == getattr(jexport, fmt)(make(J))
    if fmt == "to_csv" and batch == "points":
        lines = got.strip().splitlines()
        assert lines[0] == "id,name,age,dtg,geom"
        assert "POINT (0.0 2.0)" in lines[1]
        assert "2018-01-01T00:00:00.000" in lines[1]
    if fmt == "to_geojson" and batch == "points":
        fc = json.loads(got)
        assert fc["features"][1]["geometry"]["coordinates"] == [1.0, 3.0]


@pytest.mark.parametrize("batch", ["points", "polygons", "lines",
                                   "multipoints"])
def test_shapefile_export_bytes_equal(batch, tmp_path):
    def make(ns):
        if batch == "points":
            return _point_batch(ns)
        if batch == "polygons":
            return _polygon_batch(ns)
        t = ns.types
        spec, geoms = {
            "lines": ("name:String,*geom:LineString",
                      [t.LineString(np.array([(0.0, 0.0), (1.0, 2.0)])),
                       t.LineString(np.array([(5.0, 5.0), (6.0, 7.0),
                                              (8.0, 9.5)]))]),
            "multipoints": ("name:String,*geom:MultiPoint",
                            [t.MultiPoint(np.array([(0.0, 0.0),
                                                    (1.0, 2.0)]))] * 2),
        }[batch]
        return ns.batch.FeatureBatch.from_dict(
            ns.ft.parse_spec("g", spec),
            {"name": np.array(["x" * 300, "y"], dtype=object),
             "geom": geoms})

    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    texport.to_shapefile(make(T), str(tmp_path / "t" / "out.shp"))
    jexport.to_shapefile(make(J), str(tmp_path / "j" / "out"))
    for ext in (".shp", ".shx", ".dbf"):
        assert (tmp_path / "t" / f"out{ext}").read_bytes() == \
            (tmp_path / "j" / f"out{ext}").read_bytes()
    # read back by both packages' readers, equal
    tg, ta = tformats.read_shapefile(str(tmp_path / "t" / "out.shp"))
    jg, ja = jformats.read_shapefile(str(tmp_path / "t" / "out.shp"))
    assert [repr(g) for g in tg] == [repr(g) for g in jg]
    assert sorted(ta) == sorted(ja)
    for k in ja:
        _same(ta[k], ja[k])
    if batch == "points":
        np.testing.assert_allclose([g.x for g in tg], [0.0, 1.0,
                                                       -74.0123456789])
        assert [int(v) for v in ta["age"]] == [1, 2, 3]
    if batch == "polygons":
        assert len(tg[0].holes) == 1
        assert tg[1].envelope.as_tuple() == (20.0, 20.0, 24.0, 24.0)
