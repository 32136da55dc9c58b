"""Config-driven converters: files → FeatureBatches.

The reference's SimpleFeatureConverter SPI (geomesa-convert-common/.../
AbstractConverter.scala; typesafe-config definitions with ``id-field``,
``fields`` transform expressions, error modes) rebuilt columnar: the
format layer parses a whole file into raw columns (pyarrow CSV for
delimited — a native-code parse path; json via stdlib), then transform
expressions evaluate vectorized (io/expressions.py), then the batch is
assembled.  ``EvaluationContext`` carries success/failure counters like
the reference's ingest metrics (convert/.../EvaluationContext.scala).

The port's copy of the JAX package's ``io/converters.py``: the same
configs, batches, failure counts and messages, and the same logger
(``geomesa_tpu.convert``) for the ``log`` error mode.  One difference in
cost, none in output: the delimited reader turns only the raw columns
that a transform or the id field references into numpy arrays.
"""

from __future__ import annotations

import io as _io
import json
import threading
from dataclasses import dataclass, field

import numpy as np

from ..features.batch import FeatureBatch
from ..features.feature_type import FeatureType
from .expressions import parse_expression

__all__ = ["Converter", "EvaluationContext", "converter_from_config"]


@dataclass
class EvaluationContext:
    """Ingest counters (the reference's EvaluationContext success/failure
    metrics, convert2/EvaluationContext.scala): per-RECORD accounting —
    a malformed row increments ``failure`` and leaves the rest of the
    batch intact (error-mode skip-bad-records semantics)."""

    success: int = 0
    failure: int = 0
    errors: list = field(default_factory=list)

    #: cap on retained error samples (counters keep counting past it)
    MAX_ERRORS = 32

    def record_failure(self, count: int, reason: str) -> None:
        self.failure += count
        if len(self.errors) < self.MAX_ERRORS:
            self.errors.append(reason)


class Converter:
    """Base converter: subclasses produce raw columns; the shared path
    applies transforms and assembles the batch."""

    def __init__(self, sft: FeatureType, config: dict):
        self.sft = sft
        self.config = config
        self.error_mode = config.get("options", {}).get("error-mode", "skip")
        self.id_expr = (parse_expression(config["id-field"])
                        if "id-field" in config else None)
        self.fields = []
        for f in config.get("fields", []):
            self.fields.append((f["name"], parse_expression(f["transform"])
                                if "transform" in f else None))
        # named enrichment lookup tables for cacheLookup() transforms —
        # scoped to this converter (pushed during convert()), so same-named
        # caches in unrelated configs never collide
        self._caches = {}
        #: per-thread state of a running convert(): an ingest's worker
        #: threads share one converter
        self._tls = threading.local()
        if config.get("caches"):
            from .enrichment import cache_from_config
            self._caches = {cname: cache_from_config(ccfg)
                            for cname, ccfg in config["caches"].items()}

    #: converters whose raw source is a file path (shapefile sidecars,
    #: jdbc databases) rather than the file's bytes
    wants_path = False

    @property
    def _parse_failures(self) -> list:
        """Parse-level per-record failures (ragged CSV rows etc.) of the
        convert() running on this thread.  The JAX converter keeps them
        in one attribute, which concurrent convert() calls reset and
        share, so its ingests with several workers lose or double-count
        ragged rows; here each thread keeps its own."""
        return self._tls.parse_failures

    # -- subclass hook ----------------------------------------------------
    def raw_columns(self, source) -> dict:
        raise NotImplementedError

    def referenced_paths(self) -> set:
        """Raw-column names/paths referenced by the configured field
        transforms and id-field ($-refs, shared by json/xml converters)."""
        from .expressions import expr_refs

        paths: set = set()
        for f in self.config.get("fields", []):
            t = f.get("transform")
            if t:
                paths.update(expr_refs(t))
            else:
                # transform-less fields read the raw column by name
                paths.add(f["name"])
        paths.update(expr_refs(self.config.get("id-field", "")))
        return paths

    # -- shared pipeline --------------------------------------------------
    def convert(self, source, ec: EvaluationContext | None = None) -> FeatureBatch:
        """Parse → transform (vectorized) → validate → assemble.

        Error handling mirrors AbstractConverter's modes
        (convert2/AbstractConverter.scala): ``raise`` propagates the
        first failure; ``skip`` (default) and ``log`` drop bad RECORDS —
        when a vectorized transform fails, rows are retried one at a
        time so only the malformed ones are lost (per-record failure
        accounting, not per-batch)."""
        ec = ec if ec is not None else EvaluationContext()
        # parse-level per-record failures noted by raw_columns, folded
        # into the context here
        self._tls.parse_failures = []
        cols = self.raw_columns(source)
        for msg in self._parse_failures:
            ec.record_failure(1, msg)
        n = len(next(iter(cols.values()))) if cols else 0
        from .enrichment import pop_active_caches, push_active_caches
        push_active_caches(self._caches)
        try:
            try:
                data, ids = self._transform(cols)
            except Exception as e:
                if self.error_mode == "raise":
                    raise
                if self.error_mode == "log":
                    import logging
                    logging.getLogger("geomesa_tpu.convert").warning(
                        "vectorized transform failed (%r); retrying "
                        "row-by-row to isolate bad records", e)
                data, ids = self._transform_salvage(cols, n, ec)
        finally:
            pop_active_caches()
        batch = self._assemble(data, ids, ec)
        batch = self._validate(batch, ec)
        ec.success += len(batch)
        return batch

    def _transform(self, cols: dict):
        data: dict = {}
        for name, expr in self.fields:
            if expr is None:
                data[name] = cols[name]
            else:
                data[name] = expr.evaluate(cols)
        ids = self.id_expr.evaluate(cols) if self.id_expr else None
        return data, ids

    def _transform_salvage(self, cols: dict, n: int, ec: EvaluationContext):
        """Per-record retry after a vectorized transform failure: each
        row evaluates alone; rows that still fail are counted and
        dropped (skip-bad-records).  O(rows) Python — the failure path
        only; clean files never pay it."""
        good: list[dict] = []
        good_ids: list = []
        for i in range(n):
            row = {k: v[i:i + 1] for k, v in cols.items()}
            try:
                d, ids = self._transform(row)
                # scalar-ize: each value is a 1-element array
                good.append(d)
                good_ids.append(ids[0] if ids is not None else None)
            except Exception as e:
                ec.record_failure(1, f"row {i}: {e!r}")
        if not good:
            return {name: np.empty(0, dtype=object)
                    for name, _ in self.fields}, None

        def cat(k):
            first = good[0][k]
            if isinstance(first, tuple):  # e.g. point() → (x, y)
                return tuple(
                    np.concatenate([np.asarray(g[k][j]) for g in good])
                    for j in range(len(first)))
            return np.concatenate([np.asarray(g[k]) for g in good])

        data = {k: cat(k) for k in good[0]}
        ids = (None if self.id_expr is None
               else np.asarray(good_ids, dtype=object))
        return data, ids

    def _assemble(self, data: dict, ids, ec: EvaluationContext) -> FeatureBatch:
        # geometry attrs: object arrays of Geometry objects → packed
        for attr in self.sft.attributes:
            v = data.get(attr.name)
            if attr.is_geometry and isinstance(v, np.ndarray) and v.dtype == object:
                data[attr.name] = list(v)
        try:
            return FeatureBatch.from_dict(self.sft, data, ids=ids)
        except Exception as e:
            if self.error_mode == "raise":
                raise
            n = len(next(iter(data.values()))) if data else 0
            ec.record_failure(n, f"batch assembly: {e!r}")
            return FeatureBatch(self.sft, {})

    def _validate(self, batch: FeatureBatch,
                  ec: EvaluationContext) -> FeatureBatch:
        """Index validators (the reference's SimpleFeatureValidator:
        ``has-geo``, ``has-dtg``, ``z-index`` — convert2/validators):
        drop (or raise on) records an index could not serve."""
        validators = self.config.get("options", {}).get("validators", [])
        if not validators or len(batch) == 0:
            return batch
        n = len(batch)
        keep = np.ones(n, dtype=bool)
        reasons: dict[str, int] = {}

        def fail(mask: np.ndarray, why: str):
            bad = ~mask
            cnt = int((keep & bad).sum())
            if cnt:
                if self.error_mode == "raise":
                    raise ValueError(
                        f"validator {why}: {cnt} invalid record(s)")
                reasons[why] = reasons.get(why, 0) + cnt
            return mask

        sft = self.sft
        for v in validators:
            if v not in ("has-geo", "has-dtg", "z-index", "index"):
                raise ValueError(f"unknown validator {v!r}")
            if v in ("has-geo", "z-index", "index") and sft.geom_field:
                x, y = batch.geom_xy(sft.geom_field)
                x = np.asarray(x, np.float64)
                y = np.asarray(y, np.float64)
                keep &= fail(~(np.isnan(x) | np.isnan(y)), "has-geo")
                if v != "has-geo":
                    keep &= fail((x >= -180) & (x <= 180)
                                 & (y >= -90) & (y <= 90), "z-index-bounds")
            if v in ("has-dtg", "z-index", "index") and sft.dtg_field:
                dtg = batch.columns.get(sft.dtg_field)
                if dtg is None:
                    keep &= fail(np.zeros(n, dtype=bool), "has-dtg")
                    continue
                if dtg.dtype == object:
                    ok = np.asarray([d is not None for d in dtg])
                else:
                    ok = ~np.isnan(dtg.astype(np.float64))
                keep &= fail(ok, "has-dtg")
                if v != "has-dtg":
                    from ..curve.binnedtime import max_date_ms
                    ms = np.where(ok, dtg.astype(np.int64,
                                                 casting="unsafe"), 0)
                    in_range = (ms >= 0) & (ms < max_date_ms(
                        sft.z3_interval))
                    keep &= fail(in_range | ~ok, "z-index-time")
        dropped = int((~keep).sum())
        if dropped:
            for why, cnt in reasons.items():
                ec.record_failure(cnt, f"validator {why}: {cnt} record(s)")
            if self.error_mode == "log":
                import logging
                logging.getLogger("geomesa_tpu.convert").warning(
                    "validators dropped %d record(s): %s", dropped, reasons)
            batch = batch.take(np.flatnonzero(keep))
        return batch


class DelimitedTextConverter(Converter):
    """CSV/TSV via pyarrow's native parser; raw columns are ``$0``-style
    positional refs plus header names when present."""

    def raw_columns(self, source) -> dict:
        import pyarrow.csv as pacsv

        default_fmt = "TSV" if self.config.get("type", "").lower() == "tsv" else "CSV"
        fmt = self.config.get("format", default_fmt).upper()
        if "delimiter" in self.config:
            delim = self.config["delimiter"]
        else:
            delim = {"CSV": ",", "TSV": "\t"}.get(fmt, ",")
        opts = self.config.get("options", {})
        skip = int(opts.get("skip-lines", 0))
        has_header = bool(opts.get("header", False))
        if isinstance(source, (str, bytes)):
            buf = _io.BytesIO(source.encode() if isinstance(source, str) else source)
        else:
            buf = source
        read_opts = pacsv.ReadOptions(
            skip_rows=skip, autogenerate_column_names=not has_header)
        parse_opts = {"delimiter": delim}
        if self.error_mode != "raise":
            # the serial reader calls the Python handler below on this
            # thread; pyarrow's reader threads calling it while an ingest
            # parses several files at once abort the process now and then.
            # Both readers infer the same types (over every block)
            read_opts.use_threads = False
            # ragged rows are per-RECORD failures, not file failures
            # (AbstractConverter skip-bad-records at the parse stage)
            failures = getattr(self, "_parse_failures", [])

            def _skip_row(row):
                failures.append(
                    f"parse: expected {row.expected_columns} columns, "
                    f"got {row.actual_columns}: {row.text!r}")
                return "skip"

            parse_opts["invalid_row_handler"] = _skip_row
        table = pacsv.read_csv(
            buf, read_opts,
            pacsv.ParseOptions(**parse_opts),
            pacsv.ConvertOptions(strings_can_be_null=True),
        )
        # only the columns a transform or the id field reads become numpy
        # arrays (a string column costs a Python object a row); the first
        # always does, since the functions of no column (uuid(), lineNo())
        # take the row count from the first column they find
        wanted = self.referenced_paths()
        cols = {}
        for i, col_name in enumerate(table.column_names):
            keys = [str(i)] + ([col_name] if has_header else [])
            if i and wanted.isdisjoint(keys):
                continue
            arr = table.column(col_name).to_numpy(zero_copy_only=False)
            for k in keys:
                cols[k] = arr
        return cols


class JsonConverter(Converter):
    """Newline-delimited JSON or a JSON array; raw columns are top-level
    keys plus dotted paths (the reference's json-path subset)."""

    def raw_columns(self, source) -> dict:
        if isinstance(source, bytes):
            source = source.decode()
        text = source.strip()
        if text.startswith("["):
            records = json.loads(text)
        else:
            records = [json.loads(line) for line in text.splitlines() if line.strip()]
        paths = self.referenced_paths()
        cols: dict = {}
        for p in paths:
            cols[p] = np.asarray([_dig(r, p) for r in records], dtype=object)
        if not cols:
            # expose all top-level keys
            keys = set()
            for r in records:
                keys.update(r)
            for k in keys:
                cols[k] = np.asarray([r.get(k) for r in records], dtype=object)
        return cols


def _dig(record: dict, path: str):
    cur = record
    for part in path.split("."):
        if not isinstance(cur, dict):
            return None
        cur = cur.get(part)
    return cur


class GeoJsonConverter(Converter):
    """GeoJSON FeatureCollection → batch (geometry + properties)."""

    def raw_columns(self, source) -> dict:
        if isinstance(source, bytes):
            source = source.decode()
        fc = json.loads(source)
        feats = fc.get("features", [])
        from ..geometry.geojson import geojson_to_geometry

        cols: dict = {"geometry": np.asarray(
            [geojson_to_geometry(f["geometry"]) for f in feats],
            dtype=object)}
        keys = set()
        for f in feats:
            keys.update((f.get("properties") or {}).keys())
        for k in keys:
            cols[k] = np.asarray([(f.get("properties") or {}).get(k) for f in feats],
                                 dtype=object)
        cols["id"] = np.asarray([f.get("id") for f in feats], dtype=object)
        return cols


_TYPES = {
    "delimited-text": DelimitedTextConverter,
    "csv": DelimitedTextConverter,
    "tsv": DelimitedTextConverter,
    "json": JsonConverter,
    "geojson": GeoJsonConverter,
}


def converter_from_config(sft: FeatureType, config: dict) -> Converter:
    """Instantiate a converter from a config dict (``type``, ``id-field``,
    ``fields``, ``options`` — the reference's config shape)."""
    ctype = config.get("type", "delimited-text").lower()
    cls = _TYPES.get(ctype)
    if cls is None:
        raise ValueError(f"unknown converter type {ctype!r}")
    return cls(sft, config)


# additional formats register themselves on import (xml, fixed-width,
# avro, jdbc, shp, osm — one module per format in the reference)
from .formats import (  # noqa: E402  (registry must exist first)
    AvroConverter,
    FixedWidthConverter,
    JdbcConverter,
    OsmConverter,
    ShapefileConverter,
    XmlConverter,
)

_TYPES.update({
    "xml": XmlConverter,
    "fixed-width": FixedWidthConverter,
    "avro": AvroConverter,
    "jdbc": JdbcConverter,
    "shp": ShapefileConverter,
    "shapefile": ShapefileConverter,
    "osm": OsmConverter,
})
