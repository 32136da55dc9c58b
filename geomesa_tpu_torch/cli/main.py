"""geomesa-tpu-torch CLI entry point: the JAX package's ``geomesa-tpu``
commands, with the same output, over the port's store.

Every command that opens the catalog opens it on the CUDA card unless
``--device cpu`` is given; with no card and no ``--device cpu`` it exits
non-zero with :func:`~geomesa_tpu_torch.device.resolve_device`'s
message and never runs on the host quietly.

Usage examples (mirroring the reference's tools):

    geomesa-tpu-torch create-schema -c /data/cat -f gdelt \
        -s "actor:String,dtg:Date,*geom:Point;geomesa.z3.interval=week"
    geomesa-tpu-torch ingest -c /data/cat -f gdelt -C conv.json events.csv
    geomesa-tpu-torch export -c /data/cat -f gdelt -q "BBOX(geom,-10,35,15,52)" -F geojson
    geomesa-tpu-torch explain -c /data/cat -f gdelt -q "..."
    geomesa-tpu-torch stats-count / stats-bounds / stats-top-k
    geomesa-tpu-torch get-type-names / describe-schema / remove-schema
    geomesa-tpu-torch --device cpu sql -c /data/cat "SELECT COUNT(*) FROM gdelt"
"""

from __future__ import annotations

import argparse
import json
import sys


def _store(args):
    from ..datastore import TpuDataStore
    from ..device import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"geomesa-tpu-torch: {e}")
    return TpuDataStore(device=device, catalog_dir=args.catalog)


def cmd_create_schema(args):
    ds = _store(args)
    sft = ds.create_schema(args.feature_name, args.spec)
    print(f"created schema {sft.name}: {sft.spec_string()}")


def cmd_get_type_names(args):
    for n in _store(args).type_names:
        print(n)


def cmd_describe_schema(args):
    sft = _store(args).get_schema(args.feature_name)
    print(f"{sft.name}")
    for a in sft.attributes:
        star = "*" if a.name == sft.default_geom else " "
        opts = " ".join(f"{k}={v}" for k, v in a.options.items())
        print(f"  {star}{a.name}: {a.type} {opts}".rstrip())
    for k, v in sft.user_data.items():
        print(f"  {k}={v}")


def cmd_remove_schema(args):
    _store(args).remove_schema(args.feature_name)
    print(f"removed {args.feature_name}")


def cmd_migrate_schema(args):
    """Upgrade a schema's index layouts to the current versions (the
    reference's index-format migration commands)."""
    ds = _store(args)
    old = ds.migrate_schema(args.feature_name)
    from ..datastore import CURRENT_INDEX_VERSIONS
    changed = {k: (v, CURRENT_INDEX_VERSIONS[k])
               for k, v in old.items() if v != CURRENT_INDEX_VERSIONS[k]}
    if not changed:
        print(f"{args.feature_name}: already at current index versions")
    else:
        for k, (a, b) in sorted(changed.items()):
            print(f"{args.feature_name}: {k} v{a} -> v{b}")


def cmd_index_versions(args):
    """Show a schema's recorded index-layout versions."""
    ds = _store(args)
    store = ds._store(args.feature_name)
    from ..index.registry import supported_indices
    supported = set(supported_indices(store.sft))
    for name, v in sorted(store.index_versions.items()):
        mark = "" if name in supported else "  (not applicable)"
        print(f"{name}: v{v}{mark}")


def cmd_ingest(args):
    ds = _store(args)
    sft = ds.get_schema(args.feature_name)
    from ..io.converters import EvaluationContext, converter_from_config

    total = 0
    ec = EvaluationContext()
    if args.converter:
        with open(args.converter) as f:
            conv = converter_from_config(sft, json.load(f))
        for path in args.files:
            if conv.wants_path:
                # shapefile/jdbc sources are paths (sidecar files, db handles)
                batch = conv.convert(path, ec)
            else:
                with open(path, "rb") as f:
                    batch = conv.convert(f.read(), ec)
            if len(batch):
                total += ds.write(args.feature_name, batch)
    else:
        from ..io.export import from_parquet
        for path in args.files:
            if not path.endswith(".parquet"):
                raise SystemExit(
                    "ingest without -C/--converter supports parquet only")
            batch = from_parquet(path, sft)
            total += ds.write(args.feature_name, batch)
            ec.success += len(batch)
    ds.flush(args.feature_name)
    print(f"ingested {total} features ({ec.failure} failed)")


def cmd_export(args):
    ds = _store(args)
    from ..planning.planner import Query
    q = Query.of(args.cql, max_features=args.max_features)
    batch = ds.query(args.feature_name, q)
    fmt = args.format
    if fmt == "csv":
        from ..io.export import to_csv
        out = to_csv(batch)
        _write_out(args.output, out)
    elif fmt == "geojson":
        from ..io.export import to_geojson
        _write_out(args.output, to_geojson(batch))
    elif fmt == "parquet":
        from ..io.export import to_parquet
        if not args.output:
            raise SystemExit("parquet export requires -o/--output")
        to_parquet(batch, args.output)
    elif fmt == "arrow":
        import pyarrow as pa
        from ..io.export import to_arrow
        if not args.output:
            raise SystemExit("arrow export requires -o/--output")
        with pa.OSFile(args.output, "wb") as sink:
            table = to_arrow(batch)
            with pa.ipc.new_file(sink, table.schema) as w:
                w.write_table(table)
    elif fmt == "gml":
        from ..io.export import to_gml
        _write_out(args.output, to_gml(batch))
    elif fmt == "leaflet":
        from ..io.export import to_leaflet
        _write_out(args.output, to_leaflet(batch))
    elif fmt == "avro":
        from ..io.avro import to_avro
        if not args.output:
            raise SystemExit("avro export requires -o/--output")
        to_avro(batch, args.output)
    elif fmt == "shp":
        from ..io.export import to_shapefile
        if not args.output:
            raise SystemExit("shp export requires -o/--output")
        to_shapefile(batch, args.output)
    elif fmt == "bin":
        from ..io.bin_encoder import encode_bin
        x, y = batch.geom_xy()
        dtg = (batch.column(batch.sft.dtg_field)
               if batch.sft.dtg_field else [0] * len(batch))
        track = (batch.column(args.track) if args.track else None)
        blob = encode_bin(x, y, dtg, track=track)
        if not args.output:
            sys.stdout.buffer.write(blob)
        else:
            with open(args.output, "wb") as f:
                f.write(blob)
    else:
        raise SystemExit(f"unknown format {fmt!r}")
    if args.output:
        print(f"exported {len(batch)} features to {args.output}")


def _write_out(path, text):
    if path:
        with open(path, "w") as f:
            f.write(text)
    else:
        print(text)


def cmd_explain(args):
    print(_store(args).explain(args.feature_name, args.cql))


def cmd_sql(args):
    """Run a SELECT statement (the geomesa-spark-sql user surface)."""
    import numpy as np

    from ..sql import sql_query
    out = sql_query(_store(args), args.statement)
    if isinstance(out, int):
        print(out)
        return
    if isinstance(out, dict):
        keys = list(out)
        print(",".join(keys))
        if any(np.ndim(out[k]) for k in keys):  # GROUP BY arrays
            for row in zip(*(out[k] for k in keys)):
                print(",".join(str(v) for v in row))
        else:                                   # global aggregates
            print(",".join("" if out[k] is None else str(out[k])
                           for k in keys))
        return
    names = [a.name for a in out.sft.attributes
             if not a.is_geometry and a.name in out.columns]
    gname = out.sft.default_geom
    packed = out.geoms is not None
    points = (gname and not packed and f"{gname}_x" in out.columns)
    print(",".join(["fid"] + names + ([gname] if packed or points else [])))
    from ..geometry.wkt import geometry_to_wkt
    xs = ys = None
    if points:
        xs, ys = out.geom_xy(gname)
    for i in range(len(out)):
        row = [str(out.ids[i])]
        row += [str(out.column(n)[i]) for n in names]
        if packed:
            row.append(geometry_to_wkt(out.geoms.geometry(i)))
        elif points:
            row.append(f"POINT ({float(xs[i])} {float(ys[i])})")
        print(",".join(row))


def cmd_stats_count(args):
    ds = _store(args)
    q = args.cql if args.cql else None
    print(ds.get_count(args.feature_name, q))


def cmd_stats_bounds(args):
    env = _store(args).get_bounds(args.feature_name)
    print("none" if env is None else env.as_tuple())


def cmd_stats_top_k(args):
    ds = _store(args)
    from ..process import stats_process
    s = stats_process(ds, args.feature_name, args.cql or "INCLUDE",
                      f"TopK({args.attribute})")
    for v, c in s.topk(args.k):
        print(f"{v}\t{c}")


def cmd_stats_histogram(args):
    ds = _store(args)
    from ..process import stats_process
    lo, hi = args.bounds.split(",") if args.bounds else (None, None)
    if lo is None:
        b = ds.get_attribute_bounds(args.feature_name, args.attribute)
        if b is None:
            raise SystemExit("no bounds available; pass --bounds lo,hi")
        lo, hi = b
    s = stats_process(ds, args.feature_name, args.cql or "INCLUDE",
                      f"Histogram({args.attribute},{args.bins},{lo},{hi})")
    for i, c in enumerate(s.counts):
        print(f"bin {i}\t{c}")


def cmd_stats_analyze(args):
    """Recompute stats from the stored data and persist them (the
    reference's stats-analyze command / StatsRunner)."""
    ds = _store(args)
    n = ds.stats_analyze(args.feature_name)
    print(f"analyzed {args.feature_name}: {n} features, stats persisted")


def cmd_age_off(args):
    """Expire old rows (tools age-off command analog)."""
    from ..age_off import age_off
    ds = _store(args)
    n = age_off(ds, args.feature_name, retention=args.retention,
                dry_run=args.dry_run)
    if args.dry_run:
        print(f"would age off {n} features from {args.feature_name}")
    else:
        ds.flush(args.feature_name)
        print(f"aged off {n} features from {args.feature_name}")


def cmd_fs_partitions(args):
    """List or compact a filesystem store's partitions (the reference's
    manage-partitions command over FSDS partition schemes)."""
    from ..fs import FileSystemDataStore
    fs = FileSystemDataStore(args.root)
    if args.compact:
        fs.compact(args.feature_name)
        print(f"compacted {args.feature_name}")
    info = fs.partition_info(args.feature_name)
    for name in sorted(info):
        print(f"{name}\t{info[name]['files']} file(s)"
              f"\t{info[name]['features']} features")


def cmd_flush(args):
    """Persist a schema's rows to the catalog (parquet; lean schemas
    write chunked crash-safe snapshots) — the checkpoint command."""
    ds = _store(args)
    ds.flush(args.feature_name)
    st = ds._store(args.feature_name)
    n = len(st.batch) if st.batch is not None else 0
    kind = "lean snapshot" if st.lean else "parquet"
    print(f"flushed {n} features of {args.feature_name} ({kind})")


def cmd_version(args):
    from .. import __version__
    print(f"geomesa-tpu {__version__}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="geomesa-tpu-torch",
        description="spatio-temporal index tools on a CUDA card")
    p.add_argument("--device", default="cuda",
                   help="where the catalog's store runs: cuda (default), "
                        "cuda:N or cpu")
    sub = p.add_subparsers(dest="command", required=True)

    def add(name, fn, **kw):
        sp = sub.add_parser(name, **kw)
        sp.set_defaults(fn=fn)
        return sp

    def catalog(sp, feature=True):
        sp.add_argument("-c", "--catalog", required=True,
                        help="catalog directory")
        if feature:
            sp.add_argument("-f", "--feature-name", required=True)

    sp = add("create-schema", cmd_create_schema, help="create a feature schema")
    catalog(sp)
    sp.add_argument("-s", "--spec", required=True, help="schema spec string")

    sp = add("get-type-names", cmd_get_type_names, help="list schemas")
    catalog(sp, feature=False)

    sp = add("describe-schema", cmd_describe_schema, help="describe a schema")
    catalog(sp)

    sp = add("remove-schema", cmd_remove_schema, help="remove a schema")
    catalog(sp)

    sp = add("migrate-schema", cmd_migrate_schema,
             help="upgrade index layouts to current versions")
    catalog(sp)

    sp = add("index-versions", cmd_index_versions,
             help="show a schema's index-layout versions")
    catalog(sp)

    sp = add("sql", cmd_sql, help="run a SELECT statement")
    catalog(sp, feature=False)
    sp.add_argument("statement", help="SELECT ... FROM <schema> ...")

    sp = add("ingest", cmd_ingest, help="ingest files")
    catalog(sp)
    sp.add_argument("-C", "--converter", help="converter config (json)")
    sp.add_argument("files", nargs="+")

    sp = add("export", cmd_export, help="query + export features")
    catalog(sp)
    sp.add_argument("-q", "--cql", default="INCLUDE")
    sp.add_argument("-F", "--format", default="csv",
                    choices=["csv", "geojson", "parquet", "arrow", "bin",
                             "gml", "leaflet", "avro", "shp"])
    sp.add_argument("-o", "--output")
    sp.add_argument("-m", "--max-features", type=int)
    sp.add_argument("--track", help="track-id attribute for bin export")

    sp = add("fs-partitions", cmd_fs_partitions,
             help="list/compact filesystem-store partitions")
    sp.add_argument("-r", "--root", required=True,
                    help="filesystem store root directory")
    sp.add_argument("-f", "--feature-name", required=True)
    sp.add_argument("--compact", action="store_true")

    sp = add("stats-analyze", cmd_stats_analyze,
             help="recompute and persist stats")
    catalog(sp)

    sp = add("flush", cmd_flush,
             help="checkpoint a schema's rows to the catalog")
    catalog(sp)

    sp = add("age-off", cmd_age_off, help="expire rows older than a "
                                          "retention period")
    catalog(sp)
    sp.add_argument("-r", "--retention", required=True,
                    help='e.g. "7 days", "12 hours"')
    sp.add_argument("--dry-run", action="store_true")

    sp = add("explain", cmd_explain, help="explain query planning")
    catalog(sp)
    sp.add_argument("-q", "--cql", required=True)

    sp = add("stats-count", cmd_stats_count, help="feature count")
    catalog(sp)
    sp.add_argument("-q", "--cql")

    sp = add("stats-bounds", cmd_stats_bounds, help="spatial bounds")
    catalog(sp)

    sp = add("stats-top-k", cmd_stats_top_k, help="top values of an attribute")
    catalog(sp)
    sp.add_argument("-a", "--attribute", required=True)
    sp.add_argument("-k", type=int, default=10)
    sp.add_argument("-q", "--cql")

    sp = add("stats-histogram", cmd_stats_histogram, help="attribute histogram")
    catalog(sp)
    sp.add_argument("-a", "--attribute", required=True)
    sp.add_argument("--bins", type=int, default=20)
    sp.add_argument("--bounds", help="lo,hi")
    sp.add_argument("-q", "--cql")

    add("version", cmd_version, help="print version")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
