"""The port stands alone: importing geomesa_tpu_torch and running its
queries (z3, z2), a heatmap, a mesh store's query and stats, and a lean
store's query, heatmap, tile, count, compaction, pyramid build,
pyramid-served tile, Z3Histogram stat and a replanned query, and
attribute queries on a default, a 2-shard mesh and a lean store (with
the lean attribute stat push-down), a polygon store's xz3 and xz2
queries with the native range sweep loaded, and a restricted query on a
v1-layout store with its deletes and a lean store's delete and age-off,
a catalog's flush and reopen (a labelled default schema and a lean one
with a tombstone), a FileSystemDataStore's write, pruned query and
``to_device_store``, and a 2-shard mesh lean store's z3 and attribute
queries, count, heatmap, pyramids and compaction with a ring query on the
mesh store, and a one-process multihost store's query, stats, bounds,
append and delete, and the serving plane (batched windows on a default
and a lean store, fused queries from four threads, a tile and a query
under deadlines, the audit and the metrics reduction), a traced query,
a lean query degraded by a fault armed through ``set_property``, the
storage report and EXPLAIN ANALYZE, a lean store's heat report, a
``CompactionJob``, the Prometheus text and the SLO report, and the Arrow
results (``query_arrow`` on a default and a lean store,
``query_arrow_table``, the conversion processes, a reprojected query and
the index registry), and a converter ingest of TSV files
(``run_ingest``) with its query, a ``spatial_rdd`` over the ingested
store and the CSV and GeoJSON exports, and the analytics (a
``knn_process``, a ``sql_query`` count and a ``RasterStore.mosaic``),
and the streaming modules (a ``StreamDataStore`` with Avro messages, a
``LambdaDataStore`` persist and merged count, a ``GeoCQEngine`` query, a
``NativeIndex`` query and ``profile``), loads neither ``jax`` nor any module of ``geomesa_tpu``, and its sources
import neither.  Checked in a subprocess, because this test process has
jax loaded by the suite's conftest."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

PORT = Path(__file__).resolve().parent.parent / "geomesa_tpu_torch"

_PROBE = r"""
import json, os, sys
os.environ["GEOMESA_PLANNING_REPLAN_MIN_ROWS"] = "64"
import numpy as np
import geomesa_tpu_torch
from geomesa_tpu_torch import TpuDataStore
ds = TpuDataStore(device="cpu")
ds.create_schema("s", "actor:String,dtg:Date,*geom:Point")
rng = np.random.default_rng(0)
n = 500
ds.write("s", {"actor": np.array(["a"] * n, dtype=object),
               "dtg": rng.integers(1514764800000, 1517443200000, n),
               "geom": (rng.uniform(-10, 10, n), rng.uniform(-10, 10, n))})
r = ds.query_result("s", "BBOX(geom, -5, -5, 5, 5) AND dtg DURING "
                         "2018-01-05T00:00:00Z/2018-01-20T00:00:00Z")
r2 = ds.query_result("s", "BBOX(geom, -5, -5, 5, 5)")
grid = geomesa_tpu_torch.density_process(ds, "s", "INCLUDE",
                                         (-10, -10, 10, 10), 16, 16)
tile = ds.density_tile("s", 1, 1, 0, tile=8)
from geomesa_tpu_torch import device_mesh
ms = TpuDataStore(device="cpu", mesh=device_mesh(devices=["cpu"] * 2))
ms.create_schema("s", "actor:String,dtg:Date,*geom:Point")
ms.write("s", {"actor": np.array(["a", "b"] * (n // 2), dtype=object),
               "dtg": rng.integers(1514764800000, 1517443200000, n),
               "geom": (rng.uniform(-10, 10, n), rng.uniform(-10, 10, n))})
mq = ms.query_result("s", "BBOX(geom, -5, -5, 5, 5) AND dtg DURING "
                          "2018-01-05T00:00:00Z/2018-01-20T00:00:00Z")
mstat = ms.stats("s", "BBOX(geom, -5, -5, 5, 5)",
                 "Count();Frequency(actor,4,64)")
ls = TpuDataStore(device="cpu")
ls.create_schema("l", "dtg:Date,*geom:Point;geomesa.index.profile=lean,"
                      "geomesa.lean.generation.slots=128,"
                      "geomesa.lean.hbm.budget=16384")
for _ in range(4):
    ls.write("l", {"dtg": rng.integers(1514764800000, 1517443200000, n),
                   "geom": (rng.uniform(-10, 10, n),
                            rng.uniform(-10, 10, n))})
lq = ls.query_result("l", "BBOX(geom, -5, -5, 5, 5) AND dtg DURING "
                          "2018-01-05T00:00:00Z/2018-01-20T00:00:00Z")
lgrid = geomesa_tpu_torch.density_process(ls, "l", "INCLUDE",
                                          (-10, -10, 10, 10), 16, 16)
ltile = ls.density_tile("l", 1, 1, 0, tile=8)
lcount = ls.stats("l", "INCLUDE", "Count()").count
ltiers = ls._store("l").index("z3").tier_counts()
lcompact = ls.compact("l")
lbuilt = ls.build_pyramids("l")
lidx = ls._store("l").index("z3")
h0 = lidx.pyramid_serve_hits
lptile = ls.density_tile("l", 0, 0, 0, tile=64)
lserved = lidx.pyramid_serve_hits - h0
lz3 = ls.stats("l", "INCLUDE", "Z3Histogram(geom,dtg,week,8)")
ls.create_schema("r", "dtg:Date,*geom:Point;geomesa.index.profile=lean")
ls.write("r", {"dtg": rng.integers(1514764800000, 1517443200000, n),
               "geom": (np.r_[rng.uniform(0, 0.01, 400),
                              rng.uniform(-10, 10, 100)],
                        np.r_[rng.uniform(0, 0.01, 400),
                              rng.uniform(-10, 10, 100)])})
from geomesa_tpu_torch.planning import ExplainString
rex = ExplainString()
rq = ls.query_result("r", "BBOX(geom, 0, 0, 0.01, 0.01) AND IN ('1', '2')",
                     rex)
aspec = "actor:String:index=true,score:Double:index=true,dtg:Date,*geom:Point"
arows = {"actor": np.array(["a", "b", "c", "b"] * (n // 4), dtype=object),
         "score": rng.uniform(0, 10, n),
         "dtg": rng.integers(1514764800000, 1517443200000, n),
         "geom": (rng.uniform(-10, 10, n), rng.uniform(-10, 10, n))}
aecql = ("actor = 'b' AND dtg DURING "
         "2018-01-05T00:00:00Z/2018-01-20T00:00:00Z")
attr = {}
for key, store, spec in (
        ("default", ds, aspec), ("mesh", ms, aspec),
        ("lean", ls, aspec + ";geomesa.index.profile=lean,"
                             "geomesa.lean.generation.slots=128")):
    store.create_schema("a", spec)
    store.write("a", arows)
    aq = store.query_result("a", aecql)
    rq2 = store.query_result("a", "score BETWEEN 2 AND 2.5")
    attr[key] = [aq.strategy.index, int(len(aq.positions)),
                 rq2.strategy.index, int(len(rq2.positions))]
attr["lean_minmax"] = ls.stats("a", "INCLUDE", "MinMax(score)").max
from geomesa_tpu_torch import native
from geomesa_tpu_torch.geometry.packed import packed_from_boxes
cx, cy = rng.uniform(-10, 10, n), rng.uniform(-10, 10, n)
ds.create_schema("p", "dtg:Date,*geom:Polygon")
ds.write("p", {"dtg": rng.integers(1514764800000, 1517443200000, n),
               "geom": packed_from_boxes(np.stack([cx - 0.1, cy - 0.1,
                                                    cx + 0.1, cy + 0.1], 1))})
px3 = ds.query_result("p", "INTERSECTS(geom, POLYGON((-5 -5, 5 -5, 0 5, "
                           "-5 -5))) AND dtg DURING "
                           "2018-01-05T00:00:00Z/2018-01-20T00:00:00Z")
px2 = ds.query_result("p", "BBOX(geom, -5, -5, 5, 5)")
poly = [px3.strategy.index, int(len(px3.positions)), px2.strategy.index,
        int(len(px2.positions)), native.available(),
        "geomesa_tpu_torch.native" in sys.modules]
from geomesa_tpu_torch.age_off import age_off
from geomesa_tpu_torch.security import StaticAuthorizationsProvider
vs = TpuDataStore(device="cpu",
                  auth_provider=StaticAuthorizationsProvider({"user"}))
vs.create_schema("v", "actor:String,dtg:Date,*geom:Point;"
                      "geomesa.index.versions='z3:1,z2:1'")
for label in ("", "admin"):
    vs.write("v", {"actor": np.array(["a"] * n, dtype=object),
                   "dtg": rng.integers(1514764800000, 1517443200000, n),
                   "geom": (rng.uniform(-10, 10, n),
                            rng.uniform(-10, 10, n))}, visibility=label)
vq = vs.query_result("v", "BBOX(geom, -5, -5, 5, 5) AND dtg DURING "
                          "2018-01-05T00:00:00Z/2018-01-20T00:00:00Z")
vz2 = vs.query_result("v", "BBOX(geom, -5, -5, 5, 5)")
life = {"v1": [vs._store("v").index("z3").version,
               vs._store("v").index("z2").version],
        "restricted": [int(len(vq.positions)), int(vq.positions.max()),
                       int(len(vz2.positions)), vs.get_count("v")],
        "deleted": [vs.delete("v", [str(i) for i in range(0, n, 2)]),
                    vs.delete("v", ["0"]), vs.get_count("v")],
        "lean_deleted": [ls.delete("l", ["0", "1", "1"]),
                         age_off(ls, "l", older_than_ms=1515000000000),
                         ls.stats("l", "INCLUDE", "Count()").count,
                         ls.get_count("l")]}
mls = TpuDataStore(device="cpu", mesh=device_mesh(devices=["cpu"] * 2))
mls.create_schema("ml", aspec + ";geomesa.index.profile=lean,"
                               "geomesa.lean.generation.slots=64,"
                               "geomesa.lean.hbm.budget=12032,"
                               "geomesa.lean.compaction.factor=0")
for _ in range(4):
    mls.write("ml", {k: (v[0].copy(), v[1].copy()) if k == "geom"
                     else v.copy() for k, v in arows.items()})
mlq = mls.query_result("ml", "BBOX(geom, -5, -5, 5, 5) AND dtg DURING "
                             "2018-01-05T00:00:00Z/2018-01-20T00:00:00Z")
mla = mls.query_result("ml", aecql)
mlidx = mls._store("ml").index("z3")
mlbuilt = mls.build_pyramids("ml")
mesh_lean = {"kind": type(mlidx).__name__,
             "z3": [mlq.strategy.index, int(len(mlq.positions))],
             "attr": [mla.strategy.index, int(len(mla.positions))],
             "tiers": mlidx.tier_counts(),
             "count": mls.stats("ml", "INCLUDE", "Count()").count,
             "density": float(geomesa_tpu_torch.density_process(
                 mls, "ml", "INCLUDE", (-180, -90, 180, 90), 32, 32).sum()),
             "built": mlbuilt,
             "compact": mls.compact("ml")["z3"]["merged_groups"],
             "ring": ms._store("s").index("z3").query_ring(
                 [(-5, -5, 5, 5)], None, None).tolist()
             == ms._store("s").index("z3").query(
                 [(-5, -5, 5, 5)], None, None).tolist()}
import shutil, tempfile
from geomesa_tpu_torch.fs import FileSystemDataStore, to_device_store
cat, fsroot = tempfile.mkdtemp(), tempfile.mkdtemp()
pq_ = ("BBOX(geom, -5, -5, 5, 5) AND dtg DURING "
       "2018-01-05T00:00:00Z/2018-01-20T00:00:00Z")
ps = TpuDataStore(device="cpu", catalog_dir=cat)
ps.create_schema("s", "actor:String,dtg:Date,*geom:Point")
ps.create_schema("l", "dtg:Date,*geom:Point;geomesa.index.profile=lean,"
                      "geomesa.lean.generation.slots=128")
prow = {"actor": np.array(["a"] * n, dtype=object),
        "dtg": rng.integers(1514764800000, 1517443200000, n),
        "geom": (rng.uniform(-10, 10, n), rng.uniform(-10, 10, n))}
ps.write("s", prow, visibility="user")
ps.write("l", {k: v for k, v in prow.items() if k != "actor"})
ps.delete("l", ["3"])
for name in ("s", "l"):
    ps.flush(name)
ro = TpuDataStore(device="cpu", catalog_dir=cat,
                  auth_provider=StaticAuthorizationsProvider({"user"}))
fs = FileSystemDataStore(fsroot)
fs.create_schema("e", "actor:String,dtg:Date,*geom:Point")
fs.write("e", prow)
lifted = to_device_store(fs, "e", device="cpu")
persist = {"reopen": [sorted(ro.type_names),
                      ro.query_result("s", pq_).positions.tolist()
                      == ps.query_result("s", pq_).positions.tolist(),
                      ro.query_result("l", pq_).positions.tolist()
                      == ps.query_result("l", pq_).positions.tolist(),
                      ro.get_count("s"), ro.get_count("l")],
           "fs": [fs.count("e"), len(fs.partitions("e")),
                  len(fs.query("e", pq_)),
                  int(len(lifted.query_result("e", pq_).positions)),
                  lifted.query_result("e", pq_).strategy.index]}
shutil.rmtree(cat)
shutil.rmtree(fsroot)
mh = TpuDataStore(device="cpu", mesh=device_mesh(devices=["cpu"] * 2),
                  multihost=True)
mh.create_schema("s", aspec)
mh.write("s", arows)
mhq = mh.query_result("s", pq_)
mh.write("s", {k: (v[0].copy(), v[1].copy()) if k == "geom" else v.copy()
               for k, v in arows.items()})
multihost = {"hits": [int(len(mhq.positions)),
                      int(len(ms.query_result("a", pq_).positions))],
             "append": [mh._store("s")._indexes["z3"]._multihost,
                        int(len(mh.query_result("s", pq_).positions))],
             "count": [mh.get_count("s"),
                       mh.stats("s", "BBOX(geom, -5, -5, 5, 5)",
                                "Count()").count],
             "bounds": mh.get_bounds("s") is not None,
             "deleted": mh.delete("s", ["0", "1"])}
import threading
from geomesa_tpu_torch.audit import InMemoryAuditWriter
from geomesa_tpu_torch.metrics import registry as mreg
from geomesa_tpu_torch.parallel.stats import allreduce_metrics_snapshot
from geomesa_tpu_torch.resilience import (
    CancelScope, Cancelled, admission_gate, deadline_scope,
)
aw = InMemoryAuditWriter()
sv = TpuDataStore(device="cpu", audit_writer=aw, user="probe")
sv.create_schema("sv", "dtg:Date,*geom:Point;geomesa.index.profile=lean,"
                       "geomesa.lean.generation.slots=128")
sv.write("sv", {"dtg": rng.integers(1514764800000, 1517443200000, n),
                "geom": (rng.uniform(-10, 10, n), rng.uniform(-10, 10, n))})
win = [([(-5, -5, 5, 5)], 1515110400000, 1516406400000),
       ([(-5, -5, 5, 5)], None, None)]
sq = "BBOX(geom, -5, -5, 5, 5)"
fused = [None] * 4
ths = [threading.Thread(target=lambda i=i: fused.__setitem__(
    i, sv.query_fused("sv", sq, tenant=str(i % 2)))) for i in range(4)]
for t in ths:
    t.start()
for t in ths:
    t.join()
cs = CancelScope(None)
cs.cancel()
try:
    with deadline_scope(scope=cs):
        ds.query_result("s", sq)
    cancelled = False
except Cancelled:
    cancelled = True
serving = {
    "windows": [[int(len(h)) for h in ds.query_windows("s", win)],
                [int(len(h)) for h in sv.query_windows("sv", win)]],
    "solo": [int(len(r.positions)), int(len(r2.positions))],
    "fused": sorted({(f.strategy.index, int(len(f.positions)))
                     for f in fused}),
    "fused_solo": int(len(sv.query_result("sv", sq).positions)),
    "tile": float(ds.density_tile("s", 1, 1, 0, tile=8,
                                  timeout_ms=60000.0).sum()),
    "partial": sv.query_result("sv", sq, timeout_ms=60000.0,
                               partial_results=True).timed_out,
    "cancelled": cancelled, "inflight": admission_gate.inflight,
    "events": len(aw.query_events("sv")),
    "requests": allreduce_metrics_snapshot()[
        "serving.fused.requests"]["count"],
    "windows_count": mreg.counter("query.s.windows").count}
from geomesa_tpu_torch import config as tcfg
from geomesa_tpu_torch.metrics import RESILIENCE_DEGRADED
from geomesa_tpu_torch.obs import storage_report, tracer
from geomesa_tpu_torch.ops.gate import kernel_health
with tracer.capture() as cap:
    tq = ds.query_result("s", sq)
tspans = sorted({sp.name for tr in cap.traces() for sp in tr.spans})
deg0 = mreg.counter(RESILIENCE_DEGRADED).count
tcfg.set_property("geomesa.resilience.fault.points", "device.dispatch:1=oom")
try:
    dq = sv.query_result("sv", sq)
finally:
    tcfg.clear_property("geomesa.resilience.fault.points")
obs = {"spans": tspans, "traced_hits": int(len(tq.positions)),
       "degraded": mreg.counter(RESILIENCE_DEGRADED).count - deg0,
       "degraded_hits": int(len(dq.positions)),
       "trace_id": bool(aw.query_events("sv")[-1].trace_id),
       "storage": storage_report(sv)["reconciliation"]["within_tolerance"],
       "explain": sv.explain_analyze("sv", sq).summary["actual_matched"],
       "gates": sorted(k for k, v in kernel_health().items()
                       if k.endswith("_ok"))}
from geomesa_tpu_torch.jobs import CompactionJob
from geomesa_tpu_torch.obs import jobs_registry, prometheus_text, slo_plane
hrep = ls.heat_report()
CompactionJob(ls, "l").run()
obs.update({"heat": [len(hrep["generations"]),
                     len(ls._store("l").index("z3").generations),
                     sum(g["scans"] for g in hrep["generations"])],
            "job": jobs_registry.jobs(kind="compaction")[0].state,
            "prom": prometheus_text(mreg.snapshot()).count("# TYPE "),
            "slo": [sorted(slo_plane.report()["classes"]),
                    slo_plane.report()["enabled"]]})
from geomesa_tpu_torch.arrow import read_feature_batch
from geomesa_tpu_torch.index import available_indices
from geomesa_tpu_torch.process import (arrow_conversion_process,
                                       bin_conversion_process)
from geomesa_tpu_torch.planning.planner import Query as TQ
aq = "BBOX(geom, -5, -5, 5, 5)"
arrow = {"default": [ds.query_arrow("s", aq, chunk_rows=64).to_table()
                     .num_rows, int(len(ds.query_result("s", aq).positions))],
         "lean": [ls.query_arrow("l", aq, chunk_rows=64).to_table().num_rows,
                  int(len(ls.query_result("l", aq).positions))],
         "table": ds.query_arrow_table("s", aq, sort_field="dtg").num_rows,
         "conv": [len(read_feature_batch(arrow_conversion_process(
                      ds, "s", aq))),
                  len(bin_conversion_process(ds, "s", aq)) // 16],
         "crs": float(abs(ds.query_result("s", TQ.of(aq, crs="EPSG:3857"))
                          .batch.geom_xy()[0]).max()),
         "registry": available_indices()}
from geomesa_tpu_torch.io import to_csv, to_geojson
from geomesa_tpu_torch.jobs import run_ingest
from geomesa_tpu_torch.parallel import spatial_rdd
idir = tempfile.mkdtemp()
ipaths = []
for f in range(2):
    ipaths.append(os.path.join(idir, f"e{f}.tsv"))
    with open(ipaths[-1], "w") as fh:
        fh.write("".join(f"{f}_{i}\t2018010{1 + i % 9}\t{i % 20 - 10}.5\t"
                         f"{i % 10 - 5}.25\n" for i in range(200))
                 + "bad\trow\n")
ing = TpuDataStore(device="cpu")
ing.create_schema("e", "dtg:Date,*geom:Point")
ires = run_ingest(ing, "e", {
    "type": "tsv", "id-field": "$0",
    "fields": [{"name": "dtg", "transform": "basicDate($1)"},
               {"name": "geom",
                "transform": "point(toDouble($2), toDouble($3))"}],
    "options": {"validators": ["z-index"]}}, ipaths, workers=2)
shutil.rmtree(idir)
iq = ing.query_result("e", "BBOX(geom, -5, -5, 5, 5) AND dtg DURING "
                           "2018-01-01T00:00:00Z/2018-01-05T00:00:00Z")
irdd = spatial_rdd({"store": ing}, "e", "BBOX(geom, -5, -5, 5, 5)",
                   num_partitions=3)
ingest = {"counts": [ires.ingested, ires.failed, ires.files],
          "hits": [iq.strategy.index, int(len(iq.positions))],
          "rdd": [irdd.num_partitions, irdd.count(), int(len(
              ing.query_result("e", "BBOX(geom, -5, -5, 5, 5)").positions))],
          "csv": to_csv(iq.batch).count("\n"),
          "geojson": len(json.loads(to_geojson(iq.batch))["features"])}
from geomesa_tpu_torch.process import knn_process
from geomesa_tpu_torch.raster import RasterStore
from geomesa_tpu_torch.sql import sql_query
kpos, kdist = knn_process(ds, "s", 0.0, 0.0, 7)
rs = RasterStore("r", device="cpu")
for i in range(4):
    rs.put(np.full((8, 8), float(i), np.float32), (i, 0, i + 1, 1))
mos = rs.mosaic((0, 0, 4, 1), 16, 4)
analytics = {"knn": [int(len(kpos)), bool(np.all(np.diff(kdist) >= 0))],
             "sql": [sql_query(ds, "SELECT count(*) FROM s WHERE "
                                   "BBOX(geom, -5, -5, 5, 5)"),
                     int(len(r2.positions))],
             "mosaic": [list(mos.shape), float(mos.sum())]}
import contextlib, io as _io
from geomesa_tpu_torch.blob import GeoIndexedBlobStore
from geomesa_tpu_torch.cli.main import main as cli_main
from geomesa_tpu_torch.geojson import GeoJsonIndex
from geomesa_tpu_torch.views import MergedDataStoreView
from geomesa_tpu_torch.web import WebApp


def _get(app, path):
    seen = []
    p, _, qs = path.partition("?")
    out = b"".join(app({"REQUEST_METHOD": "GET", "PATH_INFO": p,
                        "QUERY_STRING": qs, "CONTENT_LENGTH": "0",
                        "wsgi.input": _io.BytesIO(b"")},
                       lambda st, h: seen.append(st)))
    return seen[0], out


gj = GeoJsonIndex()
gj.create_index("g", points=True)
gj.add("g", {"type": "Feature", "id": "a", "properties": {"k": 1},
             "geometry": {"type": "Point", "coordinates": [1.0, 1.0]}})
web = WebApp(ds, blob=GeoIndexedBlobStore(TpuDataStore(device="cpu")),
             geojson=gj)
st_data, body_data = _get(web, "/api/data/s?format=csv&cql=BBOX(geom,"
                               "%20-5,%20-5,%205,%205)")
st_tile, body_tile = _get(web, "/tiles/1/1/0?schema=s&tile=8")
st_gj, body_gj = _get(web, "/geojson/index/g/query?q=%7B%22k%22:%201%7D")
view = MergedDataStoreView([ds, ds])
cdir = tempfile.mkdtemp()
cli = TpuDataStore(device="cpu", catalog_dir=cdir)
cli.create_schema("s", "actor:String,dtg:Date,*geom:Point")
cli.write("s", {"actor": np.array(["a"] * n, dtype=object),
                "dtg": ds.query("s").column("dtg"),
                "geom": ds.query("s").geom_xy()})
cli.flush("s")
buf = _io.StringIO()
with contextlib.redirect_stdout(buf):
    cli_rc = cli_main(["--device", "cpu", "sql", "-c", cdir,
                       "SELECT count(*) FROM s WHERE "
                       "BBOX(geom, -5, -5, 5, 5)"])
shutil.rmtree(cdir)
frontends = {"data": [st_data, body_data.decode().count("\n")],
             "tile": [st_tile, json.loads(body_tile)["total"]],
             "geojson": [st_gj, len(json.loads(body_gj)["features"])],
             "view": view.count("s", "BBOX(geom, -5, -5, 5, 5)"),
             "cli": [cli_rc, buf.getvalue().strip()]}
from geomesa_tpu_torch.geometry.types import Point as _Pt
from geomesa_tpu_torch.lambda_store import LambdaDataStore
from geomesa_tpu_torch.memory import GeoCQEngine
from geomesa_tpu_torch.native_api import NativeIndex, NativeQuery
from geomesa_tpu_torch.stream import (
    AvroMessageCodec, GeoMessage, SchemaRegistry, StreamDataStore,
)
from geomesa_tpu_torch.utils.profiling import Timings, profile
sds = StreamDataStore(registry=SchemaRegistry())
sds.create_schema("live", "v:Int,dtg:Date,*geom:Point")
for i in range(4):
    sds.write("live", f"f{i}", {"v": i, "dtg": 1514764800000,
                                "geom": (float(i), float(i))})
lclock = [1000.0]
lam = LambdaDataStore(TpuDataStore(device="cpu"), expiry_ms=1000,
                      clock=lambda: lclock[0])
lam.create_schema("lt", "v:Int,dtg:Date,*geom:Point")
for i in range(3):
    lam.write("lt", f"x{i}", {"v": i, "dtg": 1514764800000,
                              "geom": (float(i), 0.0)})
lclock[0] += 2.0
lam_persisted = lam.persist("lt")
lam.write("lt", "x9", {"v": 9, "dtg": 1514764800000, "geom": (0.5, 0.0)})
eng = GeoCQEngine(sds.get_schema("live"))
for i in range(10):
    eng.insert(f"e{i}", {"v": i, "dtg": 0}, float(i), float(i))
nidx = NativeIndex("nat", store=TpuDataStore(device="cpu"))
nidx.insert("a", _Pt(1.0, 1.0), 1514764800000, fid="n1")
nidx.insert("b", _Pt(9.0, 9.0), 1514764800000, fid="n2")
ptimes = Timings()
with profile("probe.phase", sink=ptimes):
    pass
streaming = {
    "consumed": sds.consume("live"),
    "stream_hits": list(sds.query("live", "BBOX(geom, 0.5, 0.5, 2.5, 2.5)"
                                  ).ids),
    "msg": GeoMessage.from_bytes(GeoMessage.delete("f1").to_bytes()).kind,
    "lambda": [lam_persisted, lam.count("lt")],
    "engine": list(eng.query("v >= 7 AND BBOX(geom, 0, 0, 8, 8)").ids),
    "native": nidx.query(NativeQuery().within(0, 0, 5, 5)),
    "profile": len(ptimes.times["probe.phase"])}
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "geomesa_tpu" or m.startswith("geomesa_tpu."))
print(json.dumps({"bad": bad, "strategy": r.strategy.index,
                  "hits": int(len(r.positions)),
                  "strategy2": r2.strategy.index,
                  "density": float(grid.sum()), "tile": float(tile.sum()),
                  "mesh_strategy": mq.strategy.index,
                  "mesh_hits": int(len(mq.positions)),
                  "mesh_count": int(mstat.stats[0].count),
                  "mesh_freq": int(mstat.stats[1].table.sum()),
                  "lean_strategy": lq.strategy.index,
                  "lean_hits": int(len(lq.positions)),
                  "lean_density": float(lgrid.sum()),
                  "lean_tile": float(ltile.sum()), "lean_count": int(lcount),
                  "lean_tiers": ltiers,
                  "lean_generations": lcompact["z3"]["generations"],
                  "lean_built": lbuilt, "lean_served": lserved,
                  "lean_ptile": float(lptile.sum()),
                  "lean_z3hist": int(sum(lz3.counts.values())),
                  "replan_strategy": rq.strategy.index,
                  "replan_source": rq.strategy.source,
                  "replan_hits": rq.positions.tolist(),
                  "replans": str(rex).count("Replanning: z3 observed"),
                  "attr": attr, "poly": poly, "life": life,
                  "persist": persist, "mesh_lean": mesh_lean,
                  "multihost": multihost, "serving": serving,
                  "obs": obs, "arrow": arrow, "ingest": ingest,
                  "analytics": analytics, "frontends": frontends,
                  "streaming": streaming}))
"""


def _is_jax_or_reference(name: str) -> bool:
    # geomesa_tpu_torch shares the prefix but is a package of its own
    return (name in ("jax", "jaxlib", "geomesa_tpu")
            or name.startswith(("jax.", "jaxlib.", "geomesa_tpu.")))


def test_import_and_query_load_no_jax():
    res = subprocess.run([sys.executable, "-c", _PROBE],
                         capture_output=True, text=True, timeout=300,
                         cwd=PORT.parent)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert out["strategy"] == "z3" and out["hits"] > 0
    assert out["strategy2"] == "z2"
    assert out["density"] == 500 and out["tile"] > 0
    assert out["mesh_strategy"] == "z3" and out["mesh_hits"] > 0
    assert out["mesh_count"] > 0
    assert out["mesh_freq"] == 4 * out["mesh_count"]
    assert out["lean_strategy"] == "z3" and out["lean_hits"] > 0
    assert out["lean_density"] == out["lean_count"] == 4 * 500
    assert out["lean_tile"] > 0
    assert min(out["lean_tiers"].values()) > 0   # full, keys and host
    assert out["lean_generations"] < 16
    assert out["lean_built"] == out["lean_served"] == \
        out["lean_generations"] - 1
    assert out["lean_ptile"] == out["lean_z3hist"] == 4 * 500
    assert out["replan_strategy"] == "id"
    assert out["replan_source"] == "heuristic"
    assert out["replan_hits"] == [1, 2] and out["replans"] == 1
    attr = out["attr"]
    for key in ("default", "mesh", "lean"):
        assert attr[key][0] == "attr:actor" and attr[key][1] > 0
        assert attr[key][2] == "attr:score"
        assert attr[key][1:] == attr["default"][1:]
    assert 9.9 < attr["lean_minmax"] < 10
    poly = out["poly"]
    assert poly[0] == "xz3" and poly[1] > 0
    assert poly[2] == "xz2" and poly[3] > poly[1]
    assert poly[4] is True and poly[5] is True
    life = out["life"]
    assert life["v1"] == [1, 1]
    # only the unlabelled first write's rows are visible to "user"
    assert 0 < life["restricted"][0] and life["restricted"][1] < 500
    assert life["restricted"][2] > life["restricted"][0]
    assert life["restricted"][3] == 500
    assert life["deleted"] == [250, 0, 250]
    assert life["lean_deleted"][0] == 2 and life["lean_deleted"][1] > 0
    assert (life["lean_deleted"][2] == life["lean_deleted"][3]
            == 4 * 500 - 2 - life["lean_deleted"][1])
    ml = out["mesh_lean"]
    assert ml["kind"] == "ShardedLeanZ3Index"
    assert ml["z3"][0] == "z3" and ml["z3"][1] > 0
    assert ml["attr"] == ["attr:actor", 4 * attr["default"][1]]
    assert ml["tiers"]["keys"] > 0 and ml["tiers"]["host"] > 0
    assert ml["count"] == ml["density"] == 4 * 500
    assert ml["built"] > 0 and ml["compact"] > 0 and ml["ring"] is True
    persist = out["persist"]
    assert persist["reopen"] == [["l", "s"], True, True, 500, 499]
    assert persist["fs"][0] == 500 and persist["fs"][1] > 1
    assert persist["fs"][2] == persist["fs"][3] > 0
    assert persist["fs"][4] == "z3"
    mh = out["multihost"]
    assert mh["hits"][0] == mh["hits"][1] > 0
    assert mh["append"] == [True, 2 * mh["hits"][0]]
    assert mh["count"][0] == 2 * 500 and mh["count"][1] > 0
    assert mh["bounds"] is True and mh["deleted"] == 2
    sv = out["serving"]
    # the default store's windows answer as its solo z3 and z2 queries
    assert sv["windows"][0] == sv["solo"] and sv["solo"][0] > 0
    assert sv["windows"][1][1] == sv["fused_solo"] > 0
    assert sv["fused"] == [["fused", sv["fused_solo"]]]
    assert sv["tile"] == out["tile"] and sv["partial"] is False
    assert sv["cancelled"] is True and sv["inflight"] == 0
    assert sv["events"] >= 4 and sv["requests"] == 4
    assert sv["windows_count"] == 2
    obs = out["obs"]
    assert {"query", "query.plan", "query.scan", "query.scan.device",
            "query.post_filter"} <= set(obs["spans"])
    assert obs["traced_hits"] == sv["solo"][1]
    # the armed fault demoted generations and the answer stayed whole
    assert obs["degraded"] >= 1 and obs["degraded_hits"] == sv["fused_solo"]
    assert obs["trace_id"] is True and obs["storage"] is True
    assert obs["explain"] == sv["fused_solo"]
    assert obs["gates"] == ["density_ok", "hist1d_ok", "z2_scan_ok",
                            "z3_scan_ok"]
    # every lean generation ranks once, and the probe's scans touched them
    assert obs["heat"][0] >= obs["heat"][1] > 0 and obs["heat"][2] > 0
    assert obs["job"] == "succeeded" and obs["prom"] > 10
    assert obs["slo"] == [["query", "tile.render", "write"], True]
    arrow = out["arrow"]
    assert arrow["default"][0] == arrow["default"][1] > 0
    assert arrow["lean"][0] == arrow["lean"][1] > 0
    assert arrow["table"] == arrow["conv"][0] == arrow["conv"][1] \
        == arrow["default"][1]
    assert 1e5 < arrow["crs"] < 6e5      # Mercator meters, not degrees
    assert {"z3", "z2", "xz2", "xz3", "id", "attr"} <= set(arrow["registry"])
    ing = out["ingest"]
    assert ing["counts"] == [400, 2, 2]
    assert ing["hits"][0] == "z3" and ing["hits"][1] > 0
    assert ing["rdd"][0] == 3 and ing["rdd"][1] == ing["rdd"][2] > 0
    assert ing["csv"] == ing["geojson"] + 1 == ing["hits"][1] + 1
    an = out["analytics"]
    assert an["knn"] == [7, True]
    assert an["sql"][0] == an["sql"][1] == out["serving"]["solo"][1] > 0
    assert an["mosaic"] == [[4, 16], 4.0 * (0 + 1 + 2 + 3) * 4]
    fe = out["frontends"]
    hits = out["serving"]["solo"][1]
    assert fe["data"] == ["200 OK", hits + 1]        # a header and the rows
    assert fe["tile"][0] == "200 OK" and fe["tile"][1] > 0
    assert fe["geojson"] == ["200 OK", 1]
    assert fe["view"] == 2 * hits
    assert fe["cli"] == [0, str(hits)]
    sm = out["streaming"]
    assert sm["consumed"] == 4 and sm["stream_hits"] == ["f1", "f2"]
    assert sm["msg"] == "delete" and sm["lambda"] == [3, 4]
    assert sm["engine"] == ["e7", "e8"] and sm["native"] == ["a"]
    assert sm["profile"] == 1


def test_source_scan_covers_the_streaming_modules():
    scanned = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"stream/__init__.py", "stream/messages.py", "stream/broker.py",
            "stream/registry.py", "stream/store.py", "stream/polling.py",
            "lambda_store.py", "memory.py", "native_api.py",
            "utils/profiling.py"} <= scanned


def test_source_scan_covers_the_analysis_modules():
    scanned = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"analysis/__init__.py", "analysis/__main__.py",
            "analysis/baseline.py", "analysis/model.py", "analysis/walker.py",
            "analysis/checks/__init__.py", "analysis/checks/config_options.py",
            "analysis/checks/fault_points.py", "analysis/checks/host_sync.py",
            "analysis/checks/lock_discipline.py",
            "analysis/checks/recompile_hazard.py",
            "analysis/checks/taxonomy.py"} <= scanned


def test_source_scan_covers_the_front_end_modules():
    scanned = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"web/__init__.py", "web/app.py", "web/wsgi.py",
            "geojson/__init__.py", "geojson/query.py", "geojson/index.py",
            "geojson/servlet.py", "blob.py", "views.py", "cli/__init__.py",
            "cli/__main__.py", "cli/main.py"} <= scanned


def test_source_scan_covers_the_analytics_modules():
    scanned = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"process/knn.py", "process/tube.py", "process/proximity.py",
            "process/route.py", "process/track.py", "process/transform.py",
            "process/unique.py", "process/join.py", "process/query.py",
            "process/sampling.py", "utils/geohash.py",
            "utils/spatial_index.py", "sql/__init__.py", "sql/functions.py",
            "sql/frame.py", "sql/parser.py", "sql/join.py",
            "raster.py"} <= scanned


def test_source_scan_covers_the_ingest_modules():
    scanned = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"io/converters.py", "io/expressions.py", "io/enrichment.py",
            "io/formats.py", "io/avro.py", "io/export.py",
            "geometry/geojson.py", "parallel/rdd.py", "jobs.py"} <= scanned


def test_source_scan_covers_the_serving_modules():
    scanned = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"metrics.py", "audit.py", "resilience/deadline.py",
            "resilience/admission.py", "serving/fusion.py"} <= scanned


def test_source_scan_covers_the_observability_modules():
    scanned = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"obs/trace.py", "obs/resource.py", "obs/explain_analyze.py",
            "obs/heat.py", "obs/slo.py", "obs/attribution.py",
            "obs/prom.py", "obs/jobs.py", "obs/recompile.py", "jobs.py",
            "resilience/faults.py", "resilience/degrade.py",
            "ops/gate.py"} <= scanned


def test_source_scan_covers_the_multihost_modules():
    scanned = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"parallel/multihost.py", "process/_multihost.py"} <= scanned


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_is_jax_or_reference(n) for n in names), \
            f"{path.name}:{node.lineno} imports {names}"


def test_name_check_keeps_the_port_apart():
    assert _is_jax_or_reference("geomesa_tpu")
    assert _is_jax_or_reference("geomesa_tpu.curve")
    assert not _is_jax_or_reference("geomesa_tpu_torch")
    assert not _is_jax_or_reference("geomesa_tpu_torch.curve")
