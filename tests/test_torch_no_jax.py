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
mesh store, loads neither ``jax`` nor
any module of ``geomesa_tpu``, and its sources import neither.  Checked in a subprocess, because this test process has
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
                  "persist": persist, "mesh_lean": mesh_lean}))
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
