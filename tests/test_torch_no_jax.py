"""The port stands alone: importing geomesa_tpu_torch and running its
queries (z3, z2), a heatmap, and a mesh store's query and stats loads
neither ``jax`` nor any module of ``geomesa_tpu``, and its sources import
neither.  Checked in a subprocess, because this test process has
jax loaded by the suite's conftest."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

PORT = Path(__file__).resolve().parent.parent / "geomesa_tpu_torch"

_PROBE = r"""
import json, sys
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
                  "mesh_freq": int(mstat.stats[1].table.sum())}))
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
