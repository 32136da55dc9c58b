"""Port parity: the command-line tools (``geomesa_tpu_torch/cli/``)
against geomesa_tpu's ``cli/`` — every case of ``tests/test_cli.py`` run
through the JAX ``main`` and the port's ``main --device cpu`` on catalogs
built alike, with their standard output compared (output paths replaced
by a marker) and the files they write compared byte for byte or row for
row; a catalog written by the JAX CLI read by the port's CLI and the
reverse; and the port's CLI with no card and no ``--device cpu``, which
exits non-zero with ``resolve_device``'s message and opens nothing."""

import json
import os
import re

import numpy as np
import pytest

from geomesa_tpu.cli.main import main as jmain
from geomesa_tpu_torch.cli.main import main as tmain_raw

CSV = """2018-01-01 10:00:00,alice,-74.1,40.7
2018-01-01 11:30:00,bob,2.35,48.85
2018-01-02 09:15:00,carol,139.7,35.6
2018-01-03 08:00:00,dave,-73.9,40.8
2018-01-03 23:59:59,erin,151.2,-33.9
"""

CONV = {
    "type": "delimited-text",
    "format": "CSV",
    "fields": [
        {"name": "dtg", "transform": "date('yyyy-MM-dd HH:mm:ss', $0)"},
        {"name": "name", "transform": "$1"},
        {"name": "geom", "transform": "point($2, $3)"},
    ],
}
SPEC = "name:String,dtg:Date,*geom:Point"


def tmain(argv):
    return tmain_raw(["--device", "cpu"] + list(argv))


def _inputs(tmp):
    csv_path = tmp / "data.csv"
    csv_path.write_text(CSV)
    conv_path = tmp / "conv.json"
    conv_path.write_text(json.dumps(CONV))
    return str(csv_path), str(conv_path)


class Both:
    """The JAX and the port CLI on catalogs of their own under one tmp."""

    def __init__(self, tmp, capsys):
        self.tmp, self.capsys = tmp, capsys
        self.cats = {"j": str(tmp / "jcat"), "t": str(tmp / "tcat")}

    def run(self, argv, compare=True, times=False):
        """``argv`` with ``{cat}`` and ``{out}`` placeholders; returns the
        JAX output after holding the port's equal to it (with ``times``,
        the milliseconds in it replaced by a marker first)."""
        outs = []
        for side, fn in (("j", jmain), ("t", tmain)):
            self.capsys.readouterr()
            out_dir = str(self.tmp / f"out_{side}")
            os.makedirs(out_dir, exist_ok=True)
            args = [a.replace("{cat}", self.cats[side])
                    .replace("{out}", out_dir) for a in argv]
            assert fn(args) == 0
            outs.append(self.capsys.readouterr().out
                        .replace(out_dir, "<out>")
                        .replace(self.cats[side], "<cat>"))
            if times:
                outs[-1] = re.sub(r"[0-9.]+ms", "<ms>", outs[-1])
        if compare:
            assert outs[1] == outs[0], outs
        return outs[0]

    def out(self, side, name):
        return str(self.tmp / f"out_{side}" / name)


@pytest.fixture
def cli(tmp_path, capsys):
    both = Both(tmp_path, capsys)
    csv_path, conv_path = _inputs(tmp_path)
    both.run(["create-schema", "-c", "{cat}", "-f", "people", "-s", SPEC])
    both.run(["ingest", "-c", "{cat}", "-f", "people", "-C", conv_path,
              csv_path])
    return both


def test_roundtrip_and_counts(cli):
    assert cli.run(["get-type-names", "-c", "{cat}"]) == "people\n"
    assert cli.run(["stats-count", "-c", "{cat}", "-f", "people"]) == "5\n"


@pytest.mark.parametrize("argv", [
    ["-q", "BBOX(geom, -80, 30, 10, 50)"],
    ["-q", "BBOX(geom, -80, 30, 10, 50) AND dtg DURING "
           "2018-01-01T00:00:00Z/2018-01-02T00:00:00Z"],
    [], ["-m", "2"], ["-F", "geojson"], ["-F", "gml"], ["-F", "leaflet"],
    ["-F", "geojson", "-q", "name = 'carol'"],
])
def test_export_text(cli, argv):
    out = cli.run(["export", "-c", "{cat}", "-f", "people"] + argv)
    if argv[:1] == ["-q"] and "DURING" not in argv[1]:
        assert "alice" in out and "bob" in out and "carol" not in out


@pytest.mark.parametrize("fmt,name", [
    ("geojson", "out.geojson"), ("csv", "out.csv"), ("gml", "out.gml"),
    ("leaflet", "out.html"), ("bin", "out.bin"), ("avro", "out.avro")])
def test_export_file(cli, monkeypatch, fmt, name):
    # an Avro container's 16-byte sync marker is random in both packages
    monkeypatch.setattr(os, "urandom", lambda n: bytes(range(n)))
    cli.run(["export", "-c", "{cat}", "-f", "people", "-F", fmt, "-o",
             "{out}/" + name])
    with open(cli.out("j", name), "rb") as f:
        want = f.read()
    with open(cli.out("t", name), "rb") as f:
        assert f.read() == want
    if fmt == "geojson":
        assert len(json.loads(want)["features"]) == 5


def test_export_parquet_and_reingest(cli):
    import pyarrow.parquet as pq
    cli.run(["export", "-c", "{cat}", "-f", "people", "-F", "parquet", "-o",
             "{out}/out.parquet"])
    assert pq.read_table(cli.out("t", "out.parquet")).equals(
        pq.read_table(cli.out("j", "out.parquet")))
    for side in ("j", "t"):
        cli.cats[side] = str(cli.tmp / f"cat2_{side}")
    cli.run(["create-schema", "-c", "{cat}", "-f", "people", "-s", SPEC])
    cli.run(["ingest", "-c", "{cat}", "-f", "people", "{out}/out.parquet"])
    assert cli.run(["stats-count", "-c", "{cat}", "-f", "people"]) == "5\n"


def test_export_arrow_file(cli):
    import pyarrow as pa
    cli.run(["export", "-c", "{cat}", "-f", "people", "-F", "arrow", "-o",
             "{out}/out.arrow"])
    tables = [pa.ipc.open_file(cli.out(s, "out.arrow")).read_all()
              for s in ("j", "t")]
    assert tables[1].equals(tables[0]) and tables[0].num_rows == 5


@pytest.mark.parametrize("fmt", ["parquet", "arrow", "avro", "shp"])
def test_export_needs_output(cli, fmt):
    for fn in (jmain, tmain):
        with pytest.raises(SystemExit) as e:
            fn(["export", "-c", cli.cats["j" if fn is jmain else "t"], "-f",
                "people", "-F", fmt])
        assert str(e.value) == f"{fmt} export requires -o/--output"


def test_explain_and_describe(cli):
    out = cli.run(["explain", "-c", "{cat}", "-f", "people", "-q",
                   "BBOX(geom, -80, 30, 10, 50) AND dtg DURING "
                   "2018-01-01T00:00:00Z/2018-01-02T00:00:00Z"], times=True)
    assert "chosen: z3" in out
    out = cli.run(["describe-schema", "-c", "{cat}", "-f", "people"])
    assert "*geom" in out


def test_stats_commands(cli):
    cli.run(["stats-bounds", "-c", "{cat}", "-f", "people"])
    out = cli.run(["stats-top-k", "-c", "{cat}", "-f", "people", "-a",
                   "name"])
    assert "alice" in out
    cli.run(["stats-top-k", "-c", "{cat}", "-f", "people", "-a", "name",
             "-k", "2", "-q", "BBOX(geom, -80, 30, 10, 50)"])
    cli.run(["stats-count", "-c", "{cat}", "-f", "people", "-q",
             "BBOX(geom, -80, 30, 10, 50)"])
    assert "geomesa-tpu" in cli.run(["version"])


def test_stats_histogram_and_analyze(cli):
    for side in ("j", "t"):
        cli.cats[side] = str(cli.tmp / f"num_{side}")
    cli.run(["create-schema", "-c", "{cat}", "-f", "n", "-s",
             "v:Double,dtg:Date,*geom:Point"])
    from geomesa_tpu.datastore import TpuDataStore as JStore
    from geomesa_tpu_torch.datastore import TpuDataStore as TStore
    rng = np.random.default_rng(4)
    rows = {"v": rng.uniform(0, 10, 50), "dtg": np.full(50, 1514764800000),
            "geom": (rng.uniform(-5, 5, 50), rng.uniform(-5, 5, 50))}
    for ds in (JStore(cli.cats["j"]),
               TStore(device="cpu", catalog_dir=cli.cats["t"])):
        ds.write("n", rows)
        ds.flush("n")
    cli.run(["stats-histogram", "-c", "{cat}", "-f", "n", "-a", "v",
             "--bins", "5"])
    cli.run(["stats-histogram", "-c", "{cat}", "-f", "n", "-a", "v",
             "--bins", "4", "--bounds", "0,8", "-q",
             "BBOX(geom, -5, -5, 0, 5)"])
    assert "50 features" in cli.run(["stats-analyze", "-c", "{cat}", "-f",
                                     "n"])


def test_bin_export(cli):
    from geomesa_tpu.io import decode_bin
    cli.run(["export", "-c", "{cat}", "-f", "people", "-F", "bin", "-o",
             "{out}/out.bin", "--track", "name"])
    with open(cli.out("t", "out.bin"), "rb") as f:
        blob = f.read()
    with open(cli.out("j", "out.bin"), "rb") as f:
        assert blob == f.read()
    assert len(decode_bin(blob)["lon"]) == 5


def test_catalog_persists_across_processes(cli):
    assert cli.run(["stats-count", "-c", "{cat}", "-f", "people"]) == "5\n"
    assert cli.run(["remove-schema", "-c", "{cat}", "-f", "people"]) == \
        "removed people\n"
    assert cli.run(["get-type-names", "-c", "{cat}"]) == ""


def test_cli_fs_partitions(tmp_path, capsys):
    from geomesa_tpu.fs import FileSystemDataStore as JFs
    from geomesa_tpu_torch.fs import FileSystemDataStore as TFs
    both = Both(tmp_path, capsys)
    rng = np.random.default_rng(0)
    parts = [{"dtg": rng.integers(1514764800000,
                                  1514764800000 + 2 * 86_400_000, 100),
              "geom": (rng.uniform(-10, 10, 100), rng.uniform(-10, 10, 100))}
             for _ in range(2)]
    for side, cls in (("j", JFs), ("t", TFs)):
        fs = cls(str(tmp_path / f"fs_{side}"))
        fs.create_schema("evt", "dtg:Date,*geom:Point")
        for p in parts:
            fs.write("evt", p)
        both.cats[side] = str(tmp_path / f"fs_{side}")
    out = both.run(["fs-partitions", "-r", "{cat}", "-f", "evt"])
    assert "2 file(s)" in out
    out = both.run(["fs-partitions", "-r", "{cat}", "-f", "evt",
                    "--compact"])
    assert "compacted evt" in out and "1 file(s)" in out


def test_cli_migrate_and_index_versions(tmp_path, capsys):
    both = Both(tmp_path, capsys)
    both.run(["create-schema", "-c", "{cat}", "-f", "legacy", "-s",
              "name:String,dtg:Date,*geom:Point;"
              "geomesa.index.versions='z3:1,z2:1'"])
    out = both.run(["index-versions", "-c", "{cat}", "-f", "legacy"])
    assert "z3: v1" in out and "z2: v1" in out
    assert "z3 v1 -> v2" in both.run(["migrate-schema", "-c", "{cat}", "-f",
                                      "legacy"])
    assert "z3: v2" in both.run(["index-versions", "-c", "{cat}", "-f",
                                 "legacy"])
    assert "already at current" in both.run(["migrate-schema", "-c",
                                             "{cat}", "-f", "legacy"])


def test_export_shapefile(cli):
    from geomesa_tpu_torch.io.formats import read_shapefile
    cli.run(["export", "-c", "{cat}", "-f", "people", "-F", "shp", "-o",
             "{out}/out.shp"])
    for ext in ("shp", "shx", "dbf"):
        with open(cli.out("j", f"out.{ext}"), "rb") as f:
            want = f.read()
        with open(cli.out("t", f"out.{ext}"), "rb") as f:
            assert f.read() == want, ext
    geoms, attrs = read_shapefile(cli.out("t", "out.shp"),
                                  cli.out("t", "out.dbf"))
    assert len(geoms) == 5
    assert {s.strip() for s in attrs["name"]} == \
        {"alice", "bob", "carol", "dave", "erin"}


@pytest.mark.parametrize("sql,lines", [
    ("SELECT count(*) FROM people", ["5"]),
    ("SELECT count(*) AS n FROM people GROUP BY name", None),
    ("SELECT count(*) AS n FROM people", ["n", "5"]),
    ("SELECT name FROM people WHERE BBOX(geom, -80, 30, 10, 50)", None),
    ("SELECT * FROM people WHERE name = 'erin'", None),
    ("SELECT count(*) FROM people WHERE BBOX(geom, -80, 30, 10, 50) AND "
     "dtg DURING 2018-01-01T00:00:00Z/2018-01-04T00:00:00Z", ["3"]),
])
def test_cli_sql_shapes(cli, sql, lines):
    out = cli.run(["sql", "-c", "{cat}", sql]).strip().splitlines()
    if lines is not None:
        assert out == lines
    if "GROUP BY" in sql:
        assert out[0] == "name,n" and len(out) == 6


def test_cli_flush_checkpoint(tmp_path, capsys):
    from geomesa_tpu.datastore import TpuDataStore as JStore
    from geomesa_tpu_torch.datastore import TpuDataStore as TStore
    both = Both(tmp_path, capsys)
    both.run(["create-schema", "-c", "{cat}", "-f", "evt", "-s",
              "dtg:Date,*geom:Point;geomesa.index.profile=lean,"
              "geomesa.lean.generation.slots=1024"])
    rows = {"dtg": np.full(5, 1514764800000),
            "geom": (np.zeros(5), np.zeros(5))}
    for ds in (JStore(both.cats["j"]),
               TStore(device="cpu", catalog_dir=both.cats["t"])):
        ds.write("evt", rows)
        ds.flush("evt")
    assert "lean snapshot" in both.run(["flush", "-c", "{cat}", "-f", "evt"])
    assert len(TStore(device="cpu",
                      catalog_dir=both.cats["t"])._store("evt").batch) == 5


def test_age_off(cli):
    out = cli.run(["age-off", "-c", "{cat}", "-f", "people", "-r",
                   "1 days", "--dry-run"])
    assert out == "would age off 5 features from people\n"
    assert cli.run(["age-off", "-c", "{cat}", "-f", "people", "-r",
                    "1 days"]) == "aged off 5 features from people\n"
    assert cli.run(["stats-count", "-c", "{cat}", "-f", "people"]) == "0\n"


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_catalog_crosses_packages(tmp_path, capsys, writer, reader):
    """A catalog made and filled by one package's CLI answers the other's
    commands as it answers its own."""
    csv_path, conv_path = _inputs(tmp_path)
    w, r = ((jmain, tmain) if writer == "jax" else (tmain, jmain))
    cat = str(tmp_path / "cat")
    w(["create-schema", "-c", cat, "-f", "people", "-s", SPEC])
    w(["ingest", "-c", cat, "-f", "people", "-C", conv_path, csv_path])
    queries = [["stats-count", "-c", cat, "-f", "people"],
               ["export", "-c", cat, "-f", "people", "-q",
                "BBOX(geom, -80, 30, 10, 50)"],
               ["sql", "-c", cat, "SELECT count(*) AS n FROM people "
                                  "GROUP BY name"],
               ["describe-schema", "-c", cat, "-f", "people"]]
    outs = {}
    for side, fn in (("writer", w), ("reader", r)):
        outs[side] = []
        for q in queries:
            capsys.readouterr()
            assert fn(q) == 0
            outs[side].append(capsys.readouterr().out)
    assert outs["reader"] == outs["writer"]
    assert outs["reader"][0] == "5\n"


def test_no_card_without_device_cpu_exits_nonzero(tmp_path, monkeypatch,
                                                  capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cat = str(tmp_path / "never")
    for argv in (["get-type-names", "-c", cat],
                 ["--device", "cuda", "stats-count", "-c", cat, "-f", "x"]):
        with pytest.raises(SystemExit) as e:
            tmain_raw(argv)
        assert e.value.code != 0
        assert "no CUDA device is available" in str(e.value.code)
    assert not os.path.exists(cat)              # nothing opened on the host
    # the version needs no store
    assert tmain_raw(["version"]) == 0
    assert capsys.readouterr().out == "geomesa-tpu 0.1.0\n"


def test_module_entry_point_fails_without_a_card(tmp_path):
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "geomesa_tpu_torch.cli", "get-type-names",
         "-c", str(tmp_path / "cat")],
        capture_output=True, text=True, timeout=120, cwd=root, env=env)
    assert res.returncode != 0
    assert "no CUDA device is available" in res.stderr
    res = subprocess.run(
        [sys.executable, "-m", "geomesa_tpu_torch.cli", "--device", "cpu",
         "get-type-names", "-c", str(tmp_path / "cat")],
        capture_output=True, text=True, timeout=120, cwd=root, env=env)
    assert res.returncode == 0 and res.stdout == ""
