"""Port parity: the partitioned RDD layer (``parallel/rdd.py``) and the
ingest jobs (``jobs.py``: ``IngestJob``, ``run_ingest``,
``local_paths_for_process``, ``run_distributed_ingest``), through
geomesa_tpu_torch (``device="cpu"``) against geomesa_tpu on the same
seeded rows and files.

Case for case the JAX oracle ``tests/test_rdd_jobs.py``: every RDD
provider's partitions are the same batches (the store provider's z2
order included, duplicate points too), its aggregate, Arrow table and
save equal; an ingest's counters, errors and job record equal, and after
it the stores' z3 and z2 index states (``convert.z3_index_state`` /
``z2_index_state``: ``bins``, ``z``, ``pos`` and the payload) are
bit-equal, with the same query answers; ``run_distributed_ingest``'s
sharded index state bit-equal over an 8-shard mesh.  Files complete in
``as_completed`` order, which differs between runs once a pool has more
than one file in flight: the tests that compare row order replace it, in
both packages, by submission order; the others compare by feature id."""

import numpy as np
# the reference's ingest pools parse CSV on their threads: its reader
# must be imported on the main thread first (a first import on a pool
# thread, with torch loaded, crashes a later pool's parse)
import pyarrow.csv  # noqa: F401
import pytest

import geomesa_tpu.jobs as jjobs
import geomesa_tpu.obs.jobs as jobsreg
import geomesa_tpu_torch.jobs as tjobs
import geomesa_tpu_torch.obs.jobs as tobsreg
from geomesa_tpu import parallel as jpar
from geomesa_tpu.datastore import TpuDataStore as JaxStore
from geomesa_tpu.features.feature_type import parse_spec as j_parse_spec
from geomesa_tpu.fs import FileSystemDataStore as JaxFS
from geomesa_tpu_torch import convert, device_mesh
from geomesa_tpu_torch import parallel as tpar
from geomesa_tpu_torch.datastore import TpuDataStore
from geomesa_tpu_torch.features.feature_type import parse_spec
from geomesa_tpu_torch.fs import FileSystemDataStore

from test_torch_io_converters import _same_batch

MS_2018 = 1514764800000
DAY = 86_400_000
SPEC = "name:String,v:Int,dtg:Date,*geom:Point"
CSV_CONFIG = {
    "type": "csv",
    "fields": [{"name": "name", "transform": "$0"},
               {"name": "v", "transform": "toInt($1)"},
               {"name": "dtg", "transform": "toLong($2)"},
               {"name": "geom", "transform": "point($3,$4)"}],
    "options": {"error-mode": "skip"},
}


def _rows(seed=3, n=1000):
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-120, 120, n), rng.uniform(-50, 50, n)
    # duplicate points: equal z2 keys, which the partitioning must order
    # as the reference does
    x[n // 2:n // 2 + 40], y[n // 2:n // 2 + 40] = 10.0, 20.0
    return {"name": np.asarray([f"n{i % 3}" for i in range(n)], dtype=object),
            "v": rng.integers(0, 100, n),
            "dtg": rng.integers(MS_2018, MS_2018 + 7 * DAY, n),
            "geom": (x, y)}


@pytest.fixture
def stores():
    rows = _rows()
    j, t = JaxStore(), TpuDataStore(device="cpu")
    for ds in (j, t):
        ds.create_schema("pts", SPEC)
        ds.write("pts", {k: (v[0].copy(), v[1].copy()) if k == "geom"
                         else v.copy() for k, v in rows.items()})
    return j, t


def _same_rdd(t, j):
    assert t.num_partitions == j.num_partitions and t.count() == j.count()
    for tp, jp in zip(t.partitions, j.partitions):
        _same_batch(tp, jp)


@pytest.mark.parametrize("query,k", [
    ("INCLUDE", 4), ("INCLUDE", None), ("BBOX(geom, 0, -50, 120, 50)", 3),
    ("name = 'n1'", None), ("BBOX(geom, 9, 19, 11, 21)", 5),
    ("BBOX(geom, 130, 60, 140, 70)", 2)])
def test_store_rdd_partitions_match_reference(stores, query, k):
    j, t = stores
    jr = jpar.spatial_rdd({"store": j}, "pts", query, num_partitions=k)
    tr = tpar.spatial_rdd({"store": t}, "pts", query, num_partitions=k)
    _same_rdd(tr, jr)
    _same_batch(tr.collect(), jr.collect())
    if query == "INCLUDE" and k == 4:
        assert tr.num_partitions == 4 and tr.count() == 1000
        # z-ordered partitions: contiguous key-space slabs, not random
        spans = [np.ptp(p.geom_xy()[0]) * np.ptp(p.geom_xy()[1])
                 for p in tr.partitions]
        assert min(spans) < 0.5 * 240.0 * 100.0


def test_rdd_aggregate_to_arrow_and_save_match_reference(stores):
    j, t = stores
    jr = jpar.spatial_rdd({"store": j}, "pts", num_partitions=4)
    tr = tpar.spatial_rdd({"store": t}, "pts", num_partitions=4)
    agg = [r.aggregate(lambda b: int(b.column("v").sum()),
                       lambda a, b: a + b) for r in (jr, tr)]
    assert agg[0] == agg[1] == int(t._store("pts").batch.column("v").sum())
    assert tr.map_partitions(len) == jr.map_partitions(len)
    tt, jt = tr.to_arrow(), jr.to_arrow()
    assert tt.num_rows == 1000 and tt.equals(jt, check_metadata=True)
    empty = [r.to_arrow() for r in (
        jpar.spatial_rdd({"store": j}, "pts", "name = 'none'"),
        tpar.spatial_rdd({"store": t}, "pts", "name = 'none'"))]
    assert empty[1].num_rows == 0 and empty[1].equals(empty[0])
    # save_rdd into a second store's schema
    sub = [jpar.spatial_rdd({"store": j}, "pts", "name = 'n1'"),
           tpar.spatial_rdd({"store": t}, "pts", "name = 'n1'")]
    dst = [JaxStore(), TpuDataStore(device="cpu")]
    n = [jpar.save_rdd(sub[0], {"store": dst[0]}, "pts"),
         tpar.save_rdd(sub[1], {"store": dst[1]}, "pts")]
    assert n[0] == n[1] == sub[1].count() > 0
    assert dst[1].get_count("pts") == dst[0].get_count("pts") == n[1]
    _same_batch(dst[1]._store("pts").batch, dst[0]._store("pts").batch)


def test_non_point_store_rdd_keeps_row_order():
    """A polygon schema has no x/y columns: both packages keep the result's
    row order (the port's narrowed ``except KeyError``)."""
    from geomesa_tpu.geometry.packed import packed_from_boxes as jboxes
    from geomesa_tpu_torch.geometry.packed import packed_from_boxes

    rng = np.random.default_rng(5)
    c = rng.uniform(-50, 50, (300, 2))
    boxes = np.concatenate([c - 0.5, c + 0.5], axis=1)
    out = []
    for ds, pack, par in ((JaxStore(), jboxes, jpar),
                          (TpuDataStore(device="cpu"), packed_from_boxes,
                           tpar)):
        ds.create_schema("p", "name:String,*geom:Polygon")
        ds.write("p", {"name": np.array(["a"] * 300, dtype=object),
                       "geom": pack(boxes)})
        out.append(par.spatial_rdd({"store": ds}, "p", num_partitions=3))
    _same_rdd(out[1], out[0])
    assert list(out[1].collect().ids) == [str(i) for i in range(300)]


def test_store_rdd_does_not_swallow_encode_errors(stores, monkeypatch):
    """Only a missing x/y column keeps row order: a failing z2 encode
    raises out of the port's provider."""
    import geomesa_tpu_torch.curve as tcurve

    def broken():
        raise RuntimeError("device lost")

    monkeypatch.setattr(tcurve, "z2_sfc", broken)
    with pytest.raises(RuntimeError, match="device lost"):
        tpar.spatial_rdd({"store": stores[1]}, "pts")


def _csv_files(tmp_path, n_files=3, rows=10, bad=False):
    paths = []
    for i in range(n_files):
        p = tmp_path / f"f{i}.csv"
        p.write_text("\n".join(f"a{j},{j},{MS_2018 + j},-{i}.5,4{i}.0"
                               for j in range(rows)) + "\n")
        paths.append(str(p))
    if bad:
        p = tmp_path / "bad.csv"
        p.write_text("x,notanint,0,0.0,0.0\nshort,1\n")
        paths.append(str(p))
        paths.append(str(tmp_path / "missing.csv"))
    return paths


@pytest.mark.parametrize("query", ["INCLUDE", "BBOX(geom,-1,39,0,41)"])
def test_converter_rdd_matches_reference(tmp_path, query):
    paths = _csv_files(tmp_path)
    out = []
    for par, spec in ((jpar, j_parse_spec), (tpar, parse_spec)):
        out.append(par.spatial_rdd(
            {"paths": paths, "sft": spec("pts", SPEC),
             "converter": CSV_CONFIG}, "pts", query))
    _same_rdd(out[1], out[0])
    assert out[1].count() == (30 if query == "INCLUDE" else 10)
    with pytest.raises(NotImplementedError):
        tpar.save_rdd(out[1], {"paths": paths, "converter": CSV_CONFIG},
                      "pts")
    with pytest.raises(ValueError, match="no SpatialRDDProvider"):
        tpar.spatial_rdd({"nothing": 1}, "pts")


def test_fs_rdd_matches_reference(tmp_path):
    rng = np.random.default_rng(5)
    n = 200
    rows = {"dtg": rng.integers(MS_2018, MS_2018 + 3 * DAY, n),
            "geom": (rng.uniform(-10, 10, n), rng.uniform(-10, 10, n))}
    fss = [JaxFS(str(tmp_path / "j")), FileSystemDataStore(str(tmp_path / "t"))]
    for fs in fss:
        fs.create_schema("evt", "dtg:Date,*geom:Point",
                         scheme={"scheme": "datetime",
                                 "datetime-step": "daily"})
        fs.write("evt", rows)
    for q in ("INCLUDE",
              "dtg DURING 2018-01-01T00:00:00Z/2018-01-01T23:59:59Z"):
        jr = jpar.spatial_rdd({"fs": fss[0]}, "evt", q)
        tr = tpar.spatial_rdd({"fs": fss[1]}, "evt", q)
        _same_rdd(tr, jr)
        if q == "INCLUDE":
            assert tr.count() == n and tr.num_partitions >= 3
        else:
            assert tr.num_partitions <= 2 and 0 < tr.count() < n
    # save into the port's FSDS: the same rows again
    assert tpar.save_rdd(tr, {"fs": fss[1]}, "evt") == tr.count()
    assert fss[1].count("evt") == n + tr.count()


# -- ingest jobs ---------------------------------------------------------------

@pytest.fixture
def in_order(monkeypatch):
    """Files complete in submission order in both packages (a stand-in for
    ``as_completed`` that waits on each future in turn)."""
    for mod in (jjobs, tjobs):
        monkeypatch.setattr(mod, "as_completed", lambda fs: list(fs))


def _index_states(ds, name):
    st = ds._store(name)
    return (convert.z3_index_state(st.index("z3")),
            convert.z2_index_state(st.index("z2")))


def _same_state(t, j):
    assert sorted(t) == sorted(j)
    for k in j:
        if isinstance(j[k], np.ndarray):
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        else:
            assert t[k] == j[k], k


def _job_record(reg, kind):
    rec = reg.jobs_registry.jobs(kind=kind, limit=1)[0]
    return (rec.kind, rec.state, dict(rec.detail), dict(rec.progress),
            [(p["name"], {k: v for k, v in p.items()
                          if k not in ("name", "ms")}) for p in rec.phases],
            rec.error)


@pytest.mark.parametrize("workers", [1, 3])
def test_ingest_job_matches_reference(tmp_path, in_order, workers):
    """Files with bad rows, an unparseable file and a missing one through
    ``run_ingest``: the counters, errors, job record, stores and index
    states are equal, and so are the queries after.  The reference runs
    one worker: with several its converter's shared parse-failure list
    races (ROADMAP queue C), the port's does not."""
    paths = _csv_files(tmp_path, n_files=6, rows=20, bad=True)
    pair = (JaxStore(), TpuDataStore(device="cpu"))
    results = []
    for ds, jobs, w in zip(pair, (jjobs, tjobs), (1, workers)):
        ds.create_schema("pts", SPEC)
        results.append(jobs.run_ingest(ds, "pts", CSV_CONFIG, paths,
                                       workers=w))
    jres, tres = results
    assert (tres.ingested, tres.failed, tres.files, tres.errors) == \
        (jres.ingested, jres.failed, jres.files, jres.errors)
    assert tres.ingested == 120 and tres.files == 8 and tres.failed == 3
    jrec, trec = _job_record(jobsreg, "ingest"), _job_record(tobsreg,
                                                               "ingest")
    assert trec[2].pop("workers") == workers and jrec[2].pop("workers") == 1
    assert trec == jrec
    _same_batch(pair[1]._store("pts").batch, pair[0]._store("pts").batch)
    for q in ("BBOX(geom, -3, 39, 0, 43) AND dtg DURING "
              "2018-01-01T00:00:00Z/2018-01-01T00:00:01Z",
              "BBOX(geom, -3, 39, 0, 43)"):
        np.testing.assert_array_equal(
            pair[1].query_result("pts", q).positions,
            pair[0].query_result("pts", q).positions)
    for ts, js in zip(_index_states(pair[1], "pts"),
                      _index_states(pair[0], "pts")):
        _same_state(ts, js)


def test_ingest_job_unordered_matches_by_id(tmp_path):
    """The real ``as_completed`` order: the same rows by feature id."""
    paths = []
    for i in range(6):
        p = tmp_path / f"in{i}.csv"
        p.write_text("\n".join(f"x{i}_{j},{j},{MS_2018 + j},{i}.25,1.5"
                               for j in range(20)) + "\n")
        paths.append(str(p))
    config = dict(CSV_CONFIG, **{"id-field": "$0"})
    got = []
    for ds, jobs in ((JaxStore(), jjobs), (TpuDataStore(device="cpu"), tjobs)):
        ds.create_schema("pts", SPEC)
        res = jobs.run_ingest(ds, "pts", config, paths, workers=3)
        b = ds._store("pts").batch
        order = np.argsort(b.ids.astype(str))
        got.append((res.ingested, b.take(order)))
    assert got[1][0] == got[0][0] == 120
    _same_batch(got[1][1], got[0][1])


def test_parallel_parse_counts_every_ragged_row(tmp_path):
    """Eight workers over sixteen files with ragged rows: the port counts
    each ragged row once, as the reference does on one worker (its shared
    parse-failure list loses and repeats them under several)."""
    paths = []
    for i in range(16):
        p = tmp_path / f"r{i}.csv"
        p.write_text("".join(f"a{j},{j},{MS_2018 + j},1.5,2.5\n"
                             + (f"bad{i}_{j},1\n" if j % 5 == 0 else "")
                             for j in range(400)))
        paths.append(str(p))
    got = []
    for ds, jobs, w in ((JaxStore(), jjobs, 1),
                        (TpuDataStore(device="cpu"), tjobs, 8)):
        ds.create_schema("pts", SPEC)
        res = jobs.run_ingest(ds, "pts", CSV_CONFIG, paths, workers=w)
        got.append((res.ingested, res.failed, sorted(res.errors)))
    assert got[1] == got[0]
    assert got[1][:2] == (16 * 400, 16 * 80)


_POOL_PROBE = r"""
import sys
from geomesa_tpu_torch import jobs
from geomesa_tpu_torch.datastore import TpuDataStore
paths, config = sys.argv[1:-1], {"type": "csv", "fields": [
    {"name": "name", "transform": "$0"}, {"name": "v", "transform": "toInt($1)"},
    {"name": "dtg", "transform": "toLong($2)"},
    {"name": "geom", "transform": "point($3,$4)"}]}
for _ in range(int(sys.argv[-1])):
    ds = TpuDataStore(device="cpu")
    ds.create_schema("pts", "name:String,v:Int,dtg:Date,*geom:Point")
    res = jobs.run_ingest(ds, "pts", config, paths, workers=8)
    print(res.ingested, res.failed, flush=True)
"""


def test_parallel_parse_pools_do_not_crash_a_fresh_process(tmp_path):
    """A fresh process (torch loaded, pyarrow not yet) running ingests with
    eight workers over files with ragged rows: pyarrow's CSV reader first
    imported on a pool thread crashed a later pool's parse (SIGSEGV), and
    its reader threads calling the row handler aborted the process at
    exit; the port imports it on the pool's owner and reads serially when
    it has a handler."""
    import subprocess
    import sys
    from pathlib import Path

    paths = []
    for i in range(16):
        p = tmp_path / f"r{i}.csv"
        p.write_text("".join(f"a{j},{j},{MS_2018 + j},1.5,2.5\n"
                             + (f"bad{j},1\n" if j % 5 == 0 else "")
                             for j in range(400)))
        paths.append(str(p))
    res = subprocess.run(
        [sys.executable, "-c", _POOL_PROBE, *paths, "4"],
        capture_output=True, text=True, timeout=300,
        cwd=Path(__file__).resolve().parent.parent)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split("\n")[:4] == ["6400 1280"] * 4


def test_ingest_job_failed_write_marks_the_job_failed(tmp_path):
    paths = _csv_files(tmp_path, n_files=1)
    records = []
    for ds, jobs, reg in ((JaxStore(), jjobs, jobsreg),
                          (TpuDataStore(device="cpu"), tjobs, tobsreg)):
        ds.create_schema("pts", SPEC)

        class Broken:
            get_schema = ds.get_schema

            def write(self, name, batch):
                raise OSError("disk full")

        with pytest.raises(OSError, match="disk full"):
            jobs.IngestJob(Broken(), "pts", CSV_CONFIG, workers=1).run(paths)
        records.append(_job_record(reg, "ingest"))
        with pytest.raises(KeyError):
            jobs.run_ingest(ds, "nope", CSV_CONFIG, paths)
        records.append(_job_record(reg, "ingest")[:2])
    assert records[2:] == records[:2]
    assert records[2][1] == "failed" and "disk full" in records[2][5]


def test_distributed_ingest_single_process_matches_reference(tmp_path,
                                                             in_order):
    """``run_distributed_ingest`` on one process: the sharded index state
    over an 8-shard mesh is bit-equal, and its query is the oracle."""
    from geomesa_tpu.parallel import device_mesh as j_device_mesh

    sft_spec = "name:String,dtg:Date,*geom:Point"
    config = {"type": "csv",
              "fields": [{"name": "name", "transform": "toString($0)"},
                         {"name": "dtg", "transform": "toLong($1)"},
                         {"name": "geom", "transform": "point($2, $3)"}]}
    rng = np.random.default_rng(3)
    paths, all_rows = [], []
    for f in range(3):
        rows = [(f"u{f}_{i}", MS_2018 + i * 60_000,
                 float(rng.uniform(-74.5, -73.5)),
                 float(rng.uniform(40.2, 41.8))) for i in range(50)]
        all_rows.extend(rows)
        p = tmp_path / f"f{f}.csv"
        p.write_text("\n".join(f"{n},{t},{x},{y}" for n, t, x, y in rows)
                     + "\n")
        paths.append(str(p))
    jidx, jres = jjobs.run_distributed_ingest(
        j_parse_spec("pts", sft_spec), config, paths,
        mesh=j_device_mesh(8), workers=2)
    tidx, tres = tjobs.run_distributed_ingest(
        parse_spec("pts", sft_spec), config, paths,
        mesh=device_mesh(devices=["cpu"] * 8), workers=2)
    assert (tres.files, tres.failed, tres.ingested) == \
        (jres.files, jres.failed, jres.ingested) == (3, 0, 150)
    _same_state(convert.sharded_index_state(tidx),
                convert.sharded_index_state(jidx))
    box = (-74.2, 40.5, -73.8, 41.5)
    hits = tidx.query([box], MS_2018, MS_2018 + 40 * 60_000)
    np.testing.assert_array_equal(
        hits, jidx.query([box], MS_2018, MS_2018 + 40 * 60_000))
    xs = np.array([r[2] for r in all_rows])
    ys = np.array([r[3] for r in all_rows])
    ts = np.array([r[1] for r in all_rows])
    want = np.flatnonzero((xs >= box[0]) & (xs <= box[2]) & (ys >= box[1])
                          & (ys <= box[3]) & (ts <= MS_2018 + 40 * 60_000))
    assert len(hits) == len(want) > 0
    # a process with no files still joins the build with an empty block
    empty, eres = tjobs.run_distributed_ingest(
        parse_spec("pts", sft_spec), config, [],
        mesh=device_mesh(devices=["cpu"] * 2))
    assert len(empty) == 0 and eres.files == 0


@pytest.mark.parametrize("n,procs", [(7, 3), (2, 4), (0, 2), (5, 1)])
def test_distributed_ingest_path_split(n, procs):
    paths = [f"p{i}" for i in range(n)]
    shares = [tjobs.local_paths_for_process(paths, i, procs)
              for i in range(procs)]
    assert shares == [jjobs.local_paths_for_process(paths, i, procs)
                      for i in range(procs)]
    assert sorted(sum(shares, [])) == sorted(paths)
    assert max(map(len, shares)) - min(map(len, shares)) <= 1


def test_tsv_files_through_run_ingest_to_queries(tmp_path, in_order):
    """The slice end to end: seeded TSV files with bad rows (ragged rows,
    out-of-bounds points and dates) → ``run_ingest`` with the ``z-index``
    validator → BBOX+DURING (z3) and BBOX (z2) queries, in both packages:
    counts, z3 and z2 index states bit-equal, hits equal to a numpy
    oracle over the good rows."""
    rng = np.random.default_rng(11)
    config = {"type": "tsv", "id-field": "toString($0)",
              "fields": [{"name": "name", "transform": "$6"},
                         {"name": "v", "transform": "toInt($26)"},
                         {"name": "dtg",
                          "transform": "date('yyyyMMdd', $1)"},
                         {"name": "geom", "transform":
                          "point(toDouble($54), toDouble($53))"}],
              "options": {"error-mode": "skip", "validators": ["z-index"]}}
    good = {}
    paths = []
    gid = 0
    for f in range(3):
        lines = []
        for i in range(300):
            gid += 1
            day = int(rng.integers(0, 365))
            t = MS_2018 + day * DAY
            x = round(float(rng.uniform(-180, 180)), 4)
            y = round(float(rng.uniform(-90, 90)), 4)
            date = np.datetime64(t, "ms").astype("M8[D]").astype(str)
            fields = [str(gid), date.replace("-", "")] + [
                f"c{k}" for k in range(2, 58)]
            fields[6], fields[26] = f"actor{i % 7}", str(i % 20)
            fields[53], fields[54] = str(y), str(x)
            kind = i % 50
            if kind == 1:                    # ragged
                fields = fields[:40]
            elif kind == 2:                  # latitude out of bounds
                fields[53] = "95.5"
            elif kind == 3:                  # before the z3 epoch
                fields[1] = "19650101"
            else:
                good[str(gid)] = (x, y, t)
            lines.append("\t".join(fields))
        p = tmp_path / f"events{f}.tsv"
        p.write_text("\n".join(lines) + "\n")
        paths.append(str(p))
    pair = (JaxStore(), TpuDataStore(device="cpu"))
    results = []
    for ds, jobs, w in zip(pair, (jjobs, tjobs), (1, 2)):
        ds.create_schema("gdelt", SPEC)
        results.append(jobs.run_ingest(ds, "gdelt", config, paths,
                                       workers=w))
    assert vars(results[1]) == vars(results[0])
    assert results[1].ingested == len(good) == 900 - 3 * 18
    assert results[1].failed == 3 * 18
    ids = np.array(list(good))
    xyz = np.array(list(good.values()))
    for box, lo, hi in (((-60, -30, 60, 30), MS_2018 + 30 * DAY,
                         MS_2018 + 200 * DAY),
                        ((100, 0, 180, 90), MS_2018, MS_2018 + 364 * DAY)):
        m = ((xyz[:, 0] >= box[0]) & (xyz[:, 0] <= box[2])
             & (xyz[:, 1] >= box[1]) & (xyz[:, 1] <= box[3]))
        from datetime import datetime, timezone

        def iso(ms):
            return datetime.fromtimestamp(ms / 1000, timezone.utc).strftime(
                "%Y-%m-%dT%H:%M:%SZ")

        bb = f"BBOX(geom, {box[0]}, {box[1]}, {box[2]}, {box[3]})"
        for q, want in ((f"{bb} AND dtg DURING {iso(lo)}/{iso(hi)}",
                         m & (xyz[:, 2] >= lo) & (xyz[:, 2] <= hi)),
                        (bb, m)):
            got = [ds.query_result("gdelt", q) for ds in pair]
            assert got[1].strategy.index == got[0].strategy.index
            np.testing.assert_array_equal(got[1].positions, got[0].positions)
            assert sorted(got[1].batch.ids) == sorted(ids[want])
            assert len(got[1].positions) > 0
    for ts, js in zip(_index_states(pair[1], "gdelt"),
                      _index_states(pair[0], "gdelt")):
        _same_state(ts, js)
