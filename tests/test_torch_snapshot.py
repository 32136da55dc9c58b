"""Port parity: lean snapshots through geomesa_tpu_torch's store against
geomesa_tpu's, on the same seeded rows — point z3, point z3 with an
indexed attribute, polygon XZ2 and XZ3 schemas with row labels and
tombstones, at 2^12-row parts (``LEAN_PART_ROWS`` monkeypatched in both
packages).

Held equal: the snapshot files both packages write for the same
operations (the manifest, every part's parquet table with its reserved
``__tombstone__``, ``__vis__`` and ``__wkb__`` columns, the stats JSON);
a snapshot either package writes, opened by the other — positions, ids,
tombstones, labels, ``get_count``, ``stat`` and the next implicit id,
with the indexes rebuilt lazily by the first query; a re-flush after a
reload (new-stamp parts, the manifest, then the prune); stats persisted
without rows; and ``remove_schema`` taking the snapshot with it."""

import json
import os

import numpy as np
import pyarrow.parquet as pq
import pytest

from geomesa_tpu.datastore import TpuDataStore as JaxStore
from geomesa_tpu.geometry.packed import packed_from_boxes as j_packed
from geomesa_tpu.index import attr_lean as jax_al
from geomesa_tpu.security import StaticAuthorizationsProvider as JaxAuth
from geomesa_tpu_torch import TpuDataStore
from geomesa_tpu_torch.geometry.packed import packed_from_boxes
from geomesa_tpu_torch.index.attr_lean import LeanAttrIndex
from geomesa_tpu_torch.security import StaticAuthorizationsProvider

MS = 1514764800000
DAY = 86_400_000
N = 10_000
LEAN = ";geomesa.index.profile=lean,geomesa.lean.generation.slots=2048"
SPECS = {
    "z3": "score:Double,dtg:Date,*geom:Point",
    "attr": "name:String:index=true,score:Double,dtg:Date,*geom:Point",
    "xz2": "kind:String:index=true,*geom:Polygon",
    "xz3": "kind:String:index=true,dtg:Date,*geom:Polygon",
}
POINT_QUERIES = [
    "BBOX(geom, -74.5, 40.5, -73.5, 41.5) AND dtg DURING "
    "2018-01-03T00:00:00Z/2018-01-09T00:00:00Z",
    "BBOX(geom, -74.2, 40.2, -73.9, 41.7)",
    "IN ('3', '7', '4242', '9999')",
    "INCLUDE",
]
POLY = "INTERSECTS(geom, POLYGON((-80 30, -60 30, -60 50, -80 50, -80 30)))"
QUERIES = {
    "z3": POINT_QUERIES,
    "attr": POINT_QUERIES + ["name = 'rare'"],
    "xz2": [POLY, "BBOX(geom, -100, -50, 100, 50)", "kind = 'rare'",
            "IN ('3', '17', '9999')"],
    "xz3": [POLY, POLY + " AND dtg DURING "
                         "2018-01-02T00:00:00Z/2018-01-06T00:00:00Z",
            "kind = 'rare'", "IN ('3', '17', '9999')"],
}


@pytest.fixture(autouse=True)
def _small_parts(monkeypatch):
    """2^12-row snapshot parts in both packages, and the port's
    attribute-index class default at the JAX one the suite's conftest
    sets (the per-index budget floor reads it)."""
    monkeypatch.setattr(TpuDataStore, "LEAN_PART_ROWS", 1 << 12)
    monkeypatch.setattr(JaxStore, "LEAN_PART_ROWS", 1 << 12)
    monkeypatch.setattr(LeanAttrIndex, "GENERATION_SLOTS",
                        jax_al.LeanAttrIndex.GENERATION_SLOTS)


def _open(side: str, d: str, auths=("user",)):
    if side == "jax":
        return JaxStore(d, auth_provider=JaxAuth(set(auths)))
    return TpuDataStore(device="cpu", catalog_dir=d,
                        auth_provider=StaticAuthorizationsProvider(
                            set(auths)))


def _rows(kind: str, side: str, lo: int, hi: int):
    rng = np.random.default_rng(7)
    if kind in ("z3", "attr"):
        x, y = rng.uniform(-75, -73, N), rng.uniform(40, 42, N)
        rows = {"score": rng.uniform(0, 100, N),
                "dtg": rng.integers(MS, MS + 14 * DAY, N), "geom": (x, y)}
        if kind == "attr":
            rows["name"] = rng.choice(np.array(["a", "b", "rare"], object),
                                      N, p=[.6, .39, .01])
        return {k: ((v[0][lo:hi], v[1][lo:hi]) if k == "geom" else v[lo:hi])
                for k, v in rows.items()}
    cx, cy = rng.uniform(-170, 170, N), rng.uniform(-80, 80, N)
    w = rng.uniform(0.001, 0.05, N)
    bb = np.stack([cx - w, cy - w, cx + w, cy + w], axis=1)
    packed = j_packed if side == "jax" else packed_from_boxes
    rows = {"kind": rng.choice(np.array(["road", "park", "rare"], object),
                               N, p=[0.6, 0.39, 0.01])[lo:hi],
            "geom": packed(bb[lo:hi])}
    if kind == "xz3":
        rows["dtg"] = rng.integers(MS, MS + 14 * DAY, N)[lo:hi]
    return rows


def _fill(kind: str, side: str, d: str):
    """Two labelled writes, a delete (tombstones) and a flush."""
    ds = _open(side, d)
    ds.create_schema("evt", SPECS[kind] + LEAN)
    ds.write("evt", _rows(kind, side, 0, N // 2), visibility="user")
    ds.write("evt", _rows(kind, side, N // 2, N), visibility="admin")
    assert ds.delete("evt", ["7", "19", "4242", "bogus"]) == 3
    ds.flush("evt")
    return ds


def _parts(d: str) -> list:
    with open(os.path.join(d, "evt.lean", "manifest.json")) as f:
        return json.load(f)["parts"]


def _same_answers(got, want, kind):
    for ecql in QUERIES[kind]:
        a, b = want.query_result("evt", ecql), got.query_result("evt", ecql)
        assert b.strategy.index == a.strategy.index, ecql
        np.testing.assert_array_equal(np.sort(b.positions),
                                      np.sort(a.positions))
        np.testing.assert_array_equal(
            np.sort(np.asarray(b.batch.ids).astype(np.int64)),
            np.sort(np.asarray(a.batch.ids).astype(np.int64)))
    gs, ws = got._store("evt"), want._store("evt")
    np.testing.assert_array_equal(gs.tombstone, ws.tombstone)
    np.testing.assert_array_equal(gs.visibilities.astype(str),
                                  ws.visibilities.astype(str))
    assert got.get_count("evt") == want.get_count("evt")
    assert got.stat("evt", "count").to_json() == \
        want.stat("evt", "count").to_json()


@pytest.mark.parametrize("kind", ["z3", "attr", "xz2", "xz3"])
def test_lean_snapshot_files_and_cross_open(tmp_path, kind):
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    _fill(kind, "jax", dj)
    _fill(kind, "torch", dt)
    # the same operations write the same snapshot
    for name in ("manifest.json",):
        with open(os.path.join(dj, "evt.lean", name)) as a, \
                open(os.path.join(dt, "evt.lean", name)) as b:
            assert json.load(b) == json.load(a)
    assert len(_parts(dt)) == 3
    for part in _parts(dt):
        want = pq.read_table(os.path.join(dj, "evt.lean", part))
        got = pq.read_table(os.path.join(dt, "evt.lean", part))
        assert got.schema.equals(want.schema, check_metadata=True)
        assert got.equals(want)
    with open(os.path.join(dj, "evt.stats.json")) as a, \
            open(os.path.join(dt, "evt.stats.json")) as b:
        assert json.load(b) == json.load(a)
    # each package opens the other's snapshot; indexes rebuild lazily
    ref = _open("jax", dj)
    port = _open("torch", dj)
    st = port._store("evt")
    assert st.lean and len(st.batch) == N and not st._indexes
    _same_answers(port, ref, kind)
    assert st.build_counts.get(st.lean_kind) == 1
    _same_answers(_open("jax", dt), ref, kind)
    admin = _open("torch", dj, auths=("user", "admin"))
    _same_answers(admin, _open("jax", dj, auths=("user", "admin")), kind)
    # the reloaded store keeps ingesting through the live path, with the
    # next implicit id; a re-flush after the reload keeps the crash-safe
    # order and the JAX package reads it
    for ds in (port, ref):
        ds.write("evt", _rows(kind, "jax" if ds is ref else "torch", 0, 1))
        assert len(ds._store("evt").batch) == N + 1
    got = port.query_result("evt", "IN ('10000')")
    assert list(got.positions) == [N]
    first = set(_parts(dj))
    port.flush("evt")
    on_disk = {f for f in os.listdir(os.path.join(dj, "evt.lean"))
               if f.startswith("part-")}
    assert set(_parts(dj)) == on_disk and not (first & on_disk)
    reread = _open("jax", dj)
    assert len(reread._store("evt").batch) == N + 1
    assert int(reread._store("evt").tombstone.sum()) == 3


def test_lean_reflush_is_crash_safe(tmp_path, monkeypatch):
    """Re-flush writes new-stamp parts, swaps the manifest atomically,
    then removes the prior flush's parts: at every step the manifest on
    disk names only files that exist."""
    monkeypatch.setattr(TpuDataStore, "LEAN_PART_ROWS", 64)
    d = str(tmp_path / "cat")
    ds = TpuDataStore(device="cpu", catalog_dir=d)
    ds.create_schema("evt", "dtg:Date,*geom:Point" + LEAN)
    ds.write("evt", {"dtg": np.full(100, MS),
                     "geom": (np.zeros(100), np.zeros(100))})
    ds.flush("evt")
    lean = os.path.join(d, "evt.lean")
    first = {f for f in os.listdir(lean) if f.startswith("part-")}
    seen = []
    real_replace = os.replace

    def spy(src, dst):
        # at the commit point the new parts exist and the old still do
        if dst.endswith("manifest.json"):
            names = set(os.listdir(lean))
            seen.append(first <= names and len(names) > len(first) + 1)
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", spy)
    ds.write("evt", {"dtg": np.full(100, MS + DAY),
                     "geom": (np.ones(100), np.ones(100))})
    ds.flush("evt")
    monkeypatch.setattr(os, "replace", real_replace)
    assert seen == [True]
    with open(os.path.join(lean, "manifest.json")) as f:
        manifest = json.load(f)
    on_disk = {f for f in os.listdir(lean) if f.startswith("part-")}
    assert manifest["stamp"] == 1
    assert set(manifest["parts"]) == on_disk     # orphans removed
    assert not (first & on_disk)                 # the old stamp retired
    assert len(JaxStore(d)._store("evt").batch) == 200
    assert len(TpuDataStore(device="cpu", catalog_dir=d)
               ._store("evt").batch) == 200


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_lean_stats_persist_without_flush(tmp_path, writer):
    d = str(tmp_path / "cat")
    ds = _open(writer, d, auths=())
    ds.create_schema("evt", "dtg:Date,*geom:Point" + LEAN)
    ds.write("evt", {"dtg": np.full(10, MS),
                     "geom": (np.zeros(10), np.zeros(10))})
    ds.persist_stats("evt")
    for side in ("jax", "torch"):
        ds2 = _open(side, d, auths=())
        assert ds2._store("evt").lean      # the profile survives
        assert ds2.stat("evt", "count").count == 10
        # no snapshot was flushed: no rows, the stats still answer, and
        # the id counter survives
        assert len(ds2._store("evt").batch) == 0
        assert ds2._store("evt").next_fid == 10


def test_remove_schema_clears_lean_snapshot(tmp_path):
    """A removed schema's snapshot goes with it: a stale one would
    resurrect the old rows into a later schema of the same name."""
    d = str(tmp_path / "cat")
    ds = TpuDataStore(device="cpu", catalog_dir=d)
    ds.create_schema("evt", "dtg:Date,*geom:Point" + LEAN)
    ds.write("evt", {"dtg": np.full(10, MS),
                     "geom": (np.zeros(10), np.zeros(10))})
    ds.flush("evt")
    assert os.path.isdir(os.path.join(d, "evt.lean"))
    ds.remove_schema("evt")
    assert sorted(os.listdir(d)) == [".lock", "catalog.version"]
    ds.create_schema("evt", "dtg:Date,*geom:Point" + LEAN)
    assert len(TpuDataStore(device="cpu", catalog_dir=d)
               ._store("evt").batch) == 0


def test_lean_snapshot_inconsistent_manifest_raises(tmp_path):
    from geomesa_tpu.datastore import CatalogVersionError as JaxError
    from geomesa_tpu_torch.datastore import CatalogVersionError

    d = str(tmp_path / "cat")
    _fill("z3", "torch", d)
    path = os.path.join(d, "evt.lean", "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["n"] += 1
    with open(path, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(JaxError, match="inconsistent"):
        _open("jax", d)
    with pytest.raises(CatalogVersionError, match="inconsistent"):
        _open("torch", d)
