"""Port parity: the sharded XZ2/XZ3 indexes of geomesa_tpu_torch on 2-
and 8-shard CPU meshes (``device_mesh(devices=["cpu"] * n)``) against
geomesa_tpu's on its virtual CPU mesh of the same size, and against the
single-device host indexes — the same seeded geometries; sharded
columns (compared as sorted per-shard key sets: equal keys may sort
either way in the JAX program), candidate and result gids exact; the
gather regrows past its starting capacity; the mesh store plans and
answers as the JAX one; the carry-across."""

import numpy as np
import pytest

from geomesa_tpu.datastore import TpuDataStore as JaxStore
from geomesa_tpu.geometry.packed import packed_from_boxes as j_packed
from geomesa_tpu.geometry.types import Polygon as JPolygon
from geomesa_tpu.parallel import device_mesh as jax_mesh
from geomesa_tpu.parallel.xz import ShardedXZ2Index as JSXZ2
from geomesa_tpu.parallel.xz import ShardedXZ3Index as JSXZ3
from geomesa_tpu_torch import TpuDataStore
from geomesa_tpu_torch.convert import (
    sharded_xz_index_from_state, sharded_xz_index_state,
)
from geomesa_tpu_torch.geometry.packed import packed_from_boxes
from geomesa_tpu_torch.geometry.types import Polygon
from geomesa_tpu_torch.index.xz2 import XZ2Index
from geomesa_tpu_torch.index.xz3 import XZ3Index
from geomesa_tpu_torch.parallel import device_mesh
from geomesa_tpu_torch.parallel.xz import ShardedXZ2Index, ShardedXZ3Index

MS = 1514764800000
DAY = 86_400_000
RINGS = [
    [(-80, 30), (-60, 30), (-60, 50), (-80, 50)],          # a rectangle
    [(-80, 30), (-50, 35), (-70, 55)],                      # a triangle
    [(-10, -10), (40, -10), (40, 40), (-10, 40)],           # a region
    [(-180, -90), (180, -90), (180, 90), (-180, 90)],       # the world
]
WINDOWS = [(MS + 2 * DAY, MS + 9 * DAY), (MS, MS + 13 * DAY),
           (MS + 5 * DAY, MS + 5 * DAY + 3_600_000)]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(57)
    n = 20_011
    cx = rng.uniform(-170, 170, n)
    cy = rng.uniform(-80, 80, n)
    w = rng.uniform(0.001, 0.3, n)
    t = rng.integers(MS, MS + 14 * DAY, n)
    bb = np.stack([cx - w, cy - w, cx + w, cy + w], axis=1)
    return bb, t


def _shard_sets(cols):
    """Each shard's rows as a sorted tuple set of its columns."""
    return [sorted(zip(*(np.asarray(c).tolist() for c in shard)))
            for shard in cols]


@pytest.fixture(scope="module", params=[2, 8])
def pairs(request, data):
    n_shards = request.param
    bb, t = data
    mesh = device_mesh(devices=["cpu"] * n_shards)
    jm = jax_mesh(n_shards)
    p2 = ShardedXZ2Index.build(packed_from_boxes(bb), g=12, mesh=mesh)
    j2 = JSXZ2.build(j_packed(bb), g=12, mesh=jm)
    p3 = ShardedXZ3Index.build(packed_from_boxes(bb), t, period="week",
                               g=12, mesh=mesh)
    j3 = JSXZ3.build(j_packed(bb), t, period="week", g=12, mesh=jm)
    return n_shards, (p2, j2), (p3, j3)


def test_sharded_build_columns(pairs):
    n_shards, (p2, j2), (p3, j3) = pairs
    for p, j, names in ((p2, j2, ("codes", "gid")),
                        (p3, j3, ("bins", "codes", "gid", "dtg"))):
        got = [[getattr(p, k)[s].numpy() for k in names]
               + [c[s].numpy() for c in p.bbox_cols]
               for s in range(n_shards)]
        want = [[np.asarray(getattr(j, k)).reshape(n_shards, -1)[s]
                 for k in names]
                + [np.asarray(c).reshape(n_shards, -1)[s]
                   for c in j.bbox_cols]
                for s in range(n_shards)]
        assert _shard_sets(got) == _shard_sets(want)
        # each shard is sorted by its key, padding (gid -1) last
        for s in range(n_shards):
            c = p.codes[s].numpy()
            b = (p.bins[s].numpy() if hasattr(p, "bins")
                 else np.zeros(len(c), np.int32))
            assert ((b[1:] > b[:-1])
                    | ((b[1:] == b[:-1]) & (c[1:] >= c[:-1]))).all()
            gid = p.gid[s].numpy()
            assert (gid[np.argmax(gid < 0):] < 0).all() or (gid >= 0).all()


@pytest.mark.parametrize("exact", [True, False])
def test_sharded_xz2_queries(pairs, data, exact):
    _, (p2, j2), _ = pairs
    bb, _ = data
    host = XZ2Index.build(packed_from_boxes(bb), g=12)
    # a small starting gather, so that the larger queries regrow it
    p2._capacity = 1 << 10
    for ring in RINGS:
        got = p2.query(Polygon(ring), exact=exact)
        np.testing.assert_array_equal(
            got, j2.query(JPolygon(ring), exact=exact))
        if exact:
            np.testing.assert_array_equal(got, host.query(Polygon(ring)))
    # the world query regrew the gather past its starting capacity
    assert p2._capacity >= len(bb) // len(p2.codes)


@pytest.mark.parametrize("exact", [True, False])
def test_sharded_xz3_queries(pairs, data, exact):
    _, _, (p3, j3) = pairs
    bb, t = data
    host = XZ3Index.build(packed_from_boxes(bb), t, period="week", g=12)
    for ring in RINGS:
        for lo, hi in WINDOWS:
            got = p3.query(Polygon(ring), lo, hi, exact=exact)
            np.testing.assert_array_equal(
                got, j3.query(JPolygon(ring), lo, hi, exact=exact))
            if exact:
                np.testing.assert_array_equal(
                    got, host.query(Polygon(ring), lo, hi))


def test_sharded_xz_state_round_trip(pairs):
    n_shards, (_, j2), (_, j3) = pairs
    mesh = device_mesh(devices=["cpu"] * n_shards)
    q2 = sharded_xz_index_from_state(sharded_xz_index_state(j2), mesh)
    q3 = sharded_xz_index_from_state(sharded_xz_index_state(j3), mesh)
    assert isinstance(q2, ShardedXZ2Index)
    assert isinstance(q3, ShardedXZ3Index)
    for ring in RINGS[:3]:
        np.testing.assert_array_equal(q2.query(Polygon(ring)),
                                      j2.query(JPolygon(ring)))
        lo, hi = WINDOWS[0]
        np.testing.assert_array_equal(q3.query(Polygon(ring), lo, hi),
                                      j3.query(JPolygon(ring), lo, hi))


def test_build_multihost_names_its_roadmap_item():
    for cls in (ShardedXZ2Index, ShardedXZ3Index):
        with pytest.raises(NotImplementedError, match="A7"):
            cls.build_multihost(None)


@pytest.mark.parametrize("n_shards", [2, 8])
def test_mesh_store_matches_reference(data, n_shards):
    """A mesh polygon store (two writes, a query between: the second
    write rides the kept indexes' tail) plans and answers as the JAX
    one, and as the port's single-device store."""
    bb, t = data
    spec = "kind:String,dtg:Date,*geom:Polygon"
    kind = np.where(np.arange(len(bb)) % 97 == 0, "rare", "common")
    stores = (JaxStore(mesh=jax_mesh(n_shards)),
              TpuDataStore(device="cpu",
                           mesh=device_mesh(devices=["cpu"] * n_shards)),
              TpuDataStore(device="cpu"))
    half = len(bb) // 2
    qs = ["INTERSECTS(geom, POLYGON((-80 30, -50 35, -70 55, -80 30))) AND "
          "dtg DURING 2018-01-03T00:00:00Z/2018-01-10T00:00:00Z",
          "BBOX(geom, -10, -10, 40, 40)",
          "dtg DURING 2018-01-02T00:00:00Z/2018-01-03T00:00:00Z",
          "kind = 'rare' AND BBOX(geom, -100, -50, 100, 50)"]
    results = []
    for ds, pack in zip(stores, (j_packed, packed_from_boxes,
                                 packed_from_boxes)):
        ds.create_schema("p", spec)
        out = []
        for lo, hi in ((0, half), (half, len(bb))):
            ds.write("p", {"kind": kind[lo:hi], "dtg": t[lo:hi],
                           "geom": pack(bb[lo:hi])})
            out.extend(ds.query_result("p", q) for q in qs)
        results.append(out)
    assert isinstance(stores[1]._store("p").index("xz2"), ShardedXZ2Index)
    for a, b, c in zip(*results):
        assert b.strategy.index == a.strategy.index == c.strategy.index
        np.testing.assert_array_equal(b.positions, a.positions)
        np.testing.assert_array_equal(c.positions, a.positions)
    spec_h = "Count();Histogram(dtg,16,1514764800000,1516000000000)"
    sa = stores[0].stats("p", qs[1], spec_h)
    sb = stores[1].stats("p", qs[1], spec_h)
    assert sb.stats[0].count == sa.stats[0].count
    np.testing.assert_array_equal(sb.stats[1].counts, sa.stats[1].counts)
