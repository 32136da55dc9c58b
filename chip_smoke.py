#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0] [--points 100000000]
                          [--facade-rows 16000000] [--places-rows 4000000]
                          [--mesh-rows 16000000] [--lean-rows 80000000]
                          [--lean-slots 8388608] [--attr-rows 12000000]
                          [--attr-mesh-rows 4000000]
                          [--lean-attr-rows 64000000]
                          [--lean-attr-slots 8388608]
                          [--mesh-lean-rows 64000000]
                          [--mesh-lean-slots 8388608]
                          [--poly-rows 8000000] [--poly-mesh-rows 8000000]
                          [--lean-poly-rows 32000000]
                          [--lean-poly3-rows 16000000]
                          [--lean-poly3-slots 2097152]
                          [--mesh-lean-poly-rows 16000000]
                          [--mesh-lean-poly3-rows 8000000]
                          [--mesh-lean-poly-slots 2097152]
                          [--life-rows 6000000]
                          [--life-mesh-rows 4000000]
                          [--fsds-rows 2000000] [--profile] [--out FILE]

Phases, each of which fails the run (non-zero exit) when it fails:

1. device: the card's name and power limit (``nvidia-smi``), torch/CUDA;
2. build: every kernel of ``geomesa_tpu_torch/csrc`` with ``nvcc``, one
   compiler per source, all started together, from this checkout, and
   the native range sweep (``geomesa_tpu_torch/native``, ``g++``), which
   must be available;
3. kernel: each kernel's wrapper on the card against its plain PyTorch
   version (z3_mask and z2_mask bit for bit at 2^22 and 2^22 + 37
   candidates, z2_mask also at 2^24, the capacity its scan reaches on the
   main path, R = 1 and 8; density_grid at 2^24 clustered and uniform
   points, 256x256 and 1024x1024 grids, ~50% masked in, and 256x256
   clustered with every point masked in, unit weights bit for bit and
   random weights within rtol 1e-6; hist1d at 16M rows, the mesh phase's
   per-shard slot count, and 2^22 + 37, 64, 1024 and 65,536 bins, ~50%
   masked in, and 16M rows at 64 bins every row masked in, ids past both
   ends, unit weights bit for bit and random weights within rtol 1e-5),
   timed with CUDA events beside the plain version and, where one exists,
   a PyTorch library call; the ``kernels`` line reads the ~50% rows;
4. index: ``Z3PointIndex.build`` over ``--points`` GDELT-like points (70%
   Gaussian clusters around 50 cities, 30% uniform, dtg uniform over 2018,
   WEEK bins), a 1M-row append, and 20 BBOX+DURING queries (city, region,
   continent; at least one on the two-phase path), each hit set equal to
   a chunked numpy brute-force oracle;
5. z2 index: ``Z2PointIndex.build`` over the same points, the same 1M-row
   append, the 20 queries' boxes without their times, one ``query_many``
   of 4 box sets, each equal to the oracle, and ``density_world(1024,
   512)`` equal to a numpy histogram of every point;
6. facade: ``TpuDataStore(device="cuda")`` on schema ``gdelt``:
   ``--facade-rows`` rows written in 4 batches with a query after the
   first (later writes take the append path), then ECQL BBOX+DURING, an
   OR of two DURING windows, BBOX alone (z2), an OR of two BBOXes (one z2
   scan) and INCLUDE, positions equal to the oracle; ``density_process``
   over 256x256 for BBOX+DURING, BBOX alone and INCLUDE, and
   ``density_tile`` at z = 3, counts equal to a numpy oracle; a schema
   ``places`` without a dtg (``--places-rows`` rows) answering BBOX
   queries through z2;
7. mesh: ``TpuDataStore(mesh=device_mesh(1))`` on schema ``events``
   (``actor:String,score:Double,dtg:Date,*geom:Point``): ``--mesh-rows``
   rows in 4 writes with no query between (the sharded z3 index builds
   once, at that many slots per shard); ``stats`` of Count, MinMax and a
   64-bin Histogram of ``score``, ``Frequency(actor,4,1024)`` and
   ``Frequency(score,4,1024)`` on BBOX+DURING, the first spec again on
   INCLUDE, and TopK (the host-merge reducer); BBOX+DURING (sharded z3)
   and BBOX (sharded z2) positions; a heatmap through ``density_process``
   and a tile, both pushed down per shard; then a 1M-row append, which
   grows the shard to 2^25 slots, and the Histogram spec again, now on
   the int64 route.  Every result equals a numpy oracle over the rows,
   and ``hist1d`` launches once per kernel-route Histogram and ``depth``
   times per Frequency, and never on the int64 route.  Before the
   append, the BBOX+DURING query with a max-ranges hint of 65,536, whose
   plan holds more ranges than a device replicates (4096), takes the
   ring-parallel scan (``ShardedZ3Index.query_ring``), equal to the
   oracle and launching ``z3_mask``; ``range_counts_ring`` sums to
   ``range_count``;
8. lean: ``TpuDataStore(device="cuda")`` on schema ``scale``
   (``score:Double,dtg:Date,*geom:Point``, no profile set) with
   ``geomesa.lean.hbm.budget`` at 164 B a generation slot (one full and
   four keys generations beside the sentinel charges): ``--lean-rows``
   GDELT-like rows at ``--lean-slots``-slot generations in 4 writes, the
   first of which (``LEAN_AUTO_ROWS``, 32M rows) switches the schema to
   the lean profile, the rest splitting the others three ways, ending
   with generations in all three tiers
   (full, keys, host); 8 BBOX+DURING queries (3 city, 3 region, 2
   continent) and 2 BBOX-only ones, positions and implicit ids equal to
   the oracle, each plan costed by the cardinality estimator (source
   ``sketch``; its cold fold timed first); one city BBOX with the
   estimator off and a replan threshold of 2, which must replan exactly
   once (source ``observed``) and still equal the oracle; a 256x256
   world heatmap before any pyramid; ``build_pyramids``, which must
   build one per sealed generation; ``Count()`` on INCLUDE (the count
   push-down) and on BBOX+DURING (materialized) and a whole-extent
   ``Z3Histogram`` (the sketch push-down), equal to numpy oracles, with
   the route each took; ``density_process`` heatmaps over a BBOX+DURING
   and the world at 256 and 512 (pushed down, held to the per-tier
   contract: value-exact on full-tier rows, cell-inclusive on keys and
   host rows, binned at the z-cell centre), a ``score``-weighted heatmap
   (the query path and the density kernel, rtol 1e-5), ``density_tile``
   at z = 1 (a slice of the world grid) and z = 3 (a bbox scan), the
   world grids and the z = 1 tile served from every sealed generation's
   pyramid; then ``compact``, after which the generation count has
   fallen, every merged generation has inherited its parents' pyramid,
   and two queries and the pyramid-served world heatmap still equal the
   oracle.  Kernel launches of three queries are counted with
   ``torch.profiler``.  Last, ``age_off`` of the rows dated before
   2018-01-15 tombstones them (timed with the stats' re-observe over the
   live rows): ``get_count``, the estimator-costed queries (the oracle
   less the tombstoned rows), a region heatmap and the z = 3 tile (now
   the materializing path through the density kernel, exact grids) and
   ``Count()`` on INCLUDE, whose push-down must fall back;
9. attr: ``TpuDataStore(device="cuda")`` on schema ``attrs``
   (``actor:String:index=true,score:Double:index=true,dtg:Date,
   *geom:Point``): ``--attr-rows`` GDELT-like rows in 4 writes, ``actor``
   drawn from 200 three-letter codes with Zipf(1.1) frequencies plus one
   rare code at 0.01%, ``score`` a multiple of 0.1 in [-10, 10]; the
   z3-tiered attribute indexes of both built and timed; the rare actor
   with a continent BBOX and a month (``attr:actor``), ``actor IN`` two
   mid-frequency codes, a score band (``attr:score``), ``actor LIKE
   'U%'`` and a city BBOX with a day (``z3``), each strategy as expected
   and each hit set equal to a numpy oracle; then a 1M-row append, which
   the kept indexes serve as their tail, and the queries again;
10. mesh attr: ``TpuDataStore(mesh=device_mesh(1))`` on the same schema,
   ``--attr-mesh-rows`` rows; an actor equality with a week (the sharded
   index's z3 tier) and a score range, each against the oracle;
11. lean attr: the same schema on the lean profile, ``--lean-attr-rows``
   rows in 4 writes at ``--lean-attr-slots`` generations, with a budget of
   208 B a slot: the z3 index (0.75 of it) keeps one full and three keys
   generations, each attribute index the device generations its budget
   floor holds (two class-default generations) and the rest on the host; the attribute queries above plus an actor with a day
   (the date-tier seek) and the most frequent actor with a city BBOX and
   a day (``z3``), estimator-costed (source ``sketch``; the estimator's
   cold attribute folds timed first); Count, MinMax, a 64-bin Histogram
   and a Frequency of ``score`` over a quarter's window and over
   INCLUDE, cold and warm, on the sketch route and equal to numpy
   oracles (the count-min table is the host hash over the hits), and a
   Count of ``score > 9.5`` (materialized through ``attr:score``); then
   ``compact``, which must merge a group of host runs in each attribute
   index (the LeanAttrIndex core the lean XZ indexes share), and two
   queries again;
11b. mesh lean: the same schema on the lean profile over
   ``device_mesh(1)`` (``ShardedLeanZ3Index``, two
   ``ShardedLeanAttrIndex``), ``--mesh-lean-rows`` rows in 4 writes at
   ``--mesh-lean-slots``-slot per-shard generations and 384 B a slot of
   budget (z3: full and keys generations; each attribute index one
   device generation, the rest on the host), the accounted device bytes
   within 2% of ``torch.cuda.memory_allocated``; the lean phase's 10
   queries estimator-costed and the city BBOX replanned once, the
   rare-actor and score-band queries, ``Count()`` on INCLUDE (the count
   push-down) and the whole-extent ``Z3Histogram`` (the sketch), the
   world heatmap and the z = 1 and z = 3 tiles before and after
   ``build_pyramids`` (the world grid then served from every sealed
   generation's pyramid), a ``score``-weighted heatmap (the density
   kernel); ``compact`` (fewer z3 generations, a group of host runs
   merged in each attribute index, inherited pyramids); a
   flush, a drop, a reopen over ``device_mesh(1)``, the first query
   (time to recover) and the rest; then a point schema at a sixteenth of
   the slots whose generations pass through the full, keys and host
   tiers, its queries equal to the oracle;
12. polys: ``TpuDataStore(device="cuda")`` on schema ``polys``
   (``kind:String:index=true,dtg:Date,*geom:Polygon``): ``--poly-rows``
   footprints in 4 writes, drawn as ``poly_scale_proof.py`` draws them
   (axis-aligned rectangles around four city hotspots, half-sides
   0.0005-0.01°, a kind of road/building/park/water/rare), packed
   object-free, dtg uniform over 2018, ``geomesa.xz.precision`` at its
   default 12; the host xz3, xz2 and kind indexes built and timed; a city
   triangle with a day and a region triangle with a week (``xz3``), a
   day alone (``xz3`` over the whole world), a city BBOX, a region
   triangle and a continent triangle (``xz2``), the rare kind with a
   continent BBOX (``attr:kind``) and five ids (``id``), each strategy as
   expected and each hit set equal to a numpy oracle (interval overlap
   for boxes, a separating-axis test for the convex triangles); each xz
   query's range plan timed with the native sweep and the numpy sweep,
   which must agree; a heatmap, which raises ``KeyError`` as the JAX
   store does (a polygon schema has no x/y columns); then a 1M-row
   append, which the kept indexes serve as their tail, and the queries
   again;
13. mesh polys: the same on ``TpuDataStore(mesh=device_mesh(1))``
   (``--poly-mesh-rows``; ``ShardedXZ3Index`` / ``ShardedXZ2Index`` on
   the card) and a Count and 64-bin dtg Histogram over the city BBOX;
14. lean polys: ``poly_scale_proof``'s lean schema
   (``kind:String:index=true,*geom:Polygon``), ``--lean-poly-rows`` rows
   in 4 writes at ``--lean-slots`` generations under 60 B a slot of
   budget (the xz2 index must hold device and host generations); the
   xz2 queries above plus a city triangle and a continent
   BBOX, the rare kind with a continent BBOX and five ids, against the
   oracles; tiers, accounted and allocated device bytes; then
   ``compact`` and a query again;
15. lean tracks: the same footprints with a dtg (``LeanXZ3Index``),
   ``--lean-poly3-rows`` rows at ``--lean-poly3-slots`` generations (8
   at the defaults; the xz3 index must hold device and host
   generations): the spatio-temporal and temporal-only queries of phase
   12 and the spatial-only ones, which run on ``xz3`` with an open
   interval clamped to the data's extent; then ``compact``, which must
   merge a group of host runs, and a query again;
15b. mesh lean polys: phases 14 and 15 over ``device_mesh(1)``
   (``ShardedLeanXZ2Index``, ``ShardedLeanXZ3Index``),
   ``--mesh-lean-poly-rows`` and ``--mesh-lean-poly3-rows`` footprints
   at ``--mesh-lean-poly-slots``-slot per-shard generations under 100 B
   a slot (device and host generations both), and ``compact``;
16. lifecycle: ``TpuDataStore(device="cuda", auth_provider=...)`` on the
   facade's schema, ``--life-rows`` GDELT-like rows in 4 writes labelled
   "", ``user``, ``admin`` and ``user&admin``, ``actor`` guarded by
   ``admin``, read by a caller authorized for ``user``: the index
   phase's 20 queries as BBOX+DURING (z3) and BBOX (z2), positions equal
   to the oracle restricted to the visible rows, ``max_features``, a
   filter on the guarded attribute (no hit), ``get_count``,
   ``get_bounds`` and a region heatmap (materialized: the density
   kernel, bit-equal to the snap oracle); then a delete of 1% of the
   rows by id (timed; the first query after it, which rebuilds the
   indexes, timed apart), the queries again, the same delete again
   (0 rows) and ``age_off`` of the rows before 2018-01-15;
17. legacy: the same rows on a schema pinned to the v1 key layouts
   (``geomesa.index.versions=z3:1,z2:1``): the 40 queries equal to the
   oracle, their candidates next to the current layout's; then
   ``migrate_schema`` and the queries again (now with the current
   layout's candidates);
18. mesh lifecycle: ``device_mesh(1)``, ``--life-mesh-rows`` rows in 2
   labelled writes, a delete of 1% of them: Count, MinMax and a 64-bin
   Histogram of ``score`` pushed down through hist1d over the sharded
   index rebuilt after the delete, equal to numpy, and the queries;
   then the same rows and delete read by a caller authorized for
   ``user``, the queries restricted to its rows;
19. persist (run right after phase 16, whose store keeps a catalog in a
   temporary directory from its creation and is flushed after its
   age_off; each phase that writes one first checks that the disk has
   room for twice what it writes): the store dropped (its device memory
   must fall), the catalog reopened with the same auth provider, the
   reopen and the first restricted query timed apart (the two together
   the time to recover), the 40 queries against the oracle (the visible
   rows less the deleted and aged-off ones), a restricted heatmap (one
   density_grid launch, bit-equal), a 1M-row write whose auto ids follow
   every id ever issued, an ``update_schema`` rename; the catalog
   reopened on ``device_mesh(1)`` (the renamed schema only): Count,
   MinMax and a 64-bin Histogram of ``dtg`` on a continent-month query
   and on INCLUDE, pushed down through hist1d, equal to numpy; then
   ``remove_schema``, after which no file of the schema is left;
20. lean persist (run right after phase 8, whose store keeps a catalog
   from its creation and is flushed after its tombstoning age_off, in
   2^22-row parts): the store dropped, the snapshot reopened, the lazy
   streaming index rebuild timed inside the first query, the
   estimator-costed queries against the oracle less the tombstones,
   ``get_count`` and ``Count()``, and the device bytes allocated since
   the reopen within 0.99-1.05x of the index's accounted bytes;
21. fsds: ``FileSystemDataStore`` with the daily datetime scheme,
   ``--fsds-rows`` GDELT-like rows over 2018 in 4 writes (365 partitions,
   4 files each); a city-week BBOX+DURING query pruned on the host,
   equal to the oracle, reading the week's days and a day of over-cover
   on each side; ``compact`` (one file a partition) and the query again;
   the store rediscovered from disk and the query again; then
   ``to_device_store(fs, name, device="cuda")``: the query (z3) and a
   BBOX-only one (z2) on the card, equal to the oracle and to
   ``fs.query``.

The kernel launch counts are set to 0 just before phase 4 and read just
after phase 6, and again just before and after phase 7, phase 8,
phases 9-10, phase 11 and phase 11b; a kernel of a path that was never
launched on it fails the run (on the lean path, density_grid; on the
attribute path, z3_mask, which the city query launches; the lean
attribute path runs no kernel; on the mesh lean path, density_grid).
They are set to 0 and read around each of phases 12-15b as
well, and reported: the JAX package runs no Pallas kernel on its xz
paths (host numpy and plain XLA), and the port none on them.  They are
set to 0 and read around each of phases 16-18, which must launch
z3_mask, z2_mask and density_grid (16), z3_mask and z2_mask (17), and
z3_mask, z2_mask and hist1d (18), and around each of phases 19-21,
which must launch every kernel (19) and z3_mask and z2_mask (21); phase
20's are reported.  The
z3 index phase's range plans are timed again there with the native and
the numpy sweep.  The last lines printed are one ``{"kernels": [...]}`` JSON object,
the ``nvidia-smi`` name/power-limit line, and ``{"ok": true, "device":
...}``.  Without a CUDA device, or without the ``geomesa_tpu_torch``
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime as dt
import functools
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

MS_2018 = 1514764800000
MS_2019 = 1546300800000
DAY = 86_400_000
#: H100 SXM peaks at the 700 W limit: the memory rate (NVIDIA data sheet),
#: and the 32-bit integer rate, a quarter of the data sheet's 67e12/s
#: float32 rate (that counts a fused multiply-add of 128 lanes per SM per
#: clock as 2; the integer pipe does 64 operations per SM per clock, CUDA
#: C++ Programming Guide, arithmetic-instruction throughput, compute
#: capability 9.0)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
#: float64 instructions per second: the data sheet's 34e12 FP64 FLOP/s
#: outside the tensor cores counts a fused multiply-add as 2
FP64_OPS_PER_S = 34e12 / 2
WORLD = (-180.0, -90.0, 180.0, 90.0)
#: the mesh phase's ring query: a max-ranges hint whose plan over the
#: phase's 20-degree box and two weeks holds more than the 4096 ranges a
#: device replicates (the phase checks it)
RING_MAX_RANGES = 65536
#: the lean phase's Z3Histogram resolution (top bits of the z3 key)
Z3_BITS = 12
#: the lean phase's mispredicted plan: whole-store fractions only, and a
#: replan threshold the dense city box passes
REPLAN_ENV = {"GEOMESA_PLANNING_ESTIMATOR_ENABLED": "false",
              "GEOMESA_PLANNING_REPLAN_THRESHOLD": "2.0"}
#: the lean phase's fraction-costed plans (the estimator and replanning
#: off: what PR 5's port planned), timed in turns with the sketch-costed
FRACTION_ENV = {"GEOMESA_PLANNING_ESTIMATOR_ENABLED": "false",
                "GEOMESA_PLANNING_REPLAN_THRESHOLD": "0"}


@contextlib.contextmanager
def env_set(values: dict):
    """Set environment variables for the block, then restore them."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def gdelt_like(rng, n: int, centres):
    """``n`` GDELT-like points: 70% Gaussian clusters around the city
    ``centres``, 30% uniform over the world; dtg uniform over 2018."""
    import numpy as np
    n_c = int(n * 0.7)
    which = rng.integers(0, len(centres), n_c)
    sigma = rng.uniform(0.5, 3.0, len(centres))[which]
    x = np.empty(n)
    y = np.empty(n)
    x[:n_c] = centres[which, 0] + rng.standard_normal(n_c) * sigma
    y[:n_c] = centres[which, 1] + rng.standard_normal(n_c) * sigma
    x[n_c:] = rng.uniform(-180.0, 180.0, n - n_c)
    y[n_c:] = rng.uniform(-90.0, 90.0, n - n_c)
    np.clip(x, -180.0, 180.0, out=x)
    np.clip(y, -90.0, 90.0, out=y)
    t = rng.integers(MS_2018, MS_2019, n)
    return x, y, t


#: brute-force answers already computed: a phase asks the same window of
#: the same columns many times (the queries, their turns, after a
#: compaction, after a reopen), and at the lean phase's size each
#: answer costs most of a second of host time.  Keyed by the columns' identity and the window;
#: an entry holds weak references to its columns, so it never answers
#: for other arrays, and its positions are read-only
_ORACLE_MEMO: dict = {}


def _memo_oracle(fn):
    import weakref

    @functools.wraps(fn)
    def memo(*args):
        cols = [a for a in args if hasattr(a, "dtype")]
        rest = tuple(tuple(map(tuple, a)) if isinstance(a, list) else a
                     for a in args if not hasattr(a, "dtype"))
        key = (fn.__name__, tuple(id(c) for c in cols), rest)
        hit = _ORACLE_MEMO.get(key)
        if hit is not None and all(r() is c for r, c in zip(hit[0], cols)):
            return hit[1]
        out = fn(*args)
        out.setflags(write=False)
        for k in [k for k, (refs, _) in _ORACLE_MEMO.items()
                  if any(r() is None for r in refs)]:
            del _ORACLE_MEMO[k]      # the answers of freed columns
        _ORACLE_MEMO[key] = ([weakref.ref(c) for c in cols], out)
        return out
    return memo


@_memo_oracle
def oracle(x, y, t, boxes, lo, hi, chunk: int = 1 << 24):
    """Brute-force positions of rows inside any box and [lo, hi], in
    chunks of ``chunk`` rows."""
    import numpy as np
    out = []
    for s in range(0, len(x), chunk):
        tc = t[s:s + chunk]
        idx = np.flatnonzero((tc >= lo) & (tc <= hi))
        xc, yc = x[s:s + chunk][idx], y[s:s + chunk][idx]
        m = np.zeros(len(idx), dtype=bool)
        for b in boxes:
            m |= (xc >= b[0]) & (xc <= b[2]) & (yc >= b[1]) & (yc <= b[3])
        out.append(idx[m] + s)
    return np.concatenate(out)


@_memo_oracle
def box_oracle(x, y, boxes, chunk: int = 1 << 24):
    """Brute-force positions of points inside any box, in chunks."""
    import numpy as np
    out = []
    for s in range(0, len(x), chunk):
        xc, yc = x[s:s + chunk], y[s:s + chunk]
        m = np.zeros(len(xc), dtype=bool)
        for b in boxes:
            m |= (xc >= b[0]) & (xc <= b[2]) & (yc >= b[1]) & (yc <= b[3])
        out.append(np.flatnonzero(m) + s)
    return np.concatenate(out)


def snap_counts(x, y, env, width: int, height: int, chunk: int = 1 << 24):
    """numpy histogram of unit-weight points snapped as GridSnap snaps
    them (floor of the true quotient, clamped to the grid), float64."""
    import numpy as np
    xmin, ymin, xmax, ymax = env
    dx, dy = (xmax - xmin) / width, (ymax - ymin) / height
    counts = np.zeros(width * height, dtype=np.int64)
    for s in range(0, len(x), chunk):
        ix = np.clip(np.floor((x[s:s + chunk] - xmin) / dx), 0, width - 1)
        iy = np.clip(np.floor((y[s:s + chunk] - ymin) / dy), 0, height - 1)
        counts += np.bincount(iy.astype(np.int64) * width
                              + ix.astype(np.int64),
                              minlength=width * height)
    return counts.astype(np.float64).reshape(height, width)


def bound(nbytes: float, ops: float, ops_per_s: float) -> tuple:
    """The least time the card could take, in ms, and what sets it."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def iso(ms: int) -> str:
    return dt.datetime.fromtimestamp(ms / 1000, dt.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ")


def random_boxes(rng, r_real: int, r: int, bits: int, span, dev):
    """``r_real`` random int-space boxes of ``bits``-bit dimensions, sides
    drawn from ``span``, padded to ``r`` with never-matching [1, 1, 0, 0]
    boxes."""
    import numpy as np
    import torch
    lo = rng.integers(0, 1 << bits, (r_real, 2))
    ixy = np.concatenate(
        [lo, np.minimum(lo + rng.integers(*span, (r_real, 2)),
                        (1 << bits) - 1)], axis=1)
    ixy = np.concatenate([ixy, np.tile([[1, 1, 0, 0]], (r - r_real, 1))])
    return torch.tensor(ixy.astype(np.int32), device=dev)


def mask_row(name: str, kernel, plain, args, n: int, r: int, nbytes: int,
             ops: int) -> dict:
    """Hold a candidate-mask kernel against its plain version bit for bit
    and time both (kernel, plain, kernel, plain)."""
    import torch
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
    if err != 0 or not torch.equal(got, want):
        raise AssertionError(
            f"{name} kernel disagrees with its plain version at N={n} "
            f"R={r}: {int((got != want).sum())} mismatches")
    hits = int(want.sum())
    if not 0 < hits < n:
        raise AssertionError(f"degenerate {name} case: {hits} hits")
    k1 = cuda_ms(lambda: kernel(*args), 50)
    p1 = cuda_ms(lambda: plain(*args), 10)
    k2 = cuda_ms(lambda: kernel(*args), 50)
    p2 = cuda_ms(lambda: plain(*args), 10)
    b_ms, b_by = bound(nbytes, ops, INT32_OPS_PER_S)
    row = {"n": n, "r": r, "hits": hits, "max_abs_err": err,
           "ms": min(k1, k2), "plain_ms": min(p1, p2), "bound_ms": b_ms,
           "bound_by": b_by}
    log(f"kernel {name} N={n} R={r}: equal, {hits} hits, {row['ms']:.4f} ms "
        f"(plain {row['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by {b_by})")
    return row


def kernel_phase(rng, dev):
    """The z3 mask kernel against its plain version at the main path's
    largest candidate buffers (2^22, and a ragged 2^22 + 37)."""
    import numpy as np
    import torch
    from geomesa_tpu_torch.curve import z3_sfc
    from geomesa_tpu_torch.ops.z3_mask import z3_mask, z3_mask_reference

    sfc = z3_sfc("week")
    rows = []
    for n in (1 << 22, (1 << 22) + 37):
        x = torch.tensor(rng.uniform(-180, 180, n), device=dev)
        y = torch.tensor(rng.uniform(-90, 90, n), device=dev)
        t = torch.tensor(rng.uniform(0, 604800.0, n), device=dev)
        z = sfc.index(x, y, t)
        tlo = torch.tensor(rng.integers(0, 1 << 20, n, dtype=np.int32),
                           device=dev)
        thi = tlo + torch.tensor(rng.integers(0, 1 << 21, n, dtype=np.int32),
                                 device=dev)
        for r_real, r in ((1, 1), (5, 8)):
            ixy = random_boxes(rng, r_real, r, 21, (1 << 16, 1 << 20), dev)
            # 32-bit integer operations per candidate, counted low (the
            # card has no 64-bit integer pipe): each 64-bit shift is one
            # funnel shift per 32-bit half and each xor-then-and one
            # three-input logic op per half, so z >> 1 and z >> 2 take 4,
            # each of the 3 de-interleaves 2 + 5 * 4 = 22; each box 4
            # predicate-chained compares; the time test 2
            rows.append(mask_row("z3_mask", z3_mask, z3_mask_reference,
                                 (z, ixy, tlo, thi), n, r,
                                 n * (8 + 4 + 4 + 1) + r * 16,
                                 n * (4 + 3 * 22 + 4 * r + 2)))
    return rows


def z2_kernel_phase(rng, dev):
    """The z2 mask kernel against its plain version at 2^22 candidates, a
    ragged 2^22 + 37, and 2^24: the z2 scan's gather capacity starts at
    2^15, grows to the power of two above a query's candidates, and never
    shrinks, so after the continent boxes every z2 query on the main path
    masks 2^24 slots (R = 1 for one BBOX, 2 for the two-box query)."""
    import torch
    from geomesa_tpu_torch.curve import z2_sfc
    from geomesa_tpu_torch.ops.z2_mask import z2_mask, z2_mask_reference

    rows = []
    for n in (1 << 22, (1 << 22) + 37, 1 << 24):
        z = z2_sfc().index(torch.tensor(rng.uniform(-180, 180, n), device=dev),
                           torch.tensor(rng.uniform(-90, 90, n), device=dev))
        for r_real, r in ((1, 1), (5, 8)):
            ixy = random_boxes(rng, r_real, r, 31, (1 << 26, 1 << 30), dev)
            # 32-bit integer operations per candidate, counted low as in
            # csrc/z2_mask.cu: z >> 1 is 2, each de-interleave 2 + 5 * 4,
            # each box 4 compares (the dimensions are 32-bit values)
            rows.append(mask_row("z2_mask", z2_mask, z2_mask_reference,
                                 (z, ixy), n, r, n * (8 + 1) + r * 16,
                                 n * (46 + 4 * r)))
        del z
    return rows


def density_kernel_phase(rng, centres, dev):
    """The density kernel against its plain version at 2^24 points,
    clustered GDELT-like and uniform, over the world at 256x256 and
    1024x1024, ~50% of the points masked in; and clustered at 256x256
    with every point masked in (the mask process/density.py passes).
    Unit weights bit for bit, random float64 weights within rtol 1e-6
    (float64 sums in an order that changes from run to run, then rounded
    to float32)."""
    import numpy as np
    import torch
    from geomesa_tpu_torch.ops.density_kernel import (
        density_grid_kernel, density_grid_kernel_reference,
    )

    n = 1 << 24
    rows = []

    def measure(xd, yd, w, mask, dist, weights, size, share):
        n_in = int(mask.sum())
        args = (xd, yd, w, mask, WORLD, size, size)
        got = density_grid_kernel(*args)
        want = density_grid_kernel_reference(*args)
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        if weights == "unit":
            ok = torch.equal(got, want)
        else:
            ok = bool(torch.allclose(got, want, rtol=1e-6, atol=0))
        if not ok:
            raise AssertionError(
                f"density kernel disagrees with its plain version "
                f"({dist}, {weights}, {size}x{size}, {share:.0%} in): max "
                f"abs err {err}")
        total = float(got.double().sum())
        if weights == "unit" and total != n_in:
            raise AssertionError(f"density grid holds {total} points, not "
                                 f"{n_in}")
        # the library yardstick leaves the snap out: one torch.bincount
        # over cells snapped beforehand
        xmin, ymin, xmax, ymax = WORLD
        ix = torch.clamp(torch.floor((xd - xmin) / ((xmax - xmin) / size)),
                         0, size - 1).long()
        iy = torch.clamp(torch.floor((yd - ymin) / ((ymax - ymin) / size)),
                         0, size - 1).long()
        cells = (iy * size + ix)[mask]
        w_in = w[mask].float().double()
        k1 = cuda_ms(lambda: density_grid_kernel(*args), 20)
        p1 = cuda_ms(lambda: density_grid_kernel_reference(*args), 5)
        l1 = cuda_ms(lambda: torch.bincount(cells, w_in,
                                            minlength=size * size), 20)
        k2 = cuda_ms(lambda: density_grid_kernel(*args), 20)
        p2 = cuda_ms(lambda: density_grid_kernel_reference(*args), 5)
        l2 = cuda_ms(lambda: torch.bincount(cells, w_in,
                                            minlength=size * size), 20)
        del cells, w_in
        # this run's data: the mask byte of every point, x, y and w of the
        # masked-in ones, the float32 grid written once; ~30 float64
        # instructions per masked-in point (two subtract-divide-floor-
        # clamp chains, the division some 10)
        b_ms, b_by = bound(n + 24 * n_in + 4 * size * size, 30 * n_in,
                           FP64_OPS_PER_S)
        rows.append({"n": n, "dist": dist, "weights": weights,
                     "grid": size, "masked_in_share": share,
                     "masked_in": n_in, "max_abs_err": err, "total": total,
                     "ms": min(k1, k2), "plain_ms": min(p1, p2),
                     "library_ms": min(l1, l2),
                     "bound_ms": b_ms, "bound_by": b_by})
        log(f"kernel density_grid {dist} {weights} {size}x{size} N={n} "
            f"{share:.0%} in: equal (max abs err {err:g}), "
            f"{rows[-1]['ms']:.4f} ms (plain {rows[-1]['plain_ms']:.4f} ms, "
            f"bincount {rows[-1]['library_ms']:.4f} ms, bound {b_ms:.4f} ms "
            f"by {b_by})")

    for dist in ("clustered", "uniform"):
        if dist == "clustered":
            x, y, _ = gdelt_like(rng, n, centres)
        else:
            x = rng.uniform(-180.0, 180.0, n)
            y = rng.uniform(-90.0, 90.0, n)
        xd, yd = (torch.tensor(a, device=dev) for a in (x, y))
        mask = torch.tensor(rng.random(n) < 0.5, device=dev)
        for weights in ("unit", "random"):
            w = (torch.ones(n, dtype=torch.float64, device=dev)
                 if weights == "unit" else
                 torch.tensor(rng.uniform(0.5, 2.0, n), device=dev))
            for size in (256, 1024):
                measure(xd, yd, w, mask, dist, weights, size, 0.5)
        if dist == "clustered":
            w = torch.ones(n, dtype=torch.float64, device=dev)
            measure(xd, yd, w, torch.ones(n, dtype=torch.bool, device=dev),
                    dist, "unit", 256, 1.0)
        del xd, yd, mask, w
    torch.cuda.empty_cache()
    return rows


def hist1d_kernel_phase(rng, dev):
    """The hist1d kernel against its plain version at 16M rows (the mesh
    phase's per-shard slot count) and a ragged 2^22 + 37, at 64 bins (a
    Histogram stat), 1024 (a Frequency width) and 65,536 (wider than a
    block's shared memory: a histogram spread over a cluster), ~50% of
    the rows masked in; and at 16M rows and 64 bins with every row masked
    in (the mesh phase's INCLUDE stats).  Ids run 16 past both ends of the
    bins; unit weights bit for bit, random weights within rtol 1e-5
    (float32 atomics sum in an order that changes from run to run)."""
    import numpy as np
    import torch
    from geomesa_tpu_torch.ops.hist1d_kernel import hist1d, hist1d_reference

    rows = []

    def measure(bins, w, mask, n_bins, weights, share):
        n = int(bins.shape[0])
        n_in = int(mask.sum())
        keep = mask & (bins >= 0) & (bins < n_bins)
        n_kept = int(keep.sum())
        args = (bins, w, mask, n_bins)
        got = hist1d(*args)
        want = hist1d_reference(*args)
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        ok = (torch.equal(got, want) if weights == "unit" else
              bool(torch.allclose(got, want, rtol=1e-5, atol=0)))
        if not ok:
            raise AssertionError(
                f"hist1d kernel disagrees with its plain version at N={n} "
                f"bins={n_bins} ({weights}, {share:.0%} in): max abs err "
                f"{err}")
        if weights == "unit" and float(got.double().sum()) != n_kept:
            raise AssertionError(f"hist1d counts {got.sum()} rows, not "
                                 f"{n_kept}")
        # the library yardstick leaves the mask and the range test out:
        # one torch.bincount over ids and weights prepared beforehand
        ids = torch.where(keep, bins, 0).long()
        w_in = torch.where(keep, w, 0.0)
        k1 = cuda_ms(lambda: hist1d(*args), 20)
        p1 = cuda_ms(lambda: hist1d_reference(*args), 3)
        l1 = cuda_ms(lambda: torch.bincount(ids, w_in, minlength=n_bins), 10)
        k2 = cuda_ms(lambda: hist1d(*args), 20)
        p2 = cuda_ms(lambda: hist1d_reference(*args), 3)
        l2 = cuda_ms(lambda: torch.bincount(ids, w_in, minlength=n_bins), 10)
        del ids, w_in, keep
        # this run's data: the mask byte of every row, the bin id and
        # weight of each masked-in row, the float32 output once; a range
        # test and an add per masked-in row
        b_ms, b_by = bound(n + 8 * n_in + 4 * n_bins, 3 * n_in,
                           INT32_OPS_PER_S)
        rows.append({"n": n, "bins": n_bins, "weights": weights,
                     "masked_in_share": share, "masked_in": n_in,
                     "max_abs_err": err, "ms": min(k1, k2),
                     "plain_ms": min(p1, p2), "library_ms": min(l1, l2),
                     "library": "torch.bincount, mask and range test left "
                                "out",
                     "bound_ms": b_ms, "bound_by": b_by})
        log(f"kernel hist1d N={n} bins={n_bins} {weights} {share:.0%} in: "
            f"equal (max abs err {err:g}), {rows[-1]['ms']:.4f} ms (plain "
            f"{rows[-1]['plain_ms']:.4f} ms, bincount "
            f"{rows[-1]['library_ms']:.4f} ms, bound {b_ms:.4f} ms by "
            f"{b_by})")

    for n in (16_000_000, (1 << 22) + 37):
        mask = torch.tensor(rng.random(n) < 0.5, device=dev)
        for n_bins in (64, 1024, 65_536):
            bins = torch.tensor(rng.integers(-16, n_bins + 16, n,
                                             dtype=np.int32), device=dev)
            for weights in ("unit", "random"):
                w = (torch.ones(n, dtype=torch.float32, device=dev)
                     if weights == "unit" else
                     torch.tensor(rng.uniform(0.0, 3.0, n).astype(np.float32),
                                  device=dev))
                measure(bins, w, mask, n_bins, weights, 0.5)
            if n == 16_000_000 and n_bins == 64:
                measure(bins, torch.ones(n, dtype=torch.float32, device=dev),
                        torch.ones(n, dtype=torch.bool, device=dev), n_bins,
                        "unit", 1.0)
            del bins, w
        del mask
    torch.cuda.empty_cache()
    return rows


def index_phase(rng, args, centres, dev, report):
    """The z3 index phase; returns the indexed points ``(x, y)`` (the
    appended ones last), the append's row count and the queries."""
    import numpy as np
    import torch
    from geomesa_tpu_torch.index import z3 as z3mod

    n = args.points
    t0 = time.perf_counter()
    x, y, t = gdelt_like(rng, n, centres)
    report["index"] = {"points": n, "gen_s": time.perf_counter() - t0}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    idx = z3mod.Z3PointIndex.build(x, y, t, period="week", device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    m = 1_000_000
    ax, ay, at = gdelt_like(rng, m, centres)
    t0 = time.perf_counter()
    idx.append(ax, ay, at)
    torch.cuda.synchronize()
    append_s = time.perf_counter() - t0
    x, y, t = (np.concatenate(p) for p in ((x, ax), (y, ay), (t, at)))
    if len(idx) != n + m:
        raise AssertionError(f"index holds {len(idx)} rows, not {n + m}")
    report["index"].update(
        build_s=build_s, build_keys_per_s=n / build_s, append_rows=m,
        append_s=append_s, append_keys_per_s=m / append_s,
        capacity=int(idx.z.shape[0]),
        resident_bytes=sum(int(c.numel() * c.element_size()) for c in
                           (idx.bins, idx.z, idx.pos, idx.x, idx.y,
                            idx.dtg)),
        peak_device_bytes=int(torch.cuda.max_memory_allocated()))
    log(f"index: built {n} keys in {build_s:.3f} s "
        f"({n / build_s:.4g} keys/s); appended {m} in {append_s:.3f} s "
        f"({m / append_s:.4g} keys/s); capacity {idx.z.shape[0]}")

    qs = []
    day_of = lambda: MS_2018 + int(rng.integers(0, 358)) * DAY
    for i in range(8):     # city: 1°×1°, 1 day
        cx, cy = centres[i]
        lo = day_of()
        qs.append(("city", [(cx - .5, cy - .5, cx + .5, cy + .5)],
                   lo, lo + DAY - 1))
    for i in range(8, 14):  # region: 10°×10°, 1 week
        cx, cy = centres[i]
        lo = day_of()
        qs.append(("region", [(cx - 5, cy - 5, cx + 5, cy + 5)],
                   lo, lo + 7 * DAY - 1))
    for box in ((-10, 35, 50, 75), (-125, 20, -65, 60), (70, 5, 130, 45),
                (-20, -35, 40, 5)):   # continent: 60°×40°, 1 month
        lo = day_of()
        qs.append(("continent", [box], lo, lo + 30 * DAY - 1))
    cx, cy = centres[14]
    lo = day_of()
    qs.append(("two-box", [(cx - .5, cy - .5, cx + .5, cy + .5),
                           (cx + 2, cy + 2, cx + 7, cy + 7)],
               lo, lo + 3 * DAY - 1))
    qs.append(("edge", [(170.0, 80.0, 180.0, 90.0)], MS_2018, MS_2019 - 1))

    per_query = []
    for kind, boxes, lo, hi in qs:
        two_phase = idx._capacity >= z3mod.TWO_PHASE_MIN_CAPACITY
        # the host planning alone, timed apart (the query plans again)
        t0 = time.perf_counter()
        z3mod.plan_z3_query(boxes, *idx._clamp_time(lo, hi), idx.period,
                            sfc=idx.sfc)
        plan_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        got = idx.query(boxes, lo, hi)
        ms = (time.perf_counter() - t0) * 1e3
        want = oracle(x, y, t, boxes, lo, hi)
        if not np.array_equal(got, want):
            raise AssertionError(
                f"{kind} query {boxes} [{lo}, {hi}]: {len(got)} hits, "
                f"oracle {len(want)}")
        per_query.append({"kind": kind, "ms": ms, "plan_ms": plan_ms,
                          "hits": int(len(got)),
                          "two_phase": two_phase,
                          "capacity_after": idx._capacity})
    if not any(q["two_phase"] for q in per_query):
        raise AssertionError("no query took the two-phase path")
    lat = np.array([q["ms"] for q in per_query])
    report["index"]["queries"] = per_query
    report["index"]["query_ms_p50"] = float(np.median(lat))
    report["index"]["query_ms_max"] = float(lat.max())
    log(f"index: {len(qs)} queries equal to the oracle; p50 "
        f"{np.median(lat):.3f} ms, max {lat.max():.3f} ms; two-phase "
        f"{sum(q['two_phase'] for q in per_query)}; hits "
        f"{[q['hits'] for q in per_query]}")
    if args.profile:
        report["index"]["profile"] = profile_queries(
            "z3", lambda q: idx.query(q[1], q[2], q[3]), qs)
    del idx
    torch.cuda.empty_cache()
    return x, y, m, qs


def z2_index_phase(args, x, y, m, qs, dev, report):
    """``Z2PointIndex`` over the z3 phase's points: build, the same
    append, the queries' boxes without their times, one ``query_many``
    and the world density grid, each equal to a numpy oracle."""
    import numpy as np
    import torch
    from geomesa_tpu_torch.index.z2 import Z2PointIndex

    n = len(x) - m
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    idx = Z2PointIndex.build(x[:n], y[:n], device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.append(x[n:], y[n:])
    torch.cuda.synchronize()
    append_s = time.perf_counter() - t0
    if len(idx) != n + m:
        raise AssertionError(f"z2 index holds {len(idx)} rows, not {n + m}")
    rep = report["z2_index"] = {
        "points": n, "build_s": build_s, "build_keys_per_s": n / build_s,
        "append_rows": m, "append_s": append_s,
        "append_keys_per_s": m / append_s, "capacity": int(idx.z.shape[0]),
        "resident_bytes": sum(int(c.numel() * c.element_size())
                              for c in (idx.z, idx.pos, idx.x, idx.y)),
        "peak_device_bytes": int(torch.cuda.max_memory_allocated())}
    log(f"z2 index: built {n} keys in {build_s:.3f} s "
        f"({n / build_s:.4g} keys/s); appended {m} in {append_s:.3f} s "
        f"({m / append_s:.4g} keys/s); capacity {idx.z.shape[0]}")

    per_query = []
    for kind, boxes, _, _ in qs:
        t0 = time.perf_counter()
        got = idx.query(boxes)
        ms = (time.perf_counter() - t0) * 1e3
        want = box_oracle(x, y, boxes)
        if not np.array_equal(got, want):
            raise AssertionError(f"z2 {kind} query {boxes}: {len(got)} "
                                 f"hits, oracle {len(want)}")
        per_query.append({"kind": kind, "ms": ms, "hits": int(len(got)),
                          "capacity_after": idx._capacity})
    lat = np.array([q["ms"] for q in per_query])
    rep.update(queries=per_query, query_ms_p50=float(np.median(lat)),
               query_ms_max=float(lat.max()))
    log(f"z2 index: {len(qs)} BBOX queries equal to the oracle; p50 "
        f"{np.median(lat):.3f} ms, max {lat.max():.3f} ms; hits "
        f"{[q['hits'] for q in per_query]}")

    sets = [q[1] for q in qs[:2]] + [q[1] for q in qs[8:10]]
    t0 = time.perf_counter()
    many = idx.query_many(sets)
    many_ms = (time.perf_counter() - t0) * 1e3
    for boxes, got in zip(sets, many):
        if not np.array_equal(got, box_oracle(x, y, boxes)):
            raise AssertionError(f"z2 query_many set {boxes} disagrees "
                                 "with the oracle")
    t0 = time.perf_counter()
    grid = idx.density_world(1024, 512)
    world_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(grid, snap_counts(x, y, WORLD, 1024, 512)):
        raise AssertionError("z2 density_world disagrees with the numpy "
                             "histogram")
    rep.update(query_many_ms=many_ms, density_world_ms=world_ms)
    log(f"z2 index: query_many of {len(sets)} box sets {many_ms:.1f} ms "
        f"and density_world(1024, 512) {world_ms:.1f} ms, equal to the "
        "oracle")
    if args.profile:
        rep["profile"] = profile_queries("z2", lambda q: idx.query(q[1]), qs)
    del idx
    torch.cuda.empty_cache()


def profile_queries(label: str, run, qs) -> dict:
    """One more pass over the queries (``run(q)`` runs one) under
    ``torch.profiler``: wall time, device time (its sum and share of the
    wall), and the kernels that took the most device time.  These
    queries' launches count with the main path's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for q in qs:
            run(q)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): an aten op's own row
    # repeats the time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    out = {"queries": len(qs), "wall_ms": wall_ms, "device_ms": device_ms,
           "device_busy_share": device_ms / wall_ms,
           "top": [{"name": e.key[:80], "calls": e.count,
                    "device_ms": e.self_device_time_total / 1e3}
                   for e in top]}
    log(f"profile {label}: {len(qs)} queries, wall {wall_ms:.1f} ms, device "
        f"{device_ms:.1f} ms ({100 * device_ms / wall_ms:.1f}% busy); top: "
        + ", ".join(f"{t['name'][:40]} {t['device_ms']:.2f} ms x{t['calls']}"
                    for t in out["top"][:5]))
    return out


def facade_phase(rng, args, centres, dev, report):
    import numpy as np
    from geomesa_tpu_torch import TpuDataStore, density_process
    from geomesa_tpu_torch.index.pyramid import tile_env
    from geomesa_tpu_torch.ops.density_kernel import density_grid_kernel
    from geomesa_tpu_torch.ops.z2_mask import z2_mask
    from geomesa_tpu_torch.ops.z3_mask import z3_mask

    ds = TpuDataStore(device=dev)
    ds.create_schema("gdelt", "actor:String,dtg:Date,*geom:Point")
    actors = np.array(["USA", "GBR", "FRA", "CHN", "IND", "BRA", "RUS"],
                      dtype=object)
    n = args.facade_rows
    per = n // 4
    xs, ys, ts = [], [], []
    cx, cy = centres[3]
    box = (cx - 5, cy - 5, cx + 5, cy + 5)
    bx2, by2 = centres[4]
    box2 = (bx2 - 2, by2 - 2, bx2 + 2, by2 + 2)
    w1 = (MS_2018 + 40 * DAY, MS_2018 + 47 * DAY - 1)
    w2 = (MS_2018 + 200 * DAY, MS_2018 + 203 * DAY - 1)

    def bbox(b):
        return f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})"

    q_and = f"{bbox(box)} AND dtg DURING {iso(w1[0])}/{iso(w1[1])}"
    q_or = (f"{bbox(box)} AND (dtg DURING {iso(w1[0])}/{iso(w1[1])} OR dtg "
            f"DURING {iso(w2[0])}/{iso(w2[1])})")
    q_bbox = bbox(box)
    q_bbox_or = f"{bbox(box)} OR {bbox(box2)}"
    launches0 = (z3_mask.launches, z2_mask.launches)
    write_s = []
    for i in range(4):
        x, y, t = gdelt_like(rng, per, centres)
        xs.append(x), ys.append(y), ts.append(t)
        t0 = time.perf_counter()
        ds.write("gdelt", {"actor": actors[rng.integers(0, len(actors), per)],
                           "dtg": t, "geom": (x, y)})
        write_s.append(time.perf_counter() - t0)
        if i == 0:  # builds the z3 and z2 indexes: later writes append
            ds.query_result("gdelt", q_and)
            ds.query_result("gdelt", q_bbox)
    x, y, t = (np.concatenate(p) for p in (xs, ys, ts))
    store = ds._store("gdelt")
    if (store.build_counts != {"z3": 1, "z2": 1}
            or len(store.z3_index()) != 4 * per
            or len(store.z2_index()) != 4 * per):
        raise AssertionError(f"indexes not appended to: "
                             f"{store.build_counts}")
    checks = [
        ("bbox_during", q_and, "z3", oracle(x, y, t, [box], *w1)),
        ("bbox_or_during", q_or, "z3",
         np.union1d(oracle(x, y, t, [box], *w1),
                    oracle(x, y, t, [box], *w2))),
        ("bbox", q_bbox, "z2", box_oracle(x, y, [box])),
        ("bbox_or_bbox", q_bbox_or, "z2", box_oracle(x, y, [box, box2])),
        ("include", "INCLUDE", "full", np.arange(4 * per)),
    ]
    rows = []
    for name, ecql, strategy, want in checks:
        t0 = time.perf_counter()
        res = ds.query_result("gdelt", ecql)
        ms = (time.perf_counter() - t0) * 1e3
        if res.strategy.index != strategy:
            raise AssertionError(f"{name}: strategy {res.strategy.index}, "
                                 f"expected {strategy}")
        if name == "bbox_or_bbox" and len(res.strategy.geometries) != 2:
            raise AssertionError("the OR of two BBOXes is not one z2 scan")
        if not np.array_equal(res.positions, want):
            raise AssertionError(f"{name}: {len(res.positions)} hits, "
                                 f"oracle {len(want)}")
        rows.append({"query": name, "ms": ms, "hits": int(len(want)),
                     "plan_ms": res.plan_time_ms,
                     "scan_ms": res.scan_time_ms})
    grew = (z3_mask.launches - launches0[0], z2_mask.launches - launches0[1])
    if min(grew) <= 0:
        raise AssertionError(f"z3_mask/z2_mask launches in the facade phase: "
                             f"{grew}")

    # heatmaps through density_process and density_tile, each against a
    # numpy histogram of the oracle's hits
    d0 = density_grid_kernel.launches
    tx = int((cx + 180.0) // 45.0)
    ty = 7 - int((cy + 90.0) // 22.5)
    tenv = tile_env(3, tx, ty)
    dens = [
        ("bbox_during", lambda: density_process(ds, "gdelt", q_and, box),
         box, oracle(x, y, t, [box], *w1)),
        ("bbox", lambda: density_process(ds, "gdelt", q_bbox, box),
         box, box_oracle(x, y, [box])),
        ("include", lambda: density_process(ds, "gdelt", "INCLUDE", WORLD),
         WORLD, None),
        (f"tile_3_{tx}_{ty}", lambda: ds.density_tile("gdelt", 3, tx, ty),
         tenv, box_oracle(x, y, [tenv])),
    ]
    drows = []
    for name, run, env, hits in dens:
        t0 = time.perf_counter()
        grid = run()
        ms = (time.perf_counter() - t0) * 1e3
        want = (snap_counts(x, y, env, 256, 256) if hits is None
                else snap_counts(x[hits], y[hits], env, 256, 256))
        if grid.shape != (256, 256) or not np.array_equal(
                grid.astype(np.float64), want.astype(np.float32)):
            raise AssertionError(f"density {name}: grid disagrees with the "
                                 f"oracle ({float(grid.sum())} against "
                                 f"{float(want.sum())} points)")
        drows.append({"query": name, "ms": ms, "points": float(want.sum()),
                      "dtype": str(grid.dtype)})
    dgrew = density_grid_kernel.launches - d0
    if dgrew != len(dens):
        raise AssertionError(f"density_grid launched {dgrew} times for "
                             f"{len(dens)} heatmaps")
    report["facade"] = {"rows": 4 * per, "write_s": write_s,
                        "write_rows_per_s": [per / s for s in write_s],
                        "queries": rows, "density": drows,
                        "z3_mask_launches": grew[0],
                        "z2_mask_launches": grew[1],
                        "density_grid_launches": dgrew}
    log(f"facade: {4 * per} rows in 4 writes "
        f"({', '.join(f'{s:.2f}' for s in write_s)} s); queries equal to "
        f"the oracle: " + ", ".join(f"{r['query']} {r['hits']} hits "
                                    f"{r['ms']:.1f} ms" for r in rows)
        + "; heatmaps equal to the oracle: "
        + ", ".join(f"{r['query']} {r['points']:.0f} points {r['ms']:.1f} ms"
                    for r in drows)
        + f"; launches z3_mask {grew[0]}, z2_mask {grew[1]}, density_grid "
          f"{dgrew}")
    return ds


def places_phase(rng, args, centres, ds, report):
    """A point schema without a dtg: it stays on the default profile and
    answers BBOX queries (one box, an OR of two) through z2."""
    import numpy as np

    ds.create_schema("places", "name:String,*geom:Point")
    names = np.array(["cafe", "school", "park", "station"], dtype=object)
    n = args.places_rows
    xs, ys = [], []
    cx, cy = centres[5]
    box = (cx - 3, cy - 3, cx + 3, cy + 3)
    bx2, by2 = centres[6]
    box2 = (bx2 - 1, by2 - 1, bx2 + 1, by2 + 1)
    write_s = []
    for i in range(2):
        x, y, _ = gdelt_like(rng, n // 2, centres)
        xs.append(x), ys.append(y)
        t0 = time.perf_counter()
        ds.write("places", {"name": names[rng.integers(0, len(names),
                                                      n // 2)],
                            "geom": (x, y)})
        write_s.append(time.perf_counter() - t0)
        if i == 0:  # builds the z2 index: the second write appends
            ds.query_result("places", f"BBOX(geom, {box[0]}, {box[1]}, "
                                      f"{box[2]}, {box[3]})")
    x, y = np.concatenate(xs), np.concatenate(ys)
    if ds._store("places").build_counts != {"z2": 1}:
        raise AssertionError("places: the z2 index was rebuilt")
    rows = []
    for name, boxes in (("bbox", [box]), ("bbox_small", [box2]),
                        ("bbox_or_bbox", [box, box2])):
        ecql = " OR ".join(f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})"
                           for b in boxes)
        t0 = time.perf_counter()
        res = ds.query_result("places", ecql)
        ms = (time.perf_counter() - t0) * 1e3
        want = box_oracle(x, y, boxes)
        if res.strategy.index != "z2":
            raise AssertionError(f"places {name}: strategy "
                                 f"{res.strategy.index}, expected z2")
        if not np.array_equal(res.positions, want):
            raise AssertionError(f"places {name}: {len(res.positions)} "
                                 f"hits, oracle {len(want)}")
        rows.append({"query": name, "ms": ms, "hits": int(len(want))})
    report["places"] = {"rows": len(x), "write_s": write_s, "queries": rows}
    log(f"places: {len(x)} rows without a dtg in 2 writes "
        f"({', '.join(f'{s:.2f}' for s in write_s)} s); z2 queries equal to "
        f"the oracle: " + ", ".join(f"{r['query']} {r['hits']} hits "
                                    f"{r['ms']:.1f} ms" for r in rows))


def mesh_phase(rng, args, centres, dev, report):
    """The mesh-backed store on a one-card mesh: writes, the stats
    push-down through the hist1d kernel, sharded z3/z2 queries, pushed-down
    heatmaps, and an append that moves the histograms to the int64
    route; every result against a numpy oracle over the rows."""
    import numpy as np
    import torch
    from geomesa_tpu_torch import TpuDataStore, density_process, device_mesh
    from geomesa_tpu_torch.features.batch import FeatureBatch
    from geomesa_tpu_torch.features.feature_type import parse_spec
    from geomesa_tpu_torch.index.pyramid import tile_env
    from geomesa_tpu_torch.ops.hist1d_kernel import hist1d
    from geomesa_tpu_torch.ops.z3_mask import z3_mask
    from geomesa_tpu_torch.parallel import stats as pstats
    from geomesa_tpu_torch.stats.stat import Frequency

    ds = TpuDataStore(device=dev, mesh=device_mesh(1))
    ds.create_schema("events", "actor:String,score:Double,dtg:Date,*geom:Point")
    actors = np.array(["USA", "GBR", "FRA", "CHN", "IND", "BRA", "RUS"],
                      dtype=object)
    n = args.mesh_rows
    per = n // 4
    cols = {"x": [], "y": [], "t": [], "score": [], "actor": []}
    write_s = []

    def write(m):
        x, y, t = gdelt_like(rng, m, centres)
        score = rng.uniform(0.0, 100.0, m)
        actor = actors[rng.integers(0, len(actors), m)]
        for k, v in zip(cols, (x, y, t, score, actor)):
            cols[k].append(v)
        t0 = time.perf_counter()
        ds.write("events", {"actor": actor, "score": score, "dtg": t,
                            "geom": (x, y)})
        return time.perf_counter() - t0

    for _ in range(4):  # no query between: the index builds once
        write_s.append(write(per))
    store = ds._store("events")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    z3 = store.z3_index()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if z3.capacity != per * 4 or not pstats._hist_kernel_ok(z3):
        raise AssertionError(f"sharded z3 built at {z3.capacity} slots")
    # the sharded z2, which the BBOX query below would build, built and
    # timed apart
    t0 = time.perf_counter()
    store.z2_index()
    torch.cuda.synchronize()
    z2_build_s = time.perf_counter() - t0

    def rows():
        return {k: np.concatenate(v) for k, v in cols.items()}

    cx, cy = centres[7]
    box = (cx - 10, cy - 10, cx + 10, cy + 10)
    w = (MS_2018 + 100 * DAY, MS_2018 + 114 * DAY - 1)
    q = (f"BBOX(geom, {box[0]}, {box[1]}, {box[2]}, {box[3]}) AND dtg "
         f"DURING {iso(w[0])}/{iso(w[1])}")
    q_bbox = f"BBOX(geom, {box[0]}, {box[1]}, {box[2]}, {box[3]})"
    spec = "Count();MinMax(score);Histogram(score,64,0,100)"

    def hist_oracle(score):
        b = np.clip((score - 0.0) / (100.0 / 64), 0, 63).astype(np.int64)
        return np.bincount(b, minlength=64)

    def freq_oracle(r, hits, attr):
        """The host sketch (``Frequency.observe``) over the hit rows."""
        kind = "String" if attr == "actor" else "Double"
        host = Frequency(attr, 4, 1024)
        host.observe(FeatureBatch.from_dict(
            parse_spec("f", f"{attr}:{kind},dtg:Date,*geom:Point"),
            {attr: r[attr][hits], "dtg": r["t"][hits],
             "geom": (r["x"][hits], r["y"][hits])}))
        return host.table

    stat_rows = []

    def run_stats(name, query, sp, check):
        idx = store.z3_index()
        route = "kernel" if pstats._hist_kernel_ok(idx) else "int64"
        h0 = hist1d.launches
        t0 = time.perf_counter()
        got = ds.stats("events", query, sp)
        ms = (time.perf_counter() - t0) * 1e3
        check(got)
        grew = hist1d.launches - h0
        kernel_hists = (sp.count("Histogram(") + 4 * sp.count("Frequency(")
                        if route == "kernel" else 0)
        if grew != kernel_hists:
            raise AssertionError(f"stats {name}: hist1d launched {grew} "
                                 f"times, expected {kernel_hists} ({route})")
        stat_rows.append({"stats": name, "ms": ms, "route": route,
                          "hist1d_launches": grew,
                          "slots_per_shard": idx.capacity})

    r = rows()
    hits = oracle(r["x"], r["y"], r["t"], [box], *w)

    def check_moments(hit_rows):
        def check(got):
            c, mm, h = got.stats
            sc = r["score"][hit_rows]
            if c.count != len(hit_rows) or (mm.min, mm.max) != (
                    sc.min(), sc.max()):
                raise AssertionError(f"stats: count {c.count} / minmax "
                                     f"{mm.min, mm.max}, oracle "
                                     f"{len(hit_rows)} / {sc.min(), sc.max()}")
            if not np.array_equal(h.counts, hist_oracle(sc)):
                raise AssertionError("stats: histogram disagrees with "
                                     "np.bincount")
        return check

    def check_freq(attr):
        want = freq_oracle(r, hits, attr)

        def check(got):
            if not np.array_equal(got.table, want):
                raise AssertionError(f"stats: Frequency({attr}) table "
                                     "disagrees with the host sketch")
        return check

    run_stats("bbox_during", q, spec, check_moments(hits))
    run_stats("frequency_actor", q, "Frequency(actor,4,1024)",
              check_freq("actor"))
    run_stats("frequency_score", q, "Frequency(score,4,1024)",
              check_freq("score"))
    run_stats("include", "INCLUDE", spec, check_moments(np.arange(n)))
    h0 = hist1d.launches
    t0 = time.perf_counter()
    top = ds.stats("events", q, "TopK(actor)")
    topk_ms = (time.perf_counter() - t0) * 1e3
    want_top = dict(zip(*np.unique(r["actor"][hits], return_counts=True)))
    if dict(top.topk(len(actors))) != want_top or hist1d.launches != h0:
        raise AssertionError("stats: TopK(actor) disagrees with the oracle")

    qrows = []
    for name, ecql, strategy, want in (
            ("bbox_during", q, "z3", hits),
            ("bbox", q_bbox, "z2", box_oracle(r["x"], r["y"], [box]))):
        t0 = time.perf_counter()
        res = ds.query_result("events", ecql)
        ms = (time.perf_counter() - t0) * 1e3
        if res.strategy.index != strategy or not np.array_equal(
                res.positions, want):
            raise AssertionError(f"mesh {name}: {res.strategy.index}, "
                                 f"{len(res.positions)} hits, oracle "
                                 f"{len(want)}")
        qrows.append({"query": name, "ms": ms, "hits": int(len(want))})

    # the ring-parallel scan: a max-ranges hint above 4096 plans more
    # ranges than one device replicates, so the sharded z3 query takes
    # the ring (the plan split and rotated, the data stationary; one
    # shard here), its hop through the z3 mask kernel
    z3 = store.z3_index()
    plan = z3._plan([box], *w, RING_MAX_RANGES)
    if plan.num_ranges <= z3.RING_MIN_RANGES_PER_DEVICE * z3.mesh.size:
        raise AssertionError(f"a {RING_MAX_RANGES}-range hint planned "
                             f"{plan.num_ranges} ranges: no ring")
    m0 = z3_mask.launches
    t0 = time.perf_counter()
    ring = z3.query([box], *w, max_ranges=RING_MAX_RANGES)
    ring_ms = (time.perf_counter() - t0) * 1e3
    ring_launches = z3_mask.launches - m0
    counts = z3.range_counts_ring([box], *w, max_ranges=RING_MAX_RANGES)
    total = z3.range_count([box], *w, max_ranges=RING_MAX_RANGES)
    if (not np.array_equal(ring, hits) or ring_launches <= 0
            or len(counts) != plan.num_ranges or int(counts.sum()) != total):
        raise AssertionError(f"mesh ring: {len(ring)} hits (oracle "
                             f"{len(hits)}), {ring_launches} z3_mask "
                             f"launches, ring counts {int(counts.sum())} "
                             f"against {total}")
    qrows.append({"query": "bbox_during_ring", "ms": ring_ms,
                  "hits": int(len(hits)), "ranges": int(plan.num_ranges),
                  "candidates": total, "z3_mask_launches": ring_launches})

    tx = int((cx + 180.0) // 45.0)
    ty = 7 - int((cy + 90.0) // 22.5)
    tenv = tile_env(3, tx, ty)
    drows = []
    for name, run, env, want_hits in (
            ("bbox_during", lambda: density_process(ds, "events", q, box),
             box, hits),
            (f"tile_3_{tx}_{ty}", lambda: ds.density_tile("events", 3, tx, ty),
             tenv, box_oracle(r["x"], r["y"], [tenv]))):
        t0 = time.perf_counter()
        grid = run()
        ms = (time.perf_counter() - t0) * 1e3
        want = snap_counts(r["x"][want_hits], r["y"][want_hits], env, 256,
                           256)
        if grid.shape != (256, 256) or not np.array_equal(
                grid.astype(np.float64), want.astype(np.float32)):
            raise AssertionError(f"mesh density {name}: {grid.sum()} "
                                 f"points, oracle {want.sum()}")
        drows.append({"query": name, "ms": ms, "points": float(want.sum())})

    profile = None
    if args.profile:
        profile = profile_queries("mesh", lambda call: call(), [
            lambda: ds.stats("events", q, spec),
            lambda: ds.stats("events", q, "Frequency(score,4,1024)"),
            lambda: ds.stats("events", "INCLUDE", spec),
            lambda: ds.query_result("events", q),
            lambda: density_process(ds, "events", q, box)])

    # the append lands in the built sharded z3 and z2 indexes
    append_s = write(1_000_000)
    r = rows()
    hits = oracle(r["x"], r["y"], r["t"], [box], *w)
    if pstats._hist_kernel_ok(store.z3_index()):
        raise AssertionError("the append did not move the shard past the "
                             "kernel's exactness bound")
    run_stats("bbox_during_after_append", q, spec, check_moments(hits))
    rep = report["mesh"] = {
        "rows": n, "write_s": write_s, "build_s": build_s,
        "build_keys_per_s": n / build_s, "z2_build_s": z2_build_s,
        "append_rows": 1_000_000,
        "append_write_s": append_s,
        "append_rows_per_s": 1_000_000 / append_s,
        "capacity_after_append": store.z3_index().capacity,
        "peak_device_bytes": int(torch.cuda.max_memory_allocated()),
        "stats": stat_rows, "topk_ms": topk_ms, "queries": qrows,
        "density": drows, "hits": int(len(hits))}
    if profile is not None:
        rep["profile"] = profile
    log(f"mesh: {n} rows in 4 writes ({', '.join(f'{s:.2f}' for s in write_s)}"
        f" s); sharded z3 build {build_s:.3f} s, z2 {z2_build_s:.3f} s; "
        "stats equal to the oracle: "
        + ", ".join(f"{s['stats']} {s['ms']:.1f} ms ({s['route']}, hist1d "
                    f"x{s['hist1d_launches']})" for s in stat_rows)
        + f", TopK {topk_ms:.1f} ms; queries "
        + ", ".join(f"{q_['query']} {q_['hits']} hits {q_['ms']:.1f} ms"
                    for q_ in qrows)
        + "; heatmaps " + ", ".join(f"{d['query']} {d['ms']:.1f} ms"
                                    for d in drows)
        + f"; 1M-row append write {append_s:.2f} s, capacity "
          f"{rep['capacity_after_append']}")
    del ds, store, z3
    torch.cuda.empty_cache()


def lean_norm(v, lo: float, hi: float, bits: int = 21):
    """numpy BitNormalizedDimension.normalize: floor((v - lo) · 2^bits /
    (hi - lo)), clamped to [0, 2^bits - 1] (v >= hi → the top cell)."""
    import numpy as np
    n = 1 << bits
    i = np.floor((np.maximum(v, lo) - lo) * (n / (hi - lo)))
    return np.clip(i, 0, n - 1).astype(np.int64)


def lean_denorm(i, lo: float, hi: float, bits: int = 21):
    """numpy BitNormalizedDimension.denormalize: the cell's centre."""
    return lo + (i + 0.5) * ((hi - lo) / (1 << bits))


def lean_density_oracle(cols, layout, boxes, lo, hi, env, width: int,
                        height: int, chunk: int = 1 << 24):
    """numpy oracle of the lean density contract, per tier: rows of a
    full-tier generation pass the exact box and [lo, hi] tests, rows of
    a keys- or host-tier generation the z-cell tests (normalized box
    bounds, (week bin, time cell) between those of lo and hi); every
    passing row bins at its z-cell centre (floor over ``env``, clipped).
    ``layout`` is the index's ``(base, n, tier)`` per generation."""
    import numpy as np
    from geomesa_tpu_torch.curve.binnedtime import (
        TimePeriod, max_offset, to_binned_time)
    x, y, t = cols
    t_max = float(max_offset(TimePeriod.WEEK))
    nb = [[int(lean_norm(np.float64(b[0]), -180, 180)),
           int(lean_norm(np.float64(b[1]), -90, 90)),
           int(lean_norm(np.float64(b[2]), -180, 180)),
           int(lean_norm(np.float64(b[3]), -90, 90))] for b in boxes]
    (b_lo,), (o_lo,) = to_binned_time(np.array([lo]), TimePeriod.WEEK)
    (b_hi,), (o_hi,) = to_binned_time(np.array([hi]), TimePeriod.WEEK)
    c_lo = int(lean_norm(np.float64(o_lo), 0.0, t_max))
    c_hi = int(lean_norm(np.float64(o_hi), 0.0, t_max))
    counts = np.zeros(width * height, dtype=np.int64)
    # a box covering the world passes every row's box test on both tiers
    # (normalized, the world's bounds are the first and last cells)
    world = any(b[0] <= -180.0 and b[1] <= -90.0 and b[2] >= 180.0
                and b[3] >= 90.0 for b in boxes)
    for base, n, tier in layout:
        for s in range(base, base + n, chunk):
            e = min(s + chunk, base + n)
            tc = t[s:e]
            if world and lo <= tc.min() and hi >= tc.max():
                # every row of the chunk passes either tier's tests
                sel = np.arange(s, e)
            else:
                # rows more than a cell outside every box or the window
                # fail either tier's tests: only the rest are tested
                near = np.zeros(e - s, dtype=bool)
                for b in boxes:
                    near |= ((x[s:e] >= b[0] - 1e-3) & (x[s:e] <= b[2] + 1e-3)
                             & (y[s:e] >= b[1] - 1e-3)
                             & (y[s:e] <= b[3] + 1e-3))
                near &= (tc >= lo - 1000) & (tc <= hi + 1000)
                sel = s + np.flatnonzero(near)
                xc, yc, tc = x[sel], y[sel], t[sel]
                m = np.zeros(len(sel), dtype=bool)
                if tier == "full":
                    for b in boxes:
                        m |= ((xc >= b[0]) & (xc <= b[2]) & (yc >= b[1])
                              & (yc <= b[3]))
                    m &= (tc >= lo) & (tc <= hi)
                else:
                    ix = lean_norm(xc, -180, 180)
                    iy = lean_norm(yc, -90, 90)
                    for b in nb:
                        m |= ((ix >= b[0]) & (ix <= b[2]) & (iy >= b[1])
                              & (iy <= b[3]))
                    bins, offs = to_binned_time(tc, TimePeriod.WEEK)
                    it = lean_norm(offs.astype(np.float64), 0.0, t_max)
                    m &= (((bins > b_lo) | ((bins == b_lo) & (it >= c_lo)))
                          & ((bins < b_hi)
                             | ((bins == b_hi) & (it <= c_hi))))
                sel = sel[m]
            xd = lean_denorm(lean_norm(x[sel], -180, 180), -180, 180)
            yd = lean_denorm(lean_norm(y[sel], -90, 90), -90, 90)
            gx = np.clip(((xd - env[0]) / max(env[2] - env[0], 1e-12)
                          * width).astype(np.int64), 0, width - 1)
            gy = np.clip(((yd - env[1]) / max(env[3] - env[1], 1e-12)
                          * height).astype(np.int64), 0, height - 1)
            counts += np.bincount(gy * width + gx,
                                  minlength=width * height)
    return counts.astype(np.float64).reshape(height, width)


def _split3(v):
    """numpy Morton spread of 21-bit uint64 values to every third bit."""
    import numpy as np
    v = v & np.uint64(0x1FFFFF)
    for shift, mask in ((32, 0x1F00000000FFFF), (16, 0x1F0000FF0000FF),
                        (8, 0x100F00F00F00F00F), (4, 0x10C30C30C30C30C3),
                        (2, 0x1249249249249249)):
        v = (v | (v << np.uint64(shift))) & np.uint64(mask)
    return v


def z3_cells_oracle(x, y, t, bits: int, chunk: int = 1 << 24) -> dict:
    """numpy oracle of Z3Histogram(geom, dtg, week, bits): rows counted per
    (week bin, top ``bits`` of the z3 key), the key interleaving the
    21-bit normalized lon (bit 0), lat (bit 1) and week offset (bit 2).
    With ``bits`` a multiple of 3 the top bits are the top ``bits // 3``
    bits of each dimension interleaved, spread through a lookup table."""
    import numpy as np
    from geomesa_tpu_torch.curve.binnedtime import (
        TimePeriod, max_offset, to_binned_time)
    t_max = float(max_offset(TimePeriod.WEEK))
    counts: dict = {}
    per_dim, top = divmod(bits, 3)
    lut = (_split3(np.arange(1 << per_dim, dtype=np.uint64))
           if top == 0 else None)
    for s in range(0, len(x), chunk):
        bins, offs = to_binned_time(t[s:s + chunk], TimePeriod.WEEK)
        ix = lean_norm(x[s:s + chunk], -180, 180)
        iy = lean_norm(y[s:s + chunk], -90, 90)
        it = lean_norm(offs.astype(np.float64), 0.0, t_max)
        if lut is not None:
            sh = 21 - per_dim
            cell = (lut[ix >> sh] | (lut[iy >> sh] << np.uint64(1))
                    | (lut[it >> sh] << np.uint64(2))).astype(np.int64)
        else:
            z = (_split3(ix.astype(np.uint64))
                 | (_split3(iy.astype(np.uint64)) << np.uint64(1))
                 | (_split3(it.astype(np.uint64)) << np.uint64(2)))
            cell = (z >> np.uint64(63 - bits)).astype(np.int64)
        b0 = int(bins.min())
        per = np.bincount((bins.astype(np.int64) - b0) * (1 << bits) + cell)
        for k in np.flatnonzero(per).tolist():
            kk = (b0 + (k >> bits), k & ((1 << bits) - 1))
            counts[kk] = counts.get(kk, 0) + int(per[k])
    return counts


class StatRoute:
    """Records which lean stats route answered: the Count push-down, the
    sketch push-down, or (neither) the materializing query path."""

    def __init__(self):
        import importlib
        # the module, not the function the package exports under its name
        sp = importlib.import_module("geomesa_tpu_torch.process.stats_process")
        self.sp, self.route = sp, None
        self._count, self._sketch = (sp._lean_count_pushdown,
                                     sp._lean_sketch_pushdown)

        def count(*a):
            got = self._count(*a)
            self.route = self.route or (got is not None and "count")
            return got

        def sketch(*a):
            got = self._sketch(*a)
            self.route = self.route or (got is not None and "sketch")
            return got

        sp._lean_count_pushdown, sp._lean_sketch_pushdown = count, sketch

    def run(self, fn):
        """(result, route) of one stats call."""
        self.route = None
        out = fn()
        return out, self.route or "materialized"

    def close(self):
        self.sp._lean_count_pushdown = self._count
        self.sp._lean_sketch_pushdown = self._sketch


def snap_weighted(x, y, w, env, width: int, height: int):
    """numpy weighted histogram of points snapped as GridSnap snaps them,
    the weights cast to float32 and summed in float64."""
    import numpy as np
    xmin, ymin, xmax, ymax = env
    dx, dy = (xmax - xmin) / width, (ymax - ymin) / height
    ix = np.clip(np.floor((x - xmin) / dx), 0, width - 1).astype(np.int64)
    iy = np.clip(np.floor((y - ymin) / dy), 0, height - 1).astype(np.int64)
    return np.bincount(iy * width + ix,
                       weights=w.astype(np.float32).astype(np.float64),
                       minlength=width * height).reshape(height, width)


def device_launches(fn) -> dict:
    """Kernel launches of one call of ``fn`` under ``torch.profiler``:
    device-side events (kernels, copies, sets) and launch calls on the
    host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    return {"device_events": int(sum(
                e.count for e in avg
                if e.device_type == torch.autograd.DeviceType.CUDA)),
            "launch_calls": int(sum(
                e.count for e in avg if e.key.startswith("cudaLaunchKernel")))}


def catalog_room(path: str, nbytes: int) -> int:
    """Raise unless the file system of ``path`` has room for twice the
    ``nbytes`` a phase is about to write; returns the free bytes."""
    free = shutil.disk_usage(path).free
    if free < 2 * nbytes:
        raise AssertionError(f"{path}: {free} bytes free, a phase writing "
                             f"~{nbytes} bytes needs twice that")
    return free


def dir_bytes(path: str) -> int:
    """Bytes of every file under ``path``."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def allocated_after_gc(cuda: bool):
    """``torch.cuda.memory_allocated`` after the cyclic collector ran (a
    dropped store frees its device memory only then, PERF.md §7)."""
    import torch
    gc.collect()
    if not cuda:
        return None
    torch.cuda.empty_cache()
    return int(torch.cuda.memory_allocated())


def lean_checks(qs) -> list:
    """The lean phases' queries: 3 city, 3 region and 2 continent
    BBOX+DURING queries of the index phase, then the first city and the
    first region box alone — ``(kind, ecql, boxes, lo, hi)``, the bounds
    as DURING parses them (``None`` for the BBOX-only ones)."""
    def bbox(b):
        return f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})"

    picks = ([q for q in qs if q[0] == "city"][:3]
             + [q for q in qs if q[0] == "region"][:3]
             + [q for q in qs if q[0] == "continent"][:2])
    checks = []
    for kind, boxes, lo, hi in picks:
        # DURING takes whole seconds: the oracle reads the bounds as parsed
        lo_s, hi_s = lo - lo % 1000, hi - hi % 1000
        checks.append((kind, f"{bbox(boxes[0])} AND dtg DURING {iso(lo)}/"
                             f"{iso(hi)}", boxes, lo_s, hi_s))
    for kind, boxes, _lo, _hi in (picks[0], picks[3]):
        checks.append((f"{kind}-bbox", bbox(boxes[0]), boxes, None, None))
    return checks


def lean_phase(rng, args, centres, qs, dev, report, cat=None):
    """The lean profile: ``--lean-rows`` GDELT-like rows (with a ``score``)
    written in 4 batches to a schema with no profile set, whose first
    write switches it to lean; a budget that leaves all three tiers;
    BBOX+DURING and BBOX queries (estimator-costed, and one replanned),
    pyramids, Count and Z3Histogram, heatmaps (pushed down, from the
    pyramids and weighted) and tiles against numpy oracles, before and
    after ``compact``.  With ``cat`` the store keeps its catalog there
    from the start and is flushed after its closing ``age_off``; returns
    what the lean persist phase reopens and checks."""
    import numpy as np
    import torch
    from geomesa_tpu_torch import TpuDataStore, density_process
    from geomesa_tpu_torch.index.pyramid import pyramid_spec, tile_env
    from geomesa_tpu_torch.index.z3_lean import LeanZ3Index
    from geomesa_tpu_torch.planning import ExplainString

    cuda = dev.type == "cuda"
    slots = args.lean_slots
    # one full generation (40 B a slot), four keys ones (16 B) and the
    # sentinel charges (16 + 40 B) take 160 B a slot; a fifth keys one
    # would take 176
    budget = 164 * slots
    ud = [f"geomesa.lean.hbm.budget={budget}",
          # opportunistic compaction off: compact() below merges at the
          # index's class factor
          "geomesa.lean.compaction.factor=0"]
    if slots != LeanZ3Index.GENERATION_SLOTS:
        ud.append(f"geomesa.lean.generation.slots={slots}")
    ds = TpuDataStore(device=dev, catalog_dir=cat)
    ds.create_schema("scale", "score:Double,dtg:Date,*geom:Point;"
                     + ",".join(ud))
    store = ds._store("scale")
    # the first write reaches the lean switch; the rest split the other
    # rows three ways
    first = max(args.lean_rows // 4, TpuDataStore.LEAN_AUTO_ROWS)
    sizes = [first] + [(args.lean_rows - first) // 3] * 3
    if sizes[1] <= 0:
        raise AssertionError(f"{args.lean_rows} rows do not fill 4 writes "
                             f"past the lean switch "
                             f"({TpuDataStore.LEAN_AUTO_ROWS})")
    write_s = []
    for i, per in enumerate(sizes):
        x, y, t = gdelt_like(rng, per, centres)
        score = rng.uniform(0.0, 100.0, per)
        t0 = time.perf_counter()
        ds.write("scale", {"score": score, "dtg": t, "geom": (x, y)})
        store.z3_index().block()
        write_s.append(time.perf_counter() - t0)
        if i == 0 and not (store.lean and store.sft.user_data.get(
                "geomesa.index.profile") == "lean"):
            raise AssertionError("the first write did not switch the "
                                 "schema to the lean profile")
    del x, y, t, score
    idx = store.z3_index()
    n = sum(sizes)
    x, y = store.batch.geom_xy()
    t = store.batch.column("dtg")
    score = store.batch.column("score")
    tiers = idx.tier_counts()
    if len(idx) != n or min(tiers.values()) == 0:
        raise AssertionError(f"lean store of {len(idx)} rows, tiers {tiers}")
    layout = [(g.base, g.n, g.tier) for g in idx.generations]
    t_min, t_max = int(t.min()), int(t.max())
    rep = {"rows": n, "slots": slots, "budget_bytes": budget,
           "write_s": write_s,
           "write_rows_per_s": [m / w for m, w in zip(sizes, write_s)],
           "tiers": tiers, "generations": len(idx.generations),
           "device_bytes": idx.device_bytes(),
           "host_key_bytes": idx.host_key_bytes(),
           "memory_allocated": (int(torch.cuda.memory_allocated())
                                if cuda else None)}
    log(f"lean: {n} rows in 4 writes ({', '.join(f'{s:.2f}' for s in write_s)}"
        f" s); tiers {tiers}; accounted device bytes {rep['device_bytes']}, "
        f"allocated {rep['memory_allocated']}")

    checks = lean_checks(qs)

    # the estimator: on at this size; its cold fold (every generation's
    # z3 cell counts) timed apart from the queries it then costs
    t0 = time.perf_counter()
    est = store.estimator()
    if est is None:
        raise AssertionError(f"no cardinality estimator on a lean store of "
                             f"{n} rows")
    est.z3_rows([WORLD], [(None, None)])
    rep["estimator_cold_ms"] = (time.perf_counter() - t0) * 1e3

    def run_query(kind, ecql, boxes, lo, hi, source="sketch"):
        ex = ExplainString()
        t0 = time.perf_counter()
        res = ds.query_result("scale", ecql, ex)
        ms = (time.perf_counter() - t0) * 1e3
        want = (box_oracle(x, y, boxes) if lo is None
                else oracle(x, y, t, boxes, lo, hi))
        st = res.strategy
        if (st.index != "z3" or st.source != source
                or not np.array_equal(res.positions, want)):
            raise AssertionError(
                f"lean {kind} {ecql}: strategy {st.index} ({st.source}), "
                f"{len(res.positions)} hits, oracle {len(want)}")
        ids = list(res.batch.ids[:3])
        if ids != [str(int(p)) for p in want[:3]]:
            raise AssertionError(f"lean {kind}: implicit ids {ids}")
        return {"query": kind, "ms": ms, "hits": int(len(want)),
                "plan_ms": res.plan_time_ms, "scan_ms": res.scan_time_ms,
                "source": st.source, "max_ranges": st.max_ranges,
                "cost": float(st.cost),
                "replans": str(ex).count("Replanning:")}

    rows = []
    for c in checks:
        d0 = idx.dispatch_count
        row = run_query(*c)
        row["dispatches"] = idx.dispatch_count - d0
        rows.append(row)
    lat = np.array([r["ms"] for r in rows])
    rep.update(queries=rows, query_ms_p50=float(np.median(lat)),
               query_ms_max=float(lat.max()))
    if cuda:
        rep["launches_per_query"] = {
            c[0]: device_launches(lambda c=c: ds.query_result("scale", c[1]))
            for c in (checks[0], checks[6], checks[8])}
    if args.profile:
        rep["profile"] = profile_queries(
            "lean", lambda c: ds.query_result("scale", c[1]), checks)
    # the same queries planned from whole-store fractions (the default
    # max_ranges), then from the sketch again, in turns in this call
    turns = {}
    for label, env, src in (("fractions", FRACTION_ENV, "stats"),
                            ("sketch", {}, "sketch")):
        with env_set(env):
            turns[label] = [run_query(*c, source=src) for c in checks]
    rep["turns"] = turns

    def split(rs):
        return [tuple(round(r[k], 1) for k in ("ms", "plan_ms", "scan_ms"))
                for r in rs]

    log(f"lean: estimator cold fold {rep['estimator_cold_ms']:.1f} ms; "
        f"{len(rows)} queries equal to the oracle, every plan costed by "
        f"the sketch; p50 {np.median(lat):.3f} ms, max {lat.max():.3f} ms; "
        f"hits {[r['hits'] for r in rows]}; max_ranges "
        f"{[r['max_ranges'] for r in rows]}; launches "
        f"{rep.get('launches_per_query')}; in turns (ms, plan ms, scan "
        f"ms), fraction-costed {split(turns['fractions'])}, sketch-costed "
        f"{split(turns['sketch'])}")

    # a mispredicted plan: the estimator off, the fraction-costed dense
    # city BBOX observes far more candidates than costed and replans once
    kind, _q, boxes, _lo, _hi = checks[8]
    with env_set(REPLAN_ENV):
        row = run_query(kind, checks[8][1], boxes, None, None,
                        source="observed")
    if row["replans"] != 1:
        raise AssertionError(f"lean mispredicted {kind}: {row['replans']} "
                             f"replans, not 1")
    rep["replan"] = row
    log(f"lean: mispredicted {kind} replanned once, {row['ms']:.1f} ms, "
        f"{row['hits']} hits equal to the oracle")

    box = checks[3][2][0]
    lo_c, hi_c = max(checks[3][3], t_min), min(checks[3][4], t_max)
    tx = int((box[0] + box[2]) / 2 + 180.0) // 180
    ty = 1 - int((box[1] + box[3]) / 2 + 90.0) // 90
    t3x = int(((box[0] + box[2]) / 2 + 180.0) // 45.0)
    t3y = 7 - int(((box[1] + box[3]) / 2 + 90.0) // 22.5)
    env3 = tile_env(3, t3x, t3y)

    @functools.lru_cache(maxsize=None)
    def world_oracle(res):
        # whole extent, whole time: every tier's test passes every row,
        # so the grid does not depend on the tier layout; a power-of-two
        # grid is the 2x2 block sum of the one twice as fine (floor
        # binning halves exactly)
        if res < 512:
            f = 512 // res
            return world_oracle(512).reshape(res, f, res, f).sum(axis=(1, 3))
        return lean_density_oracle((x, y, t), layout, [WORLD], t_min, t_max,
                                   WORLD, res, res)

    def tile1_oracle():
        g = world_oracle(512)
        return g[(1 - ty) * 256:(2 - ty) * 256, tx * 256:(tx + 1) * 256]

    def check_grid(name, run, want_fn, size=256):
        h0 = idx.pyramid_serve_hits
        t0 = time.perf_counter()
        grid = run()
        ms = (time.perf_counter() - t0) * 1e3
        served = idx.pyramid_serve_hits - h0
        want = want_fn()
        if grid.shape != (size, size) or not np.array_equal(grid, want):
            raise AssertionError(f"lean density {name}: grid disagrees with "
                                 f"the oracle ({float(grid.sum())} against "
                                 f"{float(want.sum())} points)")
        return {"query": name, "ms": ms, "points": float(want.sum()),
                "pyramid_served": served}

    # the world heatmap before any pyramid exists: every generation sweeps
    drows = [check_grid("world-before-pyramids",
                        lambda: density_process(ds, "scale", "INCLUDE",
                                                WORLD),
                        lambda: world_oracle(256))]

    # pyramids: one per sealed generation, then served in their place
    sealed = len(idx.generations) - 1
    t0 = time.perf_counter()
    built = ds.build_pyramids("scale")
    build_s = time.perf_counter() - t0
    if built != sealed or store.pyramid_build_failures:
        raise AssertionError(f"built {built} pyramids for {sealed} sealed "
                             f"generations ({store.pyramid_build_error})")
    rep["pyramids"] = {"built": built, "s": build_s}
    log(f"lean: {built} pyramids built for {sealed} sealed generations in "
        f"{build_s:.3f} s")

    # Count pushed down on INCLUDE (the pyramids' 1x1 level), materialized
    # on BBOX+DURING (the keys and host tiers are cell-granular); a whole
    # extent Z3Histogram from the keys (the sketch push-down)
    kind, q_and, boxes, lo, hi = checks[3]
    routes = StatRoute()
    crow = []
    try:
        for name, ecql, want, route in (
                ("include", "INCLUDE", n, "count"),
                (kind, q_and, len(oracle(x, y, t, boxes, lo, hi)),
                 "materialized")):
            t0 = time.perf_counter()
            got, how = routes.run(lambda: ds.stats("scale", ecql,
                                                   "Count()").count)
            ms = (time.perf_counter() - t0) * 1e3
            if got != want or how != route:
                raise AssertionError(f"lean Count {name}: {got} by {how}, "
                                     f"oracle {want} by {route}")
            crow.append({"query": name, "ms": ms, "count": int(got),
                         "route": how})
        t0 = time.perf_counter()
        hist, how = routes.run(lambda: ds.stats(
            "scale", "INCLUDE", f"Z3Histogram(geom,dtg,week,{Z3_BITS})"))
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        routes.close()
    want = z3_cells_oracle(x, y, t, Z3_BITS)
    if hist.counts != want or how != "sketch":
        raise AssertionError(f"lean Z3Histogram by {how}: "
                             f"{sum(hist.counts.values())} rows in "
                             f"{len(hist.counts)} cells, oracle "
                             f"{sum(want.values())} in {len(want)}")
    crow.append({"query": f"z3histogram-{Z3_BITS}", "ms": ms,
                 "cells": len(want), "route": how})
    rep["count"] = crow

    # heatmaps: pushed down (the per-tier contract; world grids and the
    # z = 1 tile from the pyramids), weighted (the query path and the
    # density kernel), tiles
    drows += [check_grid(*d) for d in (
        (kind, lambda: density_process(ds, "scale", q_and, box),
         lambda: lean_density_oracle((x, y, t), layout, [box], lo_c, hi_c,
                                     box, 256, 256)),
        ("world", lambda: density_process(ds, "scale", "INCLUDE", WORLD),
         lambda: world_oracle(256)),
        ("world-512", lambda: density_process(ds, "scale", "INCLUDE", WORLD,
                                              512, 512),
         lambda: world_oracle(512), 512),
        (f"tile_1_{tx}_{ty}", lambda: ds.density_tile("scale", 1, tx, ty),
         tile1_oracle),
        (f"tile_3_{t3x}_{t3y}", lambda: ds.density_tile("scale", 3, t3x,
                                                         t3y),
         lambda: lean_density_oracle((x, y, t), layout, [env3], t_min,
                                     t_max, env3, 256, 256)))]
    for r in drows[2:5]:
        if r["pyramid_served"] != sealed:
            raise AssertionError(f"lean {r['query']}: {r['pyramid_served']} "
                                 f"of {sealed} sealed generations served "
                                 f"from pyramids")
    hits = oracle(x, y, t, boxes, lo, hi)
    t0 = time.perf_counter()
    grid = density_process(ds, "scale", q_and, box, weight_attr="score")
    ms = (time.perf_counter() - t0) * 1e3
    want = snap_weighted(x[hits], y[hits], score[hits], box, 256, 256)
    if not np.allclose(grid, want, rtol=1e-5, atol=0.0):
        raise AssertionError(f"lean weighted density: grid disagrees with "
                             f"the oracle ({float(grid.sum())} against "
                             f"{float(want.sum())})")
    drows.append({"query": f"{kind}-weighted", "ms": ms,
                  "points": int(len(hits)), "dtype": str(grid.dtype)})
    rep["density"] = drows
    log("lean: counts, Z3Histogram and heatmaps equal to the oracle: "
        + ", ".join(f"{r['query']} {r['ms']:.1f} ms"
                    + (f" ({r['route']})" if "route" in r else "")
                    + (f" ({r['pyramid_served']} from pyramids)"
                       if "pyramid_served" in r else "")
                    for r in crow + drows))

    # compaction: fewer generations, the same answers; the merged run
    # inherits its parents' summed pyramid
    gens_before = len(idx.generations)
    t0 = time.perf_counter()
    res = ds.compact("scale")
    idx.block()
    compact_s = time.perf_counter() - t0
    if res["z3"]["generations"] >= gens_before:
        raise AssertionError(f"compaction left {res} from {gens_before} "
                             f"generations")
    pyr = idx._pyramid_cache.spec_cache(pyramid_spec(512))
    sealed = len(idx.generations) - 1
    if not all(g.gen_id in pyr for g in idx.generations[:-1]):
        raise AssertionError("a merged generation did not inherit its "
                             "parents' pyramids")
    layout = [(g.base, g.n, g.tier) for g in idx.generations]
    after = [run_query(*checks[0]), run_query(*checks[6])]
    wrow = check_grid("world-after-compact",
                      lambda: density_process(ds, "scale", "INCLUDE", WORLD),
                      lambda: world_oracle(256))
    if wrow["pyramid_served"] != sealed:
        raise AssertionError(f"after compaction {wrow['pyramid_served']} of "
                             f"{sealed} sealed generations served from "
                             f"pyramids")
    rep["compact"] = {"s": compact_s, "result": res["z3"],
                      "generations_before": gens_before,
                      "queries": after, "world": wrow,
                      "device_bytes": idx.device_bytes(),
                      "memory_allocated": (int(torch.cuda.memory_allocated())
                                           if cuda else None)}
    log(f"lean: compact in {compact_s:.3f} s, {gens_before} → "
        f"{res['z3']['generations']} generations, tiers {res['z3']['tiers']}; "
        f"queries equal to the oracle; world heatmap {wrow['ms']:.1f} ms, "
        f"{sealed} sealed generations (merged ones inherited) from pyramids")
    rep["tombstones"] = lean_tombstones(ds, store, (x, y, t), checks, box,
                                        env3, (t3x, t3y), cuda)
    report["lean"] = rep
    if cat is None:
        del ds, store, idx
        if cuda:
            torch.cuda.empty_cache()
        return None
    # the snapshot: sliced parquet parts with the tombstones, the manifest
    # last, then the stats
    catalog_room(cat, n * 40)
    t0 = time.perf_counter()
    ds.flush("scale")
    flush_s = time.perf_counter() - t0
    persisted = {"flush_s": flush_s, "bytes": dir_bytes(cat),
                 "parts": len([f for f in os.listdir(
                     os.path.join(cat, "scale.lean")) if f.startswith(
                     "part-")]),
                 "device_bytes": idx.device_bytes(),
                 "memory_allocated": (int(torch.cuda.memory_allocated())
                                      if cuda else None)}
    log(f"lean: flushed {n} rows in {persisted['parts']} parts in "
        f"{flush_s:.2f} s, {persisted['bytes']} bytes on disk")
    tomb = store.tombstone.copy()
    del ds, store, idx
    return {"catalog": cat, "cols": (x, y, t), "checks": checks,
            "tombstone": tomb, "persisted": persisted}


#: the age-off cutoff of the lifecycle checks: rows dated before
#: 2018-01-15
AGE_OFF_MS = MS_2018 + 14 * DAY


def lean_tombstones(ds, store, cols, checks, box, env3, t3,
                    cuda: bool) -> dict:
    """The lean phase's store after ``age_off`` of the rows dated before
    2018-01-15 (tombstoned, not removed): the count, the estimator-costed
    queries (the oracle less the tombstoned rows), a region heatmap and
    the z = 3 tile (now the materializing path and the density kernel:
    exact grids) and ``Count()`` on INCLUDE, whose push-down must fall
    back."""
    import numpy as np
    from geomesa_tpu_torch import density_process
    from geomesa_tpu_torch.age_off import age_off
    from geomesa_tpu_torch.ops.density_kernel import density_grid_kernel

    x, y, t = cols
    n = len(x)
    expired = t < AGE_OFF_MS
    n_expired = int(expired.sum())
    live = ~expired
    t0 = time.perf_counter()
    got = age_off(ds, "scale", older_than_ms=AGE_OFF_MS)
    age_s = time.perf_counter() - t0
    if got != n_expired or int(store.tombstone.sum()) != n_expired:
        raise AssertionError(f"lean age_off tombstoned {got} rows, oracle "
                             f"{n_expired}")
    count = ds.get_count("scale")
    if count != n - n_expired:
        raise AssertionError(f"lean get_count {count} after age_off, oracle "
                             f"{n - n_expired}")
    rows = []
    for kind, ecql, boxes, lo, hi in checks:
        t0 = time.perf_counter()
        res = ds.query_result("scale", ecql)
        ms = (time.perf_counter() - t0) * 1e3
        want = (box_oracle(x, y, boxes) if lo is None
                else oracle(x, y, t, boxes, lo, hi))
        want = want[live[want]]
        if (res.strategy.source != "sketch"
                or not np.array_equal(res.positions, want)):
            raise AssertionError(
                f"lean {kind} after age_off: {res.strategy.index} "
                f"({res.strategy.source}), {len(res.positions)} hits, "
                f"oracle {len(want)}")
        rows.append({"query": kind, "ms": ms, "hits": int(len(want))})
    kind, q_and, boxes, lo, hi = checks[3]
    hits = oracle(x, y, t, boxes, lo, hi)
    hits = hits[live[hits]]
    t3x, t3y = t3
    tile_hits = box_oracle(x, y, [env3])
    tile_hits = tile_hits[live[tile_hits]]
    drows = []
    for name, run, env, want_hits in (
            (kind, lambda: density_process(ds, "scale", q_and, box), box,
             hits),
            (f"tile_3_{t3x}_{t3y}",
             lambda: ds.density_tile("scale", 3, t3x, t3y), env3,
             tile_hits)):
        d0 = density_grid_kernel.launches
        t0 = time.perf_counter()
        grid = run()
        ms = (time.perf_counter() - t0) * 1e3
        want = snap_counts(x[want_hits], y[want_hits], env, 256, 256)
        if grid.shape != (256, 256) or not np.array_equal(
                grid.astype(np.float64), want.astype(np.float32)):
            raise AssertionError(f"lean {name} after age_off: grid "
                                 f"disagrees with the oracle "
                                 f"({float(grid.sum())} against "
                                 f"{float(want.sum())} points)")
        launched = density_grid_kernel.launches - d0
        route = "materialized" if launched else "pushed down"
        if cuda and launched != 1:
            raise AssertionError(f"lean {name} after age_off: density_grid "
                                 f"launched {launched} times, not once")
        drows.append({"query": name, "ms": ms, "points": float(want.sum()),
                      "route": route, "density_grid_launches": launched})
    routes = StatRoute()
    try:
        t0 = time.perf_counter()
        got, how = routes.run(lambda: ds.stats("scale", "INCLUDE",
                                               "Count()").count)
        count_ms = (time.perf_counter() - t0) * 1e3
    finally:
        routes.close()
    if got != n - n_expired or how != "materialized":
        raise AssertionError(f"lean Count() after age_off: {got} by {how}, "
                             f"oracle {n - n_expired} materialized")
    lat = np.array([r["ms"] for r in rows])
    out = {"expired": n_expired, "age_off_s": age_s, "get_count": count,
           "queries": rows, "query_ms_p50": float(np.median(lat)),
           "query_ms_max": float(lat.max()), "density": drows,
           "count": {"ms": count_ms, "count": int(got), "route": how}}
    log(f"lean: age_off tombstoned {n_expired} rows in {age_s:.2f} s "
        f"(with the stats re-observed over {n - n_expired} live rows); "
        f"get_count {count}; {len(rows)} queries equal to the oracle less "
        f"the tombstones, p50 {np.median(lat):.1f} ms, max "
        f"{lat.max():.1f} ms; "
        + ", ".join(f"{d['query']} {d['ms']:.1f} ms ({d['route']})"
                    for d in drows)
        + f"; Count() {count_ms:.1f} ms ({how})")
    return out


#: the lifecycle phase's row labels, one per write, and the caller's
#: authorizations: it sees the first two writes
LABELS = ("", "user", "admin", "user&admin")
AUTHS = frozenset({"user"})
#: the lifecycle phases' schema (the facade's), and its v1-layout twin
LIFE_SPEC = "actor:String,dtg:Date,*geom:Point"
LEGACY_SPEC = LIFE_SPEC + ";geomesa.index.versions='z3:1,z2:1'"


def life_queries(qs) -> list:
    """The index phase's 20 queries as ECQL: each BBOX+DURING (z3) and
    its boxes alone (z2), with the oracle's whole-second bounds."""
    out = []
    for kind, boxes, lo, hi in qs:
        geo = " OR ".join(f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})"
                          for b in boxes)
        if len(boxes) > 1:
            geo = f"({geo})"
        out.append((f"{kind}-during", "z3",
                    f"{geo} AND dtg DURING {iso(lo)}/{iso(hi)}", boxes,
                    lo - lo % 1000, hi - hi % 1000))
        out.append((f"{kind}-bbox", "z2", geo, boxes, None, None))
    return out


def scanned(explain_text: str) -> int:
    """The candidates a query handed its residual filter (the explain
    trace's estimate audit)."""
    import re
    return int(re.search(r"scanned (\d+)", explain_text).group(1))


def run_life_queries(ds, name, lq, cols, visible=None, label="") -> list:
    """Each of ``lq`` through ``ds`` against the oracle over ``cols``
    (restricted to ``visible`` rows when given): strategy, positions and
    the candidates scanned."""
    import numpy as np
    from geomesa_tpu_torch.planning import ExplainString
    x, y, t = cols
    rows = []
    for kind, strategy, ecql, boxes, lo, hi in lq:
        ex = ExplainString()
        t0 = time.perf_counter()
        res = ds.query_result(name, ecql, ex)
        ms = (time.perf_counter() - t0) * 1e3
        want = (box_oracle(x, y, boxes) if lo is None
                else oracle(x, y, t, boxes, lo, hi))
        if visible is not None:
            want = want[visible[want]]
        if (res.strategy.index != strategy
                or not np.array_equal(res.positions, want)):
            raise AssertionError(
                f"{label} {kind}: {res.strategy.index} (expected "
                f"{strategy}), {len(res.positions)} hits, oracle "
                f"{len(want)}")
        rows.append({"query": kind, "ms": ms, "hits": int(len(want)),
                     "candidates": scanned(str(ex))})
    return rows


def life_summary(rows) -> str:
    import numpy as np
    lat = np.array([r["ms"] for r in rows])
    return (f"{len(rows)} queries equal to the oracle, p50 "
            f"{np.median(lat):.1f} ms, max {lat.max():.1f} ms")


def lifecycle_phase(rng, args, centres, qs, dev, report, cat=None):
    """Deletes, visibilities and the read APIs on the default profile:
    ``--life-rows`` GDELT-like rows in 4 writes labelled ``LABELS``, with
    ``actor`` guarded by ``admin``, read by a caller authorized for
    ``user`` (the first two writes); the index phase's queries, a
    ``max_features`` limit, a probe of the guarded attribute, get_count,
    get_bounds and a materialized region heatmap; then a delete of 1% of
    the rows by id (timed, and the first query after it, which rebuilds
    the indexes, timed apart), the queries again, a repeated delete that
    counts 0, and ``age_off`` of the rows before 2018-01-15.  With ``cat``
    the store keeps its catalog there from the start and is flushed at
    the end.  Returns the rows written and the candidates of each query,
    which the legacy phase compares, and what the persist phase reopens
    and checks."""
    import numpy as np
    import torch
    from geomesa_tpu_torch import TpuDataStore, density_process
    from geomesa_tpu_torch.age_off import age_off
    from geomesa_tpu_torch.ops.density_kernel import density_grid_kernel
    from geomesa_tpu_torch.planning.planner import Query
    from geomesa_tpu_torch.security import StaticAuthorizationsProvider

    actors = np.array(["USA", "GBR", "FRA", "CHN", "IND", "BRA", "RUS"],
                      dtype=object)
    ds = TpuDataStore(device=dev,
                      auth_provider=StaticAuthorizationsProvider(AUTHS),
                      catalog_dir=cat)
    ds.create_schema("life", LIFE_SPEC)
    n = args.life_rows
    per = n // 4
    chunks, write_s = [], []
    for label in LABELS:
        x, y, t = gdelt_like(rng, per, centres)
        chunk = {"actor": actors[rng.integers(0, len(actors), per)],
                 "dtg": t, "geom": (x, y)}
        chunks.append(chunk)
        t0 = time.perf_counter()
        ds.write("life", chunk, visibility=label,
                 attribute_visibilities={"actor": "admin"})
        write_s.append(time.perf_counter() - t0)
    x, y, t = (np.concatenate([c["geom"][0] for c in chunks]),
               np.concatenate([c["geom"][1] for c in chunks]),
               np.concatenate([c["dtg"] for c in chunks]))
    visible = np.arange(n) < 2 * per
    lq = life_queries(qs)
    rows = run_life_queries(ds, "life", lq, (x, y, t), visible, "lifecycle")
    cands = [r["candidates"] for r in rows]
    # max_features fills from the rows the caller may see
    for kind, _s, ecql, boxes, lo, hi in (lq[8], lq[9], lq[16]):
        want = (box_oracle(x, y, boxes) if lo is None
                else oracle(x, y, t, boxes, lo, hi))
        want = want[visible[want]]
        k = max(1, len(want) // 2)
        got = ds.query_result("life", Query.of(ecql, max_features=k))
        if not np.array_equal(got.positions, want[:k]):
            raise AssertionError(f"lifecycle {kind}: max_features {k} gave "
                                 f"{len(got.positions)} rows")
    # the guarded attribute answers no filter for this caller
    probe = ds.query_result("life", f"actor = 'USA' AND {lq[17][2]}")
    if len(probe.positions):
        raise AssertionError(f"lifecycle: a guarded actor matched "
                             f"{len(probe.positions)} rows")
    count = ds.get_count("life")
    env = ds.get_bounds("life").as_tuple()
    want_env = (x[visible].min(), y[visible].min(), x[visible].max(),
                y[visible].max())
    if count != 2 * per or env != want_env:
        raise AssertionError(f"lifecycle: get_count {count}, bounds {env}; "
                             f"oracle {2 * per}, {want_env}")
    kind, _s, q_region, boxes, lo, hi = lq[16]    # a region, a week
    box = boxes[0]
    hits = oracle(x, y, t, boxes, lo, hi)
    hits = hits[visible[hits]]
    d0 = density_grid_kernel.launches
    t0 = time.perf_counter()
    grid = density_process(ds, "life", q_region, box)
    heat_ms = (time.perf_counter() - t0) * 1e3
    want = snap_counts(x[hits], y[hits], box, 256, 256)
    if not np.array_equal(grid.astype(np.float64), want.astype(np.float32)):
        raise AssertionError(f"lifecycle heatmap: {float(grid.sum())} "
                             f"points, oracle {float(want.sum())}")
    heat_launches = density_grid_kernel.launches - d0
    log(f"lifecycle: {n} rows in 4 labelled writes "
        f"({', '.join(f'{s:.2f}' for s in write_s)} s); restricted "
        f"{life_summary(rows)}; max_features and the guarded-attribute "
        f"probe equal; get_count {count}; region heatmap {heat_ms:.1f} ms "
        f"(density_grid x{heat_launches})")

    # a delete of 1% of the rows by id, then every query again
    dpos = rng.choice(n, n // 100, replace=False)
    ids = np.array([str(p) for p in dpos], dtype=object)
    t0 = time.perf_counter()
    removed = ds.delete("life", ids)
    delete_s = time.perf_counter() - t0
    if removed != len(dpos) or ds._store("life")._indexes:
        raise AssertionError(f"lifecycle delete removed {removed} of "
                             f"{len(dpos)} rows")
    keep = np.ones(n, bool)
    keep[dpos] = False
    xk, yk, tk, vk = x[keep], y[keep], t[keep], visible[keep]
    first = run_life_queries(ds, "life", lq[:1], (xk, yk, tk), vk,
                             "lifecycle after delete")
    after = run_life_queries(ds, "life", lq[1:], (xk, yk, tk), vk,
                             "lifecycle after delete")
    again = ds.delete("life", ids)
    if again != 0:
        raise AssertionError(f"lifecycle: a repeated delete removed {again}")
    t0 = time.perf_counter()
    aged = age_off(ds, "life", older_than_ms=AGE_OFF_MS)
    age_s = time.perf_counter() - t0
    want_aged = int((tk < AGE_OFF_MS).sum())
    live = tk >= AGE_OFF_MS
    if aged != want_aged or ds.get_count("life") != int((vk & live).sum()):
        raise AssertionError(f"lifecycle age_off removed {aged}, oracle "
                             f"{want_aged}")
    report["lifecycle"] = {
        "rows": n, "write_s": write_s, "queries": rows,
        "get_count": count, "heatmap_ms": heat_ms,
        "heatmap_density_grid_launches": heat_launches,
        "deleted": removed, "delete_s": delete_s,
        "first_query_after_delete_ms": first[0]["ms"],
        "queries_after_delete": first + after, "aged_off": aged,
        "age_off_s": age_s}
    log(f"lifecycle: deleted {removed} rows by id in {delete_s:.2f} s; the "
        f"first query after it (index rebuild) {first[0]['ms']:.1f} ms; "
        f"{life_summary(after)}; a repeated delete counts 0; age_off "
        f"removed {aged} rows in {age_s:.2f} s")
    persisted = None
    if cat is not None:
        # parquet rows, the labels dictionary-encoded, then the stats
        catalog_room(cat, n * 96)
        t0 = time.perf_counter()
        ds.flush("life")
        flush_s = time.perf_counter() - t0
        persisted = {
            "catalog": cat, "cols": (xk[live], yk[live], tk[live]),
            "visible": vk[live], "issued": n, "flush_s": flush_s,
            "bytes": dir_bytes(cat),
            "memory_allocated": (int(torch.cuda.memory_allocated())
                                 if dev.type == "cuda" else None)}
        log(f"lifecycle: flushed {int(live.sum())} rows in {flush_s:.2f} s, "
            f"{persisted['bytes']} bytes on disk")
    del ds
    return chunks, (x, y, t), cands, persisted


def legacy_phase(args, chunks, cols, cands, qs, dev, report):
    """The lifecycle phase's rows on a schema pinned to the v1 key layouts
    (the legacy curves): the same queries, with the candidates of each
    next to the current layout's, then ``migrate_schema`` and the queries
    again (now with the current layout's candidates)."""
    from geomesa_tpu_torch import TpuDataStore

    ds = TpuDataStore(device=dev)
    ds.create_schema("legacy", LEGACY_SPEC)
    t0 = time.perf_counter()
    for chunk in chunks:
        ds.write("legacy", chunk)
    write_s = time.perf_counter() - t0
    store = ds._store("legacy")
    lq = life_queries(qs)
    v1 = run_life_queries(ds, "legacy", lq, cols, label="legacy v1")
    if (store.z3_index().version, store.z2_index().version) != (1, 1):
        raise AssertionError("the legacy store's indexes are not v1")
    for r, c in zip(v1, cands):
        r["candidates_v2"] = c
    t0 = time.perf_counter()
    old = ds.migrate_schema("legacy")
    migrate_s = time.perf_counter() - t0
    v2 = run_life_queries(ds, "legacy", lq, cols, label="legacy migrated")
    if (old["z3"], old["z2"], store.z3_index().version) != (1, 1, 2):
        raise AssertionError(f"migrate_schema from {old}")
    if [r["candidates"] for r in v2] != cands:
        raise AssertionError("after migration the candidates differ from "
                             "the current layout's")
    report["legacy"] = {"write_s": write_s, "queries_v1": v1,
                        "migrate_s": migrate_s, "queries_migrated": v2}
    differ = sum(r["candidates"] != r["candidates_v2"] for r in v1)
    log(f"legacy: {len(chunks)} writes in {write_s:.2f} s; v1 "
        f"{life_summary(v1)}; candidates v1/v2 "
        + ", ".join(f"{r['candidates']}/{r['candidates_v2']}" for r in v1)
        + f" ({differ} of {len(v1)} differ); migrate_schema "
          f"{migrate_s * 1e3:.1f} ms, then {life_summary(v2)}")
    del ds, store


def mesh_lifecycle_phase(rng, args, centres, qs, dev, report):
    """``device_mesh(1)``: ``--life-mesh-rows`` rows in 2 writes labelled
    "" and ``admin``, a delete of 1% of them; Count, MinMax and a
    Histogram of ``score`` pushed down through hist1d over the sharded
    index rebuilt after the delete, and the queries; then the same rows
    and delete read by a caller authorized for ``user`` only (the first
    write), the queries restricted to it."""
    import numpy as np
    from geomesa_tpu_torch import TpuDataStore, device_mesh
    from geomesa_tpu_torch.ops.hist1d_kernel import hist1d
    from geomesa_tpu_torch.security import StaticAuthorizationsProvider

    spec = "actor:String,score:Double,dtg:Date,*geom:Point"
    n = args.life_mesh_rows
    per = n // 2
    chunks = []
    for _ in range(2):
        x, y, t = gdelt_like(rng, per, centres)
        chunks.append({"actor": np.array(["USA"] * per, dtype=object),
                       "score": rng.uniform(0.0, 100.0, per), "dtg": t,
                       "geom": (x, y)})
    x, y, t, score = (np.concatenate([c["geom"][0] for c in chunks]),
                      np.concatenate([c["geom"][1] for c in chunks]),
                      np.concatenate([c["dtg"] for c in chunks]),
                      np.concatenate([c["score"] for c in chunks]))
    dpos = rng.choice(n, n // 100, replace=False)
    ids = np.array([str(p) for p in dpos], dtype=object)
    keep = np.ones(n, bool)
    keep[dpos] = False
    xk, yk, tk, sk = x[keep], y[keep], t[keep], score[keep]
    lq = life_queries(qs)
    out = {}
    for label, auths in (("open", None), ("restricted", AUTHS)):
        ds = TpuDataStore(
            device=dev, mesh=device_mesh(1),
            auth_provider=(None if auths is None
                           else StaticAuthorizationsProvider(auths)))
        ds.create_schema("mlife", spec)
        for chunk, vis in zip(chunks, ("", "admin")):
            ds.write("mlife", chunk, visibility=vis)
        ds.query_result("mlife", lq[0][2])   # builds the sharded indexes
        t0 = time.perf_counter()
        removed = ds.delete("mlife", ids)
        delete_s = time.perf_counter() - t0
        if removed != len(dpos):
            raise AssertionError(f"mesh lifecycle delete removed {removed}")
        visible = (None if auths is None
                   else (np.arange(n) < per)[keep])
        rows = run_life_queries(ds, "mlife", lq, (xk, yk, tk), visible,
                                f"mesh lifecycle ({label})")
        rep = {"deleted": removed, "delete_s": delete_s, "queries": rows}
        if auths is None:
            stats = []
            kind, _s, q, boxes, lo, hi = lq[28]   # a continent, a month
            for name, ecql, hits in (
                    (kind, q, oracle(xk, yk, tk, boxes, lo, hi)),
                    ("include", "INCLUDE", np.arange(len(xk)))):
                h0 = hist1d.launches
                t0 = time.perf_counter()
                c, mm, h = ds.stats(
                    "mlife", ecql,
                    "Count();MinMax(score);Histogram(score,64,0,100)").stats
                ms = (time.perf_counter() - t0) * 1e3
                sc = sk[hits]
                want_h = np.bincount(
                    np.clip(sc / (100.0 / 64), 0, 63).astype(np.int64),
                    minlength=64)
                if (c.count != len(hits) or (mm.min, mm.max)
                        != (sc.min(), sc.max())
                        or not np.array_equal(h.counts, want_h)):
                    raise AssertionError(f"mesh lifecycle stats {name} "
                                         "disagree with numpy")
                stats.append({"stats": name, "ms": ms,
                              "hist1d_launches": hist1d.launches - h0})
            rep["stats"] = stats
        out[label] = rep
        del ds
    report["mesh_lifecycle"] = out
    log(f"mesh lifecycle: {n} rows, deleted {len(dpos)} by id in "
        f"{out['open']['delete_s']:.2f} s; stats after the delete equal to "
        f"numpy: " + ", ".join(f"{s['stats']} {s['ms']:.1f} ms (hist1d "
                               f"x{s['hist1d_launches']})"
                               for s in out["open"]["stats"])
        + f"; open {life_summary(out['open']['queries'])}; restricted "
          f"{life_summary(out['restricted']['queries'])}")


def persist_phase(args, qs, dev, report, life) -> None:
    """The lifecycle store's catalog (flushed after its delete and
    age_off): the store dropped (its device memory must fall), reopened
    with the same auth provider — the reopen and the first query timed
    apart, the two together the time to recover — then the queries
    against the oracle (the visible rows less the deleted and aged-off
    ones), a restricted heatmap (density_grid), a 1M-row write whose auto
    ids follow every id ever issued, and an ``update_schema`` rename; the
    catalog reopened on ``device_mesh(1)``, which must hold the renamed
    schema only, answering Count, MinMax and a 64-bin Histogram of
    ``dtg`` through hist1d, against numpy; then ``remove_schema``, after
    which no file of the schema is left."""
    import numpy as np
    from geomesa_tpu_torch import TpuDataStore, density_process, device_mesh
    from geomesa_tpu_torch.features.feature_type import parse_spec
    from geomesa_tpu_torch.ops.density_kernel import density_grid_kernel
    from geomesa_tpu_torch.ops.hist1d_kernel import hist1d
    from geomesa_tpu_torch.security import StaticAuthorizationsProvider

    cuda = dev.type == "cuda"
    cat = life["catalog"]
    x, y, t = life["cols"]
    visible = life["visible"]
    n = len(x)
    alloc = allocated_after_gc(cuda)
    if cuda and alloc >= life["memory_allocated"]:
        raise AssertionError(f"persist: dropping the store left "
                             f"{alloc} bytes allocated (was "
                             f"{life['memory_allocated']})")
    lq = life_queries(qs)
    t0 = time.perf_counter()
    ds = TpuDataStore(device=dev,
                      auth_provider=StaticAuthorizationsProvider(AUTHS),
                      catalog_dir=cat)
    reopen_s = time.perf_counter() - t0
    if ds.type_names != ["life"] or len(ds._store("life").batch) != n:
        raise AssertionError(f"persist: reopened {ds.type_names} with "
                             f"{len(ds._store('life').batch)} rows, not {n}")
    first = run_life_queries(ds, "life", lq[:1], (x, y, t), visible,
                             "persist")
    rest = run_life_queries(ds, "life", lq[1:], (x, y, t), visible,
                            "persist")
    if cuda:
        launches = device_launches(lambda: ds.query_result("life", lq[0][2]))
    else:
        launches = None
    kind, _s, q_region, boxes, lo, hi = lq[16]
    box = boxes[0]
    hits = oracle(x, y, t, boxes, lo, hi)
    hits = hits[visible[hits]]
    d0 = density_grid_kernel.launches
    t0 = time.perf_counter()
    grid = density_process(ds, "life", q_region, box)
    heat_ms = (time.perf_counter() - t0) * 1e3
    want = snap_counts(x[hits], y[hits], box, 256, 256)
    if not np.array_equal(grid.astype(np.float64), want.astype(np.float32)):
        raise AssertionError(f"persist heatmap: {float(grid.sum())} points, "
                             f"oracle {float(want.sum())}")
    heat_launches = density_grid_kernel.launches - d0
    # auto ids after the reopen follow every id ever issued: deleted and
    # aged-off ids are never reused
    m = 1_000_000
    rng = np.random.default_rng(args.seed + 10)
    centres = np.stack([rng.uniform(-130.0, 150.0, 50),
                        rng.uniform(-40.0, 60.0, 50)], axis=1)
    xa, ya, ta = gdelt_like(rng, m, centres)
    t0 = time.perf_counter()
    ds.write("life", {"actor": np.array(["USA"] * m, dtype=object),
                      "dtg": ta, "geom": (xa, ya)}, visibility="user")
    append_s = time.perf_counter() - t0
    ids = ds._store("life").batch.ids[-m:]
    if ids[0] != str(life["issued"]) or ids[-1] != str(life["issued"] + m - 1):
        raise AssertionError(f"persist: auto ids {ids[0]}..{ids[-1]} after "
                             f"the reopen, {life['issued']} issued before")
    after = run_life_queries(
        ds, "life", lq[:2], (np.r_[x, xa], np.r_[y, ya], np.r_[t, ta]),
        np.r_[visible, np.ones(m, bool)], "persist after the write")
    report_rows = {"reopen_s": reopen_s,
                   "first_query_ms": first[0]["ms"],
                   "recover_s": reopen_s + first[0]["ms"] / 1e3,
                   "queries": first + rest, "heatmap_ms": heat_ms,
                   "heatmap_density_grid_launches": heat_launches,
                   "device_launches": launches, "append_s": append_s,
                   "queries_after_append": after}
    # a rename moves every file of the schema (the next reopen must see
    # the new name only)
    t0 = time.perf_counter()
    ds.update_schema("life", parse_spec("life_v2", LIFE_SPEC))
    rename_ms = (time.perf_counter() - t0) * 1e3
    del ds
    log(f"persist: flush {life['flush_s']:.2f} s, {life['bytes']} bytes; "
        f"reopen {reopen_s:.2f} s, first restricted query "
        f"{first[0]['ms']:.1f} ms (time to recover "
        f"{report_rows['recover_s']:.2f} s); {life_summary(first + rest)}; "
        f"heatmap {heat_ms:.1f} ms (density_grid x{heat_launches}); 1M-row "
        f"write {append_s:.2f} s with ids from {life['issued']}")

    # the catalog on a mesh: stats pushed down through hist1d
    t0 = time.perf_counter()
    ms = TpuDataStore(device=dev, mesh=device_mesh(1), catalog_dir=cat)
    mesh_reopen_s = time.perf_counter() - t0
    if ms.type_names != ["life_v2"] or ms.get_count("life_v2") != n:
        raise AssertionError(f"persist: after the rename {ms.type_names}")
    stats = []
    kind, _s, q, boxes, lo, hi = lq[28]   # a continent, a month
    for name, ecql, rows in ((kind, q, oracle(x, y, t, boxes, lo, hi)),
                             ("include", "INCLUDE", np.arange(n))):
        h0 = hist1d.launches
        t0 = time.perf_counter()
        c, mm, h = ms.stats(
            "life_v2", ecql,
            f"Count();MinMax(dtg);Histogram(dtg,64,{MS_2018},{MS_2019})"
        ).stats
        stat_ms = (time.perf_counter() - t0) * 1e3
        tr = t[rows]
        want_h = np.bincount(np.clip(
            (tr.astype(np.float64) - MS_2018) / ((MS_2019 - MS_2018) / 64),
            0, 63).astype(np.int64), minlength=64)
        if (c.count != len(rows) or (mm.min, mm.max) != (tr.min(), tr.max())
                or not np.array_equal(h.counts, want_h)):
            raise AssertionError(f"persist mesh stats {name} disagree with "
                                 "numpy")
        stats.append({"stats": name, "ms": stat_ms,
                      "hist1d_launches": hist1d.launches - h0})
    # a remove leaves no file of the schema
    ms.remove_schema("life_v2")
    left = sorted(f for f in os.listdir(cat) if f.startswith("life"))
    if left or ms.type_names:
        raise AssertionError(f"persist: remove_schema left {left}")
    del ms
    report_rows.update(
        flush_s=life["flush_s"], bytes=life["bytes"],
        flush_rows_per_s=n / life["flush_s"], mesh_reopen_s=mesh_reopen_s,
        mesh_stats=stats, rename_ms=rename_ms,
        memory_allocated_after_drop=alloc)
    report["persist"] = report_rows
    log(f"persist: mesh reopen {mesh_reopen_s:.2f} s, stats equal to numpy: "
        + ", ".join(f"{s['stats']} {s['ms']:.1f} ms (hist1d "
                    f"x{s['hist1d_launches']})" for s in stats)
        + f"; the rename {rename_ms:.1f} ms, seen by the reopen; "
          "remove_schema left no file")


def lean_persist_phase(args, dev, report, lean) -> None:
    """The lean phase's snapshot (flushed after its tombstoning age_off):
    the store dropped (its device memory must fall), reopened, the lazy
    streaming index rebuild timed inside the first query, the
    estimator-costed queries against the oracle less the tombstones,
    ``get_count`` and ``Count()``, and the accounted device bytes next
    to ``torch.cuda.memory_allocated``."""
    import numpy as np
    import torch
    from geomesa_tpu_torch import TpuDataStore

    cuda = dev.type == "cuda"
    cat = lean["catalog"]
    x, y, t = lean["cols"]
    live = ~lean["tombstone"]
    n = len(x)
    persisted = lean["persisted"]
    alloc = allocated_after_gc(cuda)
    if cuda and alloc >= persisted["memory_allocated"]:
        raise AssertionError(f"lean persist: dropping the store left {alloc} "
                             f"bytes allocated (was "
                             f"{persisted['memory_allocated']})")
    t0 = time.perf_counter()
    ds = TpuDataStore(device=dev, catalog_dir=cat)
    reopen_s = time.perf_counter() - t0
    store = ds._store("scale")
    if (not store.lean or len(store.batch) != n or store._indexes
            or int(store.tombstone.sum()) != int((~live).sum())):
        raise AssertionError(f"lean persist: reopened {len(store.batch)} "
                             f"rows, indexes {sorted(store._indexes)}")
    rows = []
    for i, (kind, ecql, boxes, lo, hi) in enumerate(lean["checks"]):
        t0 = time.perf_counter()
        res = ds.query_result("scale", ecql)
        ms = (time.perf_counter() - t0) * 1e3
        want = (box_oracle(x, y, boxes) if lo is None
                else oracle(x, y, t, boxes, lo, hi))
        want = want[live[want]]
        # the first plan precedes the index (its rebuild runs in the
        # scan), so the estimator has no cell counts yet and it is costed
        # from the persisted stats, as in the JAX package; the rest from
        # the sketch
        if (res.strategy.index != "z3"
                or res.strategy.source != ("stats" if i == 0 else "sketch")
                or not np.array_equal(res.positions, want)):
            raise AssertionError(
                f"lean persist {kind}: {res.strategy.index} "
                f"({res.strategy.source}), {len(res.positions)} hits, "
                f"oracle {len(want)}")
        rows.append({"query": kind, "ms": ms, "hits": int(len(want)),
                     "source": res.strategy.source})
    idx = store._indexes["z3"]
    launches = (device_launches(lambda: ds.query_result(
        "scale", lean["checks"][0][1])) if cuda else None)
    count = ds.get_count("scale")
    t0 = time.perf_counter()
    counted = ds.stats("scale", "INCLUDE", "Count()").count
    count_ms = (time.perf_counter() - t0) * 1e3
    if count != counted or count != int(live.sum()):
        raise AssertionError(f"lean persist: get_count {count}, Count() "
                             f"{counted}, oracle {int(live.sum())}")
    dev_bytes = idx.device_bytes()
    grown = (int(torch.cuda.memory_allocated()) - alloc) if cuda else None
    if cuda and not 0.99 <= grown / dev_bytes <= 1.05:
        raise AssertionError(f"lean persist: {grown} bytes allocated since "
                             f"the reopen, {dev_bytes} accounted")
    lat = np.array([r["ms"] for r in rows[1:]])
    report["lean_persist"] = {
        "rows": n, "flush_s": persisted["flush_s"],
        "flush_rows_per_s": n / persisted["flush_s"],
        "bytes": persisted["bytes"], "parts": persisted["parts"],
        "reopen_s": reopen_s, "first_query_ms": rows[0]["ms"],
        "recover_s": reopen_s + rows[0]["ms"] / 1e3, "queries": rows,
        "query_ms_p50": float(np.median(lat)), "tiers": idx.tier_counts(),
        "get_count": count, "count_ms": count_ms,
        "device_bytes": dev_bytes, "allocated_since_reopen": grown,
        "device_launches": launches}
    log(f"lean persist: reopen {reopen_s:.2f} s; the first query (the lazy "
        f"streaming rebuild of {n} rows) {rows[0]['ms']:.1f} ms, time to "
        f"recover {reopen_s + rows[0]['ms'] / 1e3:.2f} s; tiers "
        f"{idx.tier_counts()}; {len(rows)} queries equal to the oracle less "
        f"the tombstones, the rest p50 {np.median(lat):.1f} ms; get_count "
        f"and Count() {count} ({count_ms:.1f} ms); device bytes {dev_bytes} "
        f"accounted, {grown} allocated since the reopen")
    del ds, store, idx
    allocated_after_gc(cuda)


def fsds_phase(rng, args, centres, qs, dev, report) -> None:
    """``FileSystemDataStore`` with the daily datetime scheme:
    ``--fsds-rows`` GDELT-like rows over 2018 in 4 writes (365 partitions,
    4 files each); a city-week BBOX+DURING query pruned on the host
    against the oracle, reading only the week's days and the one-day
    over-cover on each side; ``compact`` (one file a partition); the
    store rediscovered from disk; then ``to_device_store`` on the card and
    the query and a BBOX-only one through z3 and z2, equal to the oracle
    and to ``fs.query``."""
    import numpy as np
    from geomesa_tpu_torch.filters import parse_ecql
    from geomesa_tpu_torch.fs import FileSystemDataStore, to_device_store

    n = args.fsds_rows
    per = n // 4
    root = tempfile.mkdtemp(prefix="chip_smoke_fsds_")
    try:
        catalog_room(root, n * 200)
        fs = FileSystemDataStore(root)
        fs.create_schema("gdelt", LIFE_SPEC, {"scheme": "datetime",
                                              "datetime-step": "daily"})
        actors = np.array(["USA", "GBR", "FRA", "CHN"], dtype=object)
        cols, write_s = [], []
        for _ in range(4):
            x, y, t = gdelt_like(rng, per, centres)
            cols.append((x, y, t))
            t0 = time.perf_counter()
            fs.write("gdelt", {"actor": actors[rng.integers(0, 4, per)],
                               "dtg": t, "geom": (x, y)})
            write_s.append(time.perf_counter() - t0)
        x, y, t = (np.concatenate(c) for c in zip(*cols))
        del cols
        info = fs.partition_info("gdelt")
        if (len(info) != 365 or fs.count("gdelt") != n
                or {v["files"] for v in info.values()} != {4}):
            raise AssertionError(f"fsds: {len(info)} partitions, "
                                 f"{fs.count('gdelt')} rows")
        city = next(q for q in qs if q[0] == "city")[1][0]
        lo, hi = MS_2018 + 59 * DAY, MS_2018 + 66 * DAY   # Mar 1 to Mar 8
        q = (f"BBOX(geom, {city[0]}, {city[1]}, {city[2]}, {city[3]}) "
             f"AND dtg DURING {iso(lo)}/{iso(hi)}")
        q2 = f"BBOX(geom, {city[0]}, {city[1]}, {city[2]}, {city[3]})"
        want = oracle(x, y, t, [city], lo, hi)
        want2 = box_oracle(x, y, [city])
        read = fs._storage("gdelt")._select_partitions(parse_ecql(q))
        # the scheme over-covers the window by a day on each side
        days = (hi + DAY) // DAY - (lo - DAY) // DAY + 1

        def host_query(label):
            t0 = time.perf_counter()
            got = fs.query("gdelt", q)
            ms = (time.perf_counter() - t0) * 1e3
            ids = np.sort(got.ids.astype(np.int64))
            if not np.array_equal(ids, want):
                raise AssertionError(f"fsds {label}: {len(ids)} hits, "
                                     f"oracle {len(want)}")
            return ms

        query_ms = host_query("pruned query")
        if len(read) != days:
            raise AssertionError(f"fsds: the pruned query read {len(read)} "
                                 f"partitions, not {days}")
        t0 = time.perf_counter()
        fs.compact("gdelt")
        compact_s = time.perf_counter() - t0
        if {v["files"] for v in fs.partition_info("gdelt").values()} != {1}:
            raise AssertionError("fsds: compact left several files in a "
                                 "partition")
        compacted_ms = host_query("query after compact")
        t0 = time.perf_counter()
        fs = FileSystemDataStore(root)
        rediscover_ms = (time.perf_counter() - t0) * 1e3
        if fs.type_names != ["gdelt"] or fs.count("gdelt") != n:
            raise AssertionError(f"fsds: rediscovered {fs.type_names}")
        rediscovered_ms = host_query("query after rediscovery")
        t0 = time.perf_counter()
        ds = to_device_store(fs, "gdelt", device=dev)
        lift_s = time.perf_counter() - t0
        device = []
        for label, ecql, index, w in (("bbox-during", q, "z3", want),
                                      ("bbox", q2, "z2", want2)):
            t0 = time.perf_counter()
            res = ds.query_result("gdelt", ecql)
            ms = (time.perf_counter() - t0) * 1e3
            ids = np.sort(res.batch.ids.astype(np.int64))
            host = np.sort(fs.query("gdelt", ecql).ids.astype(np.int64))
            if (res.strategy.index != index or not np.array_equal(ids, w)
                    or not np.array_equal(host, w)):
                raise AssertionError(f"fsds device {label}: "
                                     f"{res.strategy.index}, {len(ids)} hits, "
                                     f"host {len(host)}, oracle {len(w)}")
            device.append({"query": label, "ms": ms, "hits": int(len(w)),
                           "strategy": index})
        del ds
        report["fsds"] = {
            "rows": n, "write_s": write_s,
            "write_rows_per_s": [per / s for s in write_s],
            "partitions": len(info), "bytes": dir_bytes(root),
            "partitions_read": len(read), "query_ms": query_ms,
            "compact_s": compact_s, "query_after_compact_ms": compacted_ms,
            "rediscover_ms": rediscover_ms,
            "query_after_rediscovery_ms": rediscovered_ms,
            "to_device_store_s": lift_s, "device_queries": device}
        log(f"fsds: {n} rows in 4 writes "
            f"({', '.join(f'{s:.2f}' for s in write_s)} s), {len(info)} "
            f"partitions; the city-week query read {len(read)} partitions "
            f"in {query_ms:.1f} ms, {len(want)} hits equal to the oracle; "
            f"compact {compact_s:.2f} s, then {compacted_ms:.1f} ms; "
            f"rediscovered in {rediscover_ms:.1f} ms; to_device_store "
            f"{lift_s:.2f} s; on the card "
            + ", ".join(f"{d['query']} {d['ms']:.1f} ms ({d['strategy']})"
                        for d in device))
    finally:
        shutil.rmtree(root, ignore_errors=True)


#: the attribute phases' schema: GDELT's actor code and GoldsteinScale
ATTR_SPEC = ("actor:String:index=true,score:Double:index=true,dtg:Date,"
             "*geom:Point")
#: the rare actor code (about 0.01% of the rows)
RARE_ACTOR = "QQQ"
#: the actor codes that LIKE 'U%' matches, placed in the Zipf tail
U_ACTORS = ("USA", "UKR", "UGA", "URY", "UZB")


def actor_codes(rng):
    """About 200 three-letter actor codes with Zipf(1.1) frequencies, the
    ``U_ACTORS`` at ranks 150-154, plus ``RARE_ACTOR`` at 0.01%: the
    codes (fixed-width, the rare one last) and their probabilities."""
    import numpy as np
    letters = np.array(list("ABCDEFGHIJKLMNOPQRSTVWXYZ"))   # no U
    codes: list = []
    while len(codes) < 200:
        c = "".join(rng.choice(letters, 3))
        if c not in codes and c != RARE_ACTOR:
            codes.append(c)
    codes[150:150 + len(U_ACTORS)] = U_ACTORS
    w = 1.0 / np.arange(1, 201) ** 1.1
    p = np.r_[w / w.sum() * (1.0 - 1e-4), 1e-4]
    return np.array(codes + [RARE_ACTOR]), p


def attr_rows(rng, n: int, centres, p):
    """``n`` GDELT-like rows with an actor code index (into the codes of
    :func:`actor_codes`) and a GoldsteinScale-like score, a multiple of
    0.1 in [-10, 10]."""
    import numpy as np
    x, y, t = gdelt_like(rng, n, centres)
    aidx = rng.choice(len(p), n, p=p).astype(np.int16)
    score = rng.integers(-100, 101, n) / 10.0
    return x, y, t, aidx, score


def attr_queries(codes, centres, lean: bool) -> list:
    """(name, ecql, expected strategy, oracle mask function) for the
    attribute phases.  The oracle takes ``(x, y, t, aidx, score)``."""
    import numpy as np
    cx, cy = centres[3]
    city = (cx - 0.5, cy - 0.5, cx + 0.5, cy + 0.5)
    continent = (-20.0, 20.0, 40.0, 60.0)
    month = (MS_2018 + 59 * DAY, MS_2018 + 90 * DAY - 1000)
    day = (MS_2018 + 100 * DAY, MS_2018 + 101 * DAY - 1000)
    mid = (20, 21)
    u_idx = [int(np.flatnonzero(codes == c)[0]) for c in U_ACTORS]
    rare = len(codes) - 1

    def bbox(b):
        return f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})"

    def during(w):
        return f"dtg DURING {iso(w[0])}/{iso(w[1])}"

    def inbox(x, y, b):
        return (x >= b[0]) & (x <= b[2]) & (y >= b[1]) & (y <= b[3])

    def inwin(t, w):
        return (t >= w[0]) & (t <= w[1])

    qs = [
        ("rare-continent-month",
         f"actor = '{RARE_ACTOR}' AND {bbox(continent)} AND {during(month)}",
         "attr:actor",
         lambda x, y, t, a, s: (a == rare) & inbox(x, y, continent)
         & inwin(t, month)),
        ("in-two-mid",
         f"actor IN ('{codes[mid[0]]}', '{codes[mid[1]]}')", "attr:actor",
         lambda x, y, t, a, s: np.isin(a, mid)),
        ("score-band", "score BETWEEN 2.95 AND 3.05", "attr:score",
         lambda x, y, t, a, s: (s >= 2.95) & (s <= 3.05)),
        ("like-U", "actor LIKE 'U%'", "attr:actor",
         lambda x, y, t, a, s: np.isin(a, u_idx)),
        ("city-day", f"{bbox(city)} AND {during(day)}", "z3",
         lambda x, y, t, a, s: inbox(x, y, city) & inwin(t, day)),
    ]
    if lean:
        qs += [
            ("actor-day", f"actor = '{codes[10]}' AND {during(day)}",
             "attr:actor",
             lambda x, y, t, a, s: (a == 10) & inwin(t, day)),
            ("top-actor-city-day",
             f"actor = '{codes[0]}' AND {bbox(city)} AND {during(day)}",
             "z3",
             lambda x, y, t, a, s: (a == 0) & inbox(x, y, city)
             & inwin(t, day)),
        ]
    return qs


def run_attr_query(ds, schema, q, cols, source=None) -> dict:
    """One attribute-phase query: strategy (and, when given, cost source)
    as expected, positions equal to the oracle; its ms, plan source and
    candidate count (the explain trace's "scanned")."""
    import re
    import numpy as np
    from geomesa_tpu_torch.planning import ExplainString
    name, ecql, strategy, mask = q
    ex = ExplainString()
    t0 = time.perf_counter()
    res = ds.query_result(schema, ecql, ex)
    ms = (time.perf_counter() - t0) * 1e3
    want = np.flatnonzero(mask(*cols))
    st = res.strategy
    if st.index != strategy or (source is not None and st.source != source):
        raise AssertionError(f"attr {name}: strategy {st.index} "
                             f"({st.source}), expected {strategy} "
                             f"({source})")
    if not np.array_equal(res.positions, want):
        raise AssertionError(f"attr {name}: {len(res.positions)} hits, "
                             f"oracle {len(want)}")
    scanned = re.search(r"scanned (\d+)", str(ex))
    return {"query": name, "strategy": st.index, "source": st.source,
            "cost": float(st.cost), "ms": ms, "plan_ms": res.plan_time_ms,
            "scan_ms": res.scan_time_ms, "hits": int(len(want)),
            "candidates": int(scanned.group(1)) if scanned else None}


def attr_phase(rng, args, centres, dev, report):
    """Attribute indexes on the default profile: ``--attr-rows`` rows in 4
    writes, the z3-tiered host indexes of ``actor`` and ``score``, five
    queries (rare actor with a continent BBOX and a month, actor IN, a
    score band, LIKE 'U%', and a city BBOX + day that stays on z3) with
    their strategies and oracles; then a 1M-row append (the kept
    indexes' tail) and the same queries again."""
    import numpy as np
    import torch
    from geomesa_tpu_torch import TpuDataStore
    from geomesa_tpu_torch.index.attribute import AttributeIndex

    codes, p = actor_codes(rng)
    ds = TpuDataStore(device=dev)
    ds.create_schema("attrs", ATTR_SPEC)
    per = args.attr_rows // 4
    parts, write_s = [], []
    for _ in range(4):
        x, y, t, a, s = attr_rows(rng, per, centres, p)
        parts.append((x, y, t, a, s))
        t0 = time.perf_counter()
        ds.write("attrs", {"actor": codes[a], "score": s, "dtg": t,
                           "geom": (x, y)})
        write_s.append(time.perf_counter() - t0)
    store = ds._store("attrs")
    # the z3 index, which the city query would build, built and timed
    # apart, then the two attribute indexes
    t0 = time.perf_counter()
    store.z3_index()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    build = {"z3": time.perf_counter() - t0}
    for attr in ("actor", "score"):
        t0 = time.perf_counter()
        idx = store.attribute_index(attr)
        build[attr] = time.perf_counter() - t0
        if not isinstance(idx, AttributeIndex) or idx.sec_z is None:
            raise AssertionError(f"attribute index of {attr}: "
                                 f"{type(idx).__name__}, no z3 tier")
    qs = attr_queries(codes, centres, lean=False)

    def cols():
        return tuple(np.concatenate(c) for c in zip(*parts))

    c = cols()
    rows = [run_attr_query(ds, "attrs", q, c) for q in qs]
    # an append: the kept indexes serve it as their tail (1M rows at the
    # default size, a 16th of the rows below it: under the rebuild
    # fraction)
    m = min(1_000_000, per // 4)
    x, y, t, a, s = attr_rows(rng, m, centres, p)
    parts.append((x, y, t, a, s))
    t0 = time.perf_counter()
    ds.write("attrs", {"actor": codes[a], "score": s, "dtg": t,
                       "geom": (x, y)})
    append_s = time.perf_counter() - t0
    c = cols()
    after = [run_attr_query(ds, "attrs", q, c) for q in qs]
    tail = store.index_tail("attr:actor")
    if (tail is None or len(tail) != m
            or store.build_counts.get("attr:actor") != 1):
        raise AssertionError(f"the kept actor index: tail "
                             f"{None if tail is None else len(tail)}, "
                             f"builds {store.build_counts}")
    report["attr"] = {"rows": 4 * per, "codes": len(codes),
                      "write_s": write_s,
                      "write_rows_per_s": [per / w for w in write_s],
                      "build_s": build, "queries": rows,
                      "append_s": append_s, "after_append": after,
                      "build_counts": dict(store.build_counts)}
    log(f"attr: {4 * per} rows in 4 writes "
        f"({', '.join(f'{w:.2f}' for w in write_s)} s); indexes built "
        f"z3 {build['z3']:.2f} s, actor {build['actor']:.2f} s, score "
        f"{build['score']:.2f} s; "
        "queries equal to the oracle: "
        + ", ".join(f"{r['query']} {r['strategy']} {r['hits']} hits "
                    f"{r['candidates']} candidates {r['ms']:.1f} ms"
                    for r in rows)
        + f"; after a {m}-row append ({append_s:.2f} s, tail {len(tail)}): "
        + ", ".join(f"{r['query']} {r['ms']:.1f} ms" for r in after))
    del ds, store


def mesh_attr_phase(rng, args, centres, dev, report):
    """The sharded attribute index on a one-card mesh: ``--attr-mesh-rows``
    rows, an actor equality with a time window (the z3 tier) and a score
    range, each against the oracle."""
    import numpy as np
    import torch
    from geomesa_tpu_torch import TpuDataStore, device_mesh
    from geomesa_tpu_torch.parallel.attribute import ShardedAttributeIndex

    codes, p = actor_codes(rng)
    ds = TpuDataStore(device=dev, mesh=device_mesh(1))
    ds.create_schema("events", ATTR_SPEC)
    n = args.attr_mesh_rows
    cols = attr_rows(rng, n, centres, p)
    x, y, t, a, s = cols
    t0 = time.perf_counter()
    ds.write("events", {"actor": codes[a], "score": s, "dtg": t,
                        "geom": (x, y)})
    write_s = time.perf_counter() - t0
    store = ds._store("events")
    t0 = time.perf_counter()
    idx = store.attribute_index("actor")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if not isinstance(idx, ShardedAttributeIndex) or idx.tier != "z3":
        raise AssertionError(f"mesh attribute index {type(idx).__name__}")
    week = (MS_2018 + 150 * DAY, MS_2018 + 157 * DAY - 1000)
    qs = [("actor-week", f"actor = '{codes[5]}' AND dtg DURING "
           f"{iso(week[0])}/{iso(week[1])}", "attr:actor",
           lambda x, y, t, a, s: (a == 5) & (t >= week[0]) & (t <= week[1])),
          ("score-range", "score >= 9.8", "attr:score",
           lambda x, y, t, a, s: s >= 9.8)]
    rows = [run_attr_query(ds, "events", q, cols) for q in qs]
    report["mesh_attr"] = {"rows": n, "write_s": write_s,
                           "build_s": build_s, "queries": rows}
    log(f"mesh attr: {n} rows ({write_s:.2f} s), sharded actor index "
        f"(z3 tier) built in {build_s:.2f} s; queries equal to the oracle: "
        + ", ".join(f"{r['query']} {r['strategy']} {r['hits']} hits "
                    f"{r['ms']:.1f} ms" for r in rows))
    del ds, store, idx


#: the lean attribute phase's budget, in bytes a generation slot: the z3
#: index gets 0.75 of it (156 B), one full and three keys generations
#: beside its sentinel charges; each attribute index gets its floor of
#: two class-default generations, one live device generation beside its
#: sentinel charge, the rest on the host
LEAN_ATTR_BUDGET_PER_SLOT = 208


def lean_attr_phase(rng, args, centres, dev, report):
    """The lean profile with attribute indexes: ``--lean-attr-rows`` rows
    in 4 writes, attribute generations on the device and the host, the
    z3 index under the carve-out; the attribute queries (estimator-
    costed), the attribute sketch push-down of MinMax, Histogram,
    Frequency and Count against numpy oracles (cold and warm folds), the
    estimator's choice for the rare-actor continent query, then
    ``compact`` and two queries again."""
    import numpy as np
    import torch
    from geomesa_tpu_torch import TpuDataStore
    from geomesa_tpu_torch.stats.stat import Frequency, Histogram

    cuda = dev.type == "cuda"
    # a dropped lean store frees its device memory only when the cyclic
    # collector runs (PERF.md §7): collect the lean phase's store, so that
    # memory_allocated below reads this phase's
    gc.collect()
    slots = args.lean_attr_slots
    budget = LEAN_ATTR_BUDGET_PER_SLOT * slots
    ud = ["geomesa.index.profile=lean", f"geomesa.lean.hbm.budget={budget}",
          f"geomesa.lean.generation.slots={slots}",
          "geomesa.lean.compaction.factor=0"]
    codes, p = actor_codes(rng)
    ds = TpuDataStore(device=dev)
    ds.create_schema("lattrs", f"{ATTR_SPEC};{','.join(ud)}")
    store = ds._store("lattrs")
    per = args.lean_attr_rows // 4
    parts, write_s = [], []
    for _ in range(4):
        x, y, t, a, s = attr_rows(rng, per, centres, p)
        parts.append((x, y, t, a, s))
        t0 = time.perf_counter()
        ds.write("lattrs", {"actor": codes[a], "score": s, "dtg": t,
                            "geom": (x, y)})
        for key in ("z3", "attr:actor", "attr:score"):
            store._indexes[key].block()
        write_s.append(time.perf_counter() - t0)
    n = 4 * per
    cols = tuple(np.concatenate(c) for c in zip(*parts))
    del parts
    x, y, t, a, s = cols
    if store.batch.column("actor").dtype.kind != "U":
        raise AssertionError("the lean actor column is not fixed-width")
    idxs = {k: store._indexes[k] for k in ("z3", "attr:actor", "attr:score")}
    tiers = {k: i.tier_counts() for k, i in idxs.items()}
    if (tiers["attr:actor"]["host"] == 0 or tiers["attr:score"]["host"] == 0
            or tiers["z3"]["keys"] == 0 or tiers["z3"]["host"] == 0):
        raise AssertionError(f"lean attribute tiers {tiers}")
    dev_bytes = {k: i.device_bytes() for k, i in idxs.items()}
    rep = {"rows": n, "slots": slots, "budget_bytes": budget,
           "write_s": write_s, "write_rows_per_s": [per / w for w in write_s],
           "tiers": tiers, "device_bytes": dev_bytes,
           "device_bytes_total": sum(dev_bytes.values()),
           "memory_allocated": (int(torch.cuda.memory_allocated())
                                if cuda else None),
           "z3_budget_bytes": idxs["z3"].hbm_budget_bytes,
           "attr_budget_bytes": idxs["attr:actor"].hbm_budget_bytes}
    log(f"lean attr: {n} rows in 4 writes "
        f"({', '.join(f'{w:.2f}' for w in write_s)} s); tiers {tiers}; "
        f"accounted device bytes {rep['device_bytes_total']}, allocated "
        f"{rep['memory_allocated']}")

    # the estimator: its cold attribute folds timed apart
    est = store.estimator()
    if est is None:
        raise AssertionError(f"no estimator on a lean store of {n} rows")
    t0 = time.perf_counter()
    est.attr_equals_rows("actor", (RARE_ACTOR,))
    est.attr_range_rows("score", 2.95, 3.05)
    rep["estimator_attr_cold_ms"] = (time.perf_counter() - t0) * 1e3
    qs = attr_queries(codes, centres, lean=True)
    rows = [run_attr_query(ds, "lattrs", q, cols,
                           source=("sketch" if q[0] != "like-U"
                                   else "heuristic"))
            for q in qs]
    lat = np.array([r["ms"] for r in rows])
    rep.update(queries=rows, query_ms_p50=float(np.median(lat)),
               query_ms_max=float(lat.max()))
    log(f"lean attr: estimator cold attribute folds "
        f"{rep['estimator_attr_cold_ms']:.1f} ms; queries equal to the "
        "oracle: " + ", ".join(
            f"{r['query']} {r['strategy']} ({r['source']}) {r['hits']} hits "
            f"{r['candidates']} candidates {r['ms']:.1f} ms" for r in rows))

    # the attribute sketch push-down, cold and warm, against numpy
    routes = StatRoute()
    window = (MS_2018 + 90 * DAY, MS_2018 + 181 * DAY - 1000)
    q_win = (f"BBOX(geom, -180, -90, 180, 90) AND dtg DURING "
             f"{iso(window[0])}/{iso(window[1])}")
    spec = ("Count();MinMax(score);Histogram(score,64,-10,10);"
            "Frequency(score,4,1024)")
    srows = []
    try:
        for name, query, m in (("window", q_win,
                                (t >= window[0]) & (t <= window[1])),
                               ("include", "INCLUDE", None)):
            hit = s if m is None else s[m]
            hist = Histogram("score", 64, -10.0, 10.0)
            hist.observe({"score": hit})
            freq = Frequency("score", 4, 1024)
            freq.observe({"score": hit})
            for turn in ("cold", "warm"):
                t0 = time.perf_counter()
                got, how = routes.run(lambda: ds.stats("lattrs", query,
                                                       spec))
                ms = (time.perf_counter() - t0) * 1e3
                cnt, mm, h, f = got.stats
                if (how != "sketch" or cnt.count != len(hit)
                        or (mm.min, mm.max) != (hit.min(), hit.max())
                        or not np.array_equal(h.counts, hist.counts)
                        or not np.array_equal(f.table, freq.table)):
                    raise AssertionError(f"lean attr stats {name} "
                                         f"({turn}) by {how} disagree with "
                                         f"the oracle")
                srows.append({"query": name, "turn": turn, "ms": ms,
                              "count": int(cnt.count), "route": how})
        # an attribute predicate is not a bbox+time filter: the count
        # materializes through the attribute index in both packages
        t0 = time.perf_counter()
        got, how = routes.run(lambda: ds.stats("lattrs", "score > 9.5",
                                               "Count()"))
        ms = (time.perf_counter() - t0) * 1e3
        want = int((s > 9.5).sum())
        if got.count != want or how != "materialized":
            raise AssertionError(f"lean attr Count(score > 9.5): "
                                 f"{got.count} by {how}, oracle {want}")
        srows.append({"query": "score>9.5", "ms": ms, "count": want,
                      "route": how})
    finally:
        routes.close()
    rep["stats"] = srows
    log("lean attr: stats equal to the oracle: " + ", ".join(
        f"{r['query']} {r.get('turn', '')} {r['ms']:.1f} ms ({r['route']})"
        for r in srows))

    # compaction, then two queries again
    gens = {k: len(i.generations) for k, i in idxs.items()}
    t0 = time.perf_counter()
    res = ds.compact("lattrs")
    for i in idxs.values():
        i.block()
    compact_s = time.perf_counter() - t0
    if not all(k in res for k in idxs):
        raise AssertionError(f"compact covered {sorted(res)}")
    # the host-run merge of the LeanAttrIndex core (which the lean XZ
    # indexes share) must run on the card: at 8 generations each
    # attribute index holds a group of four host runs
    if any(res[k]["merged_groups"] == 0 for k in ("attr:actor", "attr:score")):
        raise AssertionError(f"lean attr compact merged nothing: {res}")
    after = [run_attr_query(ds, "lattrs", q, cols) for q in (qs[0], qs[5])]
    rep["compact"] = {"s": compact_s, "generations_before": gens,
                      "result": res, "queries": after,
                      "device_bytes": {k: i.device_bytes()
                                       for k, i in idxs.items()}}
    log(f"lean attr: compact in {compact_s:.3f} s, generations {gens} → "
        f"{ {k: r['generations'] for k, r in res.items()} }; queries equal "
        "to the oracle: " + ", ".join(f"{r['query']} {r['ms']:.1f} ms"
                                      for r in after))
    report["lean_attr"] = rep
    del ds, store, idxs
    if cuda:
        torch.cuda.empty_cache()


#: the mesh lean phase's budget, in bytes a per-shard generation slot.
#: Each attribute index gets an eighth of it (a quarter split two ways):
#: 48 B, its sentinel charge and live generation at 24 B a slot (an int64
#: gid over a mesh), so every sealed attribute generation spills; the z3
#: index the rest, 288 B: past the sentinel charges (20 + 44 B) room for
#: payload-carrying and keys generations.  A z3 host tier would need the
#: whole budget under 240 B a slot at 8 generations, which leaves the
#: attribute indexes less than their live generation (the same accounting
#: in both packages): the mesh lean z3 phase runs it
MESH_LEAN_BUDGET_PER_SLOT = 384
#: the mesh lean z3 phase: a point schema without attribute indexes at
#: a sixteenth of the mesh lean phase's generation slots (2^19 at the
#: defaults) and 168 B a slot (sentinels 64 B, a live full generation
#: 44 B, three keys generations), so generations pass through the full,
#: keys and host tiers as 8 generations of rows arrive
MESH_LEAN_Z3_BUDGET_PER_SLOT = 168


def mesh_lean_phase(rng, args, centres, qs, dev, report):
    """Lean schemas over ``device_mesh(1)``: ``--mesh-lean-rows`` rows of
    the attribute phases' generator in 4 writes on the lean attribute
    schema at ``--mesh-lean-slots``-slot per-shard generations
    (ShardedLeanZ3Index and two ShardedLeanAttrIndexes); the lean phase's
    queries estimator-costed and one replanned, the attribute queries,
    the Count and Z3Histogram push-downs, heatmaps and tiles before and
    after pyramids, a weighted heatmap (the density kernel), compaction,
    then a flush, a drop and a reopen over ``device_mesh(1)``; the
    accounted device bytes against ``torch.cuda.memory_allocated``.  Then
    a point schema whose z3 generations pass through all three tiers."""
    import numpy as np
    import torch
    from geomesa_tpu_torch import TpuDataStore, density_process, device_mesh
    from geomesa_tpu_torch.index.pyramid import pyramid_spec, tile_env
    from geomesa_tpu_torch.parallel import (
        ShardedLeanAttrIndex, ShardedLeanZ3Index,
    )
    from geomesa_tpu_torch.planning import ExplainString

    cuda = dev.type == "cuda"
    base_alloc = allocated_after_gc(cuda)
    slots = args.mesh_lean_slots
    budget = MESH_LEAN_BUDGET_PER_SLOT * slots
    ud = ["geomesa.index.profile=lean", f"geomesa.lean.hbm.budget={budget}",
          f"geomesa.lean.generation.slots={slots}",
          "geomesa.lean.compaction.factor=0"]
    codes, p = actor_codes(rng)
    cat = tempfile.mkdtemp(prefix="chip_smoke_mesh_lean_")
    rep: dict = {"slots": slots, "budget_bytes": budget}
    try:
        ds = TpuDataStore(device=dev, mesh=device_mesh(1), catalog_dir=cat)
        ds.create_schema("mlean", f"{ATTR_SPEC};{','.join(ud)}")
        store = ds._store("mlean")
        per = args.mesh_lean_rows // 4
        parts, write_s = [], []
        for _ in range(4):
            xp, yp, tp, ap, sp = attr_rows(rng, per, centres, p)
            parts.append((xp, yp, tp, ap, sp))
            t0 = time.perf_counter()
            ds.write("mlean", {"actor": codes[ap], "score": sp, "dtg": tp,
                               "geom": (xp, yp)})
            for key in ("z3", "attr:actor", "attr:score"):
                store._indexes[key].block()
            write_s.append(time.perf_counter() - t0)
        n = 4 * per
        cols = tuple(np.concatenate(c) for c in zip(*parts))
        del parts, xp, yp, tp, ap, sp
        x, y, t, a, s = cols
        idxs = {k: store._indexes[k] for k in ("z3", "attr:actor",
                                               "attr:score")}
        idx = idxs["z3"]
        if not (isinstance(idx, ShardedLeanZ3Index) and all(
                isinstance(idxs[k], ShardedLeanAttrIndex)
                for k in ("attr:actor", "attr:score"))):
            raise AssertionError(f"mesh lean indexes {idxs}")
        tiers = {k: i.tier_counts() for k, i in idxs.items()}
        if (tiers["z3"]["full"] == 0 or tiers["z3"]["keys"] == 0
                or any(tiers[k]["device"] == 0 or tiers[k]["host"] == 0
                       for k in ("attr:actor", "attr:score"))):
            raise AssertionError(f"mesh lean tiers {tiers}")
        # one shard: generation k holds rows [base_k, base_k + n_k)
        layout, base = [], 0
        for g in idx.generations:
            layout.append((base, g.n, g.tier))
            base += g.n
        if base != n:
            raise AssertionError(f"mesh lean generations hold {base} rows")
        dev_bytes = {k: i.device_bytes() for k, i in idxs.items()}
        alloc = (allocated_after_gc(cuda) - base_alloc) if cuda else None
        total_bytes = sum(dev_bytes.values())
        if cuda and abs(alloc / total_bytes - 1.0) > 0.02:
            raise AssertionError(f"mesh lean: {alloc} bytes allocated, "
                                 f"{total_bytes} accounted")
        rep.update(rows=n, write_s=write_s,
                   write_rows_per_s=[per / w for w in write_s], tiers=tiers,
                   generations=len(idx.generations), device_bytes=dev_bytes,
                   device_bytes_total=total_bytes, memory_allocated=alloc,
                   z3_budget_bytes=idx.hbm_budget_bytes,
                   attr_budget_bytes=idxs["attr:actor"].hbm_budget_bytes)
        log(f"mesh lean: {n} rows in 4 writes "
            f"({', '.join(f'{w:.2f}' for w in write_s)} s); tiers {tiers}; "
            f"accounted device bytes {total_bytes}, allocated {alloc}")

        checks = lean_checks(qs)
        t_min, t_max = int(t.min()), int(t.max())
        est = store.estimator()
        if est is None:
            raise AssertionError(f"no estimator on a mesh lean store of {n} "
                                 "rows")
        t0 = time.perf_counter()
        est.z3_rows([WORLD], [(None, None)])
        rep["estimator_cold_ms"] = (time.perf_counter() - t0) * 1e3
        del est   # it holds the store, which the reopen below drops

        def run_query(ds, kind, ecql, boxes, lo, hi, source="sketch"):
            ex = ExplainString()
            t0 = time.perf_counter()
            res = ds.query_result("mlean", ecql, ex)
            ms = (time.perf_counter() - t0) * 1e3
            want = (box_oracle(x, y, boxes) if lo is None
                    else oracle(x, y, t, boxes, lo, hi))
            st = res.strategy
            if (st.index != "z3" or (source and st.source != source)
                    or not np.array_equal(res.positions, want)):
                raise AssertionError(
                    f"mesh lean {kind} {ecql}: strategy {st.index} "
                    f"({st.source}), {len(res.positions)} hits, oracle "
                    f"{len(want)}")
            return {"query": kind, "ms": ms, "hits": int(len(want)),
                    "source": st.source, "max_ranges": st.max_ranges,
                    "replans": str(ex).count("Replanning:")}

        rows = []
        for c in checks:
            d0 = idx.dispatch_count
            row = run_query(ds, *c)
            row["dispatches"] = idx.dispatch_count - d0
            rows.append(row)
        lat = np.array([r["ms"] for r in rows])
        rep.update(queries=rows, query_ms_p50=float(np.median(lat)),
                   query_ms_max=float(lat.max()))
        kind, _q, boxes, _lo, _hi = checks[8]
        with env_set(REPLAN_ENV):
            row = run_query(ds, kind, checks[8][1], boxes, None, None,
                            source="observed")
        if row["replans"] != 1:
            raise AssertionError(f"mesh lean mispredicted {kind}: "
                                 f"{row['replans']} replans, not 1")
        rep["replan"] = row
        aq = attr_queries(codes, centres, lean=True)
        arows = [run_attr_query(ds, "mlean", q, cols, source="sketch")
                 for q in (aq[0], aq[2])]
        rep["attr_queries"] = arows
        log(f"mesh lean: estimator cold fold {rep['estimator_cold_ms']:.1f} "
            f"ms; {len(rows)} queries equal to the oracle, sketch-costed, "
            f"p50 {np.median(lat):.1f} ms, max {lat.max():.1f} ms; "
            f"mispredicted {kind} replanned once ({row['ms']:.1f} ms); "
            + ", ".join(f"{r['query']} {r['strategy']} {r['ms']:.1f} ms"
                        for r in arows))

        # Count and the whole-extent Z3Histogram pushed down
        routes = StatRoute()
        crow = []
        try:
            t0 = time.perf_counter()
            got, how = routes.run(lambda: ds.stats("mlean", "INCLUDE",
                                                   "Count()").count)
            ms = (time.perf_counter() - t0) * 1e3
            if got != n or how != "count":
                raise AssertionError(f"mesh lean Count(): {got} by {how}")
            crow.append({"query": "include", "ms": ms, "route": how})
            t0 = time.perf_counter()
            hist, how = routes.run(lambda: ds.stats(
                "mlean", "INCLUDE", f"Z3Histogram(geom,dtg,week,{Z3_BITS})"))
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            routes.close()
        want = z3_cells_oracle(x, y, t, Z3_BITS)
        if hist.counts != want or how != "sketch":
            raise AssertionError(f"mesh lean Z3Histogram by {how}: "
                                 f"{sum(hist.counts.values())} rows")
        crow.append({"query": f"z3histogram-{Z3_BITS}", "ms": ms,
                     "route": how})
        rep["count"] = crow

        @functools.lru_cache(maxsize=None)
        def world_oracle(res):
            # as in the lean phase: the coarser grid from the 512 one
            if res < 512:
                f = 512 // res
                return world_oracle(512).reshape(res, f, res, f).sum(
                    axis=(1, 3))
            return lean_density_oracle((x, y, t), layout, [WORLD], t_min,
                                       t_max, WORLD, res, res)

        @functools.lru_cache(maxsize=None)
        def tile3_oracle():
            return lean_density_oracle((x, y, t), layout, [env3], t_min,
                                       t_max, env3, 256, 256)

        def check_grid(name, run, want_fn, size=256):
            h0 = idx.pyramid_serve_hits
            t0 = time.perf_counter()
            grid = run()
            ms = (time.perf_counter() - t0) * 1e3
            want = want_fn()
            if grid.shape != (size, size) or not np.array_equal(grid, want):
                raise AssertionError(f"mesh lean density {name}: "
                                     f"{float(grid.sum())} points, oracle "
                                     f"{float(want.sum())}")
            return {"query": name, "ms": ms, "points": float(want.sum()),
                    "pyramid_served": idx.pyramid_serve_hits - h0}

        box = checks[3][2][0]
        tx = int((box[0] + box[2]) / 2 + 180.0) // 180
        ty = 1 - int((box[1] + box[3]) / 2 + 90.0) // 90
        t3x = int(((box[0] + box[2]) / 2 + 180.0) // 45.0)
        t3y = 7 - int(((box[1] + box[3]) / 2 + 90.0) // 22.5)
        env3 = tile_env(3, t3x, t3y)

        def tiles():
            g = world_oracle(512)
            return [
                (f"tile_1_{tx}_{ty}",
                 lambda: ds.density_tile("mlean", 1, tx, ty),
                 lambda: g[(1 - ty) * 256:(2 - ty) * 256,
                           tx * 256:(tx + 1) * 256]),
                (f"tile_3_{t3x}_{t3y}",
                 lambda: ds.density_tile("mlean", 3, t3x, t3y),
                 tile3_oracle)]

        world = ("world", lambda: density_process(ds, "mlean", "INCLUDE",
                                                  WORLD),
                 lambda: world_oracle(256))
        drows = [check_grid(*world)] + [check_grid(*d) for d in tiles()]
        sealed = len(idx.generations) - 1
        t0 = time.perf_counter()
        built = ds.build_pyramids("mlean")
        build_s = time.perf_counter() - t0
        if built != sealed:
            raise AssertionError(f"mesh lean: built {built} pyramids for "
                                 f"{sealed} sealed generations")
        after = [check_grid(*world)] + [check_grid(*d) for d in tiles()]
        if after[0]["pyramid_served"] != sealed:
            raise AssertionError(f"mesh lean world heatmap: "
                                 f"{after[0]['pyramid_served']} of {sealed} "
                                 "sealed generations from pyramids")
        # the weighted heatmap runs the query path and the density kernel
        kind, q_and, boxes, lo, hi = checks[3]
        hits = oracle(x, y, t, boxes, lo, hi)
        t0 = time.perf_counter()
        grid = density_process(ds, "mlean", q_and, box, weight_attr="score")
        ms = (time.perf_counter() - t0) * 1e3
        want = snap_weighted(x[hits], y[hits], s[hits], box, 256, 256)
        if not np.allclose(grid, want, rtol=1e-5, atol=0.0):
            raise AssertionError("mesh lean weighted density disagrees with "
                                 "the oracle")
        rep["density"] = {"before_pyramids": drows, "pyramids_built": built,
                          "pyramids_s": build_s, "after_pyramids": after,
                          "weighted": {"query": kind, "ms": ms,
                                       "points": int(len(hits))}}
        log("mesh lean: Count and Z3Histogram equal to the oracle ("
            + ", ".join(f"{r['query']} {r['ms']:.1f} ms ({r['route']})"
                        for r in crow)
            + f"); {built} pyramids in {build_s:.2f} s; heatmaps before "
            + ", ".join(f"{r['query']} {r['ms']:.1f} ms" for r in drows)
            + ", after " + ", ".join(
                f"{r['query']} {r['ms']:.1f} ms ({r['pyramid_served']} from "
                "pyramids)" for r in after)
            + f"; weighted {ms:.1f} ms")

        # compaction: fewer generations, inherited pyramids, same answers
        gens_before = len(idx.generations)
        t0 = time.perf_counter()
        res = ds.compact("mlean")
        for i in idxs.values():
            i.block()
        compact_s = time.perf_counter() - t0
        # z3 merges keys runs; each attribute index a group of host runs
        if res["z3"]["generations"] >= gens_before or any(
                res[k]["merged_groups"] == 0
                for k in ("attr:actor", "attr:score")):
            raise AssertionError(f"mesh lean compaction left {res}")
        pyr = idx._pyramid_cache.spec_cache(pyramid_spec(512))
        if not all(g.gen_id in pyr for g in idx.generations[:-1]):
            raise AssertionError("mesh lean: a merged generation did not "
                                 "inherit its parents' pyramids")
        wrow = check_grid(*world)
        again = [run_query(ds, *checks[0]), run_query(ds, *checks[6])]
        rep["compact"] = {"s": compact_s, "generations_before": gens_before,
                          "result": res, "world": wrow, "queries": again}
        log(f"mesh lean: compact in {compact_s:.2f} s, {gens_before} → "
            f"{ {k: r['generations'] for k, r in res.items()} } "
            "generations; world heatmap "
            f"{wrow['ms']:.1f} ms ({wrow['pyramid_served']} from pyramids)")

        # flush, drop, reopen over device_mesh(1): the first query rebuilds
        # the sharded index by streaming the snapshot
        catalog_room(cat, n * 48)
        t0 = time.perf_counter()
        ds.flush("mlean")
        flush_s = time.perf_counter() - t0
        on_disk = dir_bytes(cat)
        del ds, store, idx, idxs
        dropped = allocated_after_gc(cuda)
        t0 = time.perf_counter()
        ds = TpuDataStore(device=dev, mesh=device_mesh(1), catalog_dir=cat)
        reopen_s = time.perf_counter() - t0
        store = ds._store("mlean")
        if len(store.batch) != n or store._indexes:
            raise AssertionError(f"mesh lean reopen: {len(store.batch)} rows,"
                                 f" indexes {sorted(store._indexes)}")
        first = run_query(ds, *checks[0], source=None)
        rest = [run_query(ds, *c) for c in checks[1:]]
        idx = store._indexes["z3"]
        grown = (allocated_after_gc(cuda) - dropped) if cuda else None
        if not isinstance(idx, ShardedLeanZ3Index):
            raise AssertionError(f"mesh lean reopen: {type(idx).__name__}")
        lat = np.array([r["ms"] for r in rest])
        rep["persist"] = {
            "flush_s": flush_s, "flush_rows_per_s": n / flush_s,
            "bytes": on_disk, "reopen_s": reopen_s,
            "first_query_ms": first["ms"],
            "recover_s": reopen_s + first["ms"] / 1e3,
            "queries_ms_p50": float(np.median(lat)),
            "tiers": idx.tier_counts(), "device_bytes": idx.device_bytes(),
            "allocated_since_reopen": grown}
        log(f"mesh lean: flushed {n} rows in {flush_s:.2f} s ({on_disk} "
            f"bytes); reopen {reopen_s:.2f} s, first query (the streaming "
            f"rebuild) {first['ms']:.1f} ms, time to recover "
            f"{rep['persist']['recover_s']:.2f} s; the rest p50 "
            f"{np.median(lat):.1f} ms; tiers {idx.tier_counts()}; z3 device "
            f"bytes {idx.device_bytes()} accounted, {grown} allocated since "
            "the reopen")
        del ds, store, idx
    finally:
        shutil.rmtree(cat, ignore_errors=True)
    allocated_after_gc(cuda)

    # a point schema whose z3 generations pass through every tier
    slots = args.mesh_lean_slots >> 4
    budget = MESH_LEAN_Z3_BUDGET_PER_SLOT * slots
    ds = TpuDataStore(device=dev, mesh=device_mesh(1))
    ds.create_schema("mz3", "dtg:Date,*geom:Point;geomesa.index.profile=lean,"
                     f"geomesa.lean.hbm.budget={budget},"
                     f"geomesa.lean.generation.slots={slots},"
                     "geomesa.lean.compaction.factor=0")
    per = 2 * slots
    parts, seen = [], set()
    for _ in range(4):
        xp, yp, tp = gdelt_like(rng, per, centres)
        parts.append((xp, yp, tp))
        ds.write("mz3", {"dtg": tp, "geom": (xp, yp)})
        seen |= {k for k, v in ds._store("mz3").index("z3")
                 .tier_counts().items() if v}
    x, y, t = (np.concatenate(c) for c in zip(*parts))
    idx = ds._store("mz3").index("z3")
    if seen != {"full", "keys", "host"}:
        raise AssertionError(f"mesh lean z3 tiers seen {seen}")
    zrows = []
    for c in checks:
        kind, ecql, boxes, lo, hi = c
        t0 = time.perf_counter()
        res = ds.query_result("mz3", ecql)
        ms = (time.perf_counter() - t0) * 1e3
        want = (box_oracle(x, y, boxes) if lo is None
                else oracle(x, y, t, boxes, lo, hi))
        if not np.array_equal(res.positions, want):
            raise AssertionError(f"mesh lean z3 {kind}: "
                                 f"{len(res.positions)} hits, oracle "
                                 f"{len(want)}")
        zrows.append({"query": kind, "ms": ms, "hits": int(len(want))})
    grid = density_process(ds, "mz3", "INCLUDE", WORLD)
    if grid.sum() != len(x):
        raise AssertionError("mesh lean z3 world heatmap lost rows")
    rep["z3_tiers"] = {"rows": len(x), "slots": slots, "budget": budget,
                       "tiers_seen": sorted(seen),
                       "tiers": idx.tier_counts(), "queries": zrows}
    log(f"mesh lean z3: {len(x)} rows; tiers seen {sorted(seen)}, at the "
        f"end {idx.tier_counts()}; {len(zrows)} queries equal to the oracle")
    report["mesh_lean"] = rep
    del ds, idx
    allocated_after_gc(cuda)


#: poly_scale_proof.py's OSM-building-shaped stream (``_slice_data``):
#: footprint centres drawn from four hotspots (New York, Paris, Beijing,
#: Johannesburg) with σ = 15° in x and 10° in y, half-sides U(0.0005,
#: 0.01)°, and a kind of road/building/park/water/rare
POLY_HOTSPOTS = ((-74.0, 40.7), (2.3, 48.8), (116.4, 39.9), (28.0, -26.2))
POLY_KINDS = ("road", "building", "park", "water", "rare")
POLY_KIND_P = (0.4, 0.4, 0.1, 0.0999, 0.0001)
POLY_SPEC = "kind:String:index=true,dtg:Date,*geom:Polygon"
LEAN_POLY_SPEC = "kind:String:index=true,*geom:Polygon"
#: the lean polygon phases' budget, in bytes a generation slot: the xz
#: index gets 0.75 of it (45 B: its sentinel charge and device
#: generations of 20 B slots, the rest on the host); the kind index its
#: floor of two class-default generations
LEAN_POLY_BUDGET_PER_SLOT = 60
#: the mesh lean polygon phases' budget a per-shard slot: the xz index
#: gets 75 B (its sentinel charge and two device generations at 24 B a
#: slot — the live one and one sealed — the rest on the host), the kind
#: index its floor of two class-default generations
MESH_LEAN_POLY_BUDGET_PER_SLOT = 100
#: the continent window of the polygon phases: South America, away from
#: the hotspots (the widest range plan, a sparse tail of rows)
CONTINENT = (-85.0, -56.0, -34.0, 12.0)


def footprints(rng, n: int):
    """``n`` footprints as ``poly_scale_proof._slice_data`` draws them:
    ``(bbox (n, 4), kind index, dtg uniform over 2018)``."""
    import numpy as np
    hs = np.asarray(POLY_HOTSPOTS)
    hot = rng.integers(0, len(hs), n)
    x = np.clip(hs[hot, 0] + rng.normal(0, 15.0, n), -179.8, 179.8)
    y = np.clip(hs[hot, 1] + rng.normal(0, 10.0, n), -84.8, 84.8)
    w = rng.uniform(0.0005, 0.01, n)
    h = rng.uniform(0.0005, 0.01, n)
    bbox = np.stack([x - w, y - h, x + w, y + h], axis=1)
    kind = rng.choice(len(POLY_KINDS), n, p=POLY_KIND_P).astype(np.uint8)
    t = rng.integers(MS_2018, MS_2019, n)
    return bbox, kind, t


def rect_box(bb, box, chunk: int = 1 << 24):
    """Rows whose rectangle meets ``box`` (closed intervals on both
    axes): the oracle of a BBOX query over axis-aligned footprints."""
    import numpy as np
    out = []
    for lo in range(0, len(bb), chunk):
        b = bb[lo:lo + chunk]
        out.append(lo + np.flatnonzero(
            (b[:, 0] <= box[2]) & (b[:, 2] >= box[0])
            & (b[:, 1] <= box[3]) & (b[:, 3] >= box[1])))
    return np.concatenate(out)


def rect_convex(bb, ring):
    """Rows whose rectangle meets the convex polygon ``ring`` (vertices,
    not closed): the separating-axis test over both rectangle axes and
    every edge normal of the polygon, closed intervals."""
    import numpy as np
    pts = np.asarray(ring, np.float64)
    env = (pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(),
           pts[:, 1].max())
    cand = rect_box(bb, env)
    b = bb[cand]
    keep = np.ones(len(cand), bool)
    for i in range(len(pts)):
        (ax, ay), (bx, by) = pts[i], pts[(i + 1) % len(pts)]
        nx, ny = by - ay, ax - bx
        proj = pts[:, 0] * nx + pts[:, 1] * ny
        rmin = (np.minimum(nx * b[:, 0], nx * b[:, 2])
                + np.minimum(ny * b[:, 1], ny * b[:, 3]))
        rmax = (np.maximum(nx * b[:, 0], nx * b[:, 2])
                + np.maximum(ny * b[:, 1], ny * b[:, 3]))
        keep &= (rmax >= proj.min()) & (rmin <= proj.max())
    return cand[keep]


def _wkt_ring(ring) -> str:
    pts = list(ring) + [ring[0]]
    return ", ".join(f"{x} {y}" for x, y in pts)


def poly_queries(rng, n_rows: int, dtg: bool, lean: bool) -> list:
    """The polygon phases' queries as dicts: ``name``, ``ecql``, the
    expected ``strategy``, the query ``env`` and time window (for the
    range-planning timings) and ``oracle(bb, kind, t)`` → positions."""
    import numpy as np
    (nyx, nyy), (pax, pay), (bjx, bjy), (jox, joy) = POLY_HOTSPOTS
    city = [(nyx - 0.6, nyy - 0.5), (nyx + 0.6, nyy - 0.3),
            (nyx, nyy + 0.6)]
    region = [(pax - 3.0, pay - 2.5), (pax + 3.0, pay - 2.0),
              (pax + 0.5, pay + 3.0)]
    bj_box = (bjx - 2.0, bjy - 1.5, bjx + 2.0, bjy + 1.5)
    jo_tri = [(jox - 2.5, joy - 2.0), (jox + 2.5, joy - 1.5),
              (jox, joy + 2.5)]
    continent = [(-82.0, 12.0), (-34.0, -6.0), (-70.0, -56.0)]
    day = MS_2018 + int(rng.integers(0, 360)) * DAY
    day_w = (day, day + DAY - 1000)
    week = MS_2018 + int(rng.integers(0, 350)) * DAY
    week_w = (week, week + 7 * DAY - 1000)
    rare = POLY_KINDS.index("rare")
    ids = np.sort(rng.choice(n_rows, 5, replace=False))

    def env_of(ring):
        a = np.asarray(ring)
        return (a[:, 0].min(), a[:, 1].min(), a[:, 0].max(), a[:, 1].max())

    def inter(ring):
        return f"INTERSECTS(geom, POLYGON(({_wkt_ring(ring)})))"

    def bbox(b):
        return f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})"

    def during(w):
        return f"dtg DURING {iso(w[0])}/{iso(w[1])}"

    def inwin(t, w):
        return (t >= w[0]) & (t <= w[1])

    def q(name, ecql, strategy, env, window, oracle):
        return {"name": name, "ecql": ecql, "strategy": strategy,
                "env": env, "window": window, "oracle": oracle}

    qs = []
    if dtg:
        qs += [
            q("city-day", f"{inter(city)} AND {during(day_w)}", "xz3",
              env_of(city), day_w,
              lambda bb, k, t: (lambda c: c[inwin(t[c], day_w)])(
                  rect_convex(bb, city))),
            q("region-week", f"{inter(region)} AND {during(week_w)}", "xz3",
              env_of(region), week_w,
              lambda bb, k, t: (lambda c: c[inwin(t[c], week_w)])(
                  rect_convex(bb, region))),
            q("during-day", during(day_w), "xz3", WORLD, day_w,
              lambda bb, k, t: np.flatnonzero(inwin(t, day_w))),
        ]
    strategy2 = "xz2" if not (lean and dtg) else "xz3"
    window2 = None if strategy2 == "xz2" else (None, None)
    qs += [
        q("bbox-city", bbox(bj_box), strategy2, bj_box, window2,
          lambda bb, k, t: rect_box(bb, bj_box)),
        q("intersects-region", inter(jo_tri), strategy2, env_of(jo_tri),
          window2, lambda bb, k, t: rect_convex(bb, jo_tri)),
        q("intersects-continent", inter(continent), strategy2,
          env_of(continent), window2,
          lambda bb, k, t: rect_convex(bb, continent)),
    ]
    if lean and not dtg:
        qs += [
            q("intersects-city", inter(city), "xz2", env_of(city), None,
              lambda bb, k, t: rect_convex(bb, city)),
            q("bbox-continent", bbox(CONTINENT), "xz2", CONTINENT, None,
              lambda bb, k, t: rect_box(bb, CONTINENT)),
        ]
    if not (lean and dtg):
        qs += [
            q("rare-continent", f"kind = 'rare' AND {bbox(CONTINENT)}",
              "attr:kind", None, None,
              lambda bb, k, t: (lambda c: c[k[c] == rare])(
                  rect_box(bb, CONTINENT))),
            q("ids", "IN (" + ", ".join(f"'{i}'" for i in ids) + ")", "id",
              None, None, lambda bb, k, t: ids),
        ]
    return qs


def run_poly_query(ds, schema, q, cols, sweeps: bool) -> dict:
    """One polygon-phase query: strategy as expected, positions equal to
    the oracle; its ms, the explain trace's candidate count, and (with
    ``sweeps``) its range planning timed with the native sweep and with
    the numpy sweep, whose outputs must agree."""
    import re
    import numpy as np
    from geomesa_tpu_torch.planning import ExplainString
    ex = ExplainString()
    t0 = time.perf_counter()
    res = ds.query_result(schema, q["ecql"], ex)
    ms = (time.perf_counter() - t0) * 1e3
    want = q["oracle"](*cols)
    if res.strategy.index != q["strategy"]:
        raise AssertionError(f"poly {q['name']}: strategy "
                             f"{res.strategy.index}, expected "
                             f"{q['strategy']}")
    if not np.array_equal(res.positions, want):
        raise AssertionError(f"poly {q['name']}: {len(res.positions)} "
                             f"hits, oracle {len(want)}")
    scanned = re.search(r"scanned (\d+)", str(ex))
    row = {"query": q["name"], "strategy": res.strategy.index, "ms": ms,
           "plan_ms": res.plan_time_ms, "scan_ms": res.scan_time_ms,
           "hits": int(len(want)),
           "candidates": int(scanned.group(1)) if scanned else None}
    if sweeps and q["env"] is not None and q["strategy"] in ("xz2", "xz3"):
        row.update(zip(("ranges", "ranges_native_ms", "ranges_numpy_ms"),
                       xz_range_sweeps(ds._store(schema), q)))
    return row


def xz_range_sweeps(store, q):
    """A query's covering-range plan, timed with the native sweep and
    again with the numpy sweep (both packages' fallback); the two plans
    must be equal.  Returns ``(ranges, native ms, numpy ms)``."""
    from geomesa_tpu_torch import native
    from geomesa_tpu_torch.config import DEFAULT_MAX_RANGES
    from geomesa_tpu_torch.index.xz3 import xz3_bin_code_ranges
    idx = store._indexes.get(q["strategy"]) or store.index(q["strategy"])
    env = q["env"]
    if q["strategy"] == "xz2":
        def plan():
            return [tuple(r) for r in idx.sfc.ranges(
                [env], max_ranges=DEFAULT_MAX_RANGES).tolist()]
    else:
        lo, hi = q["window"]
        if lo is None:
            lo = idx.t_min_ms if hasattr(idx, "t_min_ms") else int(
                idx.dtg.min())
            hi = idx.t_max_ms if hasattr(idx, "t_max_ms") else int(
                idx.dtg.max())

        def plan():
            return xz3_bin_code_ranges(idx.sfc, env, lo, hi, idx.period,
                                       DEFAULT_MAX_RANGES)
    return sweep_pair(plan)


def sweep_pair(plan):
    """``(len(plan()), native ms, numpy ms)`` of one range-planning call,
    the numpy one with the native dispatch switched off; raises when the
    two disagree."""
    from geomesa_tpu_torch import native
    t0 = time.perf_counter()
    a = plan()
    native_ms = (time.perf_counter() - t0) * 1e3
    saved = native.zranges_native, native.xz_ranges_native
    native.zranges_native = native.xz_ranges_native = (
        lambda *args, **kw: None)
    try:
        t0 = time.perf_counter()
        b = plan()
        numpy_ms = (time.perf_counter() - t0) * 1e3
    finally:
        native.zranges_native, native.xz_ranges_native = saved
    if not _same_plan(a, b):
        raise AssertionError("the native and numpy sweeps disagree")
    return getattr(a, "num_ranges", None) or len(a), native_ms, numpy_ms


def _same_plan(a, b) -> bool:
    import numpy as np
    if hasattr(a, "rbin"):
        return all(np.array_equal(getattr(a, k), getattr(b, k))
                   for k in ("rbin", "rzlo", "rzhi"))
    return a == b


def z3_sweeps(qs) -> list:
    """The z3 index phase's plans (``plan_z3_query`` of each of its
    queries) timed with the native sweep and the numpy sweep."""
    from geomesa_tpu_torch.index.z3 import plan_z3_query
    rows = []
    for kind, boxes, lo, hi in qs:
        n, a, b = sweep_pair(lambda: plan_z3_query(boxes, lo, hi, "week"))
        rows.append({"kind": kind, "plan_native_ms": a,
                     "plan_numpy_ms": b})
    return rows


def _poly_write(ds, schema, bb, kind, t, lean: bool):
    """One write of footprints, packed object-free."""
    import numpy as np
    from geomesa_tpu_torch.geometry.packed import packed_from_boxes
    names = np.array(POLY_KINDS)
    data = {"kind": names[kind] if lean else names[kind].astype(object),
            "geom": packed_from_boxes(bb)}
    if t is not None:
        data["dtg"] = t
    t0 = time.perf_counter()
    ds.write(schema, data)
    return time.perf_counter() - t0


def _poly_store_phase(rng, args, dev, report, key: str, mesh: bool):
    """The default-profile polygon store (``polys``) or its one-card mesh
    twin (``mesh_polys``): rows in 4 writes, the xz3, xz2, attribute and
    id queries against the oracles; the default store then takes a
    1M-row append the kept indexes serve as their tail, and the mesh
    store a stats call."""
    import numpy as np
    import torch
    from geomesa_tpu_torch import TpuDataStore, device_mesh
    from geomesa_tpu_torch.process.density import density_process
    from geomesa_tpu_torch.stats.stat import Histogram

    n = args.poly_mesh_rows if mesh else args.poly_rows
    ds = (TpuDataStore(device=dev, mesh=device_mesh(1)) if mesh
          else TpuDataStore(device=dev))
    ds.create_schema("polys", POLY_SPEC)
    store = ds._store("polys")
    per = n // 4
    parts, write_s = [], []
    for _ in range(4):
        bb, kind, t = footprints(rng, per)
        parts.append((bb, kind, t))
        write_s.append(_poly_write(ds, "polys", bb, kind, t, lean=False))
    cols = tuple(np.concatenate(c) for c in zip(*parts))
    build = {}
    for name in ("xz3", "xz2"):
        t0 = time.perf_counter()
        idx = store.index(name)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        build[name] = time.perf_counter() - t0
        want = ("ShardedXZ3Index", "ShardedXZ2Index") if mesh else (
            "XZ3Index", "XZ2Index")
        if type(idx).__name__ not in want:
            raise AssertionError(f"{key}: {name} index is "
                                 f"{type(idx).__name__}")
    t0 = time.perf_counter()
    store.attribute_index("kind")
    build["attr:kind"] = time.perf_counter() - t0
    qs = poly_queries(rng, 4 * per, dtg=True, lean=False)
    rows = [run_poly_query(ds, "polys", q, cols, sweeps=not mesh)
            for q in qs]
    rep = {"rows": 4 * per, "write_s": write_s,
           "write_rows_per_s": [per / w for w in write_s],
           "build_s": build, "queries": rows}
    # a heatmap over polygons: the reference bins x/y columns, which a
    # polygon schema does not have, and raises; so does the port
    try:
        density_process(ds, "polys", "INCLUDE", WORLD, 256, 256)
        raise AssertionError(f"{key}: a polygon heatmap answered")
    except KeyError as e:
        rep["heatmap"] = f"KeyError {e}"
    if mesh:
        spec = f"Count();Histogram(dtg,64,{MS_2018},{MS_2019})"
        q = next(q for q in qs if q["name"] == "bbox-city")
        t0 = time.perf_counter()
        got = ds.stats("polys", q["ecql"], spec)
        ms = (time.perf_counter() - t0) * 1e3
        hit = cols[2][q["oracle"](*cols)]
        hist = Histogram("dtg", 64, MS_2018, MS_2019)
        hist.observe({"dtg": hit})
        if (got.stats[0].count != len(hit)
                or not np.array_equal(got.stats[1].counts, hist.counts)):
            raise AssertionError(f"{key}: stats disagree with the oracle")
        rep["stats"] = {"spec": spec, "ms": ms, "count": int(len(hit))}
    else:
        m = min(1_000_000, per * 4 // 8)
        bb, kind, t = footprints(rng, m)
        parts.append((bb, kind, t))
        rep["append_s"] = _poly_write(ds, "polys", bb, kind, t, lean=False)
        cols = tuple(np.concatenate(c) for c in zip(*parts))
        rep["after_append"] = [run_poly_query(ds, "polys", q, cols,
                                              sweeps=False) for q in qs]
        tails = {k: store.index_tail(k) for k in ("xz3", "xz2")}
        if (any(v is None or len(v) != m for v in tails.values())
                or store.build_counts.get("xz3") != 1):
            raise AssertionError(f"{key}: kept xz indexes, builds "
                                 f"{store.build_counts}")
        rep["build_counts"] = dict(store.build_counts)
    report[key] = rep
    log(f"{key}: {4 * per} rows in 4 writes "
        f"({', '.join(f'{w:.2f}' for w in write_s)} s); built "
        + ", ".join(f"{k} {v:.2f} s" for k, v in build.items())
        + "; queries equal to the oracle: "
        + ", ".join(f"{r['query']} {r['strategy']} {r['hits']} hits "
                    f"{r['candidates']} candidates {r['ms']:.1f} ms"
                    + (f" (ranges {r['ranges']}: native "
                       f"{r['ranges_native_ms']:.2f} ms, numpy "
                       f"{r['ranges_numpy_ms']:.2f} ms)"
                       if "ranges" in r else "") for r in rows)
        + f"; heatmap {rep['heatmap']}"
        + (f"; stats {rep['stats']['ms']:.1f} ms" if mesh else
           f"; after a {len(parts[-1][0])}-row append "
           f"({rep['append_s']:.2f} s): "
           + ", ".join(f"{r['query']} {r['ms']:.1f} ms"
                       for r in rep["after_append"])))
    del ds, store


def polys_phase(rng, args, dev, report):
    """Polygons on the default profile (host xz3/xz2 indexes)."""
    _poly_store_phase(rng, args, dev, report, "polys", mesh=False)


def mesh_polys_phase(rng, args, dev, report):
    """Polygons on a one-card mesh (ShardedXZ3Index / ShardedXZ2Index)."""
    _poly_store_phase(rng, args, dev, report, "mesh_polys", mesh=True)


def _lean_poly_phase(rng, args, dev, report, key: str, n: int, dtg: bool,
                     slots: int, mesh: bool = False):
    """A lean polygon store: ``n`` footprints in 4 writes at ``slots``-slot
    generations under the lean polygon budget; its tiers (device and host
    generations both), accounted and allocated device bytes, the queries
    against the oracles, then ``compact`` and the first query again.
    With ``mesh`` the store is on ``device_mesh(1)`` (the sharded lean XZ
    and attribute indexes) under the mesh budget a slot."""
    import numpy as np
    import torch
    from geomesa_tpu_torch import TpuDataStore, device_mesh

    cuda = dev.type == "cuda"
    # a dropped store frees its device memory at the cyclic collector
    base_alloc = allocated_after_gc(cuda)
    budget = (MESH_LEAN_POLY_BUDGET_PER_SLOT if mesh
              else LEAN_POLY_BUDGET_PER_SLOT) * slots
    ud = ["geomesa.index.profile=lean", f"geomesa.lean.hbm.budget={budget}",
          f"geomesa.lean.generation.slots={slots}",
          "geomesa.lean.compaction.factor=0"]
    spec = POLY_SPEC if dtg else LEAN_POLY_SPEC
    ds = TpuDataStore(device=dev, mesh=device_mesh(1) if mesh else None)
    ds.create_schema(key, f"{spec};{','.join(ud)}")
    store = ds._store(key)
    kind_key = "xz3" if dtg else "xz2"
    per = n // 4
    parts, write_s = [], []
    for _ in range(4):
        bb, kind, t = footprints(rng, per)
        parts.append((bb, kind, t))
        t0 = time.perf_counter()
        _poly_write(ds, key, bb, kind, t if dtg else None, lean=True)
        for k in (kind_key, "attr:kind"):
            store._indexes[k].block()
        write_s.append(time.perf_counter() - t0)
    cols = tuple(np.concatenate(c) for c in zip(*parts))
    del parts
    if store.lean_kind != kind_key:
        raise AssertionError(f"{key}: lean kind {store.lean_kind}")
    idxs = {k: store._indexes[k] for k in (kind_key, "attr:kind")}
    tiers = {k: i.tier_counts() for k, i in idxs.items()}
    dev_bytes = {k: i.device_bytes() for k, i in idxs.items()}
    rep = {"rows": 4 * per, "slots": slots, "budget_bytes": budget,
           "write_s": write_s, "write_rows_per_s": [per / w for w in write_s],
           "tiers": tiers, "device_bytes": dev_bytes,
           "device_bytes_total": sum(dev_bytes.values()),
           "memory_allocated": (int(torch.cuda.memory_allocated())
                                if cuda else None),
           "allocated_in_phase": ((allocated_after_gc(cuda) - base_alloc)
                                  if cuda else None)}
    if tiers[kind_key]["device"] == 0 or tiers[kind_key]["host"] == 0:
        raise AssertionError(f"{key}: tiers {tiers}")
    if mesh and type(idxs[kind_key]).__name__ != (
            "ShardedLeanXZ3Index" if dtg else "ShardedLeanXZ2Index"):
        raise AssertionError(f"{key}: {type(idxs[kind_key]).__name__}")
    log(f"{key}: {4 * per} rows in 4 writes "
        f"({', '.join(f'{w:.2f}' for w in write_s)} s); tiers {tiers}; "
        f"accounted device bytes {rep['device_bytes_total']}, allocated "
        f"{rep['memory_allocated']}")
    qs = poly_queries(rng, 4 * per, dtg=dtg, lean=True)
    rows = [run_poly_query(ds, key, q, cols, sweeps=not mesh) for q in qs]
    lat = np.array([r["ms"] for r in rows])
    rep.update(queries=rows, query_ms_p50=float(np.median(lat)),
               query_ms_max=float(lat.max()))
    log(f"{key}: queries equal to the oracle: " + ", ".join(
        f"{r['query']} {r['strategy']} {r['hits']} hits {r['candidates']} "
        f"candidates {r['ms']:.1f} ms"
        + (f" (ranges {r['ranges']}: native {r['ranges_native_ms']:.2f} "
           f"ms, numpy {r['ranges_numpy_ms']:.2f} ms)"
           if "ranges" in r else "") for r in rows))
    t0 = time.perf_counter()
    res = ds.compact(key)
    for i in idxs.values():
        i.block()
    compact_s = time.perf_counter() - t0
    if set(res) != set(idxs):
        raise AssertionError(f"{key}: compact covered {sorted(res)}")
    # the lean tracks' generations leave a group of four host runs (the
    # mesh stores' generations, sized by rows a step at 4M-row writes,
    # fall in two size classes of at most three host runs each)
    if dtg and not mesh and res[kind_key]["merged_groups"] == 0:
        raise AssertionError(f"{key}: compact merged nothing: {res}")
    after = run_poly_query(ds, key, qs[0], cols, sweeps=False)
    rep["compact"] = {"s": compact_s, "result": res, "query": after}
    log(f"{key}: compact in {compact_s:.3f} s ({res}); {after['query']} "
        f"again equal to the oracle, {after['ms']:.1f} ms")
    report[key] = rep
    del ds, store, idxs
    if cuda:
        torch.cuda.empty_cache()


def lean_polys_phase(rng, args, dev, report):
    """The lean XZ2 store: poly_scale_proof's schema, ``--lean-poly-rows``
    rows at ``--lean-slots`` generations, device and host ones."""
    _lean_poly_phase(rng, args, dev, report, "lean_polys",
                     args.lean_poly_rows, dtg=False, slots=args.lean_slots)


def mesh_lean_polys_phase(rng, args, dev, report):
    """The lean polygon and tracks stores over ``device_mesh(1)``
    (ShardedLeanXZ2Index, ShardedLeanXZ3Index): ``--mesh-lean-poly-rows``
    footprints without a dtg and ``--mesh-lean-poly3-rows`` with one, at
    ``--mesh-lean-poly-slots``-slot per-shard generations, device and host
    generations both."""
    _lean_poly_phase(rng, args, dev, report, "mesh_lean_polys",
                     args.mesh_lean_poly_rows, dtg=False,
                     slots=args.mesh_lean_poly_slots, mesh=True)
    _lean_poly_phase(rng, args, dev, report, "mesh_lean_tracks",
                     args.mesh_lean_poly3_rows, dtg=True,
                     slots=args.mesh_lean_poly_slots, mesh=True)


def lean_tracks_phase(rng, args, dev, report):
    """The lean XZ3 store: the same footprints with a dtg over 2018,
    ``--lean-poly3-rows`` rows at ``--lean-poly3-slots`` generations
    (device and host ones, and a compaction that merges host runs); a
    spatio-temporal, a spatial-only (open, clamped interval) and a
    temporal-only query."""
    _lean_poly_phase(rng, args, dev, report, "lean_tracks",
                     args.lean_poly3_rows, dtg=True,
                     slots=args.lean_poly3_slots)


def kernel_entry(name: str, replaces: str, launches: int, rows: list,
                 row: dict) -> dict:
    """One kernel's entry of the ``{"kernels": [...]}`` line."""
    return {"name": name, "route": "cuda",
            "source": f"geomesa_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--points", type=int, default=100_000_000)
    ap.add_argument("--facade-rows", type=int, default=16_000_000)
    ap.add_argument("--places-rows", type=int, default=4_000_000)
    ap.add_argument("--mesh-rows", type=int, default=16_000_000)
    ap.add_argument("--lean-rows", type=int, default=80_000_000,
                    help="rows of the lean phase: a first write of the "
                         "lean switch's 32M rows, then the rest in 3")
    ap.add_argument("--lean-slots", type=int, default=1 << 23,
                    help="slots per generation of the lean and lean "
                         "polygon phases")
    ap.add_argument("--attr-rows", type=int, default=12_000_000,
                    help="rows of the default-profile attribute phase")
    ap.add_argument("--attr-mesh-rows", type=int, default=4_000_000,
                    help="rows of the mesh attribute phase")
    ap.add_argument("--lean-attr-rows", type=int, default=64_000_000,
                    help="rows of the lean attribute phase")
    ap.add_argument("--lean-attr-slots", type=int, default=1 << 23,
                    help="slots per generation of the lean attribute phase "
                         "(8 generations at the default rows)")
    ap.add_argument("--mesh-lean-rows", type=int, default=64_000_000,
                    help="rows of the mesh lean phase")
    ap.add_argument("--mesh-lean-slots", type=int, default=1 << 23,
                    help="per-shard slots per generation of the mesh lean "
                         "phase")
    ap.add_argument("--poly-rows", type=int, default=8_000_000,
                    help="rows of the default-profile polygon phase")
    ap.add_argument("--poly-mesh-rows", type=int, default=8_000_000,
                    help="rows of the mesh polygon phase")
    ap.add_argument("--lean-poly-rows", type=int, default=32_000_000,
                    help="rows of the lean XZ2 polygon phase")
    ap.add_argument("--lean-poly3-rows", type=int, default=16_000_000,
                    help="rows of the lean XZ3 polygon phase")
    ap.add_argument("--lean-poly3-slots", type=int, default=1 << 21,
                    help="slots per generation of the lean XZ3 phase (8 "
                         "generations at 16M rows: device and host tiers, "
                         "and a compaction that merges host runs)")
    ap.add_argument("--mesh-lean-poly-rows", type=int, default=16_000_000,
                    help="rows of the mesh lean XZ2 polygon phase")
    ap.add_argument("--mesh-lean-poly3-rows", type=int, default=8_000_000,
                    help="rows of the mesh lean XZ3 polygon phase")
    ap.add_argument("--mesh-lean-poly-slots", type=int, default=1 << 21,
                    help="per-shard slots per generation of the mesh lean "
                         "polygon phases")
    ap.add_argument("--life-rows", type=int, default=6_000_000,
                    help="rows of the lifecycle and legacy phases")
    ap.add_argument("--life-mesh-rows", type=int, default=4_000_000,
                    help="rows of the mesh lifecycle phase")
    ap.add_argument("--fsds-rows", type=int, default=2_000_000,
                    help="rows of the FileSystemDataStore phase")
    ap.add_argument("--profile", action="store_true",
                    help="profile the z3 and z2 index queries, the mesh "
                         "phase's stats, query and heatmap, and the lean "
                         "queries once more (torch.profiler) into the "
                         "report")
    ap.add_argument("--out", default=None,
                    help="also write the full report as JSON to this file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from geomesa_tpu_torch.ops import build as kbuild
    except ImportError as e:
        print(f"chip_smoke: the geomesa_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    import numpy as np
    from geomesa_tpu_torch.ops.density_kernel import density_grid_kernel
    from geomesa_tpu_torch.ops.hist1d_kernel import hist1d
    from geomesa_tpu_torch.ops.z2_mask import z2_mask
    from geomesa_tpu_torch.ops.z3_mask import z3_mask

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    log(f"device: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    report = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "seed": args.seed}

    t0 = time.perf_counter()
    libs = kbuild.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {sorted(libs)} in {report['build_s']:.2f} s")
    # the native range sweep (g++), which every range plan goes through
    from geomesa_tpu_torch import native
    if not native.available():
        raise AssertionError(f"the native range sweep is not available: "
                             f"{native.build_error()}")
    report["native"] = {"available": True,
                        "load_s": native.build_seconds()}
    log(f"build: native range sweep available, built and loaded in "
        f"{native.build_seconds():.2f} s")

    rng = np.random.default_rng(args.seed)
    centres = np.stack([rng.uniform(-130.0, 150.0, 50),
                        rng.uniform(-40.0, 60.0, 50)], axis=1)
    z3_rows = kernel_phase(rng, dev)
    z2_rows = z2_kernel_phase(rng, dev)
    dens_rows = density_kernel_phase(rng, centres, dev)
    hist_rows = hist1d_kernel_phase(rng, dev)
    report["kernel"] = {"z3_mask": z3_rows, "z2_mask": z2_rows,
                        "density_grid": dens_rows, "hist1d": hist_rows}

    # the main path: counts set to 0 just before, read just after
    counters = {"z3_mask": z3_mask, "z2_mask": z2_mask,
                "density_grid": density_grid_kernel}
    for fn in counters.values():
        fn.launches = 0
    phase_s = report.setdefault("phase_s", {})
    t0 = time.perf_counter()
    x, y, m, qs = index_phase(rng, args, centres, dev, report)
    phase_s["index"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    z2_index_phase(args, x, y, m, qs, dev, report)
    phase_s["z2_index"] = time.perf_counter() - t0
    del x, y
    t0 = time.perf_counter()
    ds = facade_phase(rng, args, centres, dev, report)
    places_phase(rng, args, centres, ds, report)
    phase_s["facade_places"] = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path was never launched on "
                             f"the main path: {launches}")
    report["main_path_launches"] = launches
    del ds
    torch.cuda.empty_cache()

    # the mesh path: every count set to 0 just before, read just after
    counters["hist1d"] = hist1d
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    mesh_phase(rng, args, centres, dev, report)
    phase_s["mesh"] = time.perf_counter() - t0
    mesh_launches = {k: fn.launches for k, fn in counters.items()}
    if min(mesh_launches.values()) <= 0:
        raise AssertionError(f"a kernel of the mesh path was never launched "
                             f"on it: {mesh_launches}")
    report["mesh_path_launches"] = mesh_launches

    # the lean path: every count set to 0 just before, read just after;
    # the store keeps a catalog, flushed at the end, which the lean
    # persist path reopens (its own counts)
    persist_launches = {}
    lean_cat = tempfile.mkdtemp(prefix="chip_smoke_lean_")
    try:
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        lean = lean_phase(rng, args, centres, qs, dev, report, cat=lean_cat)
        phase_s["lean"] = time.perf_counter() - t0
        lean_launches = {k: fn.launches for k, fn in counters.items()}
        if lean_launches["density_grid"] <= 0:
            raise AssertionError(f"density_grid was never launched on the "
                                 f"lean path: {lean_launches}")
        report["lean_path_launches"] = lean_launches
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        lean_persist_phase(args, dev, report, lean)
        phase_s["lean_persist"] = time.perf_counter() - t0
        persist_launches["lean_persist"] = {k: fn.launches
                                            for k, fn in counters.items()}
        del lean
    finally:
        shutil.rmtree(lean_cat, ignore_errors=True)
    torch.cuda.empty_cache()

    # the attribute paths (default profile and mesh, then lean): counts
    # set to 0 just before each, read just after
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    attr_phase(rng, args, centres, dev, report)
    phase_s["attr"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh_attr_phase(rng, args, centres, dev, report)
    phase_s["mesh_attr"] = time.perf_counter() - t0
    attr_launches = {k: fn.launches for k, fn in counters.items()}
    if attr_launches["z3_mask"] <= 0:
        raise AssertionError(f"z3_mask was never launched on the attribute "
                             f"path: {attr_launches}")
    report["attr_path_launches"] = attr_launches
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    lean_attr_phase(rng, args, centres, dev, report)
    phase_s["lean_attr"] = time.perf_counter() - t0
    report["lean_attr_path_launches"] = {k: fn.launches
                                         for k, fn in counters.items()}

    # the lean schemas over a mesh (ShardedLeanZ3Index and the sharded
    # attribute indexes): counts set to 0 just before, read just after.
    # Their scans run no kernel (the JAX package's sharded lean programs
    # reach no Pallas kernel); the weighted heatmap's query path launches
    # density_grid
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    mesh_lean_phase(rng, args, centres, qs, dev, report)
    phase_s["mesh_lean"] = time.perf_counter() - t0
    mesh_lean_launches = {k: fn.launches for k, fn in counters.items()}
    if mesh_lean_launches["density_grid"] <= 0:
        raise AssertionError(f"density_grid was never launched on the mesh "
                             f"lean path: {mesh_lean_launches}")
    report["mesh_lean_path_launches"] = mesh_lean_launches
    log(f"mesh lean path: launches {mesh_lean_launches}, "
        f"{phase_s['mesh_lean']:.1f} s")
    log(f"attribute paths: launches {attr_launches}, lean "
        f"{report['lean_attr_path_launches']}; "
        + ", ".join(f"{k} {v:.1f} s" for k, v in phase_s.items()))

    # the polygon paths (xz3/xz2 on the default profile, the mesh and the
    # lean profile): counts set to 0 just before each, read just after.
    # The JAX package runs no Pallas kernel on them (its xz programs are
    # host numpy or plain XLA), so none is required here; the counts are
    # reported
    report["z3_sweeps"] = z3_sweeps(qs)
    xz_launches = {}
    for name, phase in (("polys", polys_phase),
                        ("mesh_polys", mesh_polys_phase),
                        ("lean_polys", lean_polys_phase),
                        ("lean_tracks", lean_tracks_phase),
                        ("mesh_lean_polys", mesh_lean_polys_phase)):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        phase(rng, args, dev, report)
        phase_s[name] = time.perf_counter() - t0
        xz_launches[name] = {k: fn.launches for k, fn in counters.items()}
    report["xz_path_launches"] = xz_launches

    # the lifecycle paths (deletes, visibilities, the read APIs, the v1
    # layouts, the mesh after a delete): counts set to 0 just before
    # each, read just after; each must launch the kernels it runs
    life_launches = {}
    need = {"lifecycle": ("z3_mask", "z2_mask", "density_grid"),
            "legacy": ("z3_mask", "z2_mask"),
            "mesh_lifecycle": ("z3_mask", "z2_mask", "hist1d")}
    life_cat = tempfile.mkdtemp(prefix="chip_smoke_life_")
    try:
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        chunks, cols, cands, life = lifecycle_phase(
            rng, args, centres, qs, dev, report, cat=life_cat)
        phase_s["lifecycle"] = time.perf_counter() - t0
        life_launches["lifecycle"] = {k: fn.launches
                                      for k, fn in counters.items()}
        # the persist path: the lifecycle store's catalog reopened
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        persist_phase(args, qs, dev, report, life)
        phase_s["persist"] = time.perf_counter() - t0
        persist_launches["persist"] = {k: fn.launches
                                       for k, fn in counters.items()}
        del life
    finally:
        shutil.rmtree(life_cat, ignore_errors=True)
    torch.cuda.empty_cache()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    legacy_phase(args, chunks, cols, cands, qs, dev, report)
    phase_s["legacy"] = time.perf_counter() - t0
    life_launches["legacy"] = {k: fn.launches for k, fn in counters.items()}
    del chunks, cols
    torch.cuda.empty_cache()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    mesh_lifecycle_phase(rng, args, centres, qs, dev, report)
    phase_s["mesh_lifecycle"] = time.perf_counter() - t0
    life_launches["mesh_lifecycle"] = {k: fn.launches
                                       for k, fn in counters.items()}
    for phase, names in need.items():
        if min(life_launches[phase][k] for k in names) <= 0:
            raise AssertionError(f"a kernel of the {phase} path was never "
                                 f"launched on it: {life_launches[phase]}")
    report["life_path_launches"] = life_launches
    log(f"lifecycle paths: launches {life_launches}; "
        + ", ".join(f"{k} {phase_s[k]:.1f} s" for k in life_launches))

    # the FileSystemDataStore lifted onto the card: counts set to 0 just
    # before, read just after
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    fsds_phase(rng, args, centres, qs, dev, report)
    phase_s["fsds"] = time.perf_counter() - t0
    persist_launches["fsds"] = {k: fn.launches for k, fn in counters.items()}
    need = {"persist": ("z3_mask", "z2_mask", "density_grid", "hist1d"),
            "fsds": ("z3_mask", "z2_mask")}
    for phase, names in need.items():
        if min(persist_launches[phase][k] for k in names) <= 0:
            raise AssertionError(f"a kernel of the {phase} path was never "
                                 f"launched on it: {persist_launches[phase]}")
    report["persist_path_launches"] = persist_launches
    log(f"persistence paths: launches {persist_launches}; "
        + ", ".join(f"{k} {phase_s[k]:.1f} s" for k in persist_launches))
    z3s = report["z3_sweeps"]
    log(f"polygon paths: launches {xz_launches}; "
        + ", ".join(f"{k} {phase_s[k]:.1f} s" for k in xz_launches)
        + "; z3 plans native "
        f"{sum(r['plan_native_ms'] for r in z3s):.1f} ms, numpy "
        f"{sum(r['plan_numpy_ms'] for r in z3s):.1f} ms over "
        f"{len(z3s)} queries")
    report["total_s"] = time.perf_counter() - t_start

    def pick(rows, **kw):
        return next(r for r in rows
                    if all(r[k] == v for k, v in kw.items()))

    src = "geomesa_tpu/ops/pallas_kernels.py"
    kernels = {"kernels": [
        kernel_entry("z3_mask", f"{src}:404", launches["z3_mask"], z3_rows,
                     pick(z3_rows, n=1 << 22, r=8)),
        # the shape most z2 scans of the main path give the kernel
        kernel_entry("z2_mask", f"{src}:485", launches["z2_mask"], z2_rows,
                     pick(z2_rows, n=1 << 24, r=1)),
        kernel_entry("density_grid", f"{src}:305", launches["density_grid"],
                     dens_rows, pick(dens_rows, dist="clustered",
                                     weights="unit", grid=256,
                                     masked_in_share=0.5)),
        # the mesh phase's shape: its per-shard slots, a Histogram stat
        kernel_entry("hist1d", f"{src}:554", mesh_launches["hist1d"],
                     hist_rows, pick(hist_rows, n=16_000_000, bins=64,
                                     weights="unit", masked_in_share=0.5)),
    ]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    log(f"total: {report['total_s']:.1f} s")
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
