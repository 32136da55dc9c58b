#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0] [--points 100000000]
                          [--facade-rows 16000000] [--places-rows 4000000]
                          [--mesh-rows 16000000] [--profile] [--out FILE]

Phases, each of which fails the run (non-zero exit) when it fails:

1. device: the card's name and power limit (``nvidia-smi``), torch/CUDA;
2. build: every kernel of ``geomesa_tpu_torch/csrc`` with ``nvcc``, one
   compiler per source, all started together, from this checkout;
3. kernel: each kernel's wrapper on the card against its plain PyTorch
   version (z3_mask and z2_mask bit for bit at 2^22 and 2^22 + 37
   candidates, z2_mask also at 2^24, the capacity its scan reaches on the
   main path, R = 1 and 8; density_grid at 2^24 clustered and uniform
   points, 256x256 and 1024x1024 grids, unit weights bit for bit and
   random weights within rtol 1e-6; hist1d at 16M rows, the mesh phase's
   per-shard slot count, and 2^22 + 37, 64, 1024 and 65,536 bins, ids
   past both ends, unit weights bit for bit and random weights within
   rtol 1e-5), timed with CUDA events beside the plain version and, where
   one exists, a PyTorch library call;
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
   times per Frequency, and never on the int64 route.

The kernel launch counts are set to 0 just before phase 4 and read just
after phase 6, and again just before and after phase 7; a kernel of a
path that was never launched on it fails the run.  The last lines printed are one ``{"kernels": [...]}`` JSON object,
the ``nvidia-smi`` name/power-limit line, and ``{"ok": true, "device":
...}``.  Without a CUDA device, or without the ``geomesa_tpu_torch``
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import datetime as dt
import json
import subprocess
import sys
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
    1024x1024, ~50% of the points masked in; unit weights bit for bit,
    random float64 weights within rtol 1e-6 (float64 atomics sum in an
    order that changes from run to run, then round to float32)."""
    import numpy as np
    import torch
    from geomesa_tpu_torch.ops.density_kernel import (
        density_grid_kernel, density_grid_kernel_reference,
    )

    n = 1 << 24
    rows = []
    for dist in ("clustered", "uniform"):
        if dist == "clustered":
            x, y, _ = gdelt_like(rng, n, centres)
        else:
            x = rng.uniform(-180.0, 180.0, n)
            y = rng.uniform(-90.0, 90.0, n)
        xd, yd = (torch.tensor(a, device=dev) for a in (x, y))
        mask = torch.tensor(rng.random(n) < 0.5, device=dev)
        n_in = int(mask.sum())
        for weights in ("unit", "random"):
            w = (torch.ones(n, dtype=torch.float64, device=dev)
                 if weights == "unit" else
                 torch.tensor(rng.uniform(0.5, 2.0, n), device=dev))
            for size in (256, 1024):
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
                        f"({dist}, {weights}, {size}x{size}): max abs err "
                        f"{err}")
                total = float(got.double().sum())
                if weights == "unit" and total != n_in:
                    raise AssertionError(f"density grid holds {total} "
                                         f"points, not {n_in}")
                # the library yardstick leaves the snap out: one
                # torch.bincount over cells snapped beforehand
                xmin, ymin, xmax, ymax = WORLD
                ix = torch.clamp(torch.floor((xd - xmin) / ((xmax - xmin)
                                                            / size)),
                                 0, size - 1).long()
                iy = torch.clamp(torch.floor((yd - ymin) / ((ymax - ymin)
                                                            / size)),
                                 0, size - 1).long()
                cells = (iy * size + ix)[mask]
                w_in = w[mask].float().double()
                k1 = cuda_ms(lambda: density_grid_kernel(*args), 20)
                p1 = cuda_ms(lambda: density_grid_kernel_reference(*args), 5)
                l1 = cuda_ms(lambda: torch.bincount(
                    cells, w_in, minlength=size * size), 20)
                k2 = cuda_ms(lambda: density_grid_kernel(*args), 20)
                p2 = cuda_ms(lambda: density_grid_kernel_reference(*args), 5)
                l2 = cuda_ms(lambda: torch.bincount(
                    cells, w_in, minlength=size * size), 20)
                del cells, w_in
                # this run's data: the mask byte of every point, x, y and w
                # of the masked-in ones, the float32 grid written once;
                # ~30 float64 instructions per masked-in point (two
                # subtract-divide-floor-clamp chains, the division some 10)
                b_ms, b_by = bound(n + 24 * n_in + 4 * size * size,
                                   30 * n_in, FP64_OPS_PER_S)
                rows.append({"n": n, "dist": dist, "weights": weights,
                             "grid": size, "masked_in": n_in,
                             "max_abs_err": err, "total": total,
                             "ms": min(k1, k2), "plain_ms": min(p1, p2),
                             "library_ms": min(l1, l2),
                             "bound_ms": b_ms, "bound_by": b_by})
                log(f"kernel density_grid {dist} {weights} {size}x{size} "
                    f"N={n}: equal (max abs err {err:g}), "
                    f"{rows[-1]['ms']:.4f} ms (plain "
                    f"{rows[-1]['plain_ms']:.4f} ms, bincount "
                    f"{rows[-1]['library_ms']:.4f} ms, bound {b_ms:.4f} ms "
                    f"by {b_by})")
        del xd, yd, mask, w
    torch.cuda.empty_cache()
    return rows


def hist1d_kernel_phase(rng, dev):
    """The hist1d kernel against its plain version at 16M rows (the mesh
    phase's per-shard slot count) and a ragged 2^22 + 37, at 64 bins (a
    Histogram stat), 1024 (a Frequency width) and 65,536 (wider than a
    block's shared memory: the global-atomic branch); ids run 16 past
    both ends of the bins, ~50% of the rows are masked in; unit weights
    bit for bit, random weights within rtol 1e-5 (float32 atomics sum in
    an order that changes from run to run)."""
    import numpy as np
    import torch
    from geomesa_tpu_torch.ops.hist1d_kernel import hist1d, hist1d_reference

    rows = []
    for n in (16_000_000, (1 << 22) + 37):
        mask = torch.tensor(rng.random(n) < 0.5, device=dev)
        n_in = int(mask.sum())
        for n_bins in (64, 1024, 65_536):
            bins = torch.tensor(rng.integers(-16, n_bins + 16, n,
                                             dtype=np.int32), device=dev)
            keep = mask & (bins >= 0) & (bins < n_bins)
            n_kept = int(keep.sum())
            for weights in ("unit", "random"):
                w = (torch.ones(n, dtype=torch.float32, device=dev)
                     if weights == "unit" else
                     torch.tensor(rng.uniform(0.0, 3.0, n).astype(np.float32),
                                  device=dev))
                args = (bins, w, mask, n_bins)
                got = hist1d(*args)
                want = hist1d_reference(*args)
                torch.cuda.synchronize()
                err = float((got.double() - want.double()).abs().max())
                ok = (torch.equal(got, want) if weights == "unit" else
                      bool(torch.allclose(got, want, rtol=1e-5, atol=0)))
                if not ok:
                    raise AssertionError(
                        f"hist1d kernel disagrees with its plain version at "
                        f"N={n} bins={n_bins} ({weights}): max abs err {err}")
                if weights == "unit" and float(got.double().sum()) != n_kept:
                    raise AssertionError(f"hist1d counts {got.sum()} rows, "
                                         f"not {n_kept}")
                # the library yardstick leaves the mask and the range test
                # out: one torch.bincount over ids and weights prepared
                # beforehand
                ids = torch.where(keep, bins, 0).long()
                w_in = torch.where(keep, w, 0.0)
                k1 = cuda_ms(lambda: hist1d(*args), 20)
                p1 = cuda_ms(lambda: hist1d_reference(*args), 3)
                l1 = cuda_ms(lambda: torch.bincount(ids, w_in,
                                                    minlength=n_bins), 10)
                k2 = cuda_ms(lambda: hist1d(*args), 20)
                p2 = cuda_ms(lambda: hist1d_reference(*args), 3)
                l2 = cuda_ms(lambda: torch.bincount(ids, w_in,
                                                    minlength=n_bins), 10)
                del ids, w_in, w
                # this run's data: the mask byte of every row, the bin id
                # and weight of each masked-in row, the float32 output once;
                # a range test and an add per masked-in row
                b_ms, b_by = bound(n + 8 * n_in + 4 * n_bins, 3 * n_in,
                                   INT32_OPS_PER_S)
                rows.append({"n": n, "bins": n_bins, "weights": weights,
                             "masked_in": n_in, "max_abs_err": err,
                             "ms": min(k1, k2), "plain_ms": min(p1, p2),
                             "library_ms": min(l1, l2),
                             "library": "torch.bincount, mask and range "
                                        "test left out",
                             "bound_ms": b_ms, "bound_by": b_by})
                log(f"kernel hist1d N={n} bins={n_bins} {weights}: equal "
                    f"(max abs err {err:g}), {rows[-1]['ms']:.4f} ms (plain "
                    f"{rows[-1]['plain_ms']:.4f} ms, bincount "
                    f"{rows[-1]['library_ms']:.4f} ms, bound {b_ms:.4f} ms "
                    f"by {b_by})")
            del bins, keep
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
    ap.add_argument("--profile", action="store_true",
                    help="profile the z3 and z2 index queries, and the mesh "
                         "phase's stats, query and heatmap, once more "
                         "(torch.profiler) into the report")
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
    x, y, m, qs = index_phase(rng, args, centres, dev, report)
    z2_index_phase(args, x, y, m, qs, dev, report)
    del x, y
    ds = facade_phase(rng, args, centres, dev, report)
    places_phase(rng, args, centres, ds, report)
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
    mesh_phase(rng, args, centres, dev, report)
    mesh_launches = {k: fn.launches for k, fn in counters.items()}
    if min(mesh_launches.values()) <= 0:
        raise AssertionError(f"a kernel of the mesh path was never launched "
                             f"on it: {mesh_launches}")
    report["mesh_path_launches"] = mesh_launches
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
                                     weights="unit", grid=256)),
        # the mesh phase's shape: its per-shard slots, a Histogram stat
        kernel_entry("hist1d", f"{src}:554", mesh_launches["hist1d"],
                     hist_rows, pick(hist_rows, n=16_000_000, bins=64,
                                     weights="unit")),
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
