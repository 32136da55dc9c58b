#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0] [--points 100000000]
                          [--facade-rows 16000000] [--profile] [--out FILE]

Phases, each of which fails the run (non-zero exit) when it fails:

1. device: the card's name and power limit (``nvidia-smi``), torch/CUDA;
2. build: every kernel of ``geomesa_tpu_torch/csrc`` with ``nvcc``, from
   the sources in this checkout;
3. kernel: each kernel's wrapper on the card against its plain PyTorch
   version, bit for bit, and both timed with CUDA events;
4. index: ``Z3PointIndex.build`` over ``--points`` GDELT-like points (70%
   Gaussian clusters around 50 cities, 30% uniform, dtg uniform over 2018,
   WEEK bins), a 1M-row append, and 20 BBOX+DURING queries (city, region,
   continent; at least one on the two-phase path), each hit set equal to
   a chunked numpy brute-force oracle;
5. facade: ``TpuDataStore(device="cuda")`` on schema ``gdelt``:
   ``--facade-rows`` rows written in 4 batches with a query after the
   first (later writes take the append path), then ECQL BBOX+DURING, an
   OR of two DURING windows, and INCLUDE, positions equal to the oracle.

The kernel launch counts are set to 0 just before phase 4 and read just
after phase 5; a kernel of the path that was never launched fails the
run.  The last lines printed are one ``{"kernels": [...]}`` JSON object,
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
            lo = rng.integers(0, 1 << 21, (r_real, 2))
            ixy = np.concatenate(
                [lo, np.minimum(lo + rng.integers(1 << 16, 1 << 20,
                                                  (r_real, 2)),
                                (1 << 21) - 1)], axis=1)
            ixy = np.concatenate(   # never-matching padded boxes
                [ixy, np.tile([[1, 1, 0, 0]], (r - r_real, 1))])
            ixy = torch.tensor(ixy.astype(np.int32), device=dev)
            got = z3_mask(z, ixy, tlo, thi)
            want = z3_mask_reference(z, ixy, tlo, thi)
            torch.cuda.synchronize()
            err = int((got.to(torch.int32) - want.to(torch.int32))
                      .abs().max())
            if err != 0 or not torch.equal(got, want):
                raise AssertionError(
                    f"z3_mask kernel disagrees with its plain version at "
                    f"N={n} R={r}: {int((got != want).sum())} mismatches")
            hits = int(want.sum())
            if not 0 < hits < n:
                raise AssertionError(f"degenerate kernel case: {hits} hits")
            args = (z, ixy, tlo, thi)
            k1 = cuda_ms(lambda: z3_mask(*args), 50)
            p1 = cuda_ms(lambda: z3_mask_reference(*args), 10)
            k2 = cuda_ms(lambda: z3_mask(*args), 50)
            p2 = cuda_ms(lambda: z3_mask_reference(*args), 10)
            nbytes = n * (8 + 4 + 4 + 1) + r * 16
            # 32-bit integer operations per candidate, counted low (the
            # card has no 64-bit integer pipe): each 64-bit shift is one
            # funnel shift per 32-bit half and each xor-then-and one
            # three-input logic op per half, so z >> 1 and z >> 2 take 4,
            # each of the 3 de-interleaves 2 + 5 * 4 = 22; each box 4
            # predicate-chained compares; the time test 2
            ops = n * (4 + 3 * 22 + 4 * r + 2)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / INT32_OPS_PER_S * 1e3
            rows.append({"n": n, "r": r, "hits": hits, "max_abs_err": err,
                         "ms": min(k1, k2), "plain_ms": min(p1, p2),
                         "bound_ms": max(bytes_ms, ops_ms),
                         "bound_by": "bytes" if bytes_ms >= ops_ms
                         else "operations"})
            log(f"kernel z3_mask N={n} R={r}: equal, {hits} hits, "
                f"{rows[-1]['ms']:.4f} ms (plain {rows[-1]['plain_ms']:.4f} "
                f"ms, bound {rows[-1]['bound_ms']:.4f} ms)")
    return rows


def index_phase(rng, args, centres, dev, report):
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
        report["index"]["profile"] = profile_queries(idx, qs)
    del idx
    torch.cuda.empty_cache()


def profile_queries(idx, qs) -> dict:
    """One more pass over the queries under ``torch.profiler``: wall time,
    device time (its sum and share of the wall), and the kernels that
    took the most device time.  These queries' launches count with the
    main path's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _, boxes, lo, hi in qs:
            idx.query(boxes, lo, hi)
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
    log(f"profile: {len(qs)} queries, wall {wall_ms:.1f} ms, device "
        f"{device_ms:.1f} ms ({100 * device_ms / wall_ms:.1f}% busy); top: "
        + ", ".join(f"{t['name'][:40]} {t['device_ms']:.2f} ms x{t['calls']}"
                    for t in out["top"][:5]))
    return out


def facade_phase(rng, args, centres, dev, report):
    import numpy as np
    from geomesa_tpu_torch import TpuDataStore
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
    w1 = (MS_2018 + 40 * DAY, MS_2018 + 47 * DAY - 1)
    w2 = (MS_2018 + 200 * DAY, MS_2018 + 203 * DAY - 1)
    q_and = (f"BBOX(geom, {box[0]}, {box[1]}, {box[2]}, {box[3]}) AND dtg "
             f"DURING {iso(w1[0])}/{iso(w1[1])}")
    q_or = (f"BBOX(geom, {box[0]}, {box[1]}, {box[2]}, {box[3]}) AND (dtg "
            f"DURING {iso(w1[0])}/{iso(w1[1])} OR dtg DURING "
            f"{iso(w2[0])}/{iso(w2[1])})")
    launches0 = z3_mask.launches
    write_s = []
    for i in range(4):
        x, y, t = gdelt_like(rng, per, centres)
        xs.append(x), ys.append(y), ts.append(t)
        t0 = time.perf_counter()
        ds.write("gdelt", {"actor": actors[rng.integers(0, len(actors), per)],
                           "dtg": t, "geom": (x, y)})
        write_s.append(time.perf_counter() - t0)
        if i == 0:  # builds the z3 index: the later writes append to it
            ds.query_result("gdelt", q_and)
    x, y, t = (np.concatenate(p) for p in (xs, ys, ts))
    store = ds._store("gdelt")
    if store.build_counts != {"z3": 1} or len(store.z3_index()) != 4 * per:
        raise AssertionError(f"z3 index not appended to: "
                             f"{store.build_counts}, {len(store.z3_index())}")
    checks = [
        ("bbox_during", q_and, "z3", oracle(x, y, t, [box], *w1)),
        ("bbox_or_during", q_or, "z3",
         np.union1d(oracle(x, y, t, [box], *w1),
                    oracle(x, y, t, [box], *w2))),
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
        if not np.array_equal(res.positions, want):
            raise AssertionError(f"{name}: {len(res.positions)} hits, "
                                 f"oracle {len(want)}")
        rows.append({"query": name, "ms": ms, "hits": int(len(want)),
                     "plan_ms": res.plan_time_ms,
                     "scan_ms": res.scan_time_ms})
    grew = z3_mask.launches - launches0
    if grew <= 0:
        raise AssertionError("z3_mask was not launched in the facade phase")
    report["facade"] = {"rows": 4 * per, "write_s": write_s,
                        "write_rows_per_s": [per / s for s in write_s],
                        "queries": rows, "z3_mask_launches": grew}
    log(f"facade: {4 * per} rows in 4 writes "
        f"({', '.join(f'{s:.2f}' for s in write_s)} s); queries equal to "
        f"the oracle: " + ", ".join(f"{r['query']} {r['hits']} hits "
                                    f"{r['ms']:.1f} ms" for r in rows)
        + f"; z3_mask launches {grew}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--points", type=int, default=100_000_000)
    ap.add_argument("--facade-rows", type=int, default=16_000_000)
    ap.add_argument("--profile", action="store_true",
                    help="profile the index queries once more "
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
    kernel_rows = kernel_phase(rng, dev)
    report["kernel"] = kernel_rows

    # the main path: counts set to 0 just before, read just after
    z3_mask.launches = 0
    index_phase(rng, args, centres, dev, report)
    facade_phase(rng, args, centres, dev, report)
    launches = z3_mask.launches
    if launches <= 0:
        raise AssertionError("z3_mask was never launched on the main path")
    report["main_path_launches"] = {"z3_mask": launches}
    report["total_s"] = time.perf_counter() - t_start

    big = [r for r in kernel_rows if r["n"] == 1 << 22 and r["r"] == 8][0]
    kernels = {"kernels": [{
        "name": "z3_mask", "route": "cuda",
        "source": "geomesa_tpu_torch/csrc/z3_mask.cu",
        "replaces": "geomesa_tpu/ops/pallas_kernels.py:404",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
        "library_ms": None,
    }]}
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
