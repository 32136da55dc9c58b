// Density histogram: a weighted, masked 2-D histogram of points over a grid.
//
// Replaces geomesa_tpu/ops/pallas_kernels.py: density_grid_pallas (wrapper)
// and _density_kernel (body), the TPU kernel behind
// geomesa_tpu/ops/density.py: density_grid_auto.  Same contract:
//   density_grid(x, y, w: float64[N], mask: bool[N], env, W, H) -> float32[H, W]
// Each masked-in point lands in cell (iy, ix) with
//   ix = clamp(floor((x - xmin) / dx), 0, W - 1), dx = (xmax - xmin) / W
// (and likewise iy), and adds its weight cast to float32.  The sums are
// taken in float64 and rounded to float32 once, as the JAX package's
// density_grid_sorted does, so unit-weight grids equal the float64 counts
// of its CPU path cast to float32, bit for bit (below 2^53 per cell).
//
// Keep the contract, not the method.  The TPU kernel was a one-hot matrix
// product per (grid tile, chunk of points), carrying each tile's sum in
// VMEM scratch from one grid step to the next: that works only where the
// grid runs in order on one core.  Here blocks run in parallel and in no
// order.
//
// The snap must agree cell for cell with the plain version.  dx and dy
// come from the host, computed in float64 as the JAX package computes
// them; the kernel divides (no multiply by a reciprocal, no fused
// multiply-add: the expression has none, and the build uses no fast-math
// flag), floors, and clamps in double before converting to int (a point
// far outside a deep tile's envelope is ~3e11 cells away and would
// overflow an int).
//
// Bound.  The bound counts what the inputs need: the mask byte of every
// point, x, y and w (24 bytes) of each masked-in one, the float32 grid
// written once; 2^24 points half masked in take 0.065 ms at 3.35 TB/s on
// an H100 SXM.  The float64 work (two subtract-divide-floor-clamp chains,
// the division a reciprocal-and-refine sequence of some 10 instructions)
// is ~30 instructions a point at ~16.75e12 float64 instructions/s: bytes
// bound the kernel.  Memory moves in 32-byte sectors, so a random mask
// saves almost nothing (a sector of 4 doubles is skipped only when all 4
// points are masked out, 1 in 16 at 50%): streaming every input, 2^24
// points take 0.125 ms whatever the mask, and that is the floor a
// masked-row kernel can reach.
//
// Design.
// - Streaming: the rows are cut into tiles of 512 a warp, each warp
//   walking a contiguous share of them.  A lane loads 16 mask bytes as one
//   16-byte vector into the warp's stage in shared memory, and x, y and w
//   as double2 vectors, neighbouring lanes on neighbouring addresses,
//   whether the rows are masked in or not (a random mask fetches every
//   sector anyway), so no load waits on the mask: 4 x 3 vectors a lane
//   are in flight per half tile.  Rows past the last whole tile, and every
//   row when a pointer is not 16-byte aligned, go one a lane.
// - Counts in shared memory: float64 (and float32) adds into shared
//   memory compile to compare-and-swap loops on sm_90a (``cuobjdump
//   -sass``: ATOMS.CAST.SPIN.64, and ATOM.E.CAST.SPIN.64 into another
//   block's shared memory), while integer adds are native.  So a row whose
//   weight, cast to float32, is exactly 1 (every heatmap on the main path)
//   adds 1 to a uint32 counter: in a private grid per block when the grid
//   fits a block's shared memory (``cluster`` 1), else in one spread over
//   the distributed shared memory of a thread-block cluster (up to 16
//   blocks, cell c owned by block c % cluster at slot c / cluster, through
//   cluster::map_shared_rank; 256x256 counts are 256 KB), else (1024x1024
//   is 4 MB) with global integer atomics (``cluster`` 0).  Each block (or
//   cluster) that counted anything writes its counts, without atomics, to
//   the next free row of a [parts, G] uint32 scratch (one atomic a block
//   hands out rows); one that counted nothing (every weight other than 1)
//   writes none.  Any other weight adds with a native float64 atomic into
//   a zeroed global grid.  A second pass sums each cell's written count
//   rows as integers, adds the float64 grid once and rounds to float32:
//   unit-weight grids are exact whatever the order, and no float64 atomic
//   serialises on a hot cell for them.
// - Hot cells, in the global branch: a warp whose neighbouring lanes hit
//   one cell with other weights first sums them per cell (match.any, then
//   shuffles in a tree) and one lane adds, and goes on merging while cells
//   repeat (hist_launch.cuh: merge_hot); a half tile whose weights are all
//   1 skips the test.  The merge buys 5x where every point falls in a few
//   cells and costs some 5% on spread ones; beside a shared grid even the
//   test cost the unit-weight rows 2% (measured in PERF.md), so there the
//   float64 adds go unmerged.
// - The launch shape (branch, cluster size, blocks, shared memory, parts)
//   is chosen by shape in Python (geomesa_tpu_torch/ops/density_kernel.py:
//   launch_shape) from the card's occupancy (density_grid_resident).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hist_launch.cuh"

namespace cg = cooperative_groups;
using namespace hist_launch;

namespace {

__device__ __forceinline__ long long snap(double v, double lo, double d,
                                          int cells) {
    const double f = floor((v - lo) / d);
    return static_cast<long long>(
        fmin(fmax(f, 0.0), static_cast<double>(cells - 1)));
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
density_accumulate(const double* __restrict__ x,
                   const double* __restrict__ y,
                   const double* __restrict__ w,
                   const unsigned char* __restrict__ mask, long long n,
                   int vec, double xmin, double ymin, double dx,
                   double dy, int width, int height, int slice, int shift,
                   double* __restrict__ acc, unsigned* __restrict__ part,
                   unsigned* __restrict__ rows) {
    extern __shared__ __align__(16) unsigned char smem[];
    const unsigned lane = threadIdx.x & 31;
    unsigned char* stage = smem + (threadIdx.x >> 5) * kTile;
    unsigned* cnt = reinterpret_cast<unsigned*>(smem + kStageBytes);
    const long long g = static_cast<long long>(width) * height;
    bool counted = false;  // this thread added a count in shared memory
    bool hot = false;      // the warp merges its float adds (merge_hot)

    if constexpr (kMode != kGlobal) {
        for (int j = threadIdx.x; j < slice; j += kThreads) cnt[j] = 0u;
        if constexpr (kMode == kCluster) cg::this_cluster().sync();
        else __syncthreads();
    }

    // ``merge`` (std::true_type or std::false_type): in the global branch,
    // some lane of the warp may add a weight other than 1; without it the
    // visit holds no warp vote, so the lanes never wait on each other
    auto visit = [&](bool keep, double xv, double yv, double wv,
                     auto merge) {
        unsigned key = kNone | lane;
        double v = 0.0;
        if (keep) {
            key = static_cast<unsigned>(snap(yv, ymin, dy, height) * width
                                        + snap(xv, xmin, dx, width));
            const float wf = __double2float_rn(wv);
            v = static_cast<double>(wf);
            if (wf == 1.0f) {
                // a count: a native integer add in (distributed) shared
                // memory, or in global memory
                if constexpr (kMode == kGlobal) {
                    atomicAdd(part + key, 1u);
                } else if constexpr (kMode == kBlock) {
                    atomicAdd(cnt + key, 1u);
                } else {
                    atomicAdd(cg::this_cluster().map_shared_rank(
                                  cnt + (key >> shift),
                                  key & ((1u << shift) - 1)),
                              1u);
                }
                counted = true;
                key = kNone | lane;
            }
        }
        // any other weight: a float64 add into global memory, hot cells
        // merged within the warp first
        bool add = !(key & kNone);
        if constexpr (decltype(merge)::value) {
            add = merge_hot(key, v, hot) && add;
        }
        if (add) atomicAdd(acc + key, v);
    };

    // whole tiles: a contiguous share of them per warp
    const long long gw =
        static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
    const long long tw = static_cast<long long>(gridDim.x) * kWarps;
    const long long tiles = vec ? n / kTile : 0;
    const long long t1 = (gw + 1) * tiles / tw;
    for (long long t = gw * tiles / tw; t < t1; ++t) {
        const long long base = t * kTile;
        const uint4 m16 =
            __ldg(reinterpret_cast<const uint4*>(mask + base) + lane);
        const double2* x2 = reinterpret_cast<const double2*>(x + base);
        const double2* y2 = reinterpret_cast<const double2*>(y + base);
        const double2* w2 = reinterpret_cast<const double2*>(w + base);
        double2 xa[4], ya[4], wa[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            xa[k] = __ldg(x2 + k * 32 + lane);
            ya[k] = __ldg(y2 + k * 32 + lane);
            wa[k] = __ldg(w2 + k * 32 + lane);
        }
        __syncwarp();  // every lane has read the previous tile's stage
        reinterpret_cast<uint4*>(stage)[lane] = m16;
        __syncwarp();
        const unsigned short* m2 =
            reinterpret_cast<const unsigned short*>(stage);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            if (h == 1) {
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    xa[k] = __ldg(x2 + (4 + k) * 32 + lane);
                    ya[k] = __ldg(y2 + (4 + k) * 32 + lane);
                    wa[k] = __ldg(w2 + (4 + k) * 32 + lane);
                }
            }
            auto half = [&](auto merge) {
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const unsigned mm = m2[(h * 4 + k) * 32 + lane];
                    visit((mm & 0xffu) != 0, xa[k].x, ya[k].x, wa[k].x,
                          merge);
                    visit((mm >> 8) != 0, xa[k].y, ya[k].y, wa[k].y, merge);
                }
            };
            if constexpr (kMode == kGlobal) {
                bool floats = false;
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    floats |= __double2float_rn(wa[k].x) != 1.0f
                              || __double2float_rn(wa[k].y) != 1.0f;
                }
                if (__any_sync(0xffffffffu, floats)) half(std::true_type{});
                else half(std::false_type{});
            } else {
                // beside a shared grid the merge cost the unit-weight
                // rows more than it saved (measured in PERF.md)
                half(std::false_type{});
            }
        }
    }
    // the ragged tail (every row when a pointer is unaligned), a row a lane
    for (long long i0 = tiles * kTile + gw * 32; i0 < n; i0 += tw * 32) {
        const long long i = i0 + lane;
        const bool keep = i < n && __ldg(mask + i);
        double xv = 0.0, yv = 0.0, wv = 0.0;
        if (keep) {
            xv = __ldg(x + i);
            yv = __ldg(y + i);
            wv = __ldg(w + i);
        }
        visit(keep, xv, yv, wv,
              std::integral_constant<bool, kMode == kGlobal>{});
    }

    // write the partial counts, without atomics, to the next free row of
    // ``part`` (``rows`` counts them); a block or cluster that counted
    // nothing (every weight other than 1) takes no row.  Each block's
    // flag and row sit in the mask stage: every warp is past its rows.
    unsigned* mine = reinterpret_cast<unsigned*>(smem);
    if constexpr (kMode == kBlock) {
        if (!__syncthreads_or(counted)) return;
        if (threadIdx.x == 0) mine[1] = atomicAdd(rows, 1u);
        __syncthreads();
        unsigned* dst = part + static_cast<long long>(mine[1]) * g;
        for (int j = threadIdx.x; j < g; j += kThreads) dst[j] = cnt[j];
    } else if constexpr (kMode == kCluster) {
        const int any = __syncthreads_or(counted);
        if (threadIdx.x == 0) mine[0] = any;
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();  // every add of the cluster has landed
        const unsigned c = cluster.num_blocks();
        unsigned cluster_any = 0;
        for (unsigned r = 0; r < c; ++r) {
            cluster_any |= *cluster.map_shared_rank(mine, r);
        }
        if (cluster_any) {
            if (threadIdx.x == 0 && cluster.block_rank() == 0) {
                mine[1] = atomicAdd(rows, 1u);
            }
            cluster.sync();
            const long long row = *cluster.map_shared_rank(mine + 1, 0);
            const long long chunk = (g + c - 1) / c;
            const long long lo = cluster.block_rank() * chunk;
            const long long hi = lo + chunk < g ? lo + chunk : g;
            unsigned* dst = part + row * g;
            for (long long j = lo + threadIdx.x; j < hi; j += kThreads) {
                dst[j] = *cluster.map_shared_rank(
                    cnt + (j >> shift), static_cast<unsigned>(j & (c - 1)));
            }
        }
        cluster.sync();  // no block leaves while another reads its slice
    }
}

// out[c] = float32(acc[c] + sum over k of part[k][c]): the counts summed
// as integers, then one float64 add and one rounding; ``*rows`` rows were
// written (``rows`` null: ``parts``)
__global__ void __launch_bounds__(kThreads)
density_reduce(const double* __restrict__ acc,
               const unsigned* __restrict__ part,
               const unsigned* __restrict__ rows, int parts, long long g,
               float* __restrict__ out) {
    const int written = rows == nullptr ? parts : static_cast<int>(*rows);
    const long long stride = static_cast<long long>(kThreads) * gridDim.x;
    for (long long c = static_cast<long long>(blockIdx.x) * kThreads
                       + threadIdx.x;
         c < g; c += stride) {
        unsigned long long k_sum = 0;
        for (int k = 0; k < written; ++k) k_sum += part[k * g + c];
        out[c] = __double2float_rn(acc[c] + static_cast<double>(k_sum));
    }
}

using Kernel = decltype(&density_accumulate<kGlobal>);

Kernel accumulate_for(int cluster) {
    return cluster == 0   ? density_accumulate<kGlobal>
           : cluster == 1 ? density_accumulate<kBlock>
                          : density_accumulate<kCluster>;
}

}  // namespace

// Blocks of the accumulate kernel the current device holds at once for
// ``cluster`` (0: global atomics, 1: a private grid per block, 2..16: a
// cluster of that size) and ``smem`` bytes of dynamic shared memory; 0
// when it cannot run that shape.  Returns the CUDA error of the query.
extern "C" int density_grid_resident(int cluster, int smem, int* blocks) {
    return static_cast<int>(
        resident(accumulate_for(cluster), cluster, smem, blocks));
}

// Plain C entry point, bound with ctypes.  The launch shape comes from the
// wrapper (geomesa_tpu_torch/ops/density_kernel.py: launch_shape), which
// the CPU tests reach: ``cluster`` 0 counts unit weights with global
// atomics into ``part`` (``parts`` 1, zeroed), 1 in a private grid per
// block and 2..16 per cluster of that many blocks, each that counted
// anything writing its counts whole to the next free row of ``part``
// (``parts`` rows of width * height uint32 cells); other weights add with
// float64 atomics into ``acc``, a zeroed float64 grid, with one more zeroed
// cell behind it (when ``cluster`` is not 0) that counts the rows
// written.  ``vec`` says
// every pointer is 16-byte aligned.
// Launches the accumulate kernel (n >= 1) and the reduce pass on
// ``stream`` (the caller's current torch stream), does not synchronise,
// allocates nothing, and returns the CUDA error of the attribute calls or
// launches, so a refused launch is reported.
extern "C" int density_grid_launch(const void* x, const void* y,
                                   const void* w, const void* mask,
                                   long long n, double xmin, double ymin,
                                   double dx, double dy, int width,
                                   int height, int cluster, int blocks,
                                   int smem, int vec, void* acc,
                                   void* part, int parts, void* out,
                                   void* stream) {
    const long long g = static_cast<long long>(width) * height;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int c = cluster < 1 ? 1 : cluster;
    const long long slice = cluster == 0 ? 0 : (g + c - 1) / c;
    const bool pow2 = (c & (c - 1)) == 0 && c <= 16;
    if (!pow2 || blocks < 1 || blocks % c != 0 || n < 1 || n >= (1LL << 32)
        || slice * 4 + kStageBytes > smem
        || parts != (cluster == 0 ? 1 : blocks / c)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const double* xp = static_cast<const double*>(x);
    const double* yp = static_cast<const double*>(y);
    const double* wp = static_cast<const double*>(w);
    const unsigned char* mp = static_cast<const unsigned char*>(mask);
    double* ap = static_cast<double*>(acc);
    unsigned* pp = static_cast<unsigned*>(part);
    unsigned* rows =
        cluster == 0 ? nullptr : reinterpret_cast<unsigned*>(ap + g);
    const int sl = static_cast<int>(slice), sh = log2_of(c);
    cudaError_t err =
        launch(accumulate_for(cluster), cluster, blocks, smem, s, xp, yp, wp,
               mp, n, vec, xmin, ymin, dx, dy, width, height, sl, sh, ap, pp,
               rows);
    if (err != cudaSuccess) return static_cast<int>(err);
    // a few waves of blocks over the cells
    int sms = 0;
    err = sm_count(&sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long want = (g + kThreads - 1) / kThreads;
    const long long cap = 8LL * sms;
    return static_cast<int>(launch(
        density_reduce, 0, static_cast<int>(want < cap ? want : cap), 0, s,
        static_cast<const double*>(ap), static_cast<const unsigned*>(pp),
        static_cast<const unsigned*>(rows), parts, g,
        static_cast<float*>(out)));
}
