// Masked, weighted 1-D histogram of int32 bin ids.
//
// Replaces geomesa_tpu/ops/pallas_kernels.py: hist1d_pallas (wrapper) and
// _hist1d_kernel (body), the TPU kernel behind the sharded Histogram and
// Frequency (count-min) stats of geomesa_tpu/parallel/stats.py.  Same
// contract:
//   hist1d(bins: int32[N], w: float32[N], mask: bool[N], n_bins) -> float32[n_bins]
// A row adds w[i] to bin bins[i] when mask[i] is set and 0 <= bins[i] <
// n_bins; every other row adds nothing.
//
// Keep the contract, not the method.  The TPU kernel was a one-hot MXU
// product per 512-bin tile, carrying the tile's sum in VMEM from one grid
// step to the next, which needs a core that runs the grid in order.  Here
// blocks run in parallel and in no order.
//
// Exactness: with unit weights every partial is an integer, and float32
// sums of integers are exact below 2^24, so a histogram of fewer than 2^24
// rows equals np.bincount bit for bit (the stats scan sends larger shards
// to an int64 scatter instead).  Other weights sum in an order that
// changes from run to run.
//
// Bound.  The bound counts what the inputs need: the mask byte of every
// row, the bin id and weight (8 bytes) of each masked-in row, the output
// written once; 16M rows half masked in take 0.024 ms at 3.35 TB/s on an
// H100 SXM, and the work (a compare, an add) is a few operations a row,
// so bytes bound the kernel.  Memory moves in 32-byte sectors, so a random
// mask saves almost nothing (a sector of 8 ids is skipped only when all 8
// rows are masked out, 1 in 256 at 50%): streaming all 9 bytes of every
// row, 16M rows take 0.043 ms whatever the mask, and that is the floor a
// masked-row kernel can reach.
//
// Design.
// - Streaming: the rows are cut into tiles of 512 a warp, each warp
//   walking a contiguous share of them.  A lane loads 16 mask bytes as one
//   16-byte vector into the warp's stage in shared memory, and the ids and
//   weights as int4 and float4 vectors, neighbouring lanes on neighbouring
//   addresses, whether the rows are masked in or not (a random mask
//   fetches every sector anyway), so no load waits on the mask: 8 vectors
//   a lane are in flight per tile.  Rows past the last whole tile, and
//   every row when a pointer is not 16-byte aligned, go one a lane.
// - Counts in shared memory: float adds into shared memory compile to
//   compare-and-swap loops on sm_90a (``cuobjdump -sass``: ATOMS.CAST.SPIN,
//   and ATOM.E.CAST.SPIN into another block's shared memory), while
//   integer adds are native (ATOMS.POPC.INC.32, the compiler's own warp
//   aggregation of +1).  So a row of weight exactly 1 (every Histogram and
//   Frequency stat on the main path) adds 1 to a uint32 counter: in
//   ``copies`` replicas per block, one per group of warps, when the
//   histogram fits a block's shared memory (``cluster`` 1), else in one
//   histogram spread over the distributed shared memory of a thread-block
//   cluster (up to 16 blocks, bin b owned by block b % cluster at slot
//   b / cluster, through cluster::map_shared_rank; 65,536 bins are
//   256 KB).  Any other weight adds in one block to a float replica beside
//   the counts (a compare-and-swap loop, but on a warp's own replica: few
//   bins would make global atomics on the same words serialise), and
//   otherwise, as every row of a histogram wider than a cluster holds
//   (``cluster`` 0), straight into the output with a native global float
//   atomic.  Each block then adds its non-zero bins into the output
//   (zeroed by the wrapper) with one global float atomic each.
// - Hot bins: the compiler already sums a warp's +1s to one bin into one
//   add (ATOMS.POPC.INC).  Where other weights add into global memory
//   (every row of the global branch, and beside a cluster's counts), a
//   warp whose neighbouring lanes hit one bin first sums them per bin
//   (match.any, then shuffles in a tree) and one lane adds, and goes on
//   merging while bins repeat (hist_launch.cuh: merge_hot), so a hot bin
//   does not serialise its adds in L2; beside a cluster's counts a tile
//   of unit weights skips the test.  Beside a block's own replicas the
//   merge cost more than it saved (measured in PERF.md).  A cluster that
//   counted nothing skips its flush.
// - The launch shape (branch, cluster size, blocks, replicas, shared
//   memory) is chosen by shape in Python (geomesa_tpu_torch/ops/
//   hist1d_kernel.py: launch_shape) from the card's occupancy
//   (hist1d_resident).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hist_launch.cuh"

namespace cg = cooperative_groups;
using namespace hist_launch;

namespace {

template <int kMode>
__global__ void __launch_bounds__(kThreads)
hist1d_kernel(const int* __restrict__ bins, const float* __restrict__ w,
              const unsigned char* __restrict__ mask, long long n, int vec,
              int n_bins, int copies, int slice, int shift,
              float* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];
    const unsigned lane = threadIdx.x & 31;
    unsigned char* stage = smem + (threadIdx.x >> 5) * kTile;
    unsigned* cnt = reinterpret_cast<unsigned*>(smem + kStageBytes);
    // one unsigned compare rejects negative ids and ids >= n_bins alike
    const unsigned nb = static_cast<unsigned>(n_bins);
    bool counted = false;  // this thread added a count to the cluster
    bool hot = false;      // the warp merges its float adds (merge_hot)

    // in one block: ``copies`` count replicas, then as many float sums
    float* sums = reinterpret_cast<float*>(cnt + copies * n_bins);
    if constexpr (kMode != kGlobal) {
        const int cells = kMode == kBlock ? 2 * copies * n_bins : slice;
        for (int j = threadIdx.x; j < cells; j += kThreads) cnt[j] = 0u;
        if constexpr (kMode == kCluster) cg::this_cluster().sync();
        else __syncthreads();
    }
    unsigned* mine = cnt;
    float* other = out;  // where a weight other than 1 adds
    if constexpr (kMode == kBlock) {
        const int replica = ((threadIdx.x >> 5) % copies) * n_bins;
        mine += replica;
        other = sums + replica;
    }

    // ``merge`` (std::true_type or std::false_type): some lane of the warp
    // may add a weight other than 1 into global memory; without it the
    // visit holds no warp vote
    auto visit = [&](bool keep, int b, float v, auto merge) {
        unsigned key = kNone | lane;
        if (keep && static_cast<unsigned>(b) < nb) {
            key = b;
            if (kMode != kGlobal && v == 1.0f) {
                // a count: a native integer add in (distributed) shared
                // memory
                if constexpr (kMode == kBlock) {
                    atomicAdd(mine + key, 1u);
                } else if constexpr (kMode == kCluster) {
                    atomicAdd(cg::this_cluster().map_shared_rank(
                                  cnt + (key >> shift),
                                  key & ((1u << shift) - 1)),
                              1u);
                    counted = true;
                }
                key = kNone | lane;
            }
        }
        // any other weight: a float add into the block's replica, or into
        // the output, hot bins merged within the warp first there
        bool add = !(key & kNone);
        if constexpr (decltype(merge)::value) {
            add = merge_hot(key, v, hot) && add;
        }
        if (add) atomicAdd(other + key, v);
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
        const int4* b4 = reinterpret_cast<const int4*>(bins + base);
        const float4* w4 = reinterpret_cast<const float4*>(w + base);
        int4 ba[4];
        float4 wa[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            ba[k] = __ldg(b4 + k * 32 + lane);
            wa[k] = __ldg(w4 + k * 32 + lane);
        }
        __syncwarp();  // every lane has read the previous tile's stage
        reinterpret_cast<uint4*>(stage)[lane] = m16;
        __syncwarp();
        const unsigned* m4 = reinterpret_cast<const unsigned*>(stage);
        auto tile = [&](auto merge) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const unsigned mm = m4[k * 32 + lane];
                visit((mm & 0xffu) != 0, ba[k].x, wa[k].x, merge);
                visit((mm & 0xff00u) != 0, ba[k].y, wa[k].y, merge);
                visit((mm & 0xff0000u) != 0, ba[k].z, wa[k].z, merge);
                visit((mm >> 24) != 0, ba[k].w, wa[k].w, merge);
            }
        };
        if constexpr (kMode == kGlobal) {
            tile(std::true_type{});  // every row adds as a float
        } else if constexpr (kMode == kBlock) {
            tile(std::false_type{});  // every row adds in shared memory
        } else {
            bool floats = false;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                floats |= wa[k].x != 1.0f || wa[k].y != 1.0f
                          || wa[k].z != 1.0f || wa[k].w != 1.0f;
            }
            if (__any_sync(0xffffffffu, floats)) tile(std::true_type{});
            else tile(std::false_type{});
        }
    }
    // the ragged tail (every row when a pointer is unaligned), a row a lane
    for (long long i0 = tiles * kTile + gw * 32; i0 < n; i0 += tw * 32) {
        const long long i = i0 + lane;
        const bool keep = i < n && __ldg(mask + i);
        visit(keep, keep ? __ldg(bins + i) : -1, keep ? __ldg(w + i) : 0.0f,
              std::integral_constant<bool, kMode != kBlock>{});
    }

    // add the block's (or cluster's) non-zero bins into the output
    if constexpr (kMode == kBlock) {
        __syncthreads();
        for (int j = threadIdx.x; j < n_bins; j += kThreads) {
            unsigned k = 0;
            float f = 0.0f;
            for (int c = 0; c < copies; ++c) {
                k += cnt[c * n_bins + j];
                f += sums[c * n_bins + j];
            }
            const float s = static_cast<float>(k) + f;
            if (s != 0.0f) atomicAdd(out + j, s);
        }
    } else if constexpr (kMode == kCluster) {
        // the block's flag, in the mask stage: every warp is past its rows
        int* counted_here = reinterpret_cast<int*>(smem);
        const int any = __syncthreads_or(counted);
        if (threadIdx.x == 0) *counted_here = any;
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();  // every add of the cluster has landed
        const unsigned c = cluster.num_blocks();
        int cluster_any = 0;  // a cluster that counted nothing reads nothing
        for (unsigned r = 0; r < c; ++r) {
            cluster_any |= *cluster.map_shared_rank(counted_here, r);
        }
        if (cluster_any) {
            const unsigned chunk = (nb + c - 1) / c;
            const unsigned lo = cluster.block_rank() * chunk;
            const unsigned hi = lo + chunk < nb ? lo + chunk : nb;
            for (unsigned j = lo + threadIdx.x; j < hi; j += kThreads) {
                const unsigned s = *cluster.map_shared_rank(
                    cnt + (j >> shift), j & (c - 1));
                if (s != 0) atomicAdd(out + j, static_cast<float>(s));
            }
        }
        cluster.sync();  // no block leaves while another reads its slice
    }
}

using Kernel = decltype(&hist1d_kernel<kGlobal>);

Kernel kernel_for(int cluster) {
    return cluster == 0   ? hist1d_kernel<kGlobal>
           : cluster == 1 ? hist1d_kernel<kBlock>
                          : hist1d_kernel<kCluster>;
}

}  // namespace

// Blocks of the kernel the current device holds at once for ``cluster``
// (0: global atomics, 1: private replicas per block, 2..16: a cluster of
// that size) and ``smem`` bytes of dynamic shared memory; 0 when it cannot
// run that shape.  Returns the CUDA error of the query.
extern "C" int hist1d_resident(int cluster, int smem, int* blocks) {
    return static_cast<int>(
        resident(kernel_for(cluster), cluster, smem, blocks));
}

// Plain C entry point, bound with ctypes.  The launch shape comes from the
// wrapper (geomesa_tpu_torch/ops/hist1d_kernel.py: launch_shape), which
// the CPU tests reach: ``cluster`` 0 adds straight into the output, 1
// keeps ``copies`` replicas per block, 2..16 one histogram per cluster of
// that many blocks; ``smem`` is the dynamic shared memory per block and
// ``vec`` says every pointer is 16-byte aligned.  Launches on ``stream``
// (the caller's current torch stream), does not synchronise, allocates
// nothing (``out`` is the zeroed float32 output of n_bins cells), and
// returns the CUDA error of the attribute calls or the launch, so a
// refused launch is reported.
extern "C" int hist1d_launch(const void* bins, const void* w,
                             const void* mask, long long n, int n_bins,
                             int cluster, int blocks, int copies, int smem,
                             int vec, void* out, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int c = cluster < 1 ? 1 : cluster;
    const long long slice = (static_cast<long long>(n_bins) + c - 1) / c;
    const long long need = cluster == 0 ? 0
                           : cluster == 1 ? 2 * slice * copies : slice;
    const bool pow2 = (c & (c - 1)) == 0 && c <= 16;
    if (!pow2 || blocks < 1 || blocks % c != 0 || n >= (1LL << 32)
        || (cluster == 1 && copies < 1)
        || need * 4 + kStageBytes > smem) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int sl = static_cast<int>(slice), sh = log2_of(c);
    return static_cast<int>(launch(
        kernel_for(cluster), cluster, blocks, smem, s,
        static_cast<const int*>(bins), static_cast<const float*>(w),
        static_cast<const unsigned char*>(mask), n, vec, n_bins, copies, sl,
        sh, static_cast<float*>(out)));
}
