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
// blocks run in parallel and in no order, so each block keeps a private
// histogram in shared memory: its threads take rows in a grid-stride loop
// and add with shared-memory atomicAdd, then the block adds each of its
// non-zero bins into the output (zeroed by the wrapper) with one global
// atomicAdd.  Few bins (64 for a Histogram stat) would send every thread of
// a block to the same few shared words, so the histogram is kept in
// ``copies`` replicas, one per group of warps, summed at the flush.  A
// histogram wider than a block's 227 KB of shared memory (above 58,112
// bins) takes the global-atomic branch of the same kernel (``copies`` 0):
// each row adds straight into the output.
//
// Exactness: with unit weights every partial is an integer, and float32
// sums of integers are exact below 2^24, so a histogram of fewer than 2^24
// rows equals np.bincount bit for bit (the stats scan sends larger shards
// to an int64 scatter instead).  Other weights sum in an order that
// changes from run to run.
//
// Bound.  A masked-out row moves its mask byte; a masked-in row also its
// bin id and weight (8 bytes); the output is written once.  16M rows, half
// of them masked in, take at least 80 MB / 3.35 TB/s ~ 0.024 ms on an
// H100 SXM; the work (a compare, an add) is a few operations a row, so
// bytes bound the kernel.  What the bound leaves out is the atomics: a
// shared-memory atomicAdd per masked-in row and the flush's n_bins global
// atomics per block, which the launch shape keeps below N.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
hist1d_kernel(const int* __restrict__ bins, const float* __restrict__ w,
              const unsigned char* __restrict__ mask, long long n,
              int n_bins, int copies, float* __restrict__ out) {
    extern __shared__ float hist[];
    const long long stride = static_cast<long long>(blockDim.x) * gridDim.x;
    const long long first =
        static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    // one unsigned compare rejects negative ids and ids >= n_bins alike
    const unsigned nb = static_cast<unsigned>(n_bins);
    if (copies == 0) {  // wider than shared memory: add into the output
        for (long long i = first; i < n; i += stride) {
            if (!__ldg(mask + i)) continue;
            const unsigned b = static_cast<unsigned>(__ldg(bins + i));
            if (b < nb) atomicAdd(out + b, __ldg(w + i));
        }
        return;
    }
    const int cells = copies * n_bins;
    for (int j = threadIdx.x; j < cells; j += blockDim.x) hist[j] = 0.0f;
    __syncthreads();
    float* mine = hist + ((threadIdx.x >> 5) % copies) * n_bins;
    for (long long i = first; i < n; i += stride) {
        if (!__ldg(mask + i)) continue;
        const unsigned b = static_cast<unsigned>(__ldg(bins + i));
        if (b < nb) atomicAdd(mine + b, __ldg(w + i));
    }
    __syncthreads();
    for (int j = threadIdx.x; j < n_bins; j += blockDim.x) {
        float s = 0.0f;
        for (int c = 0; c < copies; ++c) s += hist[c * n_bins + j];
        if (s != 0.0f) atomicAdd(out + j, s);
    }
}

}  // namespace

// Plain C entry point, bound with ctypes.  ``blocks`` and ``copies`` come
// from the wrapper (geomesa_tpu_torch/ops/hist1d_kernel.py: launch_shape),
// which the CPU tests reach; ``copies`` 0 selects the global-atomic branch.
// Launches on ``stream`` (the caller's current torch stream), does not
// synchronise, allocates nothing (``out`` is the zeroed float32 output of
// n_bins cells), and returns the CUDA error of the attribute call or the
// launch, so a refused launch is reported.
extern "C" int hist1d_launch(const void* bins, const void* w,
                             const void* mask, long long n, int n_bins,
                             int blocks, int copies, void* out,
                             void* stream) {
    const size_t smem = static_cast<size_t>(copies) * n_bins * sizeof(float);
    if (smem > 48 * 1024) {
        // above 48 KB a block's dynamic shared memory needs the opt-in
        const cudaError_t err = cudaFuncSetAttribute(
            hist1d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    hist1d_kernel<<<blocks, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(bins), static_cast<const float*>(w),
        static_cast<const unsigned char*>(mask), n, n_bins, copies,
        static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}
