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
// order, so each thread takes points in a grid-stride loop, snaps each one
// and adds its weight to the cell with a float64 atomicAdd (native since
// sm_60) into a float64 scratch grid the wrapper zeroed; a second kernel
// rounds the scratch to the float32 output.
//
// The snap must agree cell for cell with the plain version.  dx and dy
// come from the host, computed in float64 as the JAX package computes
// them; the kernel divides (no multiply by a reciprocal, no fused
// multiply-add: the expression has none, and the build uses no fast-math
// flag), floors, and clamps in double before converting to int (a point
// far outside a deep tile's envelope is ~3e11 cells away and would
// overflow an int).
//
// Bound.  A masked-in point moves 25 bytes (x, y, w float64 and the mask
// byte), a masked-out one the mask byte, and the grid is written once as
// float32: 2^24 points, all masked in, take at least 419 MB / 3.35 TB/s
// ~ 0.125 ms on an H100 SXM.  The float64 work (two subtract-divide-
// floor-clamp chains, the division a reciprocal-and-refine sequence of
// some 10 instructions) is ~30 instructions a point at the card's ~16.75e12
// float64 instructions/s, ~0.03 ms for 2^24: bytes bound the kernel.  What
// the bound leaves out is contention: clustered points send many atomics
// to a few cells, and same-address float64 atomics serialise in L2.  A
// 256x256 float64 grid is 512 KiB, more than a block's 227 KB of shared
// memory, so a private per-block copy of the whole grid does not fit and
// this simple kernel adds into global memory.  Privatising tiles of the
// grid in shared memory, or warp-aggregating hot cells, is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long snap(double v, double lo, double d,
                                          int cells) {
    const double f = floor((v - lo) / d);
    return static_cast<long long>(
        fmin(fmax(f, 0.0), static_cast<double>(cells - 1)));
}

__global__ void __launch_bounds__(kThreads)
density_accumulate(const double* __restrict__ x,
                   const double* __restrict__ y,
                   const double* __restrict__ w,
                   const unsigned char* __restrict__ mask, long long n,
                   double xmin, double ymin, double dx, double dy,
                   int width, int height, double* __restrict__ acc) {
    const long long stride = static_cast<long long>(blockDim.x) * gridDim.x;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                       + threadIdx.x;
         i < n; i += stride) {
        if (!__ldg(mask + i)) continue;
        const long long ix = snap(__ldg(x + i), xmin, dx, width);
        const long long iy = snap(__ldg(y + i), ymin, dy, height);
        const float wf = __double2float_rn(__ldg(w + i));
        atomicAdd(acc + iy * width + ix, static_cast<double>(wf));
    }
}

__global__ void __launch_bounds__(kThreads)
density_round(const double* __restrict__ acc, float* __restrict__ out,
              long long g) {
    const long long stride = static_cast<long long>(blockDim.x) * gridDim.x;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                       + threadIdx.x;
         i < g; i += stride) {
        out[i] = __double2float_rn(acc[i]);
    }
}

int blocks_for(long long n) {
    const long long want = (n + kThreads - 1) / kThreads;
    // a few waves of blocks; the grid-stride loop covers the rest
    return static_cast<int>(want < 132 * 16 ? want : 132 * 16);
}

}  // namespace

// Plain C entry point, bound with ctypes.  Launches both kernels on
// ``stream`` (the caller's current torch stream), does not synchronise,
// allocates nothing (``acc`` is the zeroed float64 scratch grid, ``out``
// the float32 grid, both of width * height cells), and returns
// cudaGetLastError() after each launch so a refused launch is reported.
extern "C" int density_grid_launch(const void* x, const void* y,
                                   const void* w, const void* mask,
                                   long long n, double xmin, double ymin,
                                   double dx, double dy, int width,
                                   int height, void* acc, void* out,
                                   void* stream) {
    const long long g = static_cast<long long>(width) * height;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n > 0) {
        density_accumulate<<<blocks_for(n), kThreads, 0, s>>>(
            static_cast<const double*>(x), static_cast<const double*>(y),
            static_cast<const double*>(w),
            static_cast<const unsigned char*>(mask), n, xmin, ymin, dx, dy,
            width, height, static_cast<double*>(acc));
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (g > 0) {
        density_round<<<blocks_for(g), kThreads, 0, s>>>(
            static_cast<const double*>(acc), static_cast<float*>(out), g);
    }
    return static_cast<int>(cudaGetLastError());
}
