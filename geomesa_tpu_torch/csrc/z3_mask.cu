// z3 candidate mask: the Z3Filter.inBounds test over gathered candidates.
//
// Replaces geomesa_tpu/ops/pallas_kernels.py: z3_mask_pallas (wrapper) and
// _z3_mask_kernel (body), the TPU kernel of the z3 scan
// (geomesa_tpu/index/z3.py: _scan_core).  Same contract:
//   z3_mask(z: int64[N], ixy: int32[R,4], tlo: int32[N], thi: int32[N]) -> bool[N]
// out[i] = (OR over boxes k of xlo_k <= x_i <= xhi_k && ylo_k <= y_i <= yhi_k)
//          && tlo[i] <= t_i <= thi[i]
// where (x_i, y_i, t_i) are the 21-bit dimensions of the 63-bit z[i]
// (index/filters/Z3Filter.scala:19-55).
//
// Bound.  Each candidate moves 17 bytes (8 z + 4 tlo + 4 thi + 1 out), so
// 1M candidates take at least 17 MB / 3.35 TB/s ~ 5 us on an H100 SXM.
// Its operations are integer, and Hopper has no 64-bit integer pipe: each
// 64-bit shift is at least one funnel shift per 32-bit half, and each
// xor-then-and of the de-interleave one three-input logic op per half, so
// z >> 1, z >> 2 and the three de-interleaves take some 70 32-bit
// operations, each box 4 predicate-chained compares and the time test 2.
// At the card's 32-bit integer rate (64 per SM per clock, a quarter of
// the float32 FLOP rate: ~16.75e12/s) that is ~4.5 us per 1M candidates
// at R = 1 and ~6.2 us at R = 8, so bytes bound the kernel up to R = 3
// and operations from R = 4 (chip_smoke.py computes both for each run's
// shapes).  The design does nothing but stream: one thread per candidate in a grid-stride loop, neighbouring threads on
// neighbouring addresses (coalesced 8/4/4/1-byte accesses), the ragged
// tail masked by the loop bound (no padding, unlike the TPU's (8, 1024)
// blocks), z decoded as one unsigned 64-bit word with the every-3rd-bit
// magic masks (no hand-written u32-half split; the compiler makes the
// 32-bit pairs), and the R boxes staged once per block in dynamic shared
// memory (R * 16 bytes, at most the 48 KiB a launch gets without opt-in,
// so the wrapper refuses R above 3072).
// Later work: fuse the gathers that feed this kernel (z[idx], rtlo[rid],
// rthi[rid]) and the exact double-precision re-check into it, so the
// candidate columns are read once instead of being materialized first.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int combine3(unsigned long long z) {
    unsigned long long x = z & 0x1249249249249249ULL;
    x = (x ^ (x >> 2)) & 0x10C30C30C30C30C3ULL;
    x = (x ^ (x >> 4)) & 0x100F00F00F00F00FULL;
    x = (x ^ (x >> 8)) & 0x1F0000FF0000FFULL;
    x = (x ^ (x >> 16)) & 0x1F00000000FFFFULL;
    x = (x ^ (x >> 32)) & 0x1FFFFFULL;
    return static_cast<int>(x);
}

__device__ __forceinline__ bool in_box(int x, int y, int4 b) {
    return (x >= b.x) & (y >= b.y) & (x <= b.z) & (y <= b.w);
}

__global__ void __launch_bounds__(kThreads)
z3_mask_kernel(const long long* __restrict__ z,
               const int* __restrict__ ixy, int r,
               const int* __restrict__ tlo,
               const int* __restrict__ thi,
               unsigned char* __restrict__ out, long long n) {
    extern __shared__ int4 boxes[];
    for (int k = threadIdx.x; k < r; k += blockDim.x) {
        boxes[k] = make_int4(ixy[4 * k], ixy[4 * k + 1],
                             ixy[4 * k + 2], ixy[4 * k + 3]);
    }
    __syncthreads();
    const long long stride = static_cast<long long>(blockDim.x) * gridDim.x;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                       + threadIdx.x;
         i < n; i += stride) {
        const unsigned long long zv =
            static_cast<unsigned long long>(__ldg(z + i));
        const int xs = combine3(zv);
        const int ys = combine3(zv >> 1);
        const int ts = combine3(zv >> 2);
        bool hit = false;
        for (int k = 0; k < r; ++k) hit |= in_box(xs, ys, boxes[k]);
        out[i] = hit && ts >= __ldg(tlo + i) && ts <= __ldg(thi + i);
    }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Launches on ``stream`` (the
// caller's current torch stream), does not synchronise, allocates nothing,
// and returns cudaGetLastError() so a refused launch is reported.
extern "C" int z3_mask_launch(const void* z, const void* ixy, int r,
                              const void* tlo, const void* thi, void* out,
                              long long n, void* stream) {
    if (n <= 0) return static_cast<int>(cudaSuccess);
    const long long want = (n + kThreads - 1) / kThreads;
    // a few waves of blocks; the grid-stride loop covers the rest
    const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
    const size_t smem = static_cast<size_t>(r) * sizeof(int4);
    z3_mask_kernel<<<blocks, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(z), static_cast<const int*>(ixy), r,
        static_cast<const int*>(tlo), static_cast<const int*>(thi),
        static_cast<unsigned char*>(out), n);
    return static_cast<int>(cudaGetLastError());
}
