// z2 candidate mask: the Z2Filter.inBounds test over gathered candidates.
//
// Replaces geomesa_tpu/ops/pallas_kernels.py: z2_mask_pallas (wrapper) and
// _z2_mask_kernel (body), the TPU kernel of the z2 scan
// (geomesa_tpu/index/z2.py: _query_packed).  Same contract:
//   z2_mask(z: int64[N], ixy: int32[R,4]) -> bool[N]
// out[i] = OR over boxes k of xlo_k <= x_i <= xhi_k && ylo_k <= y_i <= yhi_k
// where x_i (even bits) and y_i (odd bits) are the 31-bit dimensions of the
// 62-bit z[i] (index/filters/Z2Filter.scala).
//
// Bound.  Each candidate moves 9 bytes (8 z + 1 out), so 2^24 candidates
// (the gather capacity the z2 scan reaches on 100M points) take at least
// 151 MB / 3.35 TB/s ~ 45.1 us on an H100 SXM.  The operations are integer,
// and Hopper has no 64-bit integer pipe: z >> 1 is one funnel shift per
// 32-bit half, each of the 5 xor-shift-and steps of a de-interleave (after
// its first and) a funnel shift and a three-input logic op per half, and
// each box test 4 compares of 32-bit values: counted low,
// 2 + 2 * (2 + 5 * 4) + 4R = 46 + 4R 32-bit operations per candidate.  At
// the card's 32-bit integer rate (~16.75e12/s) that is ~50.1 us at R = 1
// and ~78.1 us at R = 8 for 2^24 candidates, so operations bound the
// kernel at every R, narrowly at R = 1 (chip_smoke.py computes both bounds
// for each run's shapes).
//
// Design: stream.  One thread per candidate in a grid-stride loop,
// neighbouring threads on neighbouring addresses (coalesced 8-byte loads,
// 1-byte stores), the ragged tail masked by the loop bound (no padding;
// the TPU kernel padded to (8, 1024) blocks with z = 2^62 - 1), z decoded
// as one unsigned 64-bit word with the every-2nd-bit masks (the TPU's
// split into two u32 halves existed because Mosaic has no 64-bit lanes),
// and the R boxes staged once per block in dynamic shared memory (R * 16
// bytes, at most the 48 KiB a launch gets without opt-in, so the wrapper
// refuses R above 3072).  A decoded dimension is an unsigned 32-bit value
// (x from the even bits, y from the odd bits of any 64-bit word), so each
// box is staged as unsigned bounds: a negative low bound becomes 0 and a
// box with a negative high bound becomes the empty [1, 0].  Each bound
// test is then one unsigned 32-bit compare, and every input gives what
// the plain version's int64 compares give.
// Later work: fuse the z[idx] gather that feeds this kernel and the exact
// double-precision re-check into it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned combine2(unsigned long long z) {
    unsigned long long x = z & 0x5555555555555555ULL;
    x = (x ^ (x >> 1)) & 0x3333333333333333ULL;
    x = (x ^ (x >> 2)) & 0x0F0F0F0F0F0F0F0FULL;
    x = (x ^ (x >> 4)) & 0x00FF00FF00FF00FFULL;
    x = (x ^ (x >> 8)) & 0x0000FFFF0000FFFFULL;
    x = (x ^ (x >> 16)) & 0x00000000FFFFFFFFULL;
    return static_cast<unsigned>(x);
}

// [xlo, ylo, xhi, yhi] as unsigned bounds that accept the same 32-bit
// unsigned dimensions as the signed int64 compares do
__device__ __forceinline__ uint4 unsigned_box(int xlo, int ylo, int xhi,
                                              int yhi) {
    if (xhi < 0 || yhi < 0) return make_uint4(1u, 1u, 0u, 0u);
    return make_uint4(xlo < 0 ? 0u : static_cast<unsigned>(xlo),
                      ylo < 0 ? 0u : static_cast<unsigned>(ylo),
                      static_cast<unsigned>(xhi), static_cast<unsigned>(yhi));
}

__device__ __forceinline__ bool in_box(unsigned x, unsigned y, uint4 b) {
    return (x >= b.x) & (y >= b.y) & (x <= b.z) & (y <= b.w);
}

__global__ void __launch_bounds__(kThreads)
z2_mask_kernel(const long long* __restrict__ z,
               const int* __restrict__ ixy, int r,
               unsigned char* __restrict__ out, long long n) {
    extern __shared__ uint4 boxes[];
    for (int k = threadIdx.x; k < r; k += blockDim.x) {
        boxes[k] = unsigned_box(ixy[4 * k], ixy[4 * k + 1],
                                ixy[4 * k + 2], ixy[4 * k + 3]);
    }
    __syncthreads();
    const long long stride = static_cast<long long>(blockDim.x) * gridDim.x;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                       + threadIdx.x;
         i < n; i += stride) {
        const unsigned long long zv =
            static_cast<unsigned long long>(__ldg(z + i));
        const unsigned xs = combine2(zv);
        const unsigned ys = combine2(zv >> 1);
        bool hit = false;
        for (int k = 0; k < r; ++k) hit |= in_box(xs, ys, boxes[k]);
        out[i] = hit;
    }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Launches on ``stream`` (the
// caller's current torch stream), does not synchronise, allocates nothing,
// and returns cudaGetLastError() so a refused launch is reported.
extern "C" int z2_mask_launch(const void* z, const void* ixy, int r,
                              void* out, long long n, void* stream) {
    if (n <= 0) return static_cast<int>(cudaSuccess);
    const long long want = (n + kThreads - 1) / kThreads;
    // a few waves of blocks; the grid-stride loop covers the rest
    const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
    const size_t smem = static_cast<size_t>(r) * sizeof(uint4);
    z2_mask_kernel<<<blocks, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(z), static_cast<const int*>(ixy), r,
        static_cast<unsigned char*>(out), n);
    return static_cast<int>(cudaGetLastError());
}
