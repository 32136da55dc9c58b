// Launch helpers shared by the histogram kernels (density_grid.cu and
// hist1d.cu).
//
// Both kernels stream their rows in tiles of kTile rows a warp, staging
// each tile's mask bytes in kStageBytes of shared memory, and come in
// three modes: a private histogram per block (kBlock), one spread over the
// distributed shared memory of a thread-block cluster (kCluster), or adds
// into global memory (kGlobal).  Which mode runs, and the launch shape,
// are chosen by shape on the host (geomesa_tpu_torch/ops/launch.py:
// pick_cluster); this header configures, sizes and launches that shape.

#pragma once

#include <cuda_runtime.h>

namespace hist_launch {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 512;                    // rows a warp takes per step
constexpr int kStageBytes = kWarps * kTile;   // one staged mask tile a warp
constexpr unsigned kNone = 0x80000000u;       // | lane: a row adding nothing

// ``cluster`` on the host: 0 global, 1 a block, 2..16 a cluster
enum Mode { kGlobal = 0, kBlock = 1, kCluster = 2 };

// Before a global atomic add of ``v`` at ``key``: false on a lane whose
// value another lane now adds.  A warp that finds two neighbouring lanes
// holding one key (a hot cell or bin) turns ``hot``; while it is, the
// lanes of each key first sum their values into the lowest (match.any,
// then shuffles in a tree), so a hot key takes one add a warp instead of
// serialising up to 32 in L2, and it stays hot while keys repeat.
// Elsewhere the test costs a shuffle and a vote.  Keys kNone | lane,
// adding nothing, never match.  Every lane of the warp calls it together,
// with one ``hot``.
template <typename T>
__device__ __forceinline__ bool merge_hot(unsigned key, T& v, bool& hot) {
    const unsigned lane = threadIdx.x & 31;
    if (!hot) {
        const unsigned below = __shfl_down_sync(0xffffffffu, key, 1);
        hot = __any_sync(0xffffffffu, lane != 31 && below == key);
        if (!hot) return true;
    }
    unsigned peers = __match_any_sync(0xffffffffu, key);
    hot = __any_sync(0xffffffffu, (peers & (peers - 1)) != 0);
    const bool leader = static_cast<unsigned>(__ffs(peers) - 1) == lane;
    unsigned rel = __popc(peers & ((1u << lane) - 1));  // peers below
    peers &= ~((2u << lane) - 1);                       // peers above
    while (__any_sync(0xffffffffu, peers != 0)) {
        const int next = __ffs(peers);
        const T t = __shfl_sync(0xffffffffu, v, next ? next - 1 : lane);
        if (next) v += t;
        peers &= ~__ballot_sync(0xffffffffu, rel & 1);
        rel >>= 1;
    }
    return leader;
}

inline int log2_of(int c) {
    int s = 0;
    while ((1 << s) < c) ++s;
    return s;
}

// Lets ``kernel`` take ``smem`` bytes of dynamic shared memory (above
// 48 KB a block needs the opt-in) and, above 8, a non-portable cluster.
// A refusal is returned here and cleared, so no later launch's
// cudaGetLastError() reports it.
template <typename... P>
cudaError_t configure(void (*kernel)(P...), int smem, int cluster) {
    cudaError_t err = cudaSuccess;
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    }
    if (err == cudaSuccess && cluster > 8) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) cudaGetLastError();
    return err;
}

// A launch of ``blocks`` blocks of kThreads, in clusters of ``cluster``
// blocks when it is above 1; ``attr`` holds the cluster attribute.
inline cudaLaunchConfig_t launch_config(int blocks, int cluster, int smem,
                                        cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    if (cluster > 1) {
        attr->id = cudaLaunchAttributeClusterDimension;
        attr->val.clusterDim.x = cluster;
        attr->val.clusterDim.y = 1;
        attr->val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
    }
    return cfg;
}

// Streaming multiprocessors of the current device.
inline cudaError_t sm_count(int* sms) {
    int dev = 0;
    const cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Blocks of ``kernel`` the current device holds at once in clusters of
// ``cluster`` (1 or 0: no cluster) with ``smem`` bytes of dynamic shared
// memory; 0 when it cannot run that shape.
template <typename... P>
cudaError_t resident(void (*kernel)(P...), int cluster, int smem,
                     int* blocks) {
    *blocks = 0;
    cudaError_t err = configure(kernel, smem, cluster);
    if (err != cudaSuccess) return err;
    if (cluster <= 1) {
        int sms = 0, per_sm = 0;
        err = sm_count(&sms);
        if (err == cudaSuccess) {
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, kThreads, smem);
        }
        *blocks = per_sm * sms;
        return err;
    }
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        launch_config(cluster, cluster, smem, nullptr, &attr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    *blocks = clusters * cluster;
    return err;
}

// Launches ``kernel`` on ``blocks`` blocks in clusters of ``cluster``;
// returns the CUDA error of the attribute calls or of this launch (not an
// earlier one's).
template <typename... P, typename... A>
cudaError_t launch(void (*kernel)(P...), int cluster, int blocks, int smem,
                   cudaStream_t stream, A... args) {
    cudaError_t err = configure(kernel, smem, cluster);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        launch_config(blocks, cluster, smem, stream, &attr);
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace hist_launch
