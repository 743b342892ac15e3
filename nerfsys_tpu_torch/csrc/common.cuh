// Shared helpers of the port's kernels (nerfsys_tpu_torch/csrc/*.cu).
//
// Every library is built on its own (one nvcc per .cu, see
// nerfsys_tpu_torch/kernels/__init__.py) with a plain C interface that the
// Python side binds with ctypes. Entry points launch on the caller's stream,
// never synchronise, allocate nothing, and return cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#define NERF_API extern "C" __attribute__((visibility("default")))
#define FULL_MASK 0xffffffffu

NERF_API const char* nerfsys_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

static inline unsigned int nerf_blocks(long long work, int threads) {
    return static_cast<unsigned int>((work + threads - 1) / threads);
}

// ---------------------------------------------------------------------------
// Host state of one kernel variant's launches, so that a launch costs no
// runtime queries after the first at its shape (kernels 3 and 5 launch
// 108 times in a host-bound training step): the dynamic shared memory it has
// been opted in to, per device, and the occupancy calculator's answers,
// per (device, threads, smem), and each device's SM count.
struct LaunchCache {
    std::mutex mu;
    std::map<int, int> opted;
    std::map<std::tuple<int, int, int>, int> per_sm;
    std::map<int, int> sms;
};

template <typename Kern>
static cudaError_t cached_occupancy(LaunchCache& cache, Kern kern,
                                    int threads, int smem, int* per_sm) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    std::lock_guard<std::mutex> lock(cache.mu);
    int& opted = cache.opted[dev];  // 0 on a device's first launch
    if (smem > 48 * 1024 && smem > opted) {  // opt in above the default
        e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
        opted = smem;
    }
    const auto key = std::make_tuple(dev, threads, smem);
    const auto it = cache.per_sm.find(key);
    if (it != cache.per_sm.end()) {
        *per_sm = it->second;
        return cudaSuccess;
    }
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, threads,
                                                      smem);
    if (e == cudaSuccess) cache.per_sm[key] = *per_sm;
    return e;
}

// The blocks of `kern` resident at once on the current device: the
// occupancy calculator's blocks an SM times the SMs.
template <typename Kern>
static cudaError_t cached_resident(LaunchCache& cache, Kern kern, int threads,
                                   int smem, int* blocks) {
    int per_sm = 0, dev = 0;
    cudaError_t e = cached_occupancy(cache, kern, threads, smem, &per_sm);
    if (e != cudaSuccess) return e;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    std::lock_guard<std::mutex> lock(cache.mu);
    auto it = cache.sms.find(dev);
    if (it == cache.sms.end()) {
        int n = 0;
        e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return e;
        it = cache.sms.emplace(dev, n).first;
    }
    *blocks = per_sm * it->second;
    return cudaSuccess;
}

// Round a float to bfloat16 (nearest even) and back: the reference's bf16
// operands and residuals (planes.cu 1b, planes_bwd.cu 5 / 5b, planes_bwd2.cu
// 5'', hash_grid.cu 7b). Under --fmad=false a product of two such values is
// exact in float32.
__device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// ---------------------------------------------------------------------------
// Tiles staged in shared memory and scatter-adds aggregated in the warp
// (the table-gradient kernels: planes_bwd.cu kernel 5, hash_grid.cu 7c).

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    if (bytes == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                     "l"(gmem));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                     "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Sum v over the lanes of `peers` (the lanes of this warp with the same
// key, this one included) into the group's lowest lane; every lane of the
// warp must call it. A tree over each group's ranks: at step j the lanes
// whose rank has bit j set hand their partial sum to the next lower
// remaining peer and drop out, so a group of n lanes takes ceil(log2 n)
// steps (at most 5) and singleton groups none.
template <int VEC>
__device__ __forceinline__ void reduce_peers(unsigned peers, float (&v)[VEC],
                                             int lane) {
    unsigned rank = __popc(peers & ((1u << lane) - 1u));
    unsigned higher = peers & (0xfffffffeu << lane);
    while (__any_sync(FULL_MASK, higher != 0u)) {
        const int next = __ffs(higher);  // 1 + the next remaining peer
        const int src = next ? next - 1 : lane;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
            const float t = __shfl_sync(FULL_MASK, v[i], src);
            if (next) v[i] += t;
        }
        higher &= ~__ballot_sync(FULL_MASK, rank & 1u);
        rank >>= 1;
    }
}

// Vector reductions in the L2 (no value returned, unlike atomicAdd on a
// float4, which compiles to a returning ATOM); `dst` aligned to the
// vector's bytes.
__device__ __forceinline__ void red_add4(float* dst, float a, float b,
                                         float c, float d) {
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(dst),
                 "f"(a), "f"(b), "f"(c), "f"(d)
                 : "memory");
}

__device__ __forceinline__ void red_add2(float* dst, float a, float b) {
    asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(dst), "f"(a),
                 "f"(b)
                 : "memory");
}

// Status words between blocks (the single-pass scan of bucket.cu): 32-bit
// loads and stores at device scope, relaxed (each word is self-contained).
__device__ __forceinline__ void store_relaxed(unsigned* p, unsigned v) {
    asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
                 : "memory");
}

__device__ __forceinline__ unsigned load_relaxed(const unsigned* p) {
    unsigned v;
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
                 : "=r"(v)
                 : "l"(p)
                 : "memory");
    return v;
}
