// Shared helpers of the port's kernels (nerfsys_tpu_torch/csrc/*.cu).
//
// Every library is built on its own (one nvcc per .cu, see
// nerfsys_tpu_torch/kernels/__init__.py) with a plain C interface that the
// Python side binds with ctypes. Entry points launch on the caller's stream,
// never synchronise, allocate nothing, and return cudaGetLastError().
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define NERF_API extern "C" __attribute__((visibility("default")))
#define FULL_MASK 0xffffffffu

NERF_API const char* nerfsys_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

static inline unsigned int nerf_blocks(long long work, int threads) {
    return static_cast<unsigned int>((work + threads - 1) / threads);
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
