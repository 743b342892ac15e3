// Pieces shared by kernel 4 (volrend.cu) and its VJP (volrend_bwd.cu):
// the launch plan, a sample as its lane loads it, and the segment scans.
//
// Both kernels put a ray's samples on `lanes` consecutive lanes of a warp
// (the power of 2 at or above S, at most 32: 32 / lanes rays a warp at
// S <= 16, one ray in pieces of 32 with a carry above 32), so the forward
// and the backward form the transmittance T in the same order: an
// inclusive product scan of m = 1 - alpha + 1e-10 across the segment,
// times the product of the pieces before.
#pragma once

#include "common.cuh"

struct VolrendPlan {  // ops/volrend.py VolrendLaunchPlan
    int lanes;    // lanes a ray: the power of 2 at or above S, at most 32
    int pieces;   // pieces of `lanes` samples a ray: ceil(S / lanes)
    int threads;  // per block, a multiple of 32, at most 256
    int blocks;   // enough for N rays at 32 / lanes rays a warp
    int smem;     // dynamic shared bytes: a float per piece and warp
                  // when pieces > 1, else 0
};

// One sample as its lane sees it; past S (or on a dead ray) the identity:
// alpha 0, m 1.
struct Sample {
    float4 v;  // rgb and the raw sigma
    float t, dt, e, alpha, m;
};

__device__ __forceinline__ Sample load_sample(const float* __restrict__ rs,
                                              const float* __restrict__ t,
                                              int s, int S, bool live,
                                              float sigma_scale,
                                              int scale_on) {
    Sample q;
    if (!live || s >= S) {
        q.v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        q.t = q.dt = q.e = q.alpha = 0.0f;
        q.m = 1.0f;
        return q;
    }
    q.v = __ldg(reinterpret_cast<const float4*>(rs) + s);
    q.t = __ldg(t + s);
    // the last interval repeats the one before it
    q.dt = fmaxf(s < S - 1 ? __ldg(t + s + 1) - q.t : q.t - __ldg(t + s - 1),
                 1e-4f);
    float sigma = fmaxf(q.v.w, 0.0f);
    if (scale_on) sigma = sigma * sigma_scale;
    q.e = expf(-sigma * q.dt);
    q.alpha = fminf(fmaxf(1.0f - q.e, 0.0f), 1.0f - 1e-7f);
    q.m = 1.0f - q.alpha + 1e-10f;
    return q;
}

// Inclusive product of v over lanes 0..sl of this lane's segment of W.
template <int W>
__device__ __forceinline__ float seg_prod(float v, int sl) {
#pragma unroll
    for (int d = 1; d < W; d <<= 1) {
        const float u = __shfl_up_sync(FULL_MASK, v, d, W);
        if (sl >= d) v = v * u;
    }
    return v;
}

template <int W>
__device__ __forceinline__ float seg_sum(float v) {
#pragma unroll
    for (int d = W >> 1; d > 0; d >>= 1)
        v += __shfl_xor_sync(FULL_MASK, v, d, W);
    return v;
}
