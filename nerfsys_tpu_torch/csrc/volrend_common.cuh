// Pieces shared by the kernels that put a ray's samples on the lanes of a
// warp: kernel 4 (volrend.cu), its VJP (volrend_bwd.cu), the segment
// compositor (row 8, composite_seg.cu) and the coherent-expert test (row
// 10b, coherent.cu): the launch plans, a sample as kernel 4 loads it, and
// the segment scans.
//
// Each puts a ray's samples on `lanes` consecutive lanes of a warp (the
// power of 2 at or above S, at most 32: 32 / lanes rays a warp at S <= 16,
// one ray in pieces of 32 with a carry above 32), so the compositors form
// the transmittance T in one order: an inclusive product scan of
// m = 1 - alpha + 1e-10 across the segment, times the product of the
// pieces before.
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

// Rows 8 and 10b: a ray's samples on `lanes` lanes in pieces (any lanes
// may take pieces), and a warp takes `groups` groups of 32 / lanes rays at
// once (10b: their loads issued together, their arithmetic interleaved,
// walked with a grid-stride loop; row 8 takes one group a warp).
struct RayLanePlan {  // ops/volrend.py RayLaneLaunchPlan
    int lanes;    // lanes a ray: a power of 2, at most 32
    int pieces;   // pieces of `lanes` samples a ray: ceil(S / lanes)
    int groups;   // ray groups a warp takes at once (the kernel's constant)
    int threads;  // per block, a multiple of 32, at most 256
    int blocks;
};

// The checks both entry points make on a RayLanePlan for S samples.
static inline bool ray_lane_plan_ok(const RayLanePlan& p, int S, int groups) {
    const int W = p.lanes;
    return S >= 1 && W >= 1 && W <= 32 && !(W & (W - 1)) && p.pieces >= 1 &&
           (long long)p.pieces * W >= S &&
           (long long)(p.pieces - 1) * W < S && p.groups == groups &&
           p.threads >= 32 && p.threads <= 256 && p.threads % 32 == 0 &&
           p.blocks >= 1;
}

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

template <int W>
__device__ __forceinline__ float seg_max(float v) {
#pragma unroll
    for (int d = W >> 1; d > 0; d >>= 1)
        v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, d, W));
    return v;
}
