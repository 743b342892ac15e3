// Kernel 4: volume compositor, forward.
//
// Replaces: nerfsys_tpu/ops/volrend.py `render_weights` (:57) and
// `volume_render` (:81) for rgb in [0,1] and sigma >= 0 (raw_rgb=False,
// raw_sigma=False), with the optional background blend.
//
// Per ray over its S samples (S >= 2):
//   rgb = clip(rgb, 0, 1); sigma = max(sigma, 0) [* sigma_scale]
//   delta_s = max(t[s+1] - t[s], 1e-4), the last interval repeated
//   alpha_s = clip(1 - exp(-sigma_s * delta_s), 0, 1 - 1e-7)
//   T_0 = 1, T_{s+1} = T_s * (1 - alpha_s + 1e-10); w_s = alpha_s * T_s
//   rgb_map = sum w rgb; depth = sum w t; acc = sum w;
//   rgb_map += (1 - acc) * bg when a background is given.
//
// Bound on the H100: bytes (~52 MB per 65,536-ray x 32-sample chunk: the
// (N, S, 4) samples and (N, S) t_vals in, (N, S) weights out; 3.2 MB at
// one inner step of 4,000 rays); the math is ~20 flops and one exp a
// sample. At the step the kernel is bound by latency: one thread a ray
// left 4,000 threads walking 32 dependent samples on 132 SMs, and its
// loads and weight stores were a row apart across the warp. The design is
// the VJP's lane map (volrend_common.cuh):
//   - a ray's samples on `lanes` consecutive lanes: 32 / lanes rays a warp
//     at S <= 16, pieces of 32 with the transmittance carried in a
//     register above 32;
//   - one 16-byte load of (rgb, sigma) a lane, its t and its neighbour's;
//   - T as a product scan across the segment (the VJP's order: a product
//     tree, not the reference's left-to-right cumprod; both within an ulp
//     or two a step of it);
//   - rgb, depth and acc as segment sums; the weights row stored
//     coalesced, a lane a sample; the background blend and the per-ray
//     outputs by the segment's first lane.
// The plan comes from Python (ops/volrend.py `volrend_plan`).
#include "volrend_common.cuh"

template <int W>
__global__ void __launch_bounds__(256) volume_render_fwd_kernel(
        const float* __restrict__ rgb_sigma, const float* __restrict__ t_vals,
        const float* __restrict__ bg, float* __restrict__ rgb_out,
        float* __restrict__ depth_out, float* __restrict__ weights_out,
        float* __restrict__ acc_out, int N, int S, float sigma_scale,
        int scale_on, int pieces) {
    constexpr int RAYS = 32 / W;  // rays a warp
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int sl = lane & (W - 1);  // the lane's place in its ray's segment
    const long long first =
        ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * RAYS;
    if (first >= N) return;  // the whole warp: no shuffle is left waiting
    const long long ray = first + lane / W;
    const bool live = ray < N;
    const long long row = live ? ray : first;
    const float* rs = rgb_sigma + row * S * 4;
    const float* t = t_vals + row * S;
    float* w_out = weights_out + row * S;

    float T = 1.0f;  // at the piece's start
    float cr = 0.0f, cg = 0.0f, cb = 0.0f, depth = 0.0f, acc = 0.0f;
    for (int p = 0; p < pieces; ++p) {
        const int s = p * W + sl;
        const Sample q = load_sample(rs, t, s, S, live, sigma_scale,
                                     scale_on);
        const float incl = seg_prod<W>(q.m, sl);
        float ex = __shfl_up_sync(FULL_MASK, incl, 1, W);
        if (sl == 0) ex = 1.0f;
        const float w = q.alpha * (T * ex);
        if (live && s < S) w_out[s] = w;
        cr += w * fminf(fmaxf(q.v.x, 0.0f), 1.0f);
        cg += w * fminf(fmaxf(q.v.y, 0.0f), 1.0f);
        cb += w * fminf(fmaxf(q.v.z, 0.0f), 1.0f);
        depth += w * q.t;
        acc += w;
        T = T * __shfl_sync(FULL_MASK, incl, W - 1, W);
    }
    cr = seg_sum<W>(cr);
    cg = seg_sum<W>(cg);
    cb = seg_sum<W>(cb);
    depth = seg_sum<W>(depth);
    acc = seg_sum<W>(acc);
    if (!live || sl != 0) return;
    if (bg != nullptr) {
        const float rest = 1.0f - acc;
        cr = cr + rest * __ldg(bg + ray * 3 + 0);
        cg = cg + rest * __ldg(bg + ray * 3 + 1);
        cb = cb + rest * __ldg(bg + ray * 3 + 2);
    }
    rgb_out[ray * 3 + 0] = cr;
    rgb_out[ray * 3 + 1] = cg;
    rgb_out[ray * 3 + 2] = cb;
    depth_out[ray] = depth;
    acc_out[ray] = acc;
}

// rgb_sigma: (N, S, 4), 16-byte aligned; t_vals: (N, S); bg: (N, 3) or
// null. Out: rgb (N, 3), depth (N,), weights (N, S), acc (N,).
NERF_API int volume_render_fwd(const float* rgb_sigma, const float* t_vals,
                               const float* bg, float* rgb, float* depth,
                               float* weights, float* acc, int N, int S,
                               int scale_on, float sigma_scale,
                               VolrendPlan plan, cudaStream_t stream) {
    const int W = plan.lanes;
    const int warps = plan.threads / 32;
    if (S < 2 || W < 2 || W > 32 || (W & (W - 1)) ||
        (long long)plan.pieces * W < S || (W < 32 && plan.pieces != 1) ||
        plan.threads < 32 || plan.threads > 256 || plan.threads % 32 ||
        (long long)plan.blocks * warps * (32 / W) < N || plan.smem != 0)
        return (int)cudaErrorInvalidValue;
    if (N <= 0) return (int)cudaGetLastError();
#define VOLREND_FWD_LAUNCH(LANES)                                            \
    volume_render_fwd_kernel<LANES><<<plan.blocks, plan.threads, 0,         \
                                      stream>>>(                             \
        rgb_sigma, t_vals, bg, rgb, depth, weights, acc, N, S, sigma_scale, \
        scale_on, plan.pieces)
    switch (W) {
        case 2: VOLREND_FWD_LAUNCH(2); break;
        case 4: VOLREND_FWD_LAUNCH(4); break;
        case 8: VOLREND_FWD_LAUNCH(8); break;
        case 16: VOLREND_FWD_LAUNCH(16); break;
        default: VOLREND_FWD_LAUNCH(32); break;
    }
#undef VOLREND_FWD_LAUNCH
    return (int)cudaGetLastError();
}
