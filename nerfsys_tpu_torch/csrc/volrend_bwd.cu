// Kernel 4, backward: the volume compositor's VJP.
//
// Replaces: the gradient of nerfsys_tpu/ops/volrend.py `volume_render` (:81)
// and `render_weights` (:57), which the JAX package leaves to autodiff
// through `jnp.cumprod`. Gradients reach rgb_sigma (N, S, 4) and the
// background (N, 3); t_vals gets none. An upstream gradient given as null
// (depth, weights, acc) counts as zero.
//
// Forward, per ray (kernel 4): r_s = clip(rgb_s, 0, 1);
// sigma_s = max(sigma_in_s, 0) [* scale]; a_s = 1 - exp(-sigma_s dt_s);
// alpha_s = clip(a_s, 0, 1 - 1e-7); m_s = 1 - alpha_s + 1e-10;
// T_0 = 1, T_{s+1} = T_s m_s; w_s = alpha_s T_s;
// rgb = sum w r + (1 - acc) bg, depth = sum w t, acc = sum w.
//
// Backward: with G = dL/drgb, the gradient reaching w_s is
//   g_s = G . (r_s - bg) + g_depth t_s + g_acc + g_w_s.
// A reverse recurrence WITHOUT division carries
//   A_s = g_s alpha_s + m_s A_{s+1},   A_S = 0,
// which is sum_{j>=s} g_j w_j / T_s, so dL/dm_s = T_s A_{s+1} and
//   dL/dalpha_s = T_s (g_s - A_{s+1}).
// (Recovering T_s as w_s / alpha_s, or undoing m_s by division, loses all
// precision once alpha reaches 1 - 1e-7 and m_s ~ 1e-7.)
// Every clip takes JAX's tie rule: jnp.clip is minimum(maximum(x, lo), hi)
// and max/min pass HALF the gradient when the operands are equal
// (alpha = 0 exactly whenever sigma dt < ~3e-8; rgb at 0 or 1).
//
// Bound on the H100: bytes (the (N, S, 4) samples and (N, S) t_vals in,
// the (N, S, 4) gradient out; ~40 flops and one exp per sample). At one
// inner step (4,000 rays x 32) that is 4.75 MB, ~1.4 us: the kernel is
// bound by latency, so the design spreads a ray over the lanes of a warp:
//   - lanes over samples: a ray's samples go to `lanes` consecutive lanes
//     (the power of 2 at or above S, at most 32), so a warp takes 32 /
//     lanes rays when S <= 16, and one ray in pieces of 32 samples with a
//     carry when S > 32;
//   - a lane reads its sample's (rgb, sigma) as one 16-byte load (a ray at
//     S = 32 is 512 coalesced bytes) and its t and its neighbour's;
//   - T_s is an exclusive product scan of m across the lanes (shuffles),
//     times the product of the pieces before; acc is a segment sum;
//   - A_{s+1} is an exclusive suffix scan of the affine maps
//     x -> b_s + m_s x (b_s = g_s alpha_s), composed by shuffles as
//     (m1, b1) o (m2, b2) = (m1 m2, b1 + m1 b2): still no division; the
//     pieces run last to first with A carried from the piece after;
//   - with several pieces, a first pass takes the T at each piece's start
//     (one float per piece and warp in shared memory); the second reloads
//     each piece and recomputes its values (from the L1 / L2);
//   - the gradient row is written once, as 16-byte stores: no scratch.
// The plan comes from Python (ops/volrend.py `volrend_plan`); the plan, the
// sample loader and the segment scans are kernel 4's too
// (volrend_common.cuh).
#include "volrend_common.cuh"

// d clip(x, lo, hi) / dx under the tie rule (NaN -> 0, as in JAX)
__device__ __forceinline__ float clip_grad(float x, float lo, float hi) {
    const float dmax = x > lo ? 1.0f : (x == lo ? 0.5f : 0.0f);
    const float m = fmaxf(x, lo);
    const float dmin = m < hi ? 1.0f : (m == hi ? 0.5f : 0.0f);
    return dmax * dmin;
}

__device__ __forceinline__ float max_grad(float x, float lo) {
    return x > lo ? 1.0f : (x == lo ? 0.5f : 0.0f);
}

// (m, b) becomes the composition of the maps of lanes sl..W-1 of the
// segment, the own map applied last: x -> b + m x.
template <int W>
__device__ __forceinline__ void seg_suffix(float& m, float& b, int sl) {
#pragma unroll
    for (int d = 1; d < W; d <<= 1) {
        const float m2 = __shfl_down_sync(FULL_MASK, m, d, W);
        const float b2 = __shfl_down_sync(FULL_MASK, b, d, W);
        if (sl + d < W) {
            b = b + m * b2;
            m = m * m2;
        }
    }
}

template <int W>
__global__ void __launch_bounds__(256) volume_render_bwd_kernel(
        const float* __restrict__ rgb_sigma, const float* __restrict__ t_vals,
        const float* __restrict__ bg, const float* __restrict__ g_rgb,
        const float* __restrict__ g_depth, const float* __restrict__ g_weights,
        const float* __restrict__ g_acc, float* __restrict__ g_rgb_sigma,
        float* __restrict__ g_bg, int N, int S, float sigma_scale,
        int scale_on, int pieces) {
    extern __shared__ float t_start[];  // (warps, pieces) when pieces > 1
    constexpr int RAYS = 32 / W;        // rays a warp
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
    float* gs = g_rgb_sigma + row * S * 4;
    const float* gw = g_weights != nullptr ? g_weights + row * S : nullptr;
    const float hi = 1.0f - 1e-7f;

    float G0 = 0.0f, G1 = 0.0f, G2 = 0.0f, gd = 0.0f, ga = 0.0f;
    float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f;
    if (live) {
        if (g_rgb != nullptr) {
            G0 = __ldg(g_rgb + ray * 3 + 0);
            G1 = __ldg(g_rgb + ray * 3 + 1);
            G2 = __ldg(g_rgb + ray * 3 + 2);
        }
        if (g_depth != nullptr) gd = __ldg(g_depth + ray);
        if (g_acc != nullptr) ga = __ldg(g_acc + ray);
        if (bg != nullptr) {
            b0 = __ldg(bg + ray * 3 + 0);
            b1 = __ldg(bg + ray * 3 + 1);
            b2 = __ldg(bg + ray * 3 + 2);
        }
    }

    // pass 1 (several pieces): T at each piece's start
    float* ts = t_start + warp * pieces;
    if (pieces > 1) {
        float T = 1.0f;
        for (int p = 0; p < pieces; ++p) {
            const Sample q = load_sample(rs, t, p * W + sl, S, live,
                                         sigma_scale, scale_on);
            const float incl = seg_prod<W>(q.m, sl);
            if (sl == 0) ts[p] = T;
            T = T * __shfl_sync(FULL_MASK, incl, W - 1, W);
        }
        __syncwarp();
    }

    // pass 2: the pieces last to first, A = A at the next piece's start
    float A = 0.0f, acc = 0.0f;
    for (int p = pieces - 1; p >= 0; --p) {
        const int s = p * W + sl;
        const Sample q = load_sample(rs, t, s, S, live, sigma_scale,
                                     scale_on);
        const float incl = seg_prod<W>(q.m, sl);
        float ex = __shfl_up_sync(FULL_MASK, incl, 1, W);
        if (sl == 0) ex = 1.0f;
        const float Ts = pieces > 1 ? ts[p] * ex : ex;
        const float w = q.alpha * Ts;
        acc += w;
        const bool on = live && s < S;
        const float r0 = fminf(fmaxf(q.v.x, 0.0f), 1.0f);
        const float r1 = fminf(fmaxf(q.v.y, 0.0f), 1.0f);
        const float r2 = fminf(fmaxf(q.v.z, 0.0f), 1.0f);
        float g = 0.0f;
        if (on) {
            g = G0 * (r0 - b0) + G1 * (r1 - b1) + G2 * (r2 - b2)
                + gd * q.t + ga;
            if (gw != nullptr) g += __ldg(gw + s);
        }
        float mm = q.m, bb = g * q.alpha;
        seg_suffix<W>(mm, bb, sl);
        float mn = __shfl_down_sync(FULL_MASK, mm, 1, W);
        float bn = __shfl_down_sync(FULL_MASK, bb, 1, W);
        if (sl == W - 1) {
            mn = 1.0f;
            bn = 0.0f;
        }
        const float d_alpha = Ts * (g - (bn + mn * A));  // A_{s+1}
        A = __shfl_sync(FULL_MASK, bb + mm * A, 0, W);
        if (on) {
            float d_sigma =
                d_alpha * clip_grad(1.0f - q.e, 0.0f, hi) * (q.e * q.dt);
            if (scale_on) d_sigma = d_sigma * sigma_scale;
            reinterpret_cast<float4*>(gs)[s] = make_float4(
                w * G0 * clip_grad(q.v.x, 0.0f, 1.0f),
                w * G1 * clip_grad(q.v.y, 0.0f, 1.0f),
                w * G2 * clip_grad(q.v.z, 0.0f, 1.0f),
                d_sigma * max_grad(q.v.w, 0.0f));
        }
    }
    acc = seg_sum<W>(acc);
    if (bg != nullptr && live && sl == 0) {
        const float rest = 1.0f - acc;
        g_bg[ray * 3 + 0] = G0 * rest;
        g_bg[ray * 3 + 1] = G1 * rest;
        g_bg[ray * 3 + 2] = G2 * rest;
    }
}

// rgb_sigma: (N, S, 4), 16-byte aligned; t_vals: (N, S); bg: (N, 3) or
// null. Upstream gradients g_rgb (N, 3), g_depth (N,), g_weights (N, S),
// g_acc (N,), each or null. Out: g_rgb_sigma (N, S, 4), 16-byte aligned;
// g_bg (N, 3), null when bg is.
NERF_API int volume_render_bwd(const float* rgb_sigma, const float* t_vals,
                               const float* bg, const float* g_rgb,
                               const float* g_depth, const float* g_weights,
                               const float* g_acc, float* g_rgb_sigma,
                               float* g_bg, int N, int S, int scale_on,
                               float sigma_scale, VolrendPlan plan,
                               cudaStream_t stream) {
    const int W = plan.lanes;
    const int warps = plan.threads / 32;
    if (S < 2 || (bg != nullptr) != (g_bg != nullptr) || W < 2 || W > 32 ||
        (W & (W - 1)) || (long long)plan.pieces * W < S ||
        (W < 32 && plan.pieces != 1) || plan.threads < 32 ||
        plan.threads > 256 || plan.threads % 32 ||
        (long long)plan.blocks * warps * (32 / W) < N ||
        plan.smem != (plan.pieces > 1 ? 4 * warps * plan.pieces : 0) ||
        plan.smem > 48 * 1024)
        return (int)cudaErrorInvalidValue;
    if (N <= 0) return (int)cudaGetLastError();
#define VOLREND_BWD_LAUNCH(LANES)                                            \
    volume_render_bwd_kernel<LANES><<<plan.blocks, plan.threads, plan.smem, \
                                      stream>>>(                             \
        rgb_sigma, t_vals, bg, g_rgb, g_depth, g_weights, g_acc,            \
        g_rgb_sigma, g_bg, N, S, sigma_scale, scale_on, plan.pieces)
    switch (W) {
        case 2: VOLREND_BWD_LAUNCH(2); break;
        case 4: VOLREND_BWD_LAUNCH(4); break;
        case 8: VOLREND_BWD_LAUNCH(8); break;
        case 16: VOLREND_BWD_LAUNCH(16); break;
        default: VOLREND_BWD_LAUNCH(32); break;
    }
#undef VOLREND_BWD_LAUNCH
    return (int)cudaGetLastError();
}
