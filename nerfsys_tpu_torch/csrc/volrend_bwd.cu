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
// A reverse scan WITHOUT division carries
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
// the (N, S, 4) gradient out; ~20 flops and one exp per sample). Design:
// one thread per ray, like the forward. Pass 1 recomputes the forward in
// its left-to-right order and parks alpha_s and T_s in the ray's own
// gradient row (slots 0 and 1) as scratch; pass 2 walks right to left,
// reads them back and overwrites the row with the gradient. No residual
// leaves the forward and no scratch is allocated.
#include "common.cuh"

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

__global__ void volume_render_bwd_kernel(
        const float* __restrict__ rgb_sigma, const float* __restrict__ t_vals,
        const float* __restrict__ bg, const float* __restrict__ g_rgb,
        const float* __restrict__ g_depth, const float* __restrict__ g_weights,
        const float* __restrict__ g_acc, float* __restrict__ g_rgb_sigma,
        float* __restrict__ g_bg, int N, int S, float sigma_scale,
        int scale_on) {
    const long long ray = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (ray >= N) return;
    const float* rs = rgb_sigma + ray * S * 4;
    const float* t = t_vals + ray * S;
    float* gs = g_rgb_sigma + ray * S * 4;
    const float* gw = g_weights != nullptr ? g_weights + ray * S : nullptr;
    const float hi = 1.0f - 1e-7f;

    // pass 1: the forward, parking alpha_s and T_s in the gradient row
    const float last_dt = fmaxf(t[S - 1] - t[S - 2], 1e-4f);
    float T = 1.0f, acc = 0.0f;
    for (int s = 0; s < S; ++s) {
        const float dt = (s < S - 1) ? fmaxf(t[s + 1] - t[s], 1e-4f) : last_dt;
        float sigma = fmaxf(rs[s * 4 + 3], 0.0f);
        if (scale_on) sigma = sigma * sigma_scale;
        const float alpha =
            fminf(fmaxf(1.0f - expf(-sigma * dt), 0.0f), hi);
        gs[s * 4 + 0] = alpha;
        gs[s * 4 + 1] = T;
        acc += alpha * T;
        T = T * (1.0f - alpha + 1e-10f);
    }

    const float G0 = g_rgb != nullptr ? g_rgb[ray * 3 + 0] : 0.0f;
    const float G1 = g_rgb != nullptr ? g_rgb[ray * 3 + 1] : 0.0f;
    const float G2 = g_rgb != nullptr ? g_rgb[ray * 3 + 2] : 0.0f;
    const float gd = g_depth != nullptr ? g_depth[ray] : 0.0f;
    const float ga = g_acc != nullptr ? g_acc[ray] : 0.0f;
    float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f;
    if (bg != nullptr) {
        b0 = bg[ray * 3 + 0];
        b1 = bg[ray * 3 + 1];
        b2 = bg[ray * 3 + 2];
        const float rest = 1.0f - acc;
        g_bg[ray * 3 + 0] = G0 * rest;
        g_bg[ray * 3 + 1] = G1 * rest;
        g_bg[ray * 3 + 2] = G2 * rest;
    }

    // pass 2: right to left, A = A_{s+1}
    float A = 0.0f;
    for (int s = S - 1; s >= 0; --s) {
        const float alpha = gs[s * 4 + 0];
        const float Ts = gs[s * 4 + 1];
        const float w = alpha * Ts;
        const float x0 = rs[s * 4 + 0], x1 = rs[s * 4 + 1],
                    x2 = rs[s * 4 + 2];
        const float r0 = fminf(fmaxf(x0, 0.0f), 1.0f);
        const float r1 = fminf(fmaxf(x1, 0.0f), 1.0f);
        const float r2 = fminf(fmaxf(x2, 0.0f), 1.0f);
        float g = G0 * (r0 - b0) + G1 * (r1 - b1) + G2 * (r2 - b2)
                + gd * t[s] + ga;
        if (gw != nullptr) g += gw[s];
        const float d_alpha = Ts * (g - A);
        A = g * alpha + (1.0f - alpha + 1e-10f) * A;

        const float dt = (s < S - 1) ? fmaxf(t[s + 1] - t[s], 1e-4f) : last_dt;
        const float sig_in = rs[s * 4 + 3];
        float sigma = fmaxf(sig_in, 0.0f);
        if (scale_on) sigma = sigma * sigma_scale;
        const float e = expf(-sigma * dt);
        float d_sigma = d_alpha * clip_grad(1.0f - e, 0.0f, hi) * (e * dt);
        if (scale_on) d_sigma = d_sigma * sigma_scale;
        gs[s * 4 + 0] = w * G0 * clip_grad(x0, 0.0f, 1.0f);
        gs[s * 4 + 1] = w * G1 * clip_grad(x1, 0.0f, 1.0f);
        gs[s * 4 + 2] = w * G2 * clip_grad(x2, 0.0f, 1.0f);
        gs[s * 4 + 3] = d_sigma * max_grad(sig_in, 0.0f);
    }
}

// rgb_sigma: (N, S, 4); t_vals: (N, S); bg: (N, 3) or null. Upstream
// gradients g_rgb (N, 3), g_depth (N,), g_weights (N, S), g_acc (N,), each
// or null. Out: g_rgb_sigma (N, S, 4); g_bg (N, 3), null when bg is.
NERF_API int volume_render_bwd(const float* rgb_sigma, const float* t_vals,
                               const float* bg, const float* g_rgb,
                               const float* g_depth, const float* g_weights,
                               const float* g_acc, float* g_rgb_sigma,
                               float* g_bg, int N, int S, int scale_on,
                               float sigma_scale, cudaStream_t stream) {
    if (S < 2 || (bg != nullptr) != (g_bg != nullptr))
        return (int)cudaErrorInvalidValue;
    if (N > 0) {
        const int threads = 128;
        volume_render_bwd_kernel<<<nerf_blocks(N, threads), threads, 0,
                                   stream>>>(
            rgb_sigma, t_vals, bg, g_rgb, g_depth, g_weights, g_acc,
            g_rgb_sigma, g_bg, N, S, sigma_scale, scale_on);
    }
    return (int)cudaGetLastError();
}
