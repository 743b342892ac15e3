// Kernel 4'': the volume compositor's second-order product (the VJP of
// kernel 4's VJP), which second-order MAML takes through its inner loop.
//
// Replaces: autodiff of the VJP of nerfsys_tpu/ops/volrend.py
// `volume_render` (:81) and `render_weights` (:57): the JAX package's MAML
// (`task_adapt`, pipelines/offline/meta_core.py:258-286) differentiates
// the inner gradient, so XLA differentiates the compositor twice. Kernel
// 4' is F(x, u) = J(x)^T u for the samples x = (rgb_sigma, bg) and the
// upstream u = (G = d rgb, g_depth, g_weights, g_acc), each nullable.
// Given the cotangents v = (v_rs, v_bg) of F's outputs this kernel returns
//   d u = J(x) v: the forward compositor's JVP at x in the direction v
//         (rgb', depth', w', acc'), for each upstream that was given;
//   d x = u^T H v: the gradient of Phi(x) = <u, J(x) v> at fixed u, v.
//
// Forward, per ray (kernel 4): r_s = clip(c_s, 0, 1); sigma_s =
// max(sigma_in_s, 0) [* scale]; e_s = exp(-sigma_s dt_s); alpha_s =
// clip(1 - e_s, 0, 1 - 1e-7); m_s = 1 - alpha_s + 1e-10; T_0 = 1,
// T_{s+1} = T_s m_s; w_s = alpha_s T_s; rgb = sum w r + (1 - acc) bg.
// Every clip's derivative takes JAX's tie rule (half at a bound) and is
// constant: its second derivative is 0. With kappa_s = d clip(1 - e) and
// alpha'_s = kappa_s e_s dt_s, the tangent in the direction v is
//   r'_s = d clip(c_s) v_c,  sigma'_s = d max(sigma_in_s) v_sigma [* scale],
//   a'_s = alpha'_s sigma'_s,  T'_0 = 0,  T'_{s+1} = T'_s m_s - T_s a'_s,
//   w'_s = a'_s T_s + alpha_s T'_s,
//   rgb' = sum (w' r + w r') - acc' bg + (1 - acc) v_bg,
//   depth' = sum w' t,  acc' = sum w'.
// With g_s = G . (r_s - bg) + g_depth t_s + g_acc + g_weights_s (kernel 4's)
// and h_s = G . r'_s - G . v_bg,
//   Phi = sum_s w'_s g_s + w_s h_s + G . v_bg.
// Reverse mode over that program, without division, carries two suffix
// recurrences, Q for T' and P for T:
//   Q_s = g_s alpha_s + m_s Q_{s+1}       (kernel 4's A_s),   Q_S = 0,
//   P_s = m_s P_{s+1} + a'_s (g_s - Q_{s+1}) + h_s alpha_s,    P_S = 0,
// and then, per sample,
//   d sigma_s = alpha'_s (T'_s (g_s - Q_{s+1}) + T_s (h_s - P_{s+1}))
//               - dt_s a'_s T_s (g_s - Q_{s+1}),
//   d sigma_in_s = d sigma_s [* scale] d max(sigma_in_s),
//   d c_s = w'_s G * d clip(c_s),   d bg = -G acc'.
//
// Bound on the H100: bytes. Per sample it reads (rgb, sigma), t and the
// (rgb, sigma) cotangent and writes the (rgb, sigma) product (52 bytes,
// and 4 more when g_weights is given), with ~90 flops and one exp; at one
// inner step (4,000 rays x 32) that is ~6.7 MB, ~2 us. The launch runs in
// one wave, every warp loading, computing and storing at once, so the
// time is the launch, the loads and stores, and the arithmetic and
// shuffles each warp issues in between (kernel_ab.py's split at one
// inner step, PERF.md). Its design is kernel 4''s (plan, lane map, sample
// loader and segment scans from volrend_common.cuh): a ray's samples on
// `lanes` lanes; T and T' as one scan of the forward pair,
// (T, T')_{s+1} = [[m_s, 0], [-a'_s, m_s]] (T, T')_s, whose
// lower-triangular matrices with equal diagonal (d, c) compose as
// (d1 d2, d1 c2 + c1 d2) (it commutes), an exclusive scan from (1, 0); Q
// and P as suffix scans of affine maps (the composition (m1, b1) o (m2,
// b2) = (m1 m2, b1 + m1 b2) needs no division), Q's first, since P's map
// takes Q_{s+1}. (One scan of (P, Q)'s 4-float maps, and several
// consecutive samples a lane composed in registers, measured slower: the
// shuffles are the same or more, the loads strided.) With several pieces
// a first pass keeps T and T' at each piece's start (two floats a piece
// and warp in shared memory) and the second walks the pieces last to
// first with Q and P carried. Every output is written once: no atomics,
// no scratch.
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

// The forward pair (T, T'): (d, c) becomes the composition of the maps
// (m_s, -a'_s) of lanes 0..sl of the segment (an inclusive scan; the
// matrices commute).
template <int W>
__device__ __forceinline__ void fwd_scan(float& d, float& c, int sl) {
#pragma unroll
    for (int k = 1; k < W; k <<= 1) {
        const float d2 = __shfl_up_sync(FULL_MASK, d, k, W);
        const float c2 = __shfl_up_sync(FULL_MASK, c, k, W);
        if (sl >= k) {
            c = d2 * c + c2 * d;
            d = d2 * d;
        }
    }
}

// One sample's tangent quantities: alpha'_s and a'_s (0 off the ray).
struct Tangent {
    float ap, ad;
};

__device__ __forceinline__ Tangent sample_tangent(const Sample& q,
                                                  float v_sigma, bool on,
                                                  float sigma_scale,
                                                  int scale_on, float hi) {
    Tangent k;
    k.ap = on ? clip_grad(1.0f - q.e, 0.0f, hi) * q.e * q.dt : 0.0f;
    float sd = on ? max_grad(q.v.w, 0.0f) * v_sigma : 0.0f;
    if (scale_on) sd = sd * sigma_scale;
    k.ad = k.ap * sd;
    return k;
}

template <int W>
__global__ void __launch_bounds__(256) volume_render_bwd2_kernel(
        const float* __restrict__ rgb_sigma, const float* __restrict__ t_vals,
        const float* __restrict__ bg, const float* __restrict__ g_rgb,
        const float* __restrict__ g_depth, const float* __restrict__ g_weights,
        const float* __restrict__ g_acc, const float* __restrict__ v_rs,
        const float* __restrict__ v_bg, float* __restrict__ d_rs,
        float* __restrict__ d_bg, float* __restrict__ d_rgb,
        float* __restrict__ d_depth, float* __restrict__ d_weights,
        float* __restrict__ d_acc, int N, int S, float sigma_scale,
        int scale_on, int pieces) {
    extern __shared__ float starts[];  // (warps, pieces, 2) when pieces > 1
    constexpr int RAYS = 32 / W;       // rays a warp
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
    const float4* vs = reinterpret_cast<const float4*>(v_rs + row * S * 4);
    const float* t = t_vals + row * S;
    const float* gw = g_weights != nullptr ? g_weights + row * S : nullptr;
    const float hi = 1.0f - 1e-7f;

    float G0 = 0.0f, G1 = 0.0f, G2 = 0.0f, gd = 0.0f, ga = 0.0f;
    float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f, vb0 = 0.0f, vb1 = 0.0f, vb2 = 0.0f;
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
        if (v_bg != nullptr) {
            vb0 = __ldg(v_bg + ray * 3 + 0);
            vb1 = __ldg(v_bg + ray * 3 + 1);
            vb2 = __ldg(v_bg + ray * 3 + 2);
        }
    }
    const float gvb = G0 * vb0 + G1 * vb1 + G2 * vb2;

    // pass 1 (several pieces): T and T' at each piece's start
    float* st = starts + warp * pieces * 2;
    if (pieces > 1) {
        float T = 1.0f, Td = 0.0f;
        for (int p = 0; p < pieces; ++p) {
            const int s = p * W + sl;
            const Sample q = load_sample(rs, t, s, S, live, sigma_scale,
                                         scale_on);
            const bool on = live && s < S;
            const Tangent k = sample_tangent(q, on ? __ldg(vs + s).w : 0.0f,
                                             on, sigma_scale, scale_on, hi);
            float d = q.m, c = -k.ad;
            fwd_scan<W>(d, c, sl);
            if (sl == 0) {
                st[2 * p] = T;
                st[2 * p + 1] = Td;
            }
            const float D = __shfl_sync(FULL_MASK, d, W - 1, W);
            const float C = __shfl_sync(FULL_MASK, c, W - 1, W);
            Td = C * T + D * Td;
            T = D * T;
        }
        __syncwarp();
    }

    // pass 2: the pieces last to first; Q and P at the next piece's start
    float Q = 0.0f, P = 0.0f;
    float acc = 0.0f, accd = 0.0f, rd0 = 0.0f, rd1 = 0.0f, rd2 = 0.0f;
    float dd = 0.0f;
    for (int p = pieces - 1; p >= 0; --p) {
        const int s = p * W + sl;
        const Sample q = load_sample(rs, t, s, S, live, sigma_scale,
                                     scale_on);
        const bool on = live && s < S;
        const float4 v = on ? __ldg(vs + s) : make_float4(0.f, 0.f, 0.f, 0.f);
        const Tangent k = sample_tangent(q, v.w, on, sigma_scale, scale_on,
                                         hi);
        // (T, T') at the sample: the lanes before, exclusive, after the
        // pieces before
        float fd = q.m, fc = -k.ad;
        fwd_scan<W>(fd, fc, sl);
        float ex = __shfl_up_sync(FULL_MASK, fd, 1, W);
        float ec = __shfl_up_sync(FULL_MASK, fc, 1, W);
        if (sl == 0) {
            ex = 1.0f;
            ec = 0.0f;
        }
        const float T0 = pieces > 1 ? st[2 * p] : 1.0f;
        const float Td0 = pieces > 1 ? st[2 * p + 1] : 0.0f;
        const float Ts = T0 * ex;
        const float Tds = ec * T0 + ex * Td0;

        const float w = q.alpha * Ts;
        const float wd = k.ad * Ts + q.alpha * Tds;
        const float c0 = clip_grad(q.v.x, 0.0f, 1.0f);
        const float c1 = clip_grad(q.v.y, 0.0f, 1.0f);
        const float c2 = clip_grad(q.v.z, 0.0f, 1.0f);
        const float r0 = fminf(fmaxf(q.v.x, 0.0f), 1.0f);
        const float r1 = fminf(fmaxf(q.v.y, 0.0f), 1.0f);
        const float r2 = fminf(fmaxf(q.v.z, 0.0f), 1.0f);
        acc += w;
        accd += wd;
        rd0 += wd * r0 + w * (c0 * v.x);
        rd1 += wd * r1 + w * (c1 * v.y);
        rd2 += wd * r2 + w * (c2 * v.z);
        dd += wd * q.t;
        float g = 0.0f, h = 0.0f;
        if (on) {
            g = G0 * (r0 - b0) + G1 * (r1 - b1) + G2 * (r2 - b2)
                + gd * q.t + ga;
            if (gw != nullptr) g += __ldg(gw + s);
            h = G0 * (c0 * v.x) + G1 * (c1 * v.y) + G2 * (c2 * v.z) - gvb;
            if (d_weights != nullptr) d_weights[row * S + s] = wd;
        }

        // Q_{s+1}: kernel 4''s suffix scan of x -> g alpha + m x
        float qm = q.m, qb = g * q.alpha;
        seg_suffix<W>(qm, qb, sl);
        float qmn = __shfl_down_sync(FULL_MASK, qm, 1, W);
        float qbn = __shfl_down_sync(FULL_MASK, qb, 1, W);
        if (sl == W - 1) {
            qmn = 1.0f;
            qbn = 0.0f;
        }
        const float Qn = qbn + qmn * Q;
        Q = __shfl_sync(FULL_MASK, qb + qm * Q, 0, W);
        const float gq = g - Qn;

        // P_{s+1}: the suffix scan of x -> a' (g - Q_{s+1}) + h alpha + m x
        float pm = q.m, pb = k.ad * gq + h * q.alpha;
        seg_suffix<W>(pm, pb, sl);
        float pmn = __shfl_down_sync(FULL_MASK, pm, 1, W);
        float pbn = __shfl_down_sync(FULL_MASK, pb, 1, W);
        if (sl == W - 1) {
            pmn = 1.0f;
            pbn = 0.0f;
        }
        const float Pn = pbn + pmn * P;
        P = __shfl_sync(FULL_MASK, pb + pm * P, 0, W);

        if (on) {
            float d_sigma = k.ap * (Tds * gq + Ts * (h - Pn))
                            - q.dt * k.ad * Ts * gq;
            if (scale_on) d_sigma = d_sigma * sigma_scale;
            reinterpret_cast<float4*>(d_rs + row * S * 4)[s] = make_float4(
                wd * G0 * c0, wd * G1 * c1, wd * G2 * c2,
                d_sigma * max_grad(q.v.w, 0.0f));
        }
    }
    acc = seg_sum<W>(acc);
    accd = seg_sum<W>(accd);
    rd0 = seg_sum<W>(rd0);
    rd1 = seg_sum<W>(rd1);
    rd2 = seg_sum<W>(rd2);
    dd = seg_sum<W>(dd);
    if (live && sl == 0) {
        if (d_rgb != nullptr) {
            const float rest = 1.0f - acc;
            d_rgb[ray * 3 + 0] = rd0 - accd * b0 + rest * vb0;
            d_rgb[ray * 3 + 1] = rd1 - accd * b1 + rest * vb1;
            d_rgb[ray * 3 + 2] = rd2 - accd * b2 + rest * vb2;
        }
        if (d_depth != nullptr) d_depth[ray] = dd;
        if (d_acc != nullptr) d_acc[ray] = accd;
        if (d_bg != nullptr) {
            d_bg[ray * 3 + 0] = -G0 * accd;
            d_bg[ray * 3 + 1] = -G1 * accd;
            d_bg[ray * 3 + 2] = -G2 * accd;
        }
    }
}

// rgb_sigma, v_rs: (N, S, 4), 16-byte aligned; t_vals: (N, S); bg: (N, 3)
// or null; v_bg: (N, 3) or null (zero). Upstream g_rgb (N, 3), g_depth
// (N,), g_weights (N, S), g_acc (N,), each or null. Out: d_rs (N, S, 4),
// 16-byte aligned; d_bg (N, 3), null when bg is; d_rgb, d_depth,
// d_weights, d_acc each null when its upstream is. The plan is kernel 4''s
// (shared memory: two floats a piece and warp, here twice 4''s).
NERF_API int volume_render_bwd2(const float* rgb_sigma, const float* t_vals,
                                const float* bg, const float* g_rgb,
                                const float* g_depth, const float* g_weights,
                                const float* g_acc, const float* v_rs,
                                const float* v_bg, float* d_rs, float* d_bg,
                                float* d_rgb, float* d_depth,
                                float* d_weights, float* d_acc, int N, int S,
                                int scale_on, float sigma_scale,
                                VolrendPlan plan, cudaStream_t stream) {
    const int W = plan.lanes;
    const int warps = plan.threads / 32;
    const int smem = plan.pieces > 1 ? 8 * warps * plan.pieces : 0;
    if (S < 2 || (bg != nullptr) != (d_bg != nullptr) ||
        (bg == nullptr && v_bg != nullptr) ||
        (g_rgb != nullptr) != (d_rgb != nullptr) ||
        (g_depth != nullptr) != (d_depth != nullptr) ||
        (g_weights != nullptr) != (d_weights != nullptr) ||
        (g_acc != nullptr) != (d_acc != nullptr) || W < 2 || W > 32 ||
        (W & (W - 1)) || (long long)plan.pieces * W < S ||
        (W < 32 && plan.pieces != 1) || plan.threads < 32 ||
        plan.threads > 256 || plan.threads % 32 ||
        (long long)plan.blocks * warps * (32 / W) < N ||
        plan.smem != (plan.pieces > 1 ? 4 * warps * plan.pieces : 0) ||
        smem > 96 * 1024)
        return (int)cudaErrorInvalidValue;
    if (N <= 0) return (int)cudaGetLastError();
#define VOLREND_BWD2_LAUNCH(LANES)                                           \
    do {                                                                     \
        if (smem > 48 * 1024) {                                              \
            const cudaError_t e = cudaFuncSetAttribute(                      \
                volume_render_bwd2_kernel<LANES>,                            \
                cudaFuncAttributeMaxDynamicSharedMemorySize, smem);          \
            if (e != cudaSuccess) return (int)e;                             \
        }                                                                    \
        volume_render_bwd2_kernel<LANES>                                     \
            <<<plan.blocks, plan.threads, smem, stream>>>(                   \
                rgb_sigma, t_vals, bg, g_rgb, g_depth, g_weights, g_acc,     \
                v_rs, v_bg, d_rs, d_bg, d_rgb, d_depth, d_weights, d_acc, N, \
                S, sigma_scale, scale_on, plan.pieces);                      \
    } while (0)
    switch (W) {
        case 2: VOLREND_BWD2_LAUNCH(2); break;
        case 4: VOLREND_BWD2_LAUNCH(4); break;
        case 8: VOLREND_BWD2_LAUNCH(8); break;
        case 16: VOLREND_BWD2_LAUNCH(16); break;
        default: VOLREND_BWD2_LAUNCH(32); break;
    }
#undef VOLREND_BWD2_LAUNCH
    return (int)cudaGetLastError();
}
