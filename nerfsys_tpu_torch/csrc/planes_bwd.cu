// Kernels 5 and 6: plane/line encoder, backward (the VJPs of kernel 1).
//
// Replaces: nerfsys_tpu/ops/planes.py
//   `_plane_encode_mm_light_bwd` (:565), the pos_grad=False VJP: table
//     gradients from the plane and line values ROUNDED TO BFLOAT16 (the
//     reference saves them as bf16 residuals, :556-560), zero position
//     gradients -> `plane_encode_bwd_light`;
//   `_plane_encode_mm_bwd` (:449), the exact VJP: float32 table gradients
//     and position gradients -> `plane_encode_bwd`.
// Both compute the table gradient that `_scatter_grads_mm` (:326-384)
// forms as one-hot matmul contractions: for each point, the cotangent g of
// one (level, orientation) feature block adds
//   plane[u0+i, v0+j] += wu_i * (wv_j * g * line)     (4 corners)
//   line[w0+k]        += ww_k * (g * plane)           (2 nodes)
// with the bilinear / linear weights wu = (1-fu, fu) etc. The reference's
// contraction runs in float32 on the CPU (bwd_dtype=bfloat16 is forced to
// float32 there, :576-578); so does this kernel.
//
// Residuals: the plane and line values are RECOMPUTED here from the tables
// (4 + 2 row reads per thread, the forward's own arithmetic) rather than
// written by kernel 1. Kernel 1 then stays exactly the serving kernel, and
// no (P, 2 * 72) residual buffer lives between an inner step's forward and
// backward. One expert's tables are ~33 MB at bench width (L=3, base 128,
// F=8), under the 50 MB L2, but the gradient tables double that.
// This file compiles with --fmad=false, so the recomputed values round
// exactly like the plain PyTorch version (one op at a time) before the
// bfloat16 rounding (round to nearest even, __float2bfloat16_rn).
//
// Edge: the reference's one-hot profile drops column R when u0 = R-1
// (:319-322); here the neighbour index is clamped to R-1 as in kernel 1,
// and its weight there is fu = 0, so the add is a harmless zero.
// Position gradients: d feature / d frac times (R-1), masked per
// coordinate by the INCLUSIVE test 0 <= x <= 1 (:531).
//
// Bound on the H100: bytes, the cotangent (K*N*72 floats) read once and
// the gradient tables written; each point's 6 row updates are fp32
// atomicAdd into L2-resident tables. Design: one thread per (expert,
// point, level x orientation), as kernel 1; the wrapper zeroes the
// (K, 3, R^2, F) and (K, 3, R, F) gradient tables (and gx) first.
#include "common.cuh"

#include <cuda_bf16.h>

#define PLANES_MAX_LEVELS 8

struct PlaneLevels {  // same layout as csrc/planes.cu
    const float* planes[PLANES_MAX_LEVELS];  // (K, 3, R*R, F) per level
    const float* lines[PLANES_MAX_LEVELS];   // (K, 3, R, F) per level
    int res[PLANES_MAX_LEVELS];
    float clip_hi[PLANES_MAX_LEVELS];        // float32(R - 1 - 1e-6)
    int levels;
    int has_lines;
};

struct PlaneGrads {
    float* planes[PLANES_MAX_LEVELS];  // (K, 3, R*R, F) per level, zeroed
    float* lines[PLANES_MAX_LEVELS];   // (K, 3, R, F) per level, zeroed
};

__device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool EXACT>
__global__ void plane_encode_bwd_kernel(const float* __restrict__ x,
                                        const float* __restrict__ ct,
                                        PlaneLevels lv, PlaneGrads gr,
                                        float* __restrict__ gx, int K, int N,
                                        int F) {
    const int LO = lv.levels * 3;
    const long long total = (long long)K * N * LO;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (tid >= total) return;
    const int lo = (int)(tid % LO);       // level * 3 + orientation
    const long long kn = tid / LO;        // expert * N + point
    const int k = (int)(kn / N);
    const int l = lo / 3;
    const int o = lo - 3 * l;
    const int a = (o == 2) ? 1 : 0;
    const int b = (o == 0) ? 1 : 2;
    const int c = (o == 0) ? 2 : ((o == 1) ? 1 : 0);

    const int R = lv.res[l];
    const float R1 = (float)(R - 1);
    const float hi = lv.clip_hi[l];
    const float* xp = x + kn * 3;
    const float u = fminf(fmaxf(xp[a], 0.0f), 1.0f) * R1;
    const float v = fminf(fmaxf(xp[b], 0.0f), 1.0f) * R1;
    const float u0f = floorf(fminf(fmaxf(u, 0.0f), hi));
    const float v0f = floorf(fminf(fmaxf(v, 0.0f), hi));
    const float fu = u - u0f;
    const float fv = v - v0f;
    const int u0 = (int)u0f;
    const int v0 = (int)v0f;
    const int u1 = min(u0 + 1, R - 1);
    const int v1 = min(v0 + 1, R - 1);

    const long long RR = (long long)R * R;
    const long long pofs = ((long long)k * 3 + o) * RR * F;
    const long long r00 = ((long long)u0 * R + v0) * F;
    const long long r01 = ((long long)u0 * R + v1) * F;
    const long long r10 = ((long long)u1 * R + v0) * F;
    const long long r11 = ((long long)u1 * R + v1) * F;
    const float* t = lv.planes[l] + pofs;
    float* gt = gr.planes[l] + pofs;
    const float au = 1.0f - fu;
    const float av = 1.0f - fv;

    const int has_lines = lv.has_lines;
    const float* l0 = nullptr;
    const float* l1 = nullptr;
    float* gl0 = nullptr;
    float* gl1 = nullptr;
    float fw = 0.0f;
    if (has_lines) {
        const float w = fminf(fmaxf(xp[c], 0.0f), 1.0f) * R1;
        const float w0f = floorf(fminf(fmaxf(w, 0.0f), hi));
        fw = w - w0f;
        const int w0 = (int)w0f;
        const int w1 = min(w0 + 1, R - 1);
        const long long lofs = ((long long)k * 3 + o) * R * F;
        l0 = lv.lines[l] + lofs + (long long)w0 * F;
        l1 = lv.lines[l] + lofs + (long long)w1 * F;
        gl0 = gr.lines[l] + lofs + (long long)w0 * F;
        gl1 = gr.lines[l] + lofs + (long long)w1 * F;
    }
    const float aw = 1.0f - fw;

    const float* g = ct + kn * (long long)(LO * F) + (long long)lo * F;
    float dfu = 0.0f, dfv = 0.0f, dfw = 0.0f;
    for (int f = 0; f < F; ++f) {
        const float gf = g[f];
        const float t00 = t[r00 + f], t01 = t[r01 + f];
        const float t10 = t[r10 + f], t11 = t[r11 + f];
        const float bv = t00 * au * av + t01 * au * fv + t10 * fu * av
                       + t11 * fu * fv;
        float gp = gf;
        float lval = 1.0f;
        if (has_lines) {
            lval = l0[f] * aw + l1[f] * fw;
            float gl;
            if (EXACT) {
                gp = gf * lval;
                gl = gf * bv;
            } else {
                gp = gf * bf16_round(lval);
                gl = gf * bf16_round(bv);
            }
            atomicAdd(gl0 + f, aw * gl);
            atomicAdd(gl1 + f, fw * gl);
        }
        atomicAdd(gt + r00 + f, au * (av * gp));
        atomicAdd(gt + r01 + f, au * (fv * gp));
        atomicAdd(gt + r10 + f, fu * (av * gp));
        atomicAdd(gt + r11 + f, fu * (fv * gp));
        if (EXACT) {
            const float db_dfu = (t10 - t00) * av + (t11 - t01) * fv;
            const float db_dfv = (t01 - t00) * au + (t11 - t10) * fu;
            dfu += gf * lval * db_dfu;
            dfv += gf * lval * db_dfv;
            if (has_lines) dfw += gf * bv * (l1[f] - l0[f]);
        }
    }
    if (EXACT) {
        float* gxp = gx + kn * 3;
        if (xp[a] >= 0.0f && xp[a] <= 1.0f) atomicAdd(gxp + a, dfu * R1);
        if (xp[b] >= 0.0f && xp[b] <= 1.0f) atomicAdd(gxp + b, dfv * R1);
        if (has_lines && xp[c] >= 0.0f && xp[c] <= 1.0f)
            atomicAdd(gxp + c, dfw * R1);
    }
}

static int launch_bwd(bool exact, const float* x, const float* ct,
                      PlaneLevels lv, PlaneGrads gr, float* gx, int K, int N,
                      int F, cudaStream_t stream) {
    const long long total = (long long)K * N * lv.levels * 3;
    if (total > 0) {
        const int threads = 256;
        if (exact)
            plane_encode_bwd_kernel<true><<<nerf_blocks(total, threads),
                                            threads, 0, stream>>>(
                x, ct, lv, gr, gx, K, N, F);
        else
            plane_encode_bwd_kernel<false><<<nerf_blocks(total, threads),
                                             threads, 0, stream>>>(
                x, ct, lv, gr, gx, K, N, F);
    }
    return (int)cudaGetLastError();
}

// x: (K, N, 3) unit-cube points; ct: (K, N, 3 * levels * F) cotangent.
// Adds into the zeroed gradient tables of `gr`.
NERF_API int plane_encode_bwd_light(const float* x, const float* ct,
                                    PlaneLevels lv, PlaneGrads gr, int K,
                                    int N, int F, cudaStream_t stream) {
    return launch_bwd(false, x, ct, lv, gr, nullptr, K, N, F, stream);
}

// As above, and adds the position gradient into the zeroed gx (K, N, 3).
NERF_API int plane_encode_bwd(const float* x, const float* ct,
                              PlaneLevels lv, PlaneGrads gr, float* gx, int K,
                              int N, int F, cudaStream_t stream) {
    if (gx == nullptr) return (int)cudaErrorInvalidValue;
    return launch_bwd(true, x, ct, lv, gr, gx, K, N, F, stream);
}
