// Kernel 1: plane/line (TensoRF vector-matrix) encoder, forward.
//
// Replaces: nerfsys_tpu/ops/planes.py `_plane_encode_parts` (:269) with
// `_bilinear_rows` (:155, packed corners) and `_linear_rows` (:200), reached
// from `plane_encode` (:621) through the `_plane_encode_mm_light` custom VJP
// (:542). It computes what that op computes, not its TPU layout: no rolled
// 4F-wide corner tables are built; each corner row is read in place.
//
// Per point x in [0,1]^3 (clipped), level l with resolution R, orientation
// (a,b|c) of _ORIENTATIONS = ((0,1,2),(0,2,1),(1,2,0)):
//   u,v,w = x_a, x_b, x_c times (R-1)
//   plane = bilinear lerp of the (R*R, F) table at (u, v)
//   line  = linear lerp of the (R, F) table at w
//   out[(l*3+o)*F + f] = plane[f] * line[f]           (level-major concat)
// with the cell index floor(clip(u, 0, R-1-1e-6)) of the reference.
//
// Edge: float32(R-1-1e-6) == R-1 for R >= 128, so a coordinate of exactly
// 1.0 gives u0 = R-1 (the JAX packed path then reads wrapped rows with
// weight 0). Here every neighbour index is clamped to R-1; its weight is 0,
// so the result is unchanged and every read stays in bounds.
//
// Bound on the H100: bytes. Per point it reads 3 floats and writes 3*L*F
// floats, while the arithmetic is ~12 flops per output float; the output
// (K*N*72 floats at bench width, ~604 MB per 65,536x32 chunk at K=4)
// dominates the traffic. Design: one thread per (expert, point,
// level x orientation), the 9 threads of one point adjacent so their output
// rows form one contiguous 72-float span; each thread writes its F floats
// contiguously. Tables (~8 MB per expert) stay largely L2-resident, so the
// random corner reads cost L2 rather than HBM bandwidth.
#include "common.cuh"

#define PLANES_MAX_LEVELS 8

struct PlaneLevels {
    const float* planes[PLANES_MAX_LEVELS];  // (K, 3, R*R, F) per level
    const float* lines[PLANES_MAX_LEVELS];   // (K, 3, R, F) per level
    int res[PLANES_MAX_LEVELS];
    float clip_hi[PLANES_MAX_LEVELS];        // float32(R - 1 - 1e-6)
    int levels;
    int has_lines;
};

__global__ void plane_encode_fwd_kernel(const float* __restrict__ x,
                                        float* __restrict__ out,
                                        PlaneLevels lv, int K, int N, int F) {
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
    const float* t = lv.planes[l] + ((long long)k * 3 + o) * RR * F;
    const float* g00 = t + ((long long)u0 * R + v0) * F;
    const float* g01 = t + ((long long)u0 * R + v1) * F;
    const float* g10 = t + ((long long)u1 * R + v0) * F;
    const float* g11 = t + ((long long)u1 * R + v1) * F;
    const float au = 1.0f - fu;
    const float av = 1.0f - fv;

    const float* l0 = nullptr;
    const float* l1 = nullptr;
    float fw = 0.0f;
    if (lv.has_lines) {
        const float w = fminf(fmaxf(xp[c], 0.0f), 1.0f) * R1;
        const float w0f = floorf(fminf(fmaxf(w, 0.0f), hi));
        fw = w - w0f;
        const int w0 = (int)w0f;
        const int w1 = min(w0 + 1, R - 1);
        const float* lt = lv.lines[l] + ((long long)k * 3 + o) * R * F;
        l0 = lt + (long long)w0 * F;
        l1 = lt + (long long)w1 * F;
    }
    const float aw = 1.0f - fw;

    float* dst = out + kn * (long long)(LO * F) + (long long)lo * F;
    for (int f = 0; f < F; ++f) {
        float bv = g00[f] * au * av + g01[f] * au * fv
                 + g10[f] * fu * av + g11[f] * fu * fv;
        if (lv.has_lines) bv = bv * (l0[f] * aw + l1[f] * fw);
        dst[f] = bv;
    }
}

// x: (K, N, 3) unit-cube points; out: (K, N, 3 * levels * F).
NERF_API int plane_encode_fwd(const float* x, float* out, PlaneLevels lv,
                              int K, int N, int F, cudaStream_t stream) {
    const long long total = (long long)K * N * lv.levels * 3;
    if (total > 0) {
        const int threads = 256;
        plane_encode_fwd_kernel<<<nerf_blocks(total, threads), threads, 0,
                                  stream>>>(x, out, lv, K, N, F);
    }
    return (int)cudaGetLastError();
}
