// Kernels 5'' and 6'': the plane/line encoder's second-order product (the
// VJP of kernel 5's or 6's table gradient), which second-order MAML takes
// through its inner loop.
//
// Replaces: autodiff of nerfsys_tpu/ops/planes.py
// `_plane_encode_mm_light_bwd` (:565, with its forward's bf16 residuals,
// `_plane_encode_mm_light_fwd` :542) and `_plane_encode_mm_bwd` (:449):
// the JAX package's MAML differentiates the inner gradient, so XLA
// differentiates those VJPs again. With lines the encode is bilinear in
// the tables: feature = bval(P) * lval(L), so the table gradient for the
// cotangent ct,
//   G(ct; P, L) = (scatter(ct * lval(L)), scatter(ct * bval(P))),
// is linear in ct and in each table. For the cotangents (vP, vL) of G this
// kernel returns, per point and (level, orientation) block,
//   d ct = bval(vP) * R(lval(L)) + lval(vL) * R(bval(P)),
//   d P  = scatter to the 4 plane corners of R(ct * lval(vL)),
//   d L  = scatter to the 2 line nodes of R(ct * bval(vP)),
// where R is the identity for kernel 6'' (EXACT: the exact VJP regathers
// float32 values) and for kernel 5'' (light) the rounding to bfloat16: its
// VJP multiplies by the bf16 residuals, and the cotangent that flows back
// through their float32 -> bfloat16 conversion is itself rounded to
// bfloat16 before it reaches the tables. Without lines G = scatter(ct)
// does not depend on the tables: d ct = bval(vP), d P = 0 (the wrapper's
// zeros). Positions get no derivative: on every MAML path the points are
// ray geometry (the wrapper refuses a second derivative when they require
// grad).
//
// The corners, weights, bval and lval are kernel 1's arithmetic, one
// rounding per operation (this file compiles with --fmad=false, as kernels
// 1, 5 and 6 do): the products rounded to bfloat16 then equal the plain
// version's bit for bit, and only the scatter's order of float sums
// differs.
//
// Bound on the H100: bytes. Per point it reads ct and writes d ct
// (2 x 72 floats at bench width) and the 3 coordinates; the four tables
// and two gradient tables are read / written once (~100 MB for one
// bench-width expert, 12.6 MB of it the (P, vP) tables; 3*L*F*~60 flops a
// point). What sets its time in practice is the table scatter, as in
// kernel 5: 4 + 2 row adds a point and block. Design, kernel 5's without
// its tiles: a warp takes 32 consecutive points (samples of one ray) of one
// expert at one (level, orientation), so R and the tables are uniform in
// the warp; it reads each point's coordinates and cotangent block directly
// (one 32-byte row a lane), gathers the 4 + 2 rows of the four tables,
// writes its d ct block once, and scatters d P and d L with kernel 5's
// warp aggregation: `__match_any_sync` groups the lanes that hit the same
// row, a shuffle tree sums each group, and the group's first lane adds the
// row with 16-byte vector reductions (`red.global.add.v4.f32`). A scalar
// variant (VEC=1) serves F % 4 != 0 and unaligned tables.
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

struct PlaneGrads {  // same layout as csrc/planes_bwd.cu
    float* planes[PLANES_MAX_LEVELS];  // (K, 3, R*R, F) per level, zeroed
    float* lines[PLANES_MAX_LEVELS];   // (K, 3, R, F) per level, zeroed
};

__device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

template <int VEC>
__device__ __forceinline__ void load_row(const float* p, float (&v)[VEC]) {
    if (VEC == 4) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(p));
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[i] = __ldg(p + i);
    }
}

// One row's contribution: group the lanes by row, sum, and let the group's
// first lane add it to the gradient table at `dst`.
template <int VEC>
__device__ __forceinline__ void add_row(unsigned peers, float (&v)[VEC],
                                        float* dst, bool active, int lane) {
    reduce_peers<VEC>(peers, v, lane);
    if (!active || (peers & ((1u << lane) - 1u))) return;  // not the leader
    if (VEC == 4)
        red_add4(dst, v[0], v[1], v[2], v[3]);
    else
#pragma unroll
        for (int i = 0; i < VEC; ++i) atomicAdd(dst + i, v[i]);
}

template <int VEC, bool EXACT>
__global__ void __launch_bounds__(256)
plane_encode_bwd2_kernel(const float* __restrict__ x,
                         const float* __restrict__ ct, PlaneLevels lv,
                         PlaneLevels vv, PlaneGrads gr,
                         float* __restrict__ dct, int K, int N, int F) {
    const int LO = lv.levels * 3;
    const int D = LO * F;
    const int lane = threadIdx.x & 31;
    const int groups = (N + 31) >> 5;
    const long long task =
        (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (task >= (long long)K * LO * groups) return;  // the whole warp
    const int grp = (int)(task % groups);
    const int lo = (int)((task / groups) % LO);  // level * 3 + orientation
    const int k = (int)(task / ((long long)groups * LO));
    const int p = grp * 32 + lane;
    const bool active = p < N;
    const long long pt = (long long)k * N + (active ? p : 0);
    const int l = lo / 3;
    const int o = lo - 3 * l;
    const int a = (o == 2) ? 1 : 0;
    const int b = (o == 0) ? 1 : 2;
    const int c = (o == 0) ? 2 : ((o == 1) ? 1 : 0);
    const int R = lv.res[l];
    const float R1 = (float)(R - 1);
    const float hi = lv.clip_hi[l];
    const float* xp = x + pt * 3;
    const float xa = active ? __ldg(xp + a) : 0.0f;
    const float xb = active ? __ldg(xp + b) : 0.0f;
    const float u = fminf(fmaxf(xa, 0.0f), 1.0f) * R1;
    const float v = fminf(fmaxf(xb, 0.0f), 1.0f) * R1;
    const float u0f = floorf(fminf(fmaxf(u, 0.0f), hi));
    const float v0f = floorf(fminf(fmaxf(v, 0.0f), hi));
    const float fu = u - u0f;
    const float fv = v - v0f;
    const int u0 = (int)u0f;
    const int v0 = (int)v0f;
    const int u1 = min(u0 + 1, R - 1);
    const int v1 = min(v0 + 1, R - 1);
    const float au = 1.0f - fu;
    const float av = 1.0f - fv;
    const int rows[4] = {u0 * R + v0, u0 * R + v1, u1 * R + v0,
                         u1 * R + v1};
    const long long pofs = ((long long)k * 3 + o) * R * R * F;
    const float* tp = lv.planes[l] + pofs;
    const float* vp = vv.planes[l] + pofs;
    const float* g = ct + pt * D + lo * F;
    float* dg = dct + pt * D + lo * F;

    if (!lv.has_lines) {  // d ct = bval(vP); the tables get nothing
        for (int f0 = 0; f0 < F; f0 += VEC) {
            float v00[VEC], v01[VEC], v10[VEC], v11[VEC];
            load_row<VEC>(vp + rows[0] * F + f0, v00);
            load_row<VEC>(vp + rows[1] * F + f0, v01);
            load_row<VEC>(vp + rows[2] * F + f0, v10);
            load_row<VEC>(vp + rows[3] * F + f0, v11);
            if (active)
#pragma unroll
                for (int i = 0; i < VEC; ++i)
                    dg[f0 + i] = v00[i] * au * av + v01[i] * au * fv
                               + v10[i] * fu * av + v11[i] * fu * fv;
        }
        return;
    }

    const int dead = -1 - lane;  // a key no other lane holds
    unsigned pm[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
        pm[j] = __match_any_sync(FULL_MASK, active ? rows[j] : dead);
    float* gtp = gr.planes[l] + pofs;
    const float xc = active ? __ldg(xp + c) : 0.0f;
    const float w = fminf(fmaxf(xc, 0.0f), 1.0f) * R1;
    const float w0f = floorf(fminf(fmaxf(w, 0.0f), hi));
    const float fw = w - w0f;
    const int w0 = (int)w0f;
    const int w1 = min(w0 + 1, R - 1);
    const float aw = 1.0f - fw;
    const unsigned lm0 = __match_any_sync(FULL_MASK, active ? w0 : dead);
    const unsigned lm1 = __match_any_sync(FULL_MASK, active ? w1 : dead);
    const long long lofs = ((long long)k * 3 + o) * R * F;
    const float* lp = lv.lines[l] + lofs;
    const float* vl = vv.lines[l] + lofs;
    float* glp = gr.lines[l] + lofs;

    for (int f0 = 0; f0 < F; f0 += VEC) {
        float t00[VEC], t01[VEC], t10[VEC], t11[VEC];
        float v00[VEC], v01[VEC], v10[VEC], v11[VEC];
        float m0[VEC], m1[VEC], n0[VEC], n1[VEC], gv[VEC];
        load_row<VEC>(tp + rows[0] * F + f0, t00);
        load_row<VEC>(tp + rows[1] * F + f0, t01);
        load_row<VEC>(tp + rows[2] * F + f0, t10);
        load_row<VEC>(tp + rows[3] * F + f0, t11);
        load_row<VEC>(vp + rows[0] * F + f0, v00);
        load_row<VEC>(vp + rows[1] * F + f0, v01);
        load_row<VEC>(vp + rows[2] * F + f0, v10);
        load_row<VEC>(vp + rows[3] * F + f0, v11);
        load_row<VEC>(lp + w0 * F + f0, m0);
        load_row<VEC>(lp + w1 * F + f0, m1);
        load_row<VEC>(vl + w0 * F + f0, n0);
        load_row<VEC>(vl + w1 * F + f0, n1);
        if (VEC == 4 && active) {
            const float4 q = __ldg(reinterpret_cast<const float4*>(g + f0));
            gv[0] = q.x; gv[1] = q.y; gv[2] = q.z; gv[3] = q.w;
        } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) gv[i] = active ? __ldg(g + f0 + i)
                                                         : 0.0f;
        }
        float sp[VEC], sl[VEC], out[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
            const float bP = t00[i] * au * av + t01[i] * au * fv
                           + t10[i] * fu * av + t11[i] * fu * fv;
            const float bV = v00[i] * au * av + v01[i] * au * fv
                           + v10[i] * fu * av + v11[i] * fu * fv;
            const float lL = m0[i] * aw + m1[i] * fw;
            const float lV = n0[i] * aw + n1[i] * fw;
            out[i] = bV * (EXACT ? lL : bf16_round(lL))
                   + lV * (EXACT ? bP : bf16_round(bP));
            sp[i] = EXACT ? gv[i] * lV : bf16_round(gv[i] * lV);
            sl[i] = EXACT ? gv[i] * bV : bf16_round(gv[i] * bV);
        }
        if (active) {
            if (VEC == 4)
                *reinterpret_cast<float4*>(dg + f0) =
                    make_float4(out[0], out[1], out[2], out[3]);
            else
#pragma unroll
                for (int i = 0; i < VEC; ++i) dg[f0 + i] = out[i];
        }
        float c0[VEC], c1[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
            c0[i] = aw * sl[i];
            c1[i] = fw * sl[i];
        }
        add_row<VEC>(lm0, c0, glp + w0 * F + f0, active, lane);
        add_row<VEC>(lm1, c1, glp + w1 * F + f0, active, lane);
        const float wu[4] = {au, au, fu, fu};
        const float wv[4] = {av, fv, av, fv};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            float cj[VEC];
#pragma unroll
            for (int i = 0; i < VEC; ++i) cj[i] = wu[j] * (wv[j] * sp[i]);
            add_row<VEC>(pm[j], cj, gtp + rows[j] * F + f0, active, lane);
        }
    }
}

template <int VEC, bool EXACT>
static int launch_bwd2(const float* x, const float* ct, PlaneLevels lv,
                       PlaneLevels vv, PlaneGrads gr, float* dct, int K,
                       int N, int F, int threads, cudaStream_t stream) {
    const long long warps =
        (long long)K * lv.levels * 3 * ((N + 31) / 32);
    const long long blocks = (warps * 32 + threads - 1) / threads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    plane_encode_bwd2_kernel<VEC, EXACT><<<(unsigned)blocks, threads, 0,
                                            stream>>>(x, ct, lv, vv, gr, dct,
                                                      K, N, F);
    return (int)cudaGetLastError();
}

static int bwd2(const float* x, const float* ct, PlaneLevels lv,
                PlaneLevels vv, PlaneGrads gr, float* dct, int K, int N,
                int F, bool exact, int vec, int threads,
                cudaStream_t stream) {
    if ((long long)K * N == 0 || lv.levels == 0)
        return (int)cudaGetLastError();
    if (threads % 32 || threads < 32 || threads > 256 || (vec && F % 4) ||
        lv.levels != vv.levels || lv.has_lines != vv.has_lines)
        return (int)cudaErrorInvalidValue;
    if (vec)
        return exact ? launch_bwd2<4, true>(x, ct, lv, vv, gr, dct, K, N, F,
                                            threads, stream)
                     : launch_bwd2<4, false>(x, ct, lv, vv, gr, dct, K, N, F,
                                             threads, stream);
    return exact ? launch_bwd2<1, true>(x, ct, lv, vv, gr, dct, K, N, F,
                                        threads, stream)
                 : launch_bwd2<1, false>(x, ct, lv, vv, gr, dct, K, N, F,
                                         threads, stream);
}

// x: (K, N, 3) unit-cube points; ct and dct: (K, N, 3 * levels * F); lv:
// the tables P and L; vv: their cotangents vP and vL (the same layout,
// res and clip_hi as lv); gr: the zeroed gradient tables d P and d L.
// vec 1: 16-byte rows (F % 4 == 0, every table and ct 16-byte aligned).
// Kernel 5'' (the light VJP's derivative, bf16 rounding):
NERF_API int plane_encode_bwd2_light(const float* x, const float* ct,
                                     PlaneLevels lv, PlaneLevels vv,
                                     PlaneGrads gr, float* dct, int K, int N,
                                     int F, int vec, int threads,
                                     cudaStream_t stream) {
    return bwd2(x, ct, lv, vv, gr, dct, K, N, F, false, vec, threads,
                stream);
}

// Kernel 6'' (the exact VJP's derivative):
NERF_API int plane_encode_bwd2(const float* x, const float* ct,
                               PlaneLevels lv, PlaneLevels vv, PlaneGrads gr,
                               float* dct, int K, int N, int F, int vec,
                               int threads, cudaStream_t stream) {
    return bwd2(x, ct, lv, vv, gr, dct, K, N, F, true, vec, threads, stream);
}
