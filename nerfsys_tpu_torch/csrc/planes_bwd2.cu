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
// bfloat16 before it reaches the tables. Kernel 5''b (LINES_BF16: the
// light VJP on the residuals of the reference's bfloat16 line matmuls,
// `_linear_rows_mm` :224-266) forms lval(L) as kernel 5b does, from
// bfloat16 stencil weights and rows, and so scatters d L to the line nodes
// with the bfloat16 weights bf16(1 - fw), bf16(fw): the transpose of that
// stencil. The table's own rounding passes its cotangent straight through
// and d L sums in float32 (the reference's TPU rounds that cotangent to
// bfloat16 per 32,768-point chunk; ROADMAP Queue 3). lval(vL) keeps the
// float32 weights: the light VJP scatters its line cotangent with float32
// fractions. 6'' serves the exact VJP under either line dtype: it
// regathers float32 lines. Without lines G = scatter(ct)
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
// (2 x 72 floats at bench width) and the 3 coordinates; the distinct rows
// of the four tables are read and the two gradient tables written once
// (~145 MB for one bench-width expert at one inner step, 0.043 ms at 3.35
// TB/s). What sets its time in practice is the L2's work: 12 row gathers
// and 6 row scatter-adds a point and block, twice kernel 5's gathers. The
// first design (a warp a 32-point run, every block on the same (level,
// orientation) at once) spent two thirds of its time in the scatter, most
// of it in the L2's vector reductions (`kernel_ab.py`'s split). This
// design aims at them. From the launch plan `ops/planes.py
// plane_bwd_plan(..., second=True)`, passed by value:
//   - kernel 5's frame (csrc/planes_bwd.cu): persistent blocks on a grid
//     (blocks, K), each walking tiles of `tile` consecutive points of one
//     expert; the tile's points and cotangent staged in shared memory by
//     cp.async (16-byte pieces), double-buffered so that the next tile's
//     copy overlaps this tile's work. The blocks at work hold different
//     tiles at every (level, orientation), so their reductions spread
//     over all the tables instead of meeting on one;
//   - a warp task is one (level, orientation) of 32 / lpp consecutive
//     points, with lpp = F / 4 lanes a point on the 16-byte path: each lane
//     takes one 16-byte quarter of every row, so the lanes that share a
//     row's 32-byte sector read it, and add to it, in one instruction (at
//     bench width F = 8: 2 lanes a point, 16 points a task); the corner
//     rows and weights serve both P / vP and L / vL. In a tile's task
//     order the (level, orientation) runs fastest, so the warps of a block
//     work on different tables at once (at bench width each of the 9
//     warps keeps one of the 9 for the whole tile);
//   - table rows are read through the L2 alone (ld.global.cg): the rows a
//     warp gathers are scattered and the L1 holds little of them;
//   - d ct is staged in shared memory, one writer a slot, and written
//     once a tile as one contiguous span (16 bytes a lane);
//   - the table scatter is kernel 5's: `__match_any_sync` groups the
//     lanes that hit the same (row, quarter), a shuffle tree sums each
//     group, and the group's first lane adds it with a 16-byte vector
//     reduction (`red.global.add.v4.f32`), every line level included.
//     Unlike kernel 5 no level's d L is kept private in shared memory:
//     float adds to shared memory are compare-and-swap loops on sm_90,
//     and even the coarsest level measured slower private than on the
//     global path here (PERF.md section 6).
// A scalar variant (VEC=1, one lane a point) serves F % 4 != 0 and
// unaligned tables.
#include "common.cuh"

#define PLANES_MAX_LEVELS 8
#define BWD2_MAX_THREADS 288

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

struct PlanePlan {  // same layout as csrc/planes.cu
    int tile;      // points per tile, a multiple of 32
    int threads;   // per block, a multiple of 32
    int blocks;    // persistent blocks per expert (grid x)
    int smem;      // dynamic shared-memory bytes
    int vec;       // 1: 16-byte rows and copies (F % 4 == 0, aligned)
    int line_ofs[PLANES_MAX_LEVELS];  // kernels 5 and 6 only: unread here
    int sms;       // the card's SMs (the persistent-block cap)
};

// a table row's VEC floats, through the L2 alone
template <int VEC>
__device__ __forceinline__ void load_row(const float* p, float (&v)[VEC]) {
    if (VEC == 4) {
        const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[i] = __ldcg(p + i);
    }
}

// One row's contribution: group the lanes by row, sum, and let the group's
// first lane add it to the gradient table at `gdst`.
template <int VEC>
__device__ __forceinline__ void add_row(unsigned peers, float (&v)[VEC],
                                        float* gdst, bool active, int lane) {
    reduce_peers<VEC>(peers, v, lane);
    if (!active || (peers & ((1u << lane) - 1u))) return;  // not the leader
    if (VEC == 4) {
        red_add4(gdst, v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) atomicAdd(gdst + i, v[i]);
    }
}

template <int VEC, bool EXACT, bool LINES_BF16>
__global__ void __launch_bounds__(BWD2_MAX_THREADS)
plane_encode_bwd2_kernel(const float* __restrict__ x,
                         const float* __restrict__ ct, PlaneLevels lv,
                         PlaneLevels vv, PlaneGrads gr,
                         float* __restrict__ dct, int N, int F,
                         PlanePlan plan) {
    extern __shared__ float4 smem4[];
    const int tile = plan.tile;
    const int LO = lv.levels * 3;
    const int D = LO * F;
    const int k = blockIdx.y;
    float* cbuf = reinterpret_cast<float*>(smem4);  // 2 x (tile, D) ct
    float* xbuf = cbuf + 2 * tile * D;               // 2 x (tile, 3)
    float* obuf = xbuf + 2 * tile * 3;               // (tile, D) d ct
    const int lane = threadIdx.x & 31;
    const int warps = blockDim.x >> 5;
    // lanes a point: on the 16-byte path one lane a 16-byte quarter of
    // every row (F / 4 lanes, F a power of two up to 128), so the lanes
    // that share a row's 32-byte sector read it and add to it in one
    // instruction; on the scalar path, and for other F, one lane a point
    const int lpp =
        (VEC == 4 && F <= 128 && (F & (F - 1)) == 0) ? F >> 2 : 1;
    const int ppw = 32 / lpp;  // points a warp task
    const int groups = tile / ppw;
    const int ntiles = (N + tile - 1) / tile;

    // copy tile t's cotangent and points into buffer `buf` (cp.async)
    auto load_tile = [&](int t, int buf) {
        const int p0 = t * tile;
        const int np = min(tile, N - p0);
        const long long base = (long long)k * N + p0;
        const float* cg = ct + base * D;
        float* cs = cbuf + buf * tile * D;
        if (VEC == 4) {
            for (int i = threadIdx.x; i < (np * D) >> 2; i += blockDim.x)
                cp_async(cs + 4 * i, cg + 4 * i, 16);
        } else {
            for (int i = threadIdx.x; i < np * D; i += blockDim.x)
                cp_async(cs + i, cg + i, 4);
        }
        const float* xg = x + base * 3;
        float* xs = xbuf + buf * tile * 3;
        for (int i = threadIdx.x; i < np * 3; i += blockDim.x)
            cp_async(xs + i, xg + i, 4);
    };

    int buf = 0;
    if ((int)blockIdx.x < ntiles) load_tile(blockIdx.x, 0);
    cp_async_commit();
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x, buf ^= 1) {
        if (t + (int)gridDim.x < ntiles) load_tile(t + gridDim.x, buf ^ 1);
        cp_async_commit();
        cp_async_wait_one();  // this thread's copies of tile t have landed
        __syncthreads();      // and everyone's
        const int np = min(tile, N - t * tile);
        const float* cs = cbuf + buf * tile * D;
        const float* xs = xbuf + buf * tile * 3;
        for (int task = threadIdx.x >> 5; task < LO * groups; task += warps) {
            const int lo = task % LO;  // level * 3 + orientation
            const int q = lane / lpp;      // the warp's point
            const int h = lane - q * lpp;  // its 16-byte quarter of a row
            const int p = (task / LO) * ppw + q;
            const bool active = p < np;
            const int l = lo / 3;
            const int o = lo - 3 * l;
            const int a = (o == 2) ? 1 : 0;
            const int b = (o == 0) ? 1 : 2;
            const int c = (o == 0) ? 2 : ((o == 1) ? 1 : 0);
            const int R = lv.res[l];
            const float R1 = (float)(R - 1);
            const float hi = lv.clip_hi[l];
            const float* xp = xs + (active ? p : 0) * 3;
            const float xa = active ? xp[a] : 0.0f;
            const float xb = active ? xp[b] : 0.0f;
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
            // an inactive lane reads point 0's cotangent: its key is its
            // own, and it adds nothing
            const float* g = cs + (active ? p : 0) * D + lo * F;
            float* og = obuf + (active ? p : 0) * D + lo * F;

            if (!lv.has_lines) {  // d ct = bval(vP); the tables get nothing
                for (int f0 = VEC * h; f0 < F; f0 += VEC * lpp) {
                    float v00[VEC], v01[VEC], v10[VEC], v11[VEC];
                    load_row<VEC>(vp + rows[0] * F + f0, v00);
                    load_row<VEC>(vp + rows[1] * F + f0, v01);
                    load_row<VEC>(vp + rows[2] * F + f0, v10);
                    load_row<VEC>(vp + rows[3] * F + f0, v11);
                    if (active)
#pragma unroll
                        for (int i = 0; i < VEC; ++i)
                            og[f0 + i] = v00[i] * au * av + v01[i] * au * fv
                                       + v10[i] * fu * av + v11[i] * fu * fv;
                }
                continue;
            }

            const int dead = -1 - lane;  // a key no other lane holds
            unsigned pm[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)  // a key a (row, quarter)
                pm[j] = __match_any_sync(FULL_MASK,
                                         active ? rows[j] * lpp + h : dead);
            float* gtp = gr.planes[l] + pofs;
            const float xc = active ? xp[c] : 0.0f;
            const float w = fminf(fmaxf(xc, 0.0f), 1.0f) * R1;
            const float w0f = floorf(fminf(fmaxf(w, 0.0f), hi));
            const float fw = w - w0f;
            const int w0 = (int)w0f;
            const int w1 = min(w0 + 1, R - 1);
            const float aw = 1.0f - fw;
            // 5''b: the bfloat16 stencil weights of the line matmul
            const float awb = LINES_BF16 ? bf16_round(aw) : aw;
            const float fwb = LINES_BF16 ? bf16_round(fw) : fw;
            const unsigned lm0 = __match_any_sync(
                FULL_MASK, active ? w0 * lpp + h : dead);
            const unsigned lm1 = __match_any_sync(
                FULL_MASK, active ? w1 * lpp + h : dead);
            const long long lofs = ((long long)k * 3 + o) * R * F;
            const float* lp = lv.lines[l] + lofs;
            const float* vl = vv.lines[l] + lofs;
            float* glp = gr.lines[l] + lofs;

            for (int f0 = VEC * h; f0 < F; f0 += VEC * lpp) {
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
                if (VEC == 4) {
                    const float4 q = reinterpret_cast<const float4*>(
                        g + f0)[0];
                    gv[0] = q.x; gv[1] = q.y; gv[2] = q.z; gv[3] = q.w;
                } else {
#pragma unroll
                    for (int i = 0; i < VEC; ++i) gv[i] = g[f0 + i];
                }
                float sp[VEC], sl_[VEC], out[VEC];
#pragma unroll
                for (int i = 0; i < VEC; ++i) {
                    const float bP = t00[i] * au * av + t01[i] * au * fv
                                   + t10[i] * fu * av + t11[i] * fu * fv;
                    const float bV = v00[i] * au * av + v01[i] * au * fv
                                   + v10[i] * fu * av + v11[i] * fu * fv;
                    const float lL =
                        LINES_BF16 ? bf16_round(m0[i]) * awb
                                         + bf16_round(m1[i]) * fwb
                                   : m0[i] * aw + m1[i] * fw;
                    const float lV = n0[i] * aw + n1[i] * fw;
                    out[i] = bV * (EXACT ? lL : bf16_round(lL))
                           + lV * (EXACT ? bP : bf16_round(bP));
                    sp[i] = EXACT ? gv[i] * lV : bf16_round(gv[i] * lV);
                    sl_[i] = EXACT ? gv[i] * bV : bf16_round(gv[i] * bV);
                }
                if (active) {
                    if (VEC == 4)
                        *reinterpret_cast<float4*>(og + f0) =
                            make_float4(out[0], out[1], out[2], out[3]);
                    else
#pragma unroll
                        for (int i = 0; i < VEC; ++i) og[f0 + i] = out[i];
                }
                float c0[VEC], c1[VEC];
#pragma unroll
                for (int i = 0; i < VEC; ++i) {
                    c0[i] = awb * sl_[i];
                    c1[i] = fwb * sl_[i];
                }
                add_row<VEC>(lm0, c0, glp + w0 * F + f0, active, lane);
                add_row<VEC>(lm1, c1, glp + w1 * F + f0, active, lane);
                const float wu[4] = {au, au, fu, fu};
                const float wv[4] = {av, fv, av, fv};
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    float cj[VEC];
#pragma unroll
                    for (int i = 0; i < VEC; ++i)
                        cj[i] = wu[j] * (wv[j] * sp[i]);
                    add_row<VEC>(pm[j], cj, gtp + rows[j] * F + f0, active,
                                 lane);
                }
            }
        }
        __syncthreads();  // the tile's d ct is complete
        // d ct of the tile's np points: one contiguous span
        float* dg = dct + ((long long)k * N + t * tile) * D;
        if (VEC == 4) {
            for (int i = threadIdx.x; i < (np * D) >> 2; i += blockDim.x)
                reinterpret_cast<float4*>(dg)[i] =
                    reinterpret_cast<const float4*>(obuf)[i];
        } else {
            for (int i = threadIdx.x; i < np * D; i += blockDim.x)
                dg[i] = obuf[i];
        }
        __syncthreads();  // all done with `buf` and the staged d ct
    }
}

template <int VEC, bool EXACT, bool LINES_BF16>
static int launch_bwd2(const float* x, const float* ct, PlaneLevels lv,
                       PlaneLevels vv, PlaneGrads gr, float* dct, int K,
                       int N, int F, PlanePlan plan, cudaStream_t stream) {
    static LaunchCache cache;
    auto kern = plane_encode_bwd2_kernel<VEC, EXACT, LINES_BF16>;
    int per_sm = 0;
    const cudaError_t e =
        cached_occupancy(cache, kern, plan.threads, plan.smem, &per_sm);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    // persistent blocks: no more per expert than can be resident at once
    const int resident = (int)((long long)plan.sms * per_sm / K);
    const int blocks = max(1, min(plan.blocks, resident));
    kern<<<dim3(blocks, K), plan.threads, plan.smem, stream>>>(
        x, ct, lv, vv, gr, dct, N, F, plan);
    return (int)cudaGetLastError();
}

template <bool EXACT, bool LINES_BF16>
static int bwd2(const float* x, const float* ct, PlaneLevels lv,
                PlaneLevels vv, PlaneGrads gr, float* dct, int K, int N,
                int F, PlanePlan plan, cudaStream_t stream) {
    if ((long long)K * N == 0 || lv.levels == 0)
        return (int)cudaGetLastError();
    if (plan.tile % 32 || plan.tile < 32 || plan.threads % 32 ||
        plan.threads > BWD2_MAX_THREADS || plan.blocks < 1 || plan.sms < 1 ||
        (plan.vec && F % 4) || lv.levels != vv.levels ||
        lv.has_lines != vv.has_lines || K > 65535)
        return (int)cudaErrorInvalidValue;
    // the plan's shared memory must hold what the kernel places in it
    const int D = 3 * lv.levels * F;
    if (4LL * plan.tile * (3LL * D + 6) > plan.smem)
        return (int)cudaErrorInvalidValue;
    return plan.vec ? launch_bwd2<4, EXACT, LINES_BF16>(
                          x, ct, lv, vv, gr, dct, K, N, F, plan, stream)
                    : launch_bwd2<1, EXACT, LINES_BF16>(
                          x, ct, lv, vv, gr, dct, K, N, F, plan, stream);
}

// x: (K, N, 3) unit-cube points; ct and dct: (K, N, 3 * levels * F); lv:
// the tables P and L; vv: their cotangents vP and vL (the same layout,
// res and clip_hi as lv); gr: the zeroed gradient tables d P and d L;
// plan: `plane_bwd_plan(..., second=True)` (vec 1: 16-byte rows, F % 4
// == 0 and every table, ct and dct 16-byte aligned). Writes every
// point's d ct once (dct need not be zeroed).
// Kernel 5'' (the light VJP's derivative, bf16 rounding):
NERF_API int plane_encode_bwd2_light(const float* x, const float* ct,
                                     PlaneLevels lv, PlaneLevels vv,
                                     PlaneGrads gr, float* dct, int K, int N,
                                     int F, PlanePlan plan,
                                     cudaStream_t stream) {
    return bwd2<false, false>(x, ct, lv, vv, gr, dct, K, N, F, plan,
                              stream);
}

// Kernel 5''b (the light VJP's derivative under bfloat16 line matmuls):
// kernel 5'''s inputs; lval(L) and the line-node weights of d L from
// bfloat16 stencil weights and rows, as kernel 5b recomputes them.
NERF_API int plane_encode_bwd2_light_lines_bf16(
    const float* x, const float* ct, PlaneLevels lv, PlaneLevels vv,
    PlaneGrads gr, float* dct, int K, int N, int F, PlanePlan plan,
    cudaStream_t stream) {
    return bwd2<false, true>(x, ct, lv, vv, gr, dct, K, N, F, plan, stream);
}

// Kernel 6'' (the exact VJP's derivative):
NERF_API int plane_encode_bwd2(const float* x, const float* ct,
                               PlaneLevels lv, PlaneLevels vv, PlaneGrads gr,
                               float* dct, int K, int N, int F,
                               PlanePlan plan, cudaStream_t stream) {
    return bwd2<true, false>(x, ct, lv, vv, gr, dct, K, N, F, plan,
                             stream);
}
