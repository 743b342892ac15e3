// Kernels 5 and 6: plane/line encoder, backward (the VJPs of kernel 1).
//
// Replaces: nerfsys_tpu/ops/planes.py
//   `_plane_encode_mm_light_bwd` (:565), the pos_grad=False VJP: table
//     gradients from the plane and line values ROUNDED TO BFLOAT16 (the
//     reference saves them as bf16 residuals, :556-560), zero position
//     gradients -> `plane_encode_bwd_light` (kernel 5);
//   `_plane_encode_mm_bwd` (:449), the exact VJP: float32 table gradients
//     and position gradients -> `plane_encode_bwd` (kernel 6).
// Both compute the table gradient that `_scatter_grads_mm` (:326-384)
// forms as one-hot matmul contractions: for each point, the cotangent g of
// one (level, orientation) feature block adds
//   plane[u0+i, v0+j] += wu_i * (wv_j * g * line)     (4 corners)
//   line[w0+k]        += ww_k * (g * plane)           (2 nodes)
// with the bilinear / linear weights wu = (1-fu, fu) etc. The reference's
// contraction runs in float32 on the CPU (bwd_dtype=bfloat16 is forced to
// float32 there, :576-578); so do these kernels.
//
// Residuals: the plane and line values are RECOMPUTED here from the tables
// (4 + 2 row reads per point and block, the forward's own arithmetic)
// rather than written by kernel 1. Kernel 1 then stays exactly the serving
// kernel, and no (P, 2 * 72) residual buffer lives between an inner step's
// forward and backward. This file compiles with --fmad=false, so the
// recomputed values round exactly like the plain PyTorch version (one op at
// a time) before the bfloat16 rounding (round to nearest even,
// __float2bfloat16_rn); only the order of the float sums differs.
//
// Edge: the reference's one-hot profile drops column R when u0 = R-1
// (:319-322); here the neighbour index is clamped to R-1 as in kernel 1,
// and its weight there is fu = 0, so the add is a harmless zero.
//
// Both kernels are one body, templated on EXACT. Its byte bound (the
// cotangent read once, the tables read and the gradient tables written
// once) is ~0.03 ms at one inner step; what sets its floor in practice is
// the number of read-modify-write transactions the L2 must perform on the
// gradient tables (the first designs made 48 scalar atomics per point and
// block, ~55 M per inner step, and ~2,000 adds per call landed on every
// level-0 line feature). The design cuts those transactions:
//   - persistent blocks, grid (blocks, K): each block walks tiles of
//     `tile` consecutive points of one expert; 32-bit indexing in a tile;
//   - the tile's cotangent (tile, 3*L*F), one contiguous span, and its
//     points arrive in shared memory by cp.async (16-byte pieces),
//     double-buffered so the next tile's copy overlaps this tile's work;
//   - a warp takes 32 consecutive points (samples of one ray) at one
//     (level, orientation); per corner, `__match_any_sync` groups the
//     lanes that hit the same row, a shuffle tree sums each group's
//     contributions, and the group's first lane adds the row with 16-byte
//     vector reductions (`red.global.add.v4.f32`, sm_90): 4x fewer
//     transactions from the vectors alone, more where samples share cells;
//   - line gradients are privatised: the levels the host plan picks
//     (ops/planes.py `plane_bwd_plan`: from the coarsest level up, within
//     a byte budget and the 227 KB of dynamic shared memory the block
//     opts into) accumulate per block in shared memory and are flushed
//     once, when the block ends, with vector atomics (all-zero vectors
//     skipped). The other levels take the warp-aggregated global path
//     above. Float adds to shared memory compile to compare-and-swap
//     loops on sm_90 (ATOMS.CAST.SPIN in the SASS), while the L2 adds
//     vectors natively, so the default budget privatises only the coarsest
//     level, where the most adds meet the fewest rows; privatising every
//     level at bench width was slower on an H100 (fewer resident blocks,
//     more spinning).
// A scalar variant (VEC=1) serves F % 4 != 0 and unaligned tables.
//
// Kernel 5b (`plane_encode_bwd_light_lines_bf16`) is kernel 5 built with
// LINES_BF16, for the reference's bfloat16 line matmuls (`_linear_rows_mm`
// :224-266): its light residuals are the forward's line values, which
// that forward forms as bf16(1 - fw) * bf16(l0) + bf16(fw) * bf16(l1)
// (kernel 1b's arithmetic), so the recomputed line value takes the same
// rounding before its own bfloat16 rounding. The line nodes' weights stay
// float32 (the one-hot contraction's, :375-379). The exact VJP regathers its
// line values in float32 (:492-497), so kernel 6 serves either dtype.
//
// EXACT (kernel 6) keeps the recomputed plane and line values in float32
// (the light mode rounds them to bfloat16) and also forms the position
// gradient: each warp writes its 32 points' partials d/dfu, d/dfv, d/dfw
// times R-1 of its block into a per-tile shared buffer (tile, 3*L, 3), one
// writer per slot; after the tile's tasks one pass sums each point's 3*L
// partials in (level, orientation) order, the plain version's order,
// applies the INCLUSIVE mask 0 <= x <= 1 per coordinate (:531) and stores
// gx once per point, coalesced: no atomics and no zero fill. The wrapper
// zeroes the (K, 3, R^2, F) and (K, 3, R, F) gradient tables.
#include "common.cuh"

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

struct PlanePlan {  // same layout as csrc/planes.cu
    int tile;      // points per tile, a multiple of 32
    int threads;   // per block, a multiple of 32
    int blocks;    // persistent blocks per expert (grid x)
    int smem;      // dynamic shared-memory bytes
    int vec;       // 1: 16-byte rows and copies (F % 4 == 0, aligned)
    int line_ofs[PLANES_MAX_LEVELS];  // float offset of a level's private
                                      // line gradients in shared memory,
                                      // -1: the global path
    int sms;       // the card's SMs (the persistent-block cap)
};

// ---------------------------------------------------------------------------
// Kernels 5 and 6: one body.

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

template <int VEC>
__device__ __forceinline__ void add_global(float* dst, const float (&v)[VEC]) {
    if (VEC == 4)
        red_add4(dst, v[0], v[1], v[2], v[3]);
    else
#pragma unroll
        for (int i = 0; i < VEC; ++i) atomicAdd(dst + i, v[i]);
}

// One row's contribution: group the lanes by row, sum, and let the group's
// first lane add it to the block's private lines in shared memory (`priv`,
// at float offset `sofs` of `lsm`) or to the gradient table at `gdst`.
template <int VEC>
__device__ __forceinline__ void add_row(unsigned peers, float (&v)[VEC],
                                        float* gdst, float* lsm, int sofs,
                                        bool priv, bool active, int lane) {
    reduce_peers<VEC>(peers, v, lane);
    if (!active || (peers & ((1u << lane) - 1u))) return;  // not the leader
    if (priv) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) atomicAdd(lsm + sofs + i, v[i]);
    } else {
        add_global<VEC>(gdst, v);
    }
}

// Floats of EXACT's position partials in shared memory, after the
// double-buffered cotangent and points, before the private lines.
static __host__ __device__ __forceinline__ int partials_floats(
    bool exact, int tile, int LO) {
    return exact ? tile * LO * 3 : 0;
}

template <int VEC, bool EXACT, bool LINES_BF16>
__global__ void __launch_bounds__(512)
plane_encode_bwd_kernel(const float* __restrict__ x,
                        const float* __restrict__ ct, PlaneLevels lv,
                        PlaneGrads gr, float* __restrict__ gx, int N, int F,
                        PlanePlan plan) {
    extern __shared__ float4 smem4[];
    const int tile = plan.tile;
    const int LO = lv.levels * 3;
    const int D = LO * F;
    const int k = blockIdx.y;
    float* cbuf = reinterpret_cast<float*>(smem4);  // 2 x (tile, D)
    float* xbuf = cbuf + 2 * tile * D;               // 2 x (tile, 3)
    float* pbuf = xbuf + 2 * tile * 3;               // EXACT: (tile, LO, 3)
    float* lsm = pbuf + partials_floats(EXACT, tile, LO);  // private lines
    const int lane = threadIdx.x & 31;
    const int warps = blockDim.x >> 5;
    const int groups = tile >> 5;
    const int ntiles = (N + tile - 1) / tile;

    int line_floats = 0;
    for (int l = 0; l < lv.levels; ++l)
        if (plan.line_ofs[l] >= 0) line_floats += 3 * lv.res[l] * F;
    for (int i = threadIdx.x; i < line_floats; i += blockDim.x) lsm[i] = 0.0f;

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
        __syncthreads();      // and everyone's (and the line zeroing)
        const int np = min(tile, N - t * tile);
        const float* cs = cbuf + buf * tile * D;
        const float* xs = xbuf + buf * tile * 3;
        for (int task = threadIdx.x >> 5; task < LO * groups; task += warps) {
            const int lo = task / groups;  // level * 3 + orientation
            const int p = (task - lo * groups) * 32 + lane;
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
            const int dead = -1 - lane;  // a key no other lane holds
            unsigned pm[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
                pm[j] = __match_any_sync(FULL_MASK, active ? rows[j] : dead);
            const long long pofs = ((long long)k * 3 + o) * R * R * F;
            const float* tp = lv.planes[l] + pofs;
            float* gtp = gr.planes[l] + pofs;

            const bool has_lines = lv.has_lines;
            int w0 = 0, w1 = 0;
            float fw = 0.0f;
            unsigned lm0 = 0u, lm1 = 0u;
            const float* lp = nullptr;
            float* glp = nullptr;  // global path: this orientation's grads
            int sl = 0;            // private path: their offset in lsm
            const bool priv = has_lines && plan.line_ofs[l] >= 0;
            if (has_lines) {
                const float xc = active ? xp[c] : 0.0f;
                const float w = fminf(fmaxf(xc, 0.0f), 1.0f) * R1;
                const float w0f = floorf(fminf(fmaxf(w, 0.0f), hi));
                fw = w - w0f;
                w0 = (int)w0f;
                w1 = min(w0 + 1, R - 1);
                lm0 = __match_any_sync(FULL_MASK, active ? w0 : dead);
                lm1 = __match_any_sync(FULL_MASK, active ? w1 : dead);
                const long long lofs = ((long long)k * 3 + o) * R * F;
                lp = lv.lines[l] + lofs;
                glp = gr.lines[l] + lofs;
                sl = plan.line_ofs[l] + o * R * F;
            }
            const float aw = 1.0f - fw;
            // 5b: the forward's bfloat16 stencil weights
            const float awb = LINES_BF16 ? bf16_round(aw) : aw;
            const float fwb = LINES_BF16 ? bf16_round(fw) : fw;

            const float* g = cs + (active ? p : 0) * D + lo * F;
            float dfu = 0.0f, dfv = 0.0f, dfw = 0.0f;  // EXACT: d/dfrac
            for (int f0 = 0; f0 < F; f0 += VEC) {
                float t00[VEC], t01[VEC], t10[VEC], t11[VEC], gv[VEC];
                load_row<VEC>(tp + rows[0] * F + f0, t00);
                load_row<VEC>(tp + rows[1] * F + f0, t01);
                load_row<VEC>(tp + rows[2] * F + f0, t10);
                load_row<VEC>(tp + rows[3] * F + f0, t11);
#pragma unroll
                for (int i = 0; i < VEC; ++i)
                    gv[i] = active ? g[f0 + i] : 0.0f;
                float gp[VEC];
                if (has_lines) {
                    float m0[VEC], m1[VEC], c0[VEC], c1[VEC];
                    load_row<VEC>(lp + w0 * F + f0, m0);
                    load_row<VEC>(lp + w1 * F + f0, m1);
#pragma unroll
                    for (int i = 0; i < VEC; ++i) {
                        const float bv = t00[i] * au * av + t01[i] * au * fv
                                       + t10[i] * fu * av + t11[i] * fu * fv;
                        const float lval =
                            LINES_BF16 ? bf16_round(m0[i]) * awb
                                             + bf16_round(m1[i]) * fwb
                                       : m0[i] * aw + m1[i] * fw;
                        gp[i] = gv[i] * (EXACT ? lval : bf16_round(lval));
                        const float gl = gv[i] * (EXACT ? bv : bf16_round(bv));
                        c0[i] = aw * gl;
                        c1[i] = fw * gl;
                        if (EXACT) dfw += gl * (m1[i] - m0[i]);
                    }
                    add_row<VEC>(lm0, c0, glp + w0 * F + f0, lsm,
                                 sl + w0 * F + f0, priv, active, lane);
                    add_row<VEC>(lm1, c1, glp + w1 * F + f0, lsm,
                                 sl + w1 * F + f0, priv, active, lane);
                } else {
#pragma unroll
                    for (int i = 0; i < VEC; ++i) gp[i] = gv[i];
                }
                if (EXACT) {
#pragma unroll
                    for (int i = 0; i < VEC; ++i) {
                        dfu += gp[i] * ((t10[i] - t00[i]) * av
                                        + (t11[i] - t01[i]) * fv);
                        dfv += gp[i] * ((t01[i] - t00[i]) * au
                                        + (t11[i] - t10[i]) * fu);
                    }
                }
                const float wu[4] = {au, au, fu, fu};
                const float wv[4] = {av, fv, av, fv};
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    float cj[VEC];
#pragma unroll
                    for (int i = 0; i < VEC; ++i)
                        cj[i] = wu[j] * (wv[j] * gp[i]);
                    add_row<VEC>(pm[j], cj, gtp + rows[j] * F + f0, lsm, 0,
                                 false, active, lane);
                }
            }
            if (EXACT && active) {  // this slot's one writer
                float* pp = pbuf + (p * LO + lo) * 3;
                pp[a] = dfu * R1;
                pp[b] = dfv * R1;
                pp[c] = has_lines ? dfw * R1 : 0.0f;
            }
        }
        if (EXACT) {
            __syncthreads();  // the tile's partials are complete
            // gx of the tile's np points, once each, coalesced
            float* gxt = gx + ((long long)k * N + t * tile) * 3;
            for (int i = threadIdx.x; i < np * 3; i += blockDim.x) {
                const int p = i / 3;
                const float* pp = pbuf + p * LO * 3 + (i - 3 * p);
                float s = 0.0f;
                for (int lo = 0; lo < LO; ++lo) s += pp[3 * lo];
                const float xv = xs[i];
                gxt[i] = (xv >= 0.0f && xv <= 1.0f) ? s : 0.0f;
            }
        }
        __syncthreads();  // all done with `buf` and the partials
    }
    __syncthreads();

    // flush the private line gradients of this block's expert, once
    for (int l = 0; l < lv.levels; ++l) {
        if (plan.line_ofs[l] < 0) continue;
        const int n = 3 * lv.res[l] * F;
        const float* src = lsm + plan.line_ofs[l];
        float* dst = gr.lines[l] + (long long)k * n;
        if (VEC == 4) {
            for (int i = threadIdx.x; i < (n >> 2); i += blockDim.x) {
                const float4 q = reinterpret_cast<const float4*>(src)[i];
                if (q.x != 0.0f || q.y != 0.0f || q.z != 0.0f || q.w != 0.0f)
                    red_add4(dst + 4 * i, q.x, q.y, q.z, q.w);
            }
        } else {
            for (int i = threadIdx.x; i < n; i += blockDim.x)
                if (src[i] != 0.0f) atomicAdd(dst + i, src[i]);
        }
    }
}

template <int VEC, bool EXACT, bool LINES_BF16>
static int launch_bwd(const float* x, const float* ct, PlaneLevels lv,
                      PlaneGrads gr, float* gx, int K, int N, int F,
                      PlanePlan plan, cudaStream_t stream) {
    static LaunchCache cache;
    auto kern = plane_encode_bwd_kernel<VEC, EXACT, LINES_BF16>;
    int per_sm = 0;
    const cudaError_t e =
        cached_occupancy(cache, kern, plan.threads, plan.smem, &per_sm);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    // persistent blocks: no more per expert than can be resident at once
    const int resident = (int)((long long)plan.sms * per_sm / K);
    const int blocks = max(1, min(plan.blocks, resident));
    kern<<<dim3(blocks, K), plan.threads, plan.smem, stream>>>(
        x, ct, lv, gr, gx, N, F, plan);
    return (int)cudaGetLastError();
}

template <bool EXACT, bool LINES_BF16>
static int plane_bwd(const float* x, const float* ct, PlaneLevels lv,
                     PlaneGrads gr, float* gx, int K, int N, int F,
                     PlanePlan plan, cudaStream_t stream) {
    if ((long long)K * N == 0 || lv.levels == 0)
        return (int)cudaGetLastError();
    if (plan.tile % 32 || plan.threads % 32 || plan.threads > 512 ||
        plan.blocks < 1 || plan.sms < 1 || (plan.vec && F % 4) ||
        (EXACT && gx == nullptr))
        return (int)cudaErrorInvalidValue;
    // the plan's shared memory must hold what the kernel places in it
    const int LO = 3 * lv.levels;
    const long long lines_at = 2LL * plan.tile * (LO * F + 3) +
                               partials_floats(EXACT, plan.tile, LO);
    long long need = lines_at;
    for (int l = 0; l < lv.levels; ++l)
        if (plan.line_ofs[l] >= 0)
            need = max(need, lines_at + plan.line_ofs[l] +
                                 3LL * lv.res[l] * F);
    if (4 * need > plan.smem) return (int)cudaErrorInvalidValue;
    return plan.vec ? launch_bwd<4, EXACT, LINES_BF16>(x, ct, lv, gr, gx, K,
                                                       N, F, plan, stream)
                    : launch_bwd<1, EXACT, LINES_BF16>(x, ct, lv, gr, gx, K,
                                                       N, F, plan, stream);
}

// x: (K, N, 3) unit-cube points; ct: (K, N, 3 * levels * F) cotangent.
// Adds into the zeroed gradient tables of `gr`.
NERF_API int plane_encode_bwd_light(const float* x, const float* ct,
                                    PlaneLevels lv, PlaneGrads gr, int K,
                                    int N, int F, PlanePlan plan,
                                    cudaStream_t stream) {
    return plane_bwd<false, false>(x, ct, lv, gr, nullptr, K, N, F, plan,
                                   stream);
}

// Kernel 5b: kernel 5's inputs; the line values recomputed from bfloat16
// stencil weights and rows, as the bfloat16 line matmuls formed them.
NERF_API int plane_encode_bwd_light_lines_bf16(const float* x,
                                               const float* ct,
                                               PlaneLevels lv, PlaneGrads gr,
                                               int K, int N, int F,
                                               PlanePlan plan,
                                               cudaStream_t stream) {
    return plane_bwd<false, true>(x, ct, lv, gr, nullptr, K, N, F, plan,
                                  stream);
}

// As kernel 5's inputs, with an exact plan (its smem counts the position
// partials); also writes the position gradient gx (K, N, 3), every point
// once (gx need not be zeroed).
NERF_API int plane_encode_bwd(const float* x, const float* ct,
                              PlaneLevels lv, PlaneGrads gr, float* gx, int K,
                              int N, int F, PlanePlan plan,
                              cudaStream_t stream) {
    return plane_bwd<true, false>(x, ct, lv, gr, gx, K, N, F, plan, stream);
}
