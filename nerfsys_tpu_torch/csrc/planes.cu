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
// floats; the output (K*N*72 floats at bench width, 2.4 GB per 65,536 x 32
// chunk at K=4) is nearly all of the 2.65 GB that bound it. The arithmetic
// is ~12 flops per output float, far below the card's ops:byte ridge, so
// the tensor cores have nothing to do here. What the design does about it:
//   - grid (tiles, K): a block takes a tile of `tile` consecutive points of
//     one expert (128 = 4 rays of 32 samples at bench width); all indexing
//     inside the tile is 32-bit, 64-bit only for the tile's base offset;
//   - the tile's points are read once into shared memory (coalesced);
//   - a warp takes 32 of the tile's points at one (level, orientation), so
//     R and the table are uniform in the warp; its lanes spread over the
//     tile's runs of 32 points (4 rays x 8 samples at bench width), so that
//     lanes on neighbouring rays share corner rows in one load; each
//     32-byte row is read as two 16-byte loads on the read-only path (a
//     scalar variant serves F % 4 != 0 or unaligned tables);
//   - the tile's (tile, 3*L*F) output is built in shared memory and written
//     as one contiguous span with coalesced 16-byte streaming stores, so
//     every written sector is whole (the first design wrote 4-byte pieces
//     of 32 different sectors per warp store) and the stream does not
//     evict the tables from L2.
// The launch plan (tile, threads, shared bytes, variant) is computed in
// Python: nerfsys_tpu_torch/ops/planes.py `plane_fwd_plan`.
//
// Kernel 1b (`plane_encode_fwd_lines_bf16`) is the same body built with
// LINES_BF16: the reference's bfloat16 line matmuls (`_linear_rows_mm` with
// lines_mm_dtype='bfloat16', :224-266, reached from :288 under
// lines_matmul) contract the (N, R) hat stencil, rounded to bfloat16,
// against the line table rounded to bfloat16, in float32. A stencil row
// has two nonzeros, so each line value is
//   bf16(1 - fw) * bf16(l0) + bf16(fw) * bf16(l1)
// where both products of 8-bit significands are exact in float32 and the
// sum rounds once: the plain version's order gives the same bits. The
// plane lookups are kernel 1's. Float32 line matmuls compute kernel 1's
// function and run kernel 1.
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

struct PlanePlan {  // ops/planes.py PlaneLaunchPlan; line_ofs, sms unused
    int tile;      // points per tile, a multiple of 32
    int threads;   // per block, a multiple of 32
    int blocks;    // tiles per expert (grid x)
    int smem;      // dynamic shared-memory bytes
    int vec;       // 1: 16-byte rows (F % 4 == 0, aligned), 0: scalar
    int line_ofs[PLANES_MAX_LEVELS];
    int sms;
};

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

template <int VEC, bool LINES_BF16>
__global__ void __launch_bounds__(512)
plane_encode_fwd_kernel(const float* __restrict__ x, float* __restrict__ out,
                        PlaneLevels lv, int N, int F, int tile) {
    extern __shared__ float4 smem4[];
    float* xs = reinterpret_cast<float*>(smem4);  // (tile, 3)
    float* os = xs + tile * 3;                    // (tile, D)
    const int LO = lv.levels * 3;
    const int D = LO * F;
    const int k = blockIdx.y;
    const int p0 = blockIdx.x * tile;
    const int np = min(tile, N - p0);
    const long long base = (long long)k * N + p0;  // first point of the tile

    const float* xg = x + base * 3;
    for (int i = threadIdx.x; i < np * 3; i += blockDim.x)
        xs[i] = __ldg(xg + i);
    __syncthreads();

    // A task is 32 of the tile's points at one (level, orientation). The
    // tile is `runs` runs of 32 consecutive points (rays of 32 samples in
    // the serve path); a task's lane takes run lane % runs, and the task's
    // 32 / runs consecutive points in it: neighbouring pixels' rays at the
    // same sample depth hit the same corner rows, so one warp load serves
    // several lanes, where the 32 samples of one ray mostly fall in
    // different cells.
    const int runs = tile >> 5;
    const int lane = threadIdx.x & 31;
    const int lane_p = (lane % runs) * 32 + lane / runs;
    const int span = 32 / runs;
    const int warps = blockDim.x >> 5;
    for (int task = threadIdx.x >> 5; task < LO * runs; task += warps) {
        const int lo = task / runs;  // level * 3 + orientation
        const int p = lane_p + (task - lo * runs) * span;
        if (p >= np) continue;
        const int l = lo / 3;
        const int o = lo - 3 * l;
        const int a = (o == 2) ? 1 : 0;
        const int b = (o == 0) ? 1 : 2;
        const int c = (o == 0) ? 2 : ((o == 1) ? 1 : 0);
        const int R = lv.res[l];
        const float R1 = (float)(R - 1);
        const float hi = lv.clip_hi[l];
        const float* xp = xs + p * 3;
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
        const float au = 1.0f - fu;
        const float av = 1.0f - fv;
        const float* t = lv.planes[l] + ((long long)k * 3 + o) * R * R * F;
        const float* g00 = t + (u0 * R + v0) * F;
        const float* g01 = t + (u0 * R + v1) * F;
        const float* g10 = t + (u1 * R + v0) * F;
        const float* g11 = t + (u1 * R + v1) * F;

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
            l0 = lt + w0 * F;
            l1 = lt + w1 * F;
        }
        const float aw = LINES_BF16 ? bf16_round(1.0f - fw) : 1.0f - fw;
        if (LINES_BF16) fw = bf16_round(fw);

        float* dst = os + p * D + lo * F;
        for (int f0 = 0; f0 < F; f0 += VEC) {
            float t00[VEC], t01[VEC], t10[VEC], t11[VEC], r[VEC];
            load_row<VEC>(g00 + f0, t00);
            load_row<VEC>(g01 + f0, t01);
            load_row<VEC>(g10 + f0, t10);
            load_row<VEC>(g11 + f0, t11);
#pragma unroll
            for (int i = 0; i < VEC; ++i)
                r[i] = t00[i] * au * av + t01[i] * au * fv
                     + t10[i] * fu * av + t11[i] * fu * fv;
            if (lv.has_lines) {
                float m0[VEC], m1[VEC];
                load_row<VEC>(l0 + f0, m0);
                load_row<VEC>(l1 + f0, m1);
                if (LINES_BF16) {
#pragma unroll
                    for (int i = 0; i < VEC; ++i) {
                        m0[i] = bf16_round(m0[i]);
                        m1[i] = bf16_round(m1[i]);
                    }
                }
#pragma unroll
                for (int i = 0; i < VEC; ++i)
                    r[i] = r[i] * (m0[i] * aw + m1[i] * fw);
            }
            if (VEC == 4)
                *reinterpret_cast<float4*>(dst + f0) =
                    make_float4(r[0], r[1], r[2], r[3]);
            else
#pragma unroll
                for (int i = 0; i < VEC; ++i) dst[f0 + i] = r[i];
        }
    }
    __syncthreads();

    // the tile's rows of `out` are one contiguous span of np * D floats
    float* og = out + base * D;
    if (VEC == 4) {  // D % 4 == 0 and `out` 16-byte aligned
        const float4* s4 = reinterpret_cast<const float4*>(os);
        float4* o4 = reinterpret_cast<float4*>(og);
        for (int i = threadIdx.x; i < (np * D) >> 2; i += blockDim.x)
            __stcs(o4 + i, s4[i]);
    } else {
        for (int i = threadIdx.x; i < np * D; i += blockDim.x)
            __stcs(og + i, os[i]);
    }
}

template <int VEC, bool LINES_BF16>
static int launch_fwd(const float* x, float* out, PlaneLevels lv, int K,
                      int N, int F, PlanePlan plan, cudaStream_t stream) {
    cudaError_t e = cudaFuncSetAttribute(
        plane_encode_fwd_kernel<VEC, LINES_BF16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
    if (e != cudaSuccess) return (int)e;
    plane_encode_fwd_kernel<VEC, LINES_BF16>
        <<<dim3(plan.blocks, K), plan.threads, plan.smem, stream>>>(
            x, out, lv, N, F, plan.tile);
    return (int)cudaGetLastError();
}

template <bool LINES_BF16>
static int plane_fwd(const float* x, float* out, PlaneLevels lv, int K,
                     int N, int F, PlanePlan plan, cudaStream_t stream) {
    if ((long long)K * N == 0 || lv.levels == 0)
        return (int)cudaGetLastError();
    if (plan.tile % 32 || plan.threads % 32 || plan.threads > 512 ||
        (long long)plan.blocks * plan.tile < N ||
        (plan.vec && F % 4))
        return (int)cudaErrorInvalidValue;
    return plan.vec
               ? launch_fwd<4, LINES_BF16>(x, out, lv, K, N, F, plan, stream)
               : launch_fwd<1, LINES_BF16>(x, out, lv, K, N, F, plan, stream);
}

// x: (K, N, 3) unit-cube points; out: (K, N, 3 * levels * F).
NERF_API int plane_encode_fwd(const float* x, float* out, PlaneLevels lv,
                              int K, int N, int F, PlanePlan plan,
                              cudaStream_t stream) {
    return plane_fwd<false>(x, out, lv, K, N, F, plan, stream);
}

// Kernel 1b: as plane_encode_fwd, the line lerp from bfloat16 weights and
// rows (the reference's bfloat16 line matmuls).
NERF_API int plane_encode_fwd_lines_bf16(const float* x, float* out,
                                         PlaneLevels lv, int K, int N, int F,
                                         PlanePlan plan,
                                         cudaStream_t stream) {
    return plane_fwd<true>(x, out, lv, K, N, F, plan, stream);
}
