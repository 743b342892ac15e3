// Kernel row 7: the Instant-NGP multiresolution hash-grid encoder.
//
// Replaces: nerfsys_tpu/ops/encodings.py `hash_grid_encode_fused` (:345)
// with `_encode_indices_weights` (:406) and, for Nearest,
// `hash_grid_encode` (:256) -> `hash_encode_fwd` (7a);
// `hash_grid_encode_packed` (:491, `_packed_fwd` :506) ->
// `hash_encode_fwd_packed` (7b); `_packed_bwd` (:511) and the transpose of
// `row_gather` that differentiates the fused path -> `hash_encode_bwd`
// (7c). It computes what those ops compute, not their TPU layout: no
// lane-aligned (N, L*8) index and weight tensors, no one-hot corner-sum
// matmul, no packed uint32 copy of the table (7b rounds the float32 rows
// to bfloat16 in registers, the same function).
//
// Per point x in [0,1]^3 and level l with scale s_l (float32, from the
// host), per axis: s = x * s_l (+ 0.5 in the tcnn layout, a separate
// rounding), fl = floor(s), fr = s - fl, Smoothstep fr*fr*(3 - 2fr). The
// 8 corners in _CORNERS order (dx, dy, dz lexicographic) read the rows
//   ((cx * 1) ^ (cy * 2654435761) ^ (cz * 805459861)) & (2^T - 1)   (uint32)
// of the level's slab, or in the tcnn layout x + y*res + z*res^2 at dense
// levels with both corners clamped to [0, res-1]; weight (wx*wy)*wz. The
// output is the corner sum in that order, per feature. Nearest: round(s)
// half to even (rintf, as jnp.round), one row, weight 1. Built with
// --fmad=false: a contracted multiply-add in x*s_l + 0.5 or in the weights
// could move a point into the neighbouring cell, at a hashed level an
// unrelated row; so every operation rounds as in the plain version.
//
// 7b: each feature and the weight round to bfloat16 (nearest even), and
// so does their product (the reference multiplies in bfloat16; the exact
// product of two bfloat16s fits in float32, so one float32 multiply and
// one rounding is the bfloat16 multiply); the corners sum in float32.
// 7c: dtable[k, row, f] += w * dout[k, n, l*F + f] with the float32 w
// (for the packed forward too, as `_packed_bwd`) into a buffer the caller
// zeroed; Nearest adds dout. Only the order of the float sums differs
// from the plain version.
//
// Bound on the H100: bytes. 7a at a serve chunk (K=4, 2,097,152 points,
// L=16, F=2) reads 100 MB of points and writes 1.07 GB of features, and
// reads 1.07 G corner rows of 8 bytes at random from a 512 MiB table:
// each read costs a 32-byte sector request, so the number of those
// requests, not the output, sets the pace. There are a few flops per byte
// moved and no matrix product, so the tensor cores have nothing to do.
// 7c makes the same requests as read-modify-writes in the L2.
//
// Design of 7a, 7b and 7c. 7b is 7a's body built with PACKED: only the
// corner sum differs (the bfloat16 roundings above), so it takes 7a's plan
// and reads the same float32 rows, rounding them in registers (no second,
// bfloat16 copy of the table to keep in step with training). The launch
// plans come from Python (ops/encodings.py `hash_fwd_plan`,
// `hash_bwd_plan`):
//   - tiles of `tile` consecutive points of one expert, levels in groups
//     of `level_group`, grid (blocks, level groups, K): one block per tile
//     and group, or, with one group, 7c's persistent blocks striding over
//     the tiles; 32-bit indexing inside a tile, 64-bit only for base
//     offsets, no 64-bit division;
//   - the tile's points (7c: and its cotangent columns) are staged in
//     shared memory with coalesced loads (7c: cp.async, double-buffered);
//   - levels are the outer loop: a warp takes 32 of the tile's points at
//     one level, so every lane reads one slab and the level's scale and
//     resolution are uniform; blocks are scheduled grid x first, so all
//     tiles of one level group run before the next group's and the slabs
//     in use fit the 50 MB L2 (7c: groups of 2 levels, 16 MiB at the
//     runner's width; 7a: groups of 4 once its blocks fill the card more
//     than once, else one group, which keeps the last wave short);
//   - lane map "rays" spreads a warp's lanes over the tile's runs of 32
//     points (neighbouring pixels' rays at the same sample depth, which
//     share rows at every level whose cell is wider than the rays'
//     spacing: one load serves them); "samples" gives them 32 consecutive
//     points (the samples of one ray, for random training rays);
//   - 7a and 7b build their (tile, levels x F) output in shared memory
//     and write it with 16-byte streaming stores, whole sectors that do
//     not evict the slabs from the L2;
//   - 7c groups the lanes of a warp that add into one row
//     (`__match_any_sync`), sums them with shuffles (`reduce_peers`,
//     common.cuh) and lets one lane add the row with one vector reduction
//     (`red.global.add.v2.f32` at F=2, `.v4` at F=4, two at F=8, a scalar
//     at F=1). A per-block copy of the coarse levels in shared memory
//     was measured and left out: float adds to shared memory are
//     compare-and-swap loops on sm_90, and the block's flush costs as many
//     global adds as it saves;
//   - the launch calls no attribute or occupancy query on the default
//     plans: 7a's and 7c's stay within the 48 KB of shared memory a block
//     has without opting in, and 7c asks the occupancy calculator only for
//     one level group of persistent blocks.
#include "common.cuh"

#define HASH_MAX_LEVELS 32
#define HASH_PRIME_Y 2654435761u
#define HASH_PRIME_Z 805459861u

struct HashLevels {
    float scale[HASH_MAX_LEVELS];  // float32 level_scales()
    int res[HASH_MAX_LEVELS];      // level_resolutions()
    int dense[HASH_MAX_LEVELS];    // level_dense_mask() (tcnn layout)
    int levels;
    int log2_size;                 // T: each slab holds 2^T rows
    int tcnn;                      // 0.5 offset, clamped corners, dense levels
    int mode;                      // 0 Linear, 1 Smoothstep, 2 Nearest
};

struct HashPlan {  // ops/encodings.py HashLaunchPlan
    int tile;         // points per tile: 32 x runs, runs a power of 2 <= 32
    int threads;      // per block, a multiple of 32, <= 512
    int blocks;       // per expert and level group: one per tile, or 7c's
                      // persistent blocks when it has one group
    int smem;         // dynamic shared-memory bytes
    int lane_map;     // 0 "samples": 32 consecutive points; 1 "rays"
    int vec;          // 7a: 16-byte output stores; 7c: 16-byte copies
    int level_group;  // levels per block (grid y covers the rest)
};

// The cell level l selects for the point at xp (Linear, Smoothstep): per
// axis the lower and upper lattice coordinates and the upper weight.
__device__ __forceinline__ void hash_cell(const float* __restrict__ xp,
                                          const HashLevels& lv, int l,
                                          int (&c0)[3], int (&c1)[3],
                                          float (&fr)[3]) {
    const float scale = lv.scale[l];
    const int res = lv.res[l];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        float s = xp[a] * scale;
        if (lv.tcnn) s = s + 0.5f;
        const float fl = floorf(s);
        float f = s - fl;
        if (lv.mode == 1) f = f * f * (3.0f - 2.0f * f);
        fr[a] = f;
        int lo = (int)fl;
        int hi = lo + 1;
        if (lv.tcnn) {
            lo = min(max(lo, 0), res - 1);
            hi = min(max(hi, 0), res - 1);
        }
        c0[a] = lo;
        c1[a] = hi;
    }
}

// Slab-relative row of lattice point (cx, cy, cz) at level l.
__device__ __forceinline__ unsigned int corner_row(const HashLevels& lv,
                                                   int l, bool dense, int cx,
                                                   int cy, int cz) {
    if (dense) {
        const int res = lv.res[l];
        return (unsigned int)(cx + cy * res + cz * res * res);
    }
    return ((unsigned int)cx ^ ((unsigned int)cy * HASH_PRIME_Y)
            ^ ((unsigned int)cz * HASH_PRIME_Z)) & ((1u << lv.log2_size) - 1u);
}

// Nearest: the row of round(x * s_l), half to even.
__device__ __forceinline__ unsigned int nearest_row(
    const float* __restrict__ xp, const HashLevels& lv, int l) {
    const float scale = lv.scale[l];
    unsigned int c[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) c[a] = (unsigned int)(int)rintf(xp[a] * scale);
    return (c[0] ^ (c[1] * HASH_PRIME_Y) ^ (c[2] * HASH_PRIME_Z))
           & ((1u << lv.log2_size) - 1u);
}

// Weight (wx*wy)*wz of corner i (_CORNERS order) of a cell.
__device__ __forceinline__ float corner_weight(const float (&fr)[3], int i) {
    const float wx = (i >> 2) ? fr[0] : 1.0f - fr[0];
    const float wy = ((i >> 1) & 1) ? fr[1] : 1.0f - fr[1];
    const float wz = (i & 1) ? fr[2] : 1.0f - fr[2];
    return wx * wy * wz;
}

// First row of expert k's slab l, in rows of the (K, L * 2^T, F) table.
__device__ __forceinline__ long long slab_row(const HashLevels& lv, int k,
                                              int l) {
    return ((long long)k * lv.levels + l) << lv.log2_size;
}

// One table row of F floats (the table 16-byte aligned, rows F*4 bytes).
template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&v)[F]) {
    if constexpr (F == 1) {
        v[0] = __ldg(p);
    } else if constexpr (F == 2) {
        const float2 q = __ldg(reinterpret_cast<const float2*>(p));
        v[0] = q.x; v[1] = q.y;
    } else {
#pragma unroll
        for (int i = 0; i < F; i += 4) {
            const float4 q = __ldg(reinterpret_cast<const float4*>(p + i));
            v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
        }
    }
}

// The tile's points and lanes: a tile is `runs` (a power of 2) runs of 32
// consecutive points; task g of a level gives lane `lane` the point
// lane_p + g * step.
struct TileLanes {
    int rlog, runs, lane_p, step;
    __device__ __forceinline__ TileLanes(int tile, int lane_map, int lane) {
        runs = tile >> 5;
        rlog = __ffs(runs) - 1;
        if (lane_map) {  // across the runs, 32 / runs consecutive points each
            lane_p = ((lane & (runs - 1)) << 5) + (lane >> rlog);
            step = 32 >> rlog;
        } else {
            lane_p = lane;
            step = 32;
        }
    }
};

// ---------------------------------------------------------------------------
// 7a: the fp32 forward; with PACKED (F = 2, Linear or Smoothstep), 7b.

template <int F, bool PACKED>
__global__ void __launch_bounds__(512)
hash_fwd_kernel(const float* __restrict__ x, const float* __restrict__ table,
                float* __restrict__ out, HashLevels lv, int N, HashPlan plan) {
    extern __shared__ float4 smem4[];
    const int tile = plan.tile;
    const int k = blockIdx.z;
    const int p0 = blockIdx.x * tile;
    if (p0 >= N) return;
    const int l0 = blockIdx.y * plan.level_group;
    const int nl = min(plan.level_group, lv.levels - l0);
    const int D = lv.levels * F;  // floats per point of `out`
    const int DG = nl * F;        // this block's columns of them
    // Staging rows are DG + 1 floats, and each run of 32 points is shifted
    // by `shift` more, so that the lanes of one store fall in different
    // banks under either lane map.
    const int stride = DG + 1;
    const int lane = threadIdx.x & 31;
    const TileLanes tl(tile, plan.lane_map, lane);
    const int shift = plan.lane_map ? tl.step : 0;
    float* xs = reinterpret_cast<float*>(smem4);  // (tile, 3)
    float* os = xs + tile * 3;                    // (tile, stride) + shifts
    const int np = min(tile, N - p0);
    const long long base = (long long)k * N + p0;

    const float* xg = x + base * 3;
    for (int i = threadIdx.x; i < np * 3; i += blockDim.x)
        xs[i] = __ldg(xg + i);
    __syncthreads();

    const int warps = blockDim.x >> 5;
    for (int task = threadIdx.x >> 5; task < (nl << tl.rlog); task += warps) {
        const int li = task >> tl.rlog;
        const int p = tl.lane_p + (task & (tl.runs - 1)) * tl.step;
        if (p >= np) continue;
        const int l = l0 + li;
        const float* xp = xs + p * 3;
        const float* t = table + slab_row(lv, k, l) * F;
        float acc[F];
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = 0.0f;
        if (!PACKED && lv.mode == 2) {
            float v[F];
            load_row<F>(t + (size_t)nearest_row(xp, lv, l) * F, v);
#pragma unroll
            for (int f = 0; f < F; ++f) acc[f] = acc[f] + v[f];
        } else {
            int c0[3], c1[3];
            float fr[3];
            hash_cell(xp, lv, l, c0, c1, fr);
            const bool dense = lv.tcnn && lv.dense[l];
            float v[8][F];  // corners in _CORNERS order, all loads in flight
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const unsigned int r = corner_row(
                    lv, l, dense, (i >> 2) ? c1[0] : c0[0],
                    ((i >> 1) & 1) ? c1[1] : c0[1], (i & 1) ? c1[2] : c0[2]);
                load_row<F>(t + (size_t)r * F, v[i]);
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const float w = corner_weight(fr, i);
                if constexpr (PACKED) {  // the reference's bfloat16 products
                    const float wb = bf16_round(w);
#pragma unroll
                    for (int f = 0; f < F; ++f)
                        acc[f] = acc[f] + bf16_round(wb * bf16_round(v[i][f]));
                } else {
#pragma unroll
                    for (int f = 0; f < F; ++f) acc[f] = acc[f] + w * v[i][f];
                }
            }
        }
        float* dst = os + p * stride + (p >> 5) * shift + li * F;
#pragma unroll
        for (int f = 0; f < F; ++f) dst[f] = acc[f];
    }
    __syncthreads();

    // rows of `out` for the tile: (np, D) from `base`; this block's columns
    // l0*F .. l0*F + DG of each
    float* og = out + base * D + l0 * F;
    if (plan.vec) {  // DG % 4 == 0, D % 4 == 0, `out` 16-byte aligned
        const int q = DG >> 2;
        for (int i = threadIdx.x; i < np * q; i += blockDim.x) {
            const int p = i / q;
            const int c = (i - p * q) << 2;
            const float* s = os + p * stride + (p >> 5) * shift + c;
            __stcs(reinterpret_cast<float4*>(og + p * D + c),
                   make_float4(s[0], s[1], s[2], s[3]));
        }
    } else {
        for (int i = threadIdx.x; i < np * DG; i += blockDim.x) {
            const int p = i / DG;
            const int c = i - p * DG;
            __stcs(og + p * D + c, os[p * stride + (p >> 5) * shift + c]);
        }
    }
}

// ---------------------------------------------------------------------------
// 7c: the table gradient.

// One reduction of a row's F floats in the L2 (rows F*4 bytes, aligned).
template <int F>
__device__ __forceinline__ void red_row(float* dst, const float (&v)[F]) {
    if constexpr (F == 1) {
        atomicAdd(dst, v[0]);
    } else if constexpr (F == 2) {
        red_add2(dst, v[0], v[1]);
    } else {
#pragma unroll
        for (int i = 0; i < F; i += 4)
            red_add4(dst + i, v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
}

// Add v into the row with key `key` (the lanes holding one key are one
// group): the group's sum is added by its first lane into the slab row at
// `gdst`. Every lane of the warp calls it; dead lanes hold a key no other
// lane holds.
template <int F>
__device__ __forceinline__ void add_corner(unsigned int key, float (&v)[F],
                                           float* gdst, bool active,
                                           int lane) {
    const unsigned peers = __match_any_sync(FULL_MASK, key);
    reduce_peers<F>(peers, v, lane);
    if (!active || (peers & ((1u << lane) - 1u))) return;  // not the leader
    red_row<F>(gdst, v);
}

template <int F>
__global__ void __launch_bounds__(512)
hash_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dout,
                float* __restrict__ dtable, HashLevels lv, int N,
                HashPlan plan) {
    extern __shared__ float4 smem4[];
    const int tile = plan.tile;
    const int D = lv.levels * F;
    const int l0 = blockIdx.y * plan.level_group;
    const int nl = min(plan.level_group, lv.levels - l0);
    const int DG = nl * F;  // this block's columns of the cotangent
    const int k = blockIdx.z;
    float* cbuf = reinterpret_cast<float*>(smem4);  // 2 x (tile, DG)
    float* xbuf = cbuf + 2 * tile * DG;              // 2 x (tile, 3)
    const int lane = threadIdx.x & 31;
    const int warps = blockDim.x >> 5;
    const TileLanes tl(tile, plan.lane_map, lane);
    const int ntiles = (N + tile - 1) / tile;

    // copy tile t's cotangent columns and points into buffer `buf`
    // (cp.async)
    auto load_tile = [&](int t, int buf) {
        const int p0 = t * tile;
        const int np = min(tile, N - p0);
        const long long base = (long long)k * N + p0;
        const float* cg = dout + base * D + l0 * F;
        float* cs = cbuf + buf * tile * DG;
        if (plan.vec) {  // DG, D, l0 * F multiples of 4, `dout` aligned
            const int q = DG >> 2;
            for (int i = threadIdx.x; i < np * q; i += blockDim.x) {
                const int p = i / q;
                const int c = (i - p * q) << 2;
                cp_async(cs + p * DG + c, cg + p * D + c, 16);
            }
        } else {
            for (int i = threadIdx.x; i < np * DG; i += blockDim.x) {
                const int p = i / DG;
                const int c = i - p * DG;
                cp_async(cs + p * DG + c, cg + p * D + c, 4);
            }
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
        const float* cs = cbuf + buf * tile * DG;
        const float* xs = xbuf + buf * tile * 3;
        for (int task = threadIdx.x >> 5; task < (nl << tl.rlog);
             task += warps) {
            const int li = task >> tl.rlog;
            const int l = l0 + li;
            const int p = tl.lane_p + (task & (tl.runs - 1)) * tl.step;
            const bool active = p < np;
            const int pa = active ? p : 0;
            const float* xp = xs + pa * 3;
            float g[F];
#pragma unroll
            for (int f = 0; f < F; ++f)
                g[f] = active ? cs[pa * DG + li * F + f] : 0.0f;
            float* gt = dtable + slab_row(lv, k, l) * F;
            const unsigned int dead = 0xffffffe0u | lane;
            if (lv.mode == 2) {
                const unsigned int r = nearest_row(xp, lv, l);
                add_corner<F>(active ? r : dead, g, gt + (size_t)r * F,
                              active, lane);
                continue;
            }
            int c0[3], c1[3];
            float fr[3];
            hash_cell(xp, lv, l, c0, c1, fr);
            const bool dense = lv.tcnn && lv.dense[l];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const float w = corner_weight(fr, i);
                float v[F];
#pragma unroll
                for (int f = 0; f < F; ++f) v[f] = w * g[f];
                const unsigned int r = corner_row(
                    lv, l, dense, (i >> 2) ? c1[0] : c0[0],
                    ((i >> 1) & 1) ? c1[1] : c0[1], (i & 1) ? c1[2] : c0[2]);
                add_corner<F>(active ? r : dead, v, gt + (size_t)r * F,
                              active, lane);
            }
        }
        __syncthreads();  // all done with `buf`: the next tile refills it
    }
}

// ---------------------------------------------------------------------------
// Entry points.

static bool plan_ok(const HashPlan& plan, int F) {
    const int runs = plan.tile >> 5;
    return plan.tile >= 32 && plan.tile % 32 == 0 && runs <= 32 &&
           (runs & (runs - 1)) == 0 && plan.threads >= 32 &&
           plan.threads % 32 == 0 && plan.threads <= 512 &&
           plan.blocks >= 1 && plan.smem >= 0 && plan.level_group >= 1;
}

// Opts `kern` in to `smem` bytes of dynamic shared memory where a plan
// asks for more than a block has without opting in (the attribute call
// costs host time on every launch, and the default plans need none).
template <typename Kern>
static cudaError_t smem_opt_in(Kern kern, int smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int F, bool PACKED = false>
static int launch_fwd(const float* x, const float* table, float* out,
                      HashLevels lv, int K, int N, HashPlan plan,
                      cudaStream_t stream) {
    auto kern = hash_fwd_kernel<F, PACKED>;
    const cudaError_t e = smem_opt_in(kern, plan.smem);
    if (e != cudaSuccess) return (int)e;
    const int groups = (lv.levels + plan.level_group - 1) / plan.level_group;
    kern<<<dim3(plan.blocks, groups, K), plan.threads, plan.smem, stream>>>(
        x, table, out, lv, N, plan);
    return (int)cudaGetLastError();
}

// x: (K, N, 3) unit-cube points; table: (K, L * 2^T, F), 16-byte aligned;
// out: (K, N, L*F).
static bool fwd_plan_ok(const HashPlan& plan, int F, const HashLevels& lv,
                        int N) {
    return plan_ok(plan, F) && (long long)plan.blocks * plan.tile >= N &&
           !(plan.vec && ((plan.level_group * F) % 4 ||
                          lv.levels % plan.level_group));
}

NERF_API int hash_encode_fwd(const float* x, const float* table, float* out,
                             HashLevels lv, int K, int N, int F,
                             HashPlan plan, cudaStream_t stream) {
    if ((long long)K * N == 0 || lv.levels == 0)
        return (int)cudaGetLastError();
    if (!fwd_plan_ok(plan, F, lv, N)) return (int)cudaErrorInvalidValue;
    switch (F) {
        case 1: return launch_fwd<1>(x, table, out, lv, K, N, plan, stream);
        case 2: return launch_fwd<2>(x, table, out, lv, K, N, plan, stream);
        case 4: return launch_fwd<4>(x, table, out, lv, K, N, plan, stream);
        case 8: return launch_fwd<8>(x, table, out, lv, K, N, plan, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// As hash_encode_fwd with F = 2, Linear or Smoothstep, the table read as
// bfloat16 pairs (7b), with 7a's plans.
NERF_API int hash_encode_fwd_packed(const float* x, const float* table,
                                    float* out, HashLevels lv, int K, int N,
                                    HashPlan plan, cudaStream_t stream) {
    if ((long long)K * N == 0 || lv.levels == 0)
        return (int)cudaGetLastError();
    if (lv.mode == 2 || !fwd_plan_ok(plan, 2, lv, N))
        return (int)cudaErrorInvalidValue;
    return launch_fwd<2, true>(x, table, out, lv, K, N, plan, stream);
}

template <int F>
static int launch_bwd(const float* x, const float* dout, float* dtable,
                      HashLevels lv, int K, int N, HashPlan plan,
                      cudaStream_t stream) {
    auto kern = hash_bwd_kernel<F>;
    cudaError_t e = smem_opt_in(kern, plan.smem);
    if (e != cudaSuccess) return (int)e;
    // several level groups: one block per tile, scheduled group by group
    // (grid y) so that a group's slabs stay in the L2; one: persistent
    // blocks, no more per expert than can be resident at once
    const int groups = (lv.levels + plan.level_group - 1) / plan.level_group;
    int blocks = plan.blocks;
    if (groups == 1) {
        int dev = 0, sms = 0, per_sm = 0;
        if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
        if ((e = cudaDeviceGetAttribute(
                 &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
            return (int)e;
        if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &per_sm, kern, plan.threads, plan.smem)) != cudaSuccess)
            return (int)e;
        if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
        blocks = max(1, min(blocks, (int)((long long)sms * per_sm / K)));
    }
    kern<<<dim3(blocks, groups, K), plan.threads, plan.smem, stream>>>(
        x, dout, dtable, lv, N, plan);
    return (int)cudaGetLastError();
}

// dout: (K, N, L*F); dtable: (K, L * 2^T, F), zeroed by the caller and
// 16-byte aligned.
NERF_API int hash_encode_bwd(const float* x, const float* dout, float* dtable,
                             HashLevels lv, int K, int N, int F,
                             HashPlan plan, cudaStream_t stream) {
    if ((long long)K * N == 0 || lv.levels == 0)
        return (int)cudaGetLastError();
    if (!plan_ok(plan, F) ||
        (plan.vec && ((plan.level_group * F) % 4 ||
                      lv.levels % plan.level_group)))
        return (int)cudaErrorInvalidValue;
    switch (F) {
        case 1: return launch_bwd<1>(x, dout, dtable, lv, K, N, plan, stream);
        case 2: return launch_bwd<2>(x, dout, dtable, lv, K, N, plan, stream);
        case 4: return launch_bwd<4>(x, dout, dtable, lv, K, N, plan, stream);
        case 8: return launch_bwd<8>(x, dout, dtable, lv, K, N, plan, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
