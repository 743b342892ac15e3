// Kernel 8: trilinear lookup in the corner-packed baked SH grid.
//
// Replaces: nerfsys_tpu/models/baked.py `baked_trilerp` (:647), the lookup of
// `baked_query` (:746) and `render_rays_baked` (:758). It computes what that
// op computes, not its TPU layout: the sparse block index is read by a
// direct index (slot = block_index[sid][sub]), not by the one-hot in-row
// select the TPU needs (:688-689).
//
// Table: row ((x*R)+y)*R+z (dense) or slot*Bs^3 + ((x%Bs)*Bs+y%Bs)*Bs+z%Bs
// (sparse, slot from the (Rbs^3, 64) super-block index) holds `pack` corner
// blocks of Cp channels, blocks in (dx, dy, dz) lexicographic order over the
// forward 2x2x2 neighbourhood (pack 8: all eight; 4: (dy, dz); 2: dz), the
// first C channels used. Per point p and channel c < C:
//   h = (hi - lo) / R;  g = clip((p - lo) / h - 0.5, 0, float32(R-1.000001))
//   i = floor(g), w = g - i
// then the lerp tree of the reference, in its order (:712-742):
//   pack 8: x0 = (b0(1-wz) + b1 wz)(1-wy) + (b2(1-wz) + b3 wz) wy, x1 from
//           b4..b7, val = x0(1-wx) + x1 wx
//   pack 4: row4(j) = (r0(1-wz) + r1 wz)(1-wy) + (r2(1-wz) + r3 wz) wy,
//           val = row4(ix)(1-wx) + row4(min(ix+1, R-1)) wx
//   pack 2: row2(j, k) = r0(1-wz) + r1 wz, val = row2(ix,iy)(1-wx)(1-wy)
//           + row2(ix1,iy) wx(1-wy) + row2(ix,iy1)(1-wx) wy
//           + row2(ix1,iy1) wx wy
//
// Edge: float32(R - 1.000001) == R - 1 for R >= 64, so a point on the top
// face selects i = R-1 with weight 0. Packs 2 and 4 clamp their forward
// neighbour to R-1 as the reference does; pack 8 reads the bake's clamped
// neighbours from the row itself. Built with --fmad=false: every multiply
// and add rounds on its own, as in the plain PyTorch version, so cell
// selection and the lerps agree with it bit for bit.
//
// Bound on the H100: bytes. Per point at pack 8, sparse, bf16, SH-3: one
// 512-byte payload row, the index entry (counted as its 256-byte index row,
// the reference's gather), 12 bytes of point and 112 bytes of output, for
// ~20 flops per output channel. In practice the floor is the L2's request
// rate: the serve chunk requests ~1 GB of rows, ~320 MB of them distinct.
//
// Design: a TEAM of lanes reads each table row, one 16-byte piece a lane
// (8 bf16 or 4 f32 channels); a row of `pack` blocks of Cp channels is
// pack x Cp x itemsize / 16 pieces (Cp is a multiple of 8, so blocks are
// whole pieces). The served pack-8 bf16 row of Cp = 32 is 512 bytes: one
// warp a point, one load a lane. Narrower rows (packs 2 and 4 in bf16,
// pack 2 in f32) give a warp several teams, one point each; wider rows
// (f32 pack 8, Cp = 56) give each lane S = 2 or 4 pieces ("sets"). A
// block's pieces are padded to a power of two Qp (the padding lanes load
// nothing), so that piece v of a row maps to lane v % team, set v / team,
// and the block bits dz, dy, dx of a piece are lane bits above log2(Qp)
// and then set bits.
//   - A warp takes 32 consecutive points. Lane i computes point i's cell
//     and weights, and its row indices (reading the sparse slots: 32
//     independent index reads in flight at once), and hands them to the
//     teams by shuffles: the cell arithmetic runs once per point.
//   - Each team loads the rows of U points before it reduces any, so the
//     row reads of several points overlap.
//   - The lerp tree runs across the team in the reference's order: the dz
//     pairs first, then dy, then dx (then the sets' bits, then the packs'
//     rows in registers). At each lane level the two partners swap halves
//     (`__shfl_xor_sync`): each keeps half of its channels and lerps them
//     with the partner's same channels, a(1-w) + b w with a the block of
//     bit 0, so every product and sum meets the plain version's operands
//     in its order, and with --fmad=false the result is bit for bit equal.
//     A lane ends with 8 >> (lane levels) bf16 or 4 >> ... f32 channels.
//   - Each warp stages its 32 points' C outputs in shared memory and
//     writes them as one contiguous span (whole sectors).
// Launch geometry comes from the host plan (models/baked.py `baked_plan`).
#include <cuda_bf16.h>

#include "common.cuh"

#define BAKED_SUPER 4  // blocks per super-block axis (64 slots per index row)

struct BakedGrid {
    int R, C, Cp;
    float clip_hi;           // float32(R - 1.000001)
    const int* block_index;  // (Rbs^3, 64) or nullptr (dense)
    int Bs, Rbs;
};

struct BakedPlan {  // models/baked.py BakedLaunchPlan
    int lanes;   // a team's lanes: 2^(qbits + lane levels), at most 32
    int sets;    // pieces a lane loads per row (1, 2 or 4)
    int qbits;   // log2 of the pieces per block, padded to a power of two
    int pieces;  // the pieces per block (Cp x itemsize / 16)
    int warps;   // per block
    int blocks;  // grid x: ceil(N / (32 warps))
    int smem;    // dynamic shared-memory bytes: 32 warps x C floats
};

static __device__ __forceinline__ long long baked_row(const BakedGrid& g,
                                                      int jx, int jy, int jz) {
    if (g.block_index == nullptr)
        return ((long long)jx * g.R + jy) * g.R + jz;
    const int S = BAKED_SUPER;
    const int bx = jx / g.Bs, by = jy / g.Bs, bz = jz / g.Bs;
    const long long sid =
        ((long long)(bx / S) * g.Rbs + (by / S)) * g.Rbs + (bz / S);
    const int sub = ((bx % S) * S + (by % S)) * S + (bz % S);
    const long long slot = g.block_index[sid * (S * S * S) + sub];
    return slot * g.Bs * g.Bs * g.Bs
           + ((jx % g.Bs) * g.Bs + (jy % g.Bs)) * g.Bs + (jz % g.Bs);
}

// A 16-byte piece as floats: 8 bf16 (element 2k in the low half of word
// k) or 4 f32.
template <typename T>
static __device__ __forceinline__ void unpack(const uint4& q,
                                              float (&v)[16 / sizeof(T)]) {
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
    if (sizeof(T) == 2) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            v[2 * k] = __uint_as_float(w[k] << 16);
            v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
        }
    } else {
#pragma unroll
        for (int k = 0; k < 16 / (int)sizeof(T); ++k)
            v[k] = __uint_as_float(w[k]);
    }
}

template <int PACK>
struct PackShape {
    static constexpr int rows = PACK == 8 ? 1 : (PACK == 4 ? 2 : 4);
    static constexpr int bits = PACK == 8 ? 3 : (PACK == 4 ? 2 : 1);
};

template <typename T, int PACK, int S>
__global__ void __launch_bounds__(256)
baked_trilerp_kernel(const float* __restrict__ pts,
                     const T* __restrict__ table,
                     const float* __restrict__ aabb, float* __restrict__ out,
                     int N, BakedGrid g, BakedPlan plan) {
    constexpr int CH = 16 / (int)sizeof(T);  // channels of a piece
    constexpr int NR = PackShape<PACK>::rows;  // rows a point reads
    constexpr int SB = S == 1 ? 0 : (S == 2 ? 1 : 2);  // set bits
    constexpr int LB = PackShape<PACK>::bits - SB;  // lane levels
    constexpr int KEEP = CH >> LB;  // channels a lane holds at the end
    constexpr int U = NR * S >= 8 ? 1 : 8 / (NR * S);  // loads in flight
    extern __shared__ float stage[];  // (warps, 32, C)

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long base =
        ((long long)blockIdx.x * plan.warps + warp) * 32;
    if (base >= N) return;  // the whole warp
    const int nv = (int)min(32LL, (long long)N - base);
    const int C = g.C;
    const int W = PACK * g.Cp;

    // lane i: point base + i's weights (block bits dz, dy, dx) and rows
    float wb[3] = {0.0f, 0.0f, 0.0f};
    int rows[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) rows[r] = 0;
    if (lane < nv) {
        int idx[3];
        float w[3];
        const float* p = pts + (base + lane) * 3;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const float lo = aabb[a];
            const float h = (aabb[3 + a] - lo) / (float)g.R;
            float ga = (p[a] - lo) / h - 0.5f;
            ga = fminf(fmaxf(ga, 0.0f), g.clip_hi);
            const float f = floorf(ga);
            w[a] = ga - f;
            idx[a] = (int)f;
        }
        wb[0] = w[2];
        wb[1] = w[1];
        wb[2] = w[0];
        const int ix1 = min(idx[0] + 1, g.R - 1);
        const int iy1 = min(idx[1] + 1, g.R - 1);
#pragma unroll
        for (int r = 0; r < NR; ++r)  // pack 4: (ix, ix1); 2: (x, y) pairs
            rows[r] = (int)baked_row(g, (r & 1) ? ix1 : idx[0],
                                     (r & 2) ? iy1 : idx[1], idx[2]);
    }

    const int tl = lane & (plan.lanes - 1);  // lane in the team
    const int team = lane / plan.lanes;
    const int teams = 32 / plan.lanes;
    const int q = tl & ((1 << plan.qbits) - 1);  // piece in the block
    const bool real = q < plan.pieces;
    int off = 0;  // the first channel this lane holds at the end
#pragma unroll
    for (int i = 0; i < LB; ++i)
        off += ((tl >> (plan.qbits + i)) & 1) * (CH >> (i + 1));
    off += q * CH;
    // element offset of this lane's piece of set s in a row
    int piece[S];
#pragma unroll
    for (int s = 0; s < S; ++s)
        piece[s] = ((s << LB) | (tl >> plan.qbits)) * g.Cp + q * CH;
    float* st = stage + warp * 32 * C;

    for (int it = 0; it < 32 / teams; it += U) {
        uint4 raw[U][NR][S];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int src = (it + u) * teams + team;
#pragma unroll
            for (int r = 0; r < NR; ++r) {
                const int row = __shfl_sync(FULL_MASK, rows[r], src);
                const T* rp = table + (size_t)row * W;
#pragma unroll
                for (int s = 0; s < S; ++s)
                    raw[u][r][s] =
                        real ? __ldg(reinterpret_cast<const uint4*>(
                                   rp + piece[s]))
                             : make_uint4(0u, 0u, 0u, 0u);
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int src = (it + u) * teams + team;
            float w[3];
#pragma unroll
            for (int b = 0; b < 3; ++b)
                w[b] = __shfl_sync(FULL_MASK, wb[b], src);
            float v[NR][S][CH];
#pragma unroll
            for (int r = 0; r < NR; ++r)
#pragma unroll
                for (int s = 0; s < S; ++s) unpack<T>(raw[u][r][s], v[r][s]);
            // lane levels: block bits 0 .. LB-1 (dz first)
#pragma unroll
            for (int i = 0; i < LB; ++i) {
                const int bit = (tl >> (plan.qbits + i)) & 1;
                const int mask = 1 << (plan.qbits + i);
                const int half = CH >> (i + 1);
                const float wi = w[i], omw = 1.0f - w[i];
#pragma unroll
                for (int r = 0; r < NR; ++r)
#pragma unroll
                    for (int s = 0; s < S; ++s)
#pragma unroll
                        for (int k = 0; k < half; ++k) {
                            const float lo_v = v[r][s][k];
                            const float hi_v = v[r][s][half + k];
                            const float recv = __shfl_xor_sync(
                                FULL_MASK, bit ? lo_v : hi_v, mask);
                            const float mine = bit ? hi_v : lo_v;
                            const float a = bit ? recv : mine;
                            const float b = bit ? mine : recv;
                            v[r][s][k] = a * omw + b * wi;
                        }
            }
            // set levels: block bits LB .. (in registers)
#pragma unroll
            for (int j = 0; j < SB; ++j) {
                const float wj = w[LB + j], omw = 1.0f - w[LB + j];
#pragma unroll
                for (int r = 0; r < NR; ++r)
#pragma unroll
                    for (int s = 0; s < S; ++s)
                        if (!(s & (1 << j)))
#pragma unroll
                            for (int k = 0; k < KEEP; ++k)
                                v[r][s][k] = v[r][s][k] * omw
                                             + v[r][s | (1 << j)][k] * wj;
            }
            // the packs' rows: pack 4 along x, pack 2 along x and y
            float val[KEEP];
            const float wx = w[2], wy = w[1];
            const float omx = 1.0f - wx, omy = 1.0f - wy;
#pragma unroll
            for (int k = 0; k < KEEP; ++k) {
                if (PACK == 8)
                    val[k] = v[0][0][k];
                else if (PACK == 4)
                    val[k] = v[0][0][k] * omx + v[1 % NR][0][k] * wx;
                else
                    val[k] = v[0][0][k] * omx * omy
                             + v[1 % NR][0][k] * wx * omy
                             + v[2 % NR][0][k] * omx * wy
                             + v[3 % NR][0][k] * wx * wy;
            }
            if (real && src < nv) {
#pragma unroll
                for (int k = 0; k < KEEP; ++k)
                    if (off + k < C) st[src * C + off + k] = val[k];
            }
        }
    }
    __syncwarp();
    float* o = out + base * C;
    for (int i = lane; i < nv * C; i += 32) o[i] = st[i];
}

template <typename T, int PACK, int S>
static int launch(const float* pts, const void* table, const float* aabb,
                  float* out, int N, const BakedGrid& g,
                  const BakedPlan& plan, cudaStream_t stream) {
    constexpr int CH = 16 / (int)sizeof(T);
    constexpr int SB = S == 1 ? 0 : (S == 2 ? 1 : 2);
    constexpr int LB = PackShape<PACK>::bits - SB;
    if constexpr (LB < 0 || (CH >> (LB < 0 ? 0 : LB)) < 1) {
        return (int)cudaErrorInvalidValue;
    } else {
        if (plan.lanes != (1 << (plan.qbits + LB)))
            return (int)cudaErrorInvalidValue;
        baked_trilerp_kernel<T, PACK, S>
            <<<plan.blocks, plan.warps * 32, plan.smem, stream>>>(
                pts, static_cast<const T*>(table), aabb, out, N, g, plan);
        return (int)cudaGetLastError();
    }
}

template <typename T, int PACK>
static int launch_sets(const float* pts, const void* table,
                       const float* aabb, float* out, int N,
                       const BakedGrid& g, const BakedPlan& plan,
                       cudaStream_t stream) {
    switch (plan.sets) {
        case 1:
            return launch<T, PACK, 1>(pts, table, aabb, out, N, g, plan,
                                      stream);
        case 2:
            return launch<T, PACK, 2>(pts, table, aabb, out, N, g, plan,
                                      stream);
        case 4:
            return launch<T, PACK, 4>(pts, table, aabb, out, N, g, plan,
                                      stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <typename T>
static int launch_pack(int pack, const float* pts, const void* table,
                       const float* aabb, float* out, int N,
                       const BakedGrid& g, const BakedPlan& plan,
                       cudaStream_t stream) {
    if (pack == 8)
        return launch_sets<T, 8>(pts, table, aabb, out, N, g, plan, stream);
    if (pack == 4)
        return launch_sets<T, 4>(pts, table, aabb, out, N, g, plan, stream);
    return launch_sets<T, 2>(pts, table, aabb, out, N, g, plan, stream);
}

// pts: (N, 3) f32; table: (rows, pack*Cp) bf16 (table_bf16=1) or f32,
// 16-byte aligned, fewer than 2^31 rows; aabb: (2, 3) f32; block_index:
// (Rbs^3, 64) int32 or null (dense), with the block edge Bs. Out: val
// (N, C) f32. pack in {2, 4, 8}; plan from models/baked.py `baked_plan`.
NERF_API int baked_trilerp(const float* pts, const void* table, int table_bf16,
                           const float* aabb, const int* block_index,
                           float* out, int N, int R, int C, int Cp, int pack,
                           int Bs, BakedPlan plan, cudaStream_t stream) {
    const int ch = table_bf16 ? 8 : 4;
    if ((pack != 2 && pack != 4 && pack != 8) || C > Cp || Cp % ch ||
        plan.pieces * ch != Cp || plan.pieces > (1 << plan.qbits) ||
        plan.lanes < 1 || plan.lanes > 32 || 32 % plan.lanes ||
        plan.warps < 1 || plan.warps > 8 ||
        (long long)plan.blocks * plan.warps * 32 < N ||
        plan.smem < plan.warps * 32 * C * 4 || plan.smem > 48 * 1024)
        return (int)cudaErrorInvalidValue;
    if (N > 0) {
        BakedGrid g;
        g.R = R;
        g.C = C;
        g.Cp = Cp;
        g.clip_hi = (float)((double)R - 1.000001);
        g.block_index = block_index;
        g.Bs = Bs;
        g.Rbs = block_index ? ((R / Bs) + BAKED_SUPER - 1) / BAKED_SUPER : 0;
        if (table_bf16)
            return launch_pack<__nv_bfloat16>(pack, pts, table, aabb, out, N,
                                              g, plan, stream);
        return launch_pack<float>(pack, pts, table, aabb, out, N, g, plan,
                                  stream);
    }
    return (int)cudaGetLastError();
}
