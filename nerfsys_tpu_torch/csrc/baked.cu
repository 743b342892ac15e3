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
// ~20 flops per output channel. Design: one thread per (point, channel),
// the C threads of a point adjacent, so each corner block is read by
// consecutive threads at consecutive addresses; the cell arithmetic is
// repeated per channel (cheap next to the row reads), and the index entry
// is one broadcast read per point.
#include <cuda_bf16.h>

#include "common.cuh"

#define BAKED_SUPER 4  // blocks per super-block axis (64 slots per index row)

static __device__ __forceinline__ float to_f32(float v) { return v; }
static __device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

struct BakedGrid {
    int R, C, Cp;
    float clip_hi;           // float32(R - 1.000001)
    const int* block_index;  // (Rbs^3, 64) or nullptr (dense)
    int Bs, Rbs;
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

template <typename T, int PACK>
__global__ void baked_trilerp_kernel(const float* __restrict__ pts,
                                     const T* __restrict__ table,
                                     const float* __restrict__ aabb,
                                     float* __restrict__ out, long long N,
                                     BakedGrid g) {
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (tid >= N * g.C) return;
    const long long n = tid / g.C;
    const int c = (int)(tid - n * g.C);

    int idx[3];
    float w[3];
    for (int a = 0; a < 3; ++a) {
        const float lo = aabb[a];
        const float h = (aabb[3 + a] - lo) / (float)g.R;
        float ga = (pts[n * 3 + a] - lo) / h - 0.5f;
        ga = fminf(fmaxf(ga, 0.0f), g.clip_hi);
        const float f = floorf(ga);
        w[a] = ga - f;
        idx[a] = (int)f;
    }
    const float wx = w[0], wy = w[1], wz = w[2];
    const float omx = 1.0f - wx, omy = 1.0f - wy, omz = 1.0f - wz;
    const int W = PACK * g.Cp;
    const int Cp = g.Cp;
    float val;
    if (PACK == 8) {
        const T* r = table + baked_row(g, idx[0], idx[1], idx[2]) * W + c;
        const float x0 = (to_f32(r[0]) * omz + to_f32(r[Cp]) * wz) * omy
                         + (to_f32(r[2 * Cp]) * omz + to_f32(r[3 * Cp]) * wz)
                               * wy;
        const float x1 =
            (to_f32(r[4 * Cp]) * omz + to_f32(r[5 * Cp]) * wz) * omy
            + (to_f32(r[6 * Cp]) * omz + to_f32(r[7 * Cp]) * wz) * wy;
        val = x0 * omx + x1 * wx;
    } else if (PACK == 4) {
        const int ix1 = min(idx[0] + 1, g.R - 1);
        float col[2];
        for (int i = 0; i < 2; ++i) {
            const T* r =
                table + baked_row(g, i ? ix1 : idx[0], idx[1], idx[2]) * W + c;
            const float z0 = to_f32(r[0]) * omz + to_f32(r[Cp]) * wz;
            const float z1 = to_f32(r[2 * Cp]) * omz + to_f32(r[3 * Cp]) * wz;
            col[i] = z0 * omy + z1 * wy;
        }
        val = col[0] * omx + col[1] * wx;
    } else {
        const int ix1 = min(idx[0] + 1, g.R - 1);
        const int iy1 = min(idx[1] + 1, g.R - 1);
        float q[4];  // (ix, iy), (ix1, iy), (ix, iy1), (ix1, iy1)
        for (int i = 0; i < 4; ++i) {
            const T* r = table
                         + baked_row(g, (i & 1) ? ix1 : idx[0],
                                     (i & 2) ? iy1 : idx[1], idx[2]) * W
                         + c;
            q[i] = to_f32(r[0]) * omz + to_f32(r[Cp]) * wz;
        }
        val = q[0] * omx * omy + q[1] * wx * omy + q[2] * omx * wy
              + q[3] * wx * wy;
    }
    out[n * g.C + c] = val;
}

template <typename T>
static void launch(int pack, const float* pts, const void* table,
                   const float* aabb, float* out, long long N,
                   const BakedGrid& g, cudaStream_t stream) {
    const int threads = 256;
    const unsigned int blocks = nerf_blocks(N * g.C, threads);
    const T* t = static_cast<const T*>(table);
    if (pack == 8)
        baked_trilerp_kernel<T, 8><<<blocks, threads, 0, stream>>>(
            pts, t, aabb, out, N, g);
    else if (pack == 4)
        baked_trilerp_kernel<T, 4><<<blocks, threads, 0, stream>>>(
            pts, t, aabb, out, N, g);
    else
        baked_trilerp_kernel<T, 2><<<blocks, threads, 0, stream>>>(
            pts, t, aabb, out, N, g);
}

// pts: (N, 3) f32; table: (rows, pack*Cp) bf16 (table_bf16=1) or f32;
// aabb: (2, 3) f32; block_index: (Rbs^3, 64) int32 or null (dense), with
// the block edge Bs. Out: val (N, C) f32. pack in {2, 4, 8}.
NERF_API int baked_trilerp(const float* pts, const void* table, int table_bf16,
                           const float* aabb, const int* block_index,
                           float* out, int N, int R, int C, int Cp, int pack,
                           int Bs, cudaStream_t stream) {
    if (pack != 2 && pack != 4 && pack != 8) return (int)cudaErrorInvalidValue;
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
            launch<__nv_bfloat16>(pack, pts, table, aabb, out, N, g, stream);
        else
            launch<float>(pack, pts, table, aabb, out, N, g, stream);
    }
    return (int)cudaGetLastError();
}
