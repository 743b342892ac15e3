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
// (for the packed forward too, as `_packed_bwd`), fp32 atomics into a
// zeroed buffer; Nearest adds dout.
//
// Bound on the H100: bytes. 7a at a serve chunk (K=4, 2,097,152 points,
// L=16, F=2) reads 100 MB of points and writes 1.07 GB of features, and
// reads 1.07 G corner rows of 8 bytes at random from a 512 MiB table:
// each read costs a 32-byte sector, so the random rows, not the output,
// set the pace wherever a level's slab outgrows the 50 MB L2. Design: one
// thread per (expert, point, level), the L threads of a point adjacent so
// that their outputs form one contiguous L*F-float span, and the coarse
// levels (whose rows many points share) stay in L2.
#include "common.cuh"

#include <cuda_bf16.h>

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

// Slab-relative rows and weights of the corners level l reads for the point
// at xp; returns their count (8, or 1 for Nearest).
__device__ __forceinline__ int hash_corners(const float* __restrict__ xp,
                                            const HashLevels& lv, int l,
                                            unsigned int* row, float* w) {
    const float scale = lv.scale[l];
    const unsigned int mask = (1u << lv.log2_size) - 1u;
    if (lv.mode == 2) {
        unsigned int c[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) c[a] = (unsigned int)(int)rintf(xp[a] * scale);
        row[0] = (c[0] ^ (c[1] * HASH_PRIME_Y) ^ (c[2] * HASH_PRIME_Z)) & mask;
        w[0] = 1.0f;
        return 1;
    }
    const int res = lv.res[l];
    int c0[3], c1[3];
    float fr[3];
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
    const bool dense = lv.tcnn && lv.dense[l];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int dx = i >> 2, dy = (i >> 1) & 1, dz = i & 1;
        const int cx = dx ? c1[0] : c0[0];
        const int cy = dy ? c1[1] : c0[1];
        const int cz = dz ? c1[2] : c0[2];
        if (dense) {
            row[i] = (unsigned int)(cx + cy * res + cz * res * res);
        } else {
            row[i] = ((unsigned int)cx ^ ((unsigned int)cy * HASH_PRIME_Y)
                      ^ ((unsigned int)cz * HASH_PRIME_Z)) & mask;
        }
        const float wx = dx ? fr[0] : 1.0f - fr[0];
        const float wy = dy ? fr[1] : 1.0f - fr[1];
        const float wz = dz ? fr[2] : 1.0f - fr[2];
        w[i] = wx * wy * wz;
    }
    return 8;
}

// First row of expert k's slab l, in rows of the (K, L * 2^T, F) table.
__device__ __forceinline__ long long slab_row(const HashLevels& lv, int k,
                                              int l) {
    return ((long long)k * lv.levels + l) << lv.log2_size;
}

__device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

template <int F>
__global__ void hash_fwd_kernel(const float* __restrict__ x,
                                const float* __restrict__ table,
                                float* __restrict__ out, HashLevels lv, int K,
                                int N) {
    const int L = lv.levels;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (tid >= (long long)K * N * L) return;
    const int l = (int)(tid % L);
    const long long kn = tid / L;  // expert * N + point
    const int k = (int)(kn / N);
    unsigned int row[8];
    float w[8];
    const int nc = hash_corners(x + kn * 3, lv, l, row, w);
    const float* t = table + slab_row(lv, k, l) * F;
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        if (c < nc) {
            const float* r = t + (long long)row[c] * F;
#pragma unroll
            for (int f = 0; f < F; ++f) acc[f] = acc[f] + w[c] * __ldg(r + f);
        }
    }
    float* dst = out + tid * F;  // (K, N, L, F) row-major
#pragma unroll
    for (int f = 0; f < F; ++f) dst[f] = acc[f];
}

__global__ void hash_fwd_packed_kernel(const float* __restrict__ x,
                                       const float2* __restrict__ table,
                                       float2* __restrict__ out,
                                       HashLevels lv, int K, int N) {
    const int L = lv.levels;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (tid >= (long long)K * N * L) return;
    const int l = (int)(tid % L);
    const long long kn = tid / L;
    const int k = (int)(kn / N);
    unsigned int row[8];
    float w[8];
    hash_corners(x + kn * 3, lv, l, row, w);  // Linear or Smoothstep: 8
    const float2* t = table + slab_row(lv, k, l);
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        const float2 v = __ldg(t + row[c]);
        const float wb = bf16_round(w[c]);
        a0 = a0 + bf16_round(wb * bf16_round(v.x));
        a1 = a1 + bf16_round(wb * bf16_round(v.y));
    }
    out[tid] = make_float2(a0, a1);
}

template <int F>
__global__ void hash_bwd_kernel(const float* __restrict__ x,
                                const float* __restrict__ dout,
                                float* __restrict__ dtable, HashLevels lv,
                                int K, int N) {
    const int L = lv.levels;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (tid >= (long long)K * N * L) return;
    const int l = (int)(tid % L);
    const long long kn = tid / L;
    const int k = (int)(kn / N);
    unsigned int row[8];
    float w[8];
    const int nc = hash_corners(x + kn * 3, lv, l, row, w);
    float g[F];
#pragma unroll
    for (int f = 0; f < F; ++f) g[f] = dout[tid * F + f];
    float* t = dtable + slab_row(lv, k, l) * F;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        if (c < nc) {
            float* r = t + (long long)row[c] * F;
#pragma unroll
            for (int f = 0; f < F; ++f) atomicAdd(r + f, w[c] * g[f]);
        }
    }
}

#define HASH_DISPATCH_F(KERNEL, ...)                                        \
    switch (F) {                                                            \
        case 1: KERNEL<1><<<blocks, threads, 0, stream>>>(__VA_ARGS__); break; \
        case 2: KERNEL<2><<<blocks, threads, 0, stream>>>(__VA_ARGS__); break; \
        case 4: KERNEL<4><<<blocks, threads, 0, stream>>>(__VA_ARGS__); break; \
        case 8: KERNEL<8><<<blocks, threads, 0, stream>>>(__VA_ARGS__); break; \
        default: return (int)cudaErrorInvalidValue;                         \
    }

// x: (K, N, 3) unit-cube points; table: (K, L * 2^T, F); out: (K, N, L*F).
NERF_API int hash_encode_fwd(const float* x, const float* table, float* out,
                             HashLevels lv, int K, int N, int F,
                             cudaStream_t stream) {
    const long long total = (long long)K * N * lv.levels;
    if (total > 0) {
        const int threads = 256;
        const unsigned int blocks = nerf_blocks(total, threads);
        HASH_DISPATCH_F(hash_fwd_kernel, x, table, out, lv, K, N)
    }
    return (int)cudaGetLastError();
}

// As hash_encode_fwd with F = 2, Linear or Smoothstep, bfloat16 pairs.
NERF_API int hash_encode_fwd_packed(const float* x, const float* table,
                                    float* out, HashLevels lv, int K, int N,
                                    cudaStream_t stream) {
    const long long total = (long long)K * N * lv.levels;
    if (total > 0) {
        const int threads = 256;
        const unsigned int blocks = nerf_blocks(total, threads);
        hash_fwd_packed_kernel<<<blocks, threads, 0, stream>>>(
            x, reinterpret_cast<const float2*>(table),
            reinterpret_cast<float2*>(out), lv, K, N);
    }
    return (int)cudaGetLastError();
}

// dout: (K, N, L*F); dtable: (K, L * 2^T, F), zeroed by the caller.
NERF_API int hash_encode_bwd(const float* x, const float* dout, float* dtable,
                             HashLevels lv, int K, int N, int F,
                             cudaStream_t stream) {
    const long long total = (long long)K * N * lv.levels;
    if (total > 0) {
        const int threads = 256;
        const unsigned int blocks = nerf_blocks(total, threads);
        HASH_DISPATCH_F(hash_bwd_kernel, x, dout, dtable, lv, K, N)
    }
    return (int)cudaGetLastError();
}
