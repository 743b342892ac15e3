// Row 12: trunc_exp, the density head's exp with its input clamped, and
// its first and second derivatives.
//
// Replaces: nerfsys_tpu/ops/activations.py `trunc_exp` (:32-47), a
// jax.custom_vjp: y = exp(clip(x, -m, m)) with the residual y saved,
// backward g * y. MAML differentiates that backward again; through the
// residual y = exp(clip(x)), JAX's jnp.clip passes the derivative with
// slope 1 inside the clamp, 1/2 at a bound (jnp.maximum / jnp.minimum
// split a tie) and 0 beyond. m is float32(88.7) for float32 inputs.
//
//   trunc_exp_fwd:  y = exp(clamp(x, -m, m))               (one pass)
//   trunc_exp_bwd:  gx = g * y                             (y the saved y)
//   trunc_exp_bwd2: for the cotangent v of gx = g * exp(clip(x)),
//                   d g = v * y,  d x = s(x) * ((v * g) * y),
//                   s = 1 inside, 1/2 at -m or m, 0 beyond (an exact 0,
//                   as autograd's masked fill gives, whatever the product),
//                   with y = exp(clamp(x)) recomputed from x (the
//                   forward's arithmetic, so the same bits)
// Every value is the plain PyTorch version's bit for bit: the clamp keeps
// NaN (fminf / fmaxf would return the other operand), exp is `expf`, the
// accurate one (not __expf), subnormal results are kept (no
// flush-to-zero: exp(-88.7) is 3.0e-39), and the products are taken in
// autograd's order, one rounding each (this file builds with
// --fmad=false, though no product here meets an add).
//
// Bound on the H100: bytes. The forward reads x and writes y (8 bytes a
// point), the backward reads g and y and writes gx (12), the second
// derivative reads v, g, x and writes two outputs (20); the arithmetic is
// a few operations a point. Design: a grid-stride loop over 16-byte
// vectors, 4 points a thread a trip, for each function, on at most 8
// blocks an SM; up to 1,081,344 points (a bench step's calls) it makes
// one trip a thread. The forward alone, the one kernel a frame launches
// at its 8,388,608 points, takes above that size an exact-cover grid
// (`fwd_cover_kernel`), since the loop left its last trip a quarter of
// the card idle: ACT_VECS vectors a thread, every load issued before the
// first store, read and written with streaming hints (__ldcs / __stcs:
// each byte is used once). The launch (path and blocks) is the wrapper's,
// ops/activations.py `act_launch`; the entry points refuse a grid that
// does not cover n. The n % 4 tail and the path for pointers that are
// not 16-byte aligned take scalar points.
#include "common.cuh"

#define ACT_THREADS 256
#define ACT_VECS 2  // the exact-cover grid's 16-byte vectors a thread

// clamp(x, -m, m) that keeps NaN, as torch.clamp and jnp.clip do
__device__ __forceinline__ float clamp_keep_nan(float x, float m) {
    return x < -m ? -m : (x > m ? m : x);
}

__device__ __forceinline__ float fwd1(float x, float m) {
    return expf(clamp_keep_nan(x, m));
}

// the slope of clip(x, -m, m) applied to t: t inside, t / 2 at a bound
// (t * 0.5f is t / 2 exactly), +0 beyond; a NaN x compares false
// everywhere and keeps t
__device__ __forceinline__ float clip_slope(float x, float m, float t) {
    if (x > m || x < -m) return 0.0f;
    return (x == m || x == -m) ? t * 0.5f : t;
}

__global__ void __launch_bounds__(ACT_THREADS)
trunc_exp_fwd_kernel(const float* __restrict__ x, float* __restrict__ y,
                     long long n, float m, int vec) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long nv = vec ? n >> 2 : 0;
    for (long long j = i; j < nv; j += stride) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(x) + j);
        reinterpret_cast<float4*>(y)[j] =
            make_float4(fwd1(a.x, m), fwd1(a.y, m), fwd1(a.z, m),
                        fwd1(a.w, m));
    }
    for (long long j = 4 * nv + i; j < n; j += stride) y[j] = fwd1(x[j], m);
}

__global__ void __launch_bounds__(ACT_THREADS)
trunc_exp_bwd_kernel(const float* __restrict__ g, const float* __restrict__ y,
                     float* __restrict__ gx, long long n, int vec) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long nv = vec ? n >> 2 : 0;
    for (long long j = i; j < nv; j += stride) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(g) + j);
        const float4 b = __ldg(reinterpret_cast<const float4*>(y) + j);
        reinterpret_cast<float4*>(gx)[j] =
            make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
    }
    for (long long j = 4 * nv + i; j < n; j += stride) gx[j] = g[j] * y[j];
}

__device__ __forceinline__ void bwd2_1(float v, float g, float x, float m,
                                       float& dg, float& dx) {
    const float y = fwd1(x, m);
    dg = v * y;
    dx = clip_slope(x, m, (v * g) * y);
}

__global__ void __launch_bounds__(ACT_THREADS)
trunc_exp_bwd2_kernel(const float* __restrict__ v, const float* __restrict__ g,
                      const float* __restrict__ x, float* __restrict__ dg,
                      float* __restrict__ dx,
                      long long n, float m, int vec) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long nv = vec ? n >> 2 : 0;
    for (long long j = i; j < nv; j += stride) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(v) + j);
        const float4 b = __ldg(reinterpret_cast<const float4*>(g) + j);
        const float4 c = __ldg(reinterpret_cast<const float4*>(x) + j);
        float4 p, q;
        bwd2_1(a.x, b.x, c.x, m, p.x, q.x);
        bwd2_1(a.y, b.y, c.y, m, p.y, q.y);
        bwd2_1(a.z, b.z, c.z, m, p.z, q.z);
        bwd2_1(a.w, b.w, c.w, m, p.w, q.w);
        reinterpret_cast<float4*>(dg)[j] = p;
        reinterpret_cast<float4*>(dx)[j] = q;
    }
    for (long long j = 4 * nv + i; j < n; j += stride)
        bwd2_1(v[j], g[j], x[j], m, dg[j], dx[j]);
}

// The forward's exact-cover grid: block b takes vectors [b T V,
// (b + 1) T V) (V = ACT_VECS), its thread t vectors b T V + k T + t for
// k < V, so that each load instruction of a warp reads 512 contiguous
// bytes; the thread whose vector is the first past the whole ones takes
// the n % 4 points of the tail. Without vec the same span of 4 T V
// points, scalar: point 4 b T V + k T + t for k < 4 V.
__global__ void __launch_bounds__(ACT_THREADS)
fwd_cover_kernel(const float* __restrict__ x, float* __restrict__ y,
                 long long n, float m, int vec) {
    const long long T = blockDim.x;
    const long long b0 = (long long)blockIdx.x * T * ACT_VECS;
    if (vec) {
        const long long nv = n >> 2;
        float4 a[ACT_VECS];
#pragma unroll
        for (int k = 0; k < ACT_VECS; ++k) {
            const long long j = b0 + k * T + threadIdx.x;
            if (j < nv) a[k] = __ldcs(reinterpret_cast<const float4*>(x) + j);
        }
#pragma unroll
        for (int k = 0; k < ACT_VECS; ++k) {
            const long long j = b0 + k * T + threadIdx.x;
            if (j < nv) {
                __stcs(reinterpret_cast<float4*>(y) + j,
                       make_float4(fwd1(a[k].x, m), fwd1(a[k].y, m),
                                   fwd1(a[k].z, m), fwd1(a[k].w, m)));
            } else if (j == nv) {
                for (long long q = 4 * nv; q < n; ++q) y[q] = fwd1(x[q], m);
            }
        }
        return;
    }
    float a[4 * ACT_VECS];
#pragma unroll
    for (int k = 0; k < 4 * ACT_VECS; ++k) {
        const long long q = 4 * b0 + k * T + threadIdx.x;
        if (q < n) a[k] = __ldcs(x + q);
    }
#pragma unroll
    for (int k = 0; k < 4 * ACT_VECS; ++k) {
        const long long q = 4 * b0 + k * T + threadIdx.x;
        if (q < n) __stcs(y + q, fwd1(a[k], m));
    }
}

// Every pointer a float32 device array of n points; vec 1: all of them
// 16-byte aligned (the 16-byte path). cover, blocks: the wrapper's launch
// (ops/activations.py `act_launch`): the grid-stride loop on `blocks`
// blocks (any count covers n), or with cover 1 (the forward only) the
// exact-cover grid, which must span n.
NERF_API int trunc_exp_fwd(const float* x, float* y, long long n, float m,
                           int vec, int cover, int blocks,
                           cudaStream_t stream) {
    if (n < 0 || blocks < 1 ||
        (cover && (long long)blocks * ACT_THREADS * ACT_VECS * 4 < n))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    if (cover)
        fwd_cover_kernel<<<blocks, ACT_THREADS, 0, stream>>>(x, y, n, m, vec);
    else
        trunc_exp_fwd_kernel<<<blocks, ACT_THREADS, 0, stream>>>(x, y, n, m,
                                                                 vec);
    return (int)cudaGetLastError();
}

NERF_API int trunc_exp_bwd(const float* g, const float* y, float* gx,
                           long long n, int vec, int blocks,
                           cudaStream_t stream) {
    if (n < 0 || blocks < 1) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    trunc_exp_bwd_kernel<<<blocks, ACT_THREADS, 0, stream>>>(g, y, gx, n,
                                                             vec);
    return (int)cudaGetLastError();
}

NERF_API int trunc_exp_bwd2(const float* v, const float* g, const float* x,
                            float* dg, float* dx, long long n, float m,
                            int vec, int blocks, cudaStream_t stream) {
    if (n < 0 || blocks < 1) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    trunc_exp_bwd2_kernel<<<blocks, ACT_THREADS, 0, stream>>>(
        v, g, x, dg, dx, n, m, vec);
    return (int)cudaGetLastError();
}
