// Kernel row 10a: bucketed top-E expert dispatch (10a-i), the blend of the
// bucket results back to the points (10a-ii) and its transpose (10a-iii).
//
// Replaces: nerfsys_tpu/models/container.py `_bucketed_eval` (:279-396):
// top-E routing with margin weights renormalised over E (:307-317), the
// counting sort of the N*E (point, expert) pairs into (K, C) buckets through
// an exclusive one-hot cumsum (:319-333), the bucket-row scatter and the
// 6-wide pts|dirs row gather (:336-350), and the reshape-sum blend (:363-373)
// with its VJP. The per-expert field evaluation between dispatch and blend
// stays the experts' own encoder kernel plus batched matmuls.
//
// 10a-i `bucket_dispatch`, four passes on the caller's stream:
//   1. route: one thread per point. Routing distances to the K centroids,
//      sum x^2 - 2 x.c + sum c^2, clamped at 0, sqrt, each sum left to
//      right (built with --fmad=false, so they round as the plain version's
//      elementwise torch ops do); the E nearest by an insertion scan over
//      ascending k with a strict less-than, so equal distances keep the
//      lower expert first (lax.top_k's order); the weights; and per block
//      the count of each expert's pairs with w > 0 (shared-memory atomics
//      on counts only).
//   2. scan: one block per expert, an exclusive scan of the block counts
//      (the expert's rank offset of every block) and its total demand.
//   3. place: per block, each pair's rank among the earlier pairs of its
//      expert in flattened pair order n*E+e: one warp ballot per expert
//      gives the rank inside the warp, the warps' counts in shared memory
//      the rank inside the block, pass 2 the block's offset. A point's E
//      experts are distinct, so the order inside a point never matters.
//      This is a stable counting sort: the reference's exclusive cumsum, the
//      same pairs overflow. No rank comes from an atomic counter. Then
//      slot, keep (slot < C and w > 0), dest (k*C + slot, or the trash slot
//      K*C), the bucket row and the gathered pts|dirs row.
//   4. fill: the empty slots of each bucket hold point 0 (the reference
//      scatters into zeros).
// 10a-ii `bucket_combine_fwd`: one thread per point, sigma = sum over e in
// e order of wk * sigma_b[dest] (wk = w on kept pairs, 0 on the trash slot,
// which reads 0); the same for rgb.
// 10a-iii `bucket_combine_bwd`: one thread per pair. Each kept slot is the
// destination of exactly one pair, so the transpose is a plain scatter with
// no atomics: g_sigma_b[dest] = wk * g_sigma[n]; the caller zeroes the rest.
//
// Bound on the H100: bytes. 10a-i reads N*12 B of points (and N*12 of
// directions) and writes N*E*12 B (idx, w, dest) + K*C*(4 + 24) B; 10a-ii
// reads N*E*(4 + 4 + 16) B and writes N*16 B; a 65,536 x 32 chunk is
// ~0.03-0.1 ms of traffic at 3.35 TB/s. A simple kernel first: one thread
// per point, the centroids in shared memory.
#include <math.h>

#include "common.cuh"

#define MAX_EXPERTS 64  // models/container.py MAX_EXPERTS
#define MAX_E 8         // experts per point the dispatch takes
#define BUCKET_THREADS 256  // models/container.py BUCKET_THREADS
#define SCAN_THREADS 1024

// the routing coordinates: (y, z) when cluster_2d, else (x, y, z)
struct RouteDims {
    int first;  // index of the first coordinate
    int nd;     // number of coordinates
};

static inline RouteDims route_dims(int cluster_2d) {
    RouteDims r;
    r.first = cluster_2d ? 1 : 0;
    r.nd = cluster_2d ? 2 : 3;
    return r;
}

__device__ __forceinline__ float sum_sq(const float* v, int nd) {
    float s = v[0] * v[0];
    for (int j = 1; j < nd; ++j) s = s + v[j] * v[j];
    return s;
}

// the centroids' routing coordinates and squared norms, in shared memory
__device__ __forceinline__ void load_centroids(const float* __restrict__ cent,
                                               int K, RouteDims rd,
                                               float* s_c, float* s_sc) {
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
        float c[3];
        for (int j = 0; j < rd.nd; ++j) c[j] = cent[k * 3 + rd.first + j];
        for (int j = 0; j < rd.nd; ++j) s_c[k * 3 + j] = c[j];
        s_sc[k] = sum_sq(c, rd.nd);
    }
}

__device__ __forceinline__ float route_dist(const float* x, float sx,
                                           const float* c, float sc,
                                           int nd) {
    float dot = (2.0f * x[0]) * c[0];
    for (int j = 1; j < nd; ++j) dot = dot + (2.0f * x[j]) * c[j];
    const float d2 = (sx - dot) + sc;
    return sqrtf(fmaxf(d2, 0.0f));
}

__global__ void bucket_route_kernel(
        const float* __restrict__ pts, const float* __restrict__ cent,
        int* __restrict__ idx, float* __restrict__ w,
        int* __restrict__ block_counts, int N, int K, int E, RouteDims rd,
        float margin, int soft) {
    __shared__ float s_c[MAX_EXPERTS * 3];
    __shared__ float s_sc[MAX_EXPERTS];
    __shared__ int s_cnt[MAX_EXPERTS];
    load_centroids(cent, K, rd, s_c, s_sc);
    for (int k = threadIdx.x; k < K; k += blockDim.x) s_cnt[k] = 0;
    __syncthreads();

    const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (n < N) {
        float x[3];
        for (int j = 0; j < rd.nd; ++j) x[j] = pts[n * 3 + rd.first + j];
        const float sx = sum_sq(x, rd.nd);
        float bd[MAX_E];
        int bk[MAX_E];
        for (int e = 0; e < E; ++e) {
            bd[e] = INFINITY;
            bk[e] = 0;
        }
        for (int k = 0; k < K; ++k) {
            const float d = route_dist(x, sx, s_c + k * 3, s_sc[k], rd.nd);
            if (d < bd[E - 1]) {  // strict: a tie keeps the lower expert
                int p = E - 1;
                while (p > 0 && d < bd[p - 1]) {
                    bd[p] = bd[p - 1];
                    bk[p] = bk[p - 1];
                    --p;
                }
                bd[p] = d;
                bk[p] = k;
            }
        }
        float wv[MAX_E];
        if (soft) {
            const float lim = margin * fmaxf(bd[0], 1e-6f);
            float tot = 0.0f;
            for (int e = 0; e < E; ++e) {
                const float ds = fmaxf(bd[e], 1e-6f);
                wv[e] = (1.0f / ds) * (ds <= lim ? 1.0f : 0.0f);
                tot = e == 0 ? wv[0] : tot + wv[e];
            }
            const float den = fmaxf(tot, 1e-6f);
            for (int e = 0; e < E; ++e) wv[e] = wv[e] / den;
        } else {
            for (int e = 0; e < E; ++e) wv[e] = e == 0 ? 1.0f : 0.0f;
        }
        for (int e = 0; e < E; ++e) {
            idx[n * E + e] = bk[e];
            w[n * E + e] = wv[e];
            if (wv[e] > 0.0f) atomicAdd(&s_cnt[bk[e]], 1);
        }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < K; k += blockDim.x)
        block_counts[(long long)blockIdx.x * K + k] = s_cnt[k];
}

// one block per expert: block_counts[b*K + k] becomes the exclusive prefix
// over blocks b' < b; counts[k] the expert's total demand
__global__ void bucket_scan_kernel(int* __restrict__ block_counts,
                                   int* __restrict__ counts, int n_blocks,
                                   int K) {
    __shared__ int s[SCAN_THREADS];
    const int k = blockIdx.x;
    const int t = threadIdx.x;
    const int per = (n_blocks + SCAN_THREADS - 1) / SCAN_THREADS;
    const int b0 = t * per;
    const int b1 = min(b0 + per, n_blocks);
    int part = 0;
    for (int b = b0; b < b1; ++b) part += block_counts[(long long)b * K + k];
    s[t] = part;
    __syncthreads();
    for (int off = 1; off < SCAN_THREADS; off <<= 1) {  // inclusive scan
        const int v = t >= off ? s[t - off] : 0;
        __syncthreads();
        s[t] += v;
        __syncthreads();
    }
    int run = s[t] - part;  // exclusive
    for (int b = b0; b < b1; ++b) {
        const long long i = (long long)b * K + k;
        const int v = block_counts[i];
        block_counts[i] = run;
        run += v;
    }
    if (t == SCAN_THREADS - 1) counts[k] = s[t];
}

__global__ void bucket_place_kernel(
        const float* __restrict__ pts, const float* __restrict__ dirs,
        const int* __restrict__ idx, const float* __restrict__ w,
        const int* __restrict__ block_offsets, int* __restrict__ dest,
        int* __restrict__ bucket_rows, float* __restrict__ rows, int N,
        int K, int E, int C) {
    __shared__ int s_warp[BUCKET_THREADS / 32][MAX_EXPERTS];
    const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const bool valid = n < N;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int myk[MAX_E];
    float myw[MAX_E];
    int myrank[MAX_E];
    for (int e = 0; e < E; ++e) {
        myk[e] = valid ? idx[n * E + e] : -1;
        myw[e] = valid ? w[n * E + e] : 0.0f;
        myrank[e] = 0;
    }
    const unsigned lower = (1u << lane) - 1u;
    for (int k = 0; k < K; ++k) {
        int which = -1;
        for (int e = 0; e < E; ++e)
            if (myk[e] == k && myw[e] > 0.0f) which = e;
        const unsigned m = __ballot_sync(0xffffffffu, which >= 0);
        if (which >= 0) myrank[which] = __popc(m & lower);
        if (lane == 0) s_warp[warp][k] = __popc(m);
    }
    __syncthreads();
    if (!valid) return;
    const int trash = K * C;
    const int width = dirs ? 6 : 3;
    for (int e = 0; e < E; ++e) {
        int d = trash;
        if (myw[e] > 0.0f) {
            const int k = myk[e];
            int r = block_offsets[(long long)blockIdx.x * K + k] + myrank[e];
            for (int v = 0; v < warp; ++v) r += s_warp[v][k];
            if (r < C) {
                d = k * C + r;
                bucket_rows[d] = (int)n;
                float* row = rows + (long long)d * width;
                for (int j = 0; j < 3; ++j) row[j] = pts[n * 3 + j];
                if (dirs)
                    for (int j = 0; j < 3; ++j) row[3 + j] = dirs[n * 3 + j];
            }
        }
        dest[n * E + e] = d;
    }
}

// slots at or past an expert's kept demand hold point 0
__global__ void bucket_fill_kernel(const float* __restrict__ pts,
                                   const float* __restrict__ dirs,
                                   const int* __restrict__ counts,
                                   int* __restrict__ bucket_rows,
                                   float* __restrict__ rows, int K, int C) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)K * C) return;
    const int k = (int)(i / C);
    const int s = (int)(i % C);
    if (s < counts[k]) return;
    bucket_rows[i] = 0;
    const int width = dirs ? 6 : 3;
    float* row = rows + i * width;
    for (int j = 0; j < 3; ++j) row[j] = pts[j];
    if (dirs)
        for (int j = 0; j < 3; ++j) row[3 + j] = dirs[j];
}

// pts, dirs (N, 3) (dirs nullable), centroids (K, 3) -> idx, w (N, E),
// dest (N*E,), counts (K,), bucket_rows (K, C), rows (K, C, 6 | 3).
// scratch: (ceil(N / 256) * K,) int32.
NERF_API int bucket_dispatch(const float* pts, const float* dirs,
                             const float* centroids, int* idx, float* w,
                             int* dest, int* counts, int* bucket_rows,
                             float* rows, int* scratch, int N, int K, int E,
                             int C, int cluster_2d, float margin,
                             cudaStream_t stream) {
    if (N < 1 || K < 1 || K > MAX_EXPERTS || E < 1 || E > MAX_E || E > K ||
        C < 1)
        return (int)cudaErrorInvalidValue;
    const RouteDims rd = route_dims(cluster_2d);
    const unsigned n_blocks = nerf_blocks(N, BUCKET_THREADS);
    bucket_route_kernel<<<n_blocks, BUCKET_THREADS, 0, stream>>>(
        pts, centroids, idx, w, scratch, N, K, E, rd, margin,
        margin > 1.0f ? 1 : 0);
    bucket_scan_kernel<<<K, SCAN_THREADS, 0, stream>>>(scratch, counts,
                                                       (int)n_blocks, K);
    bucket_place_kernel<<<n_blocks, BUCKET_THREADS, 0, stream>>>(
        pts, dirs, idx, w, scratch, dest, bucket_rows, rows, N, K, E, C);
    const long long slots = (long long)K * C;
    bucket_fill_kernel<<<nerf_blocks(slots, 256), 256, 0, stream>>>(
        pts, dirs, counts, bucket_rows, rows, K, C);
    return (int)cudaGetLastError();
}

__global__ void bucket_combine_fwd_kernel(
        const float* __restrict__ w, const int* __restrict__ dest,
        const float* __restrict__ sigma_b, const float* __restrict__ rgb_b,
        float* __restrict__ sigma, float* __restrict__ rgb, int N, int E,
        int n_slots) {
    const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    float s = 0.0f, r0 = 0.0f, r1 = 0.0f, r2 = 0.0f;
    for (int e = 0; e < E; ++e) {
        const int d = dest[n * E + e];
        const bool keep = d < n_slots;
        const float wk = keep ? w[n * E + e] : 0.0f;
        const float ps = wk * (keep ? sigma_b[d] : 0.0f);
        s = e == 0 ? ps : s + ps;
        if (rgb_b) {
            const float p0 = wk * (keep ? rgb_b[(long long)d * 3 + 0] : 0.0f);
            const float p1 = wk * (keep ? rgb_b[(long long)d * 3 + 1] : 0.0f);
            const float p2 = wk * (keep ? rgb_b[(long long)d * 3 + 2] : 0.0f);
            r0 = e == 0 ? p0 : r0 + p0;
            r1 = e == 0 ? p1 : r1 + p1;
            r2 = e == 0 ? p2 : r2 + p2;
        }
    }
    sigma[n] = s;
    if (rgb_b) {
        rgb[n * 3 + 0] = r0;
        rgb[n * 3 + 1] = r1;
        rgb[n * 3 + 2] = r2;
    }
}

// w (N, E), dest (N*E,), sigma_b (n_slots,), rgb_b (n_slots, 3) nullable
// -> sigma (N,), rgb (N, 3) (null when rgb_b is).
NERF_API int bucket_combine_fwd(const float* w, const int* dest,
                                const float* sigma_b, const float* rgb_b,
                                float* sigma, float* rgb, int N, int E,
                                int n_slots, cudaStream_t stream) {
    if (E < 1 || (rgb_b == nullptr) != (rgb == nullptr))
        return (int)cudaErrorInvalidValue;
    if (N > 0) {
        bucket_combine_fwd_kernel<<<nerf_blocks(N, 256), 256, 0, stream>>>(
            w, dest, sigma_b, rgb_b, sigma, rgb, N, E, n_slots);
    }
    return (int)cudaGetLastError();
}

__global__ void bucket_combine_bwd_kernel(
        const float* __restrict__ w, const int* __restrict__ dest,
        const float* __restrict__ g_sigma, const float* __restrict__ g_rgb,
        float* __restrict__ g_sigma_b, float* __restrict__ g_rgb_b, int N,
        int E, int n_slots) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)N * E) return;
    const int d = dest[i];
    if (d >= n_slots) return;  // the trash slot has no gradient
    const long long n = i / E;
    const float wk = w[i];
    g_sigma_b[d] = wk * g_sigma[n];
    if (g_rgb) {
        for (int c = 0; c < 3; ++c)
            g_rgb_b[(long long)d * 3 + c] = wk * g_rgb[n * 3 + c];
    }
}

// w (N, E), dest (N*E,), g_sigma (N,), g_rgb (N, 3) nullable -> the
// caller-zeroed g_sigma_b (n_slots,) and g_rgb_b (n_slots, 3) at the kept
// slots.
NERF_API int bucket_combine_bwd(const float* w, const int* dest,
                                const float* g_sigma, const float* g_rgb,
                                float* g_sigma_b, float* g_rgb_b, int N,
                                int E, int n_slots, cudaStream_t stream) {
    if (E < 1 || (g_rgb == nullptr) != (g_rgb_b == nullptr))
        return (int)cudaErrorInvalidValue;
    const long long pairs = (long long)N * E;
    if (pairs > 0) {
        bucket_combine_bwd_kernel<<<nerf_blocks(pairs, 256), 256, 0,
                                    stream>>>(w, dest, g_sigma, g_rgb,
                                              g_sigma_b, g_rgb_b, N, E,
                                              n_slots);
    }
    return (int)cudaGetLastError();
}
