// Kernel row 10b: the per-ray coherent expert of the coherent-expert renderer.
//
// Replaces: nerfsys_tpu/models/container.py `routing_coherent_expert`
// (:198-231), the probe of the coherent dispatch
// (nerfsys_tpu/pipelines/online/runtime_adapt.py:1226-1246, :1314-1330).
//
// A ray (its S sample points) is coherent on expert k iff the nearest
// centroid is k at every sample (the first index on equal distances, as
// argmin), and, under soft routing (margin > 1), the second-nearest
// distance exceeds margin times the nearest at every sample, both clamped
// at 1e-6 as routing_weights clamps them. The output is k, or -1.
//
// Distances are the container's routing distances: sum x^2 - 2 x.c +
// sum c^2 over the routing coordinates, each sum left to right, clamped at
// 0, sqrt; built with --fmad=false, so they round as the plain version's
// elementwise torch ops do and the argmin picks the same expert.
//
// Bound on the H100: bytes, N*S*12 B of points read and N*4 B written
// (~25 MB for a 65,536 x 32 chunk, ~0.008 ms at 3.35 TB/s); the S*K
// distances per ray are ~20 operations each. Design: one thread per ray
// walks its samples in order (the loads are per-thread row walks, not
// coalesced across the warp; a simple kernel first) and stops at the first
// sample that breaks coherence. The centroids sit in shared memory.
#include <math.h>

#include "common.cuh"

#define MAX_EXPERTS 64  // models/container.py MAX_EXPERTS

__device__ __forceinline__ float sum_sq(const float* v, int nd) {
    float s = v[0] * v[0];
    for (int j = 1; j < nd; ++j) s = s + v[j] * v[j];
    return s;
}

__global__ void coherent_expert_kernel(const float* __restrict__ pts,
                                       const float* __restrict__ cent,
                                       int* __restrict__ out, int N, int S,
                                       int K, int first, int nd,
                                       float margin, int soft) {
    __shared__ float s_c[MAX_EXPERTS * 3];
    __shared__ float s_sc[MAX_EXPERTS];
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
        float c[3];
        for (int j = 0; j < nd; ++j) c[j] = cent[k * 3 + first + j];
        for (int j = 0; j < nd; ++j) s_c[k * 3 + j] = c[j];
        s_sc[k] = sum_sq(c, nd);
    }
    __syncthreads();
    const long long ray = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (ray >= N) return;
    const float* p = pts + ray * S * 3;
    int a0 = 0;
    bool same = true;
    for (int s = 0; s < S && same; ++s) {
        float x[3];
        for (int j = 0; j < nd; ++j) x[j] = p[s * 3 + first + j];
        const float sx = sum_sq(x, nd);
        float best = INFINITY, m1 = INFINITY, m2 = INFINITY;
        int a = 0;
        for (int k = 0; k < K; ++k) {
            const float* c = s_c + k * 3;
            float dot = (2.0f * x[0]) * c[0];
            for (int j = 1; j < nd; ++j) dot = dot + (2.0f * x[j]) * c[j];
            const float d = sqrtf(fmaxf((sx - dot) + s_sc[k], 0.0f));
            if (d < best) {  // strict: the first index on ties
                best = d;
                a = k;
            }
            const float dc = fmaxf(d, 1e-6f);
            if (dc < m1) {
                m2 = m1;
                m1 = dc;
            } else if (dc < m2) {
                m2 = dc;
            }
        }
        if (s == 0) a0 = a;
        same = a == a0 && (!soft || m2 > margin * m1);
    }
    out[ray] = same ? a0 : -1;
}

// pts (N, S, 3), centroids (K, 3) -> out (N,) int32.
NERF_API int coherent_expert(const float* pts, const float* centroids,
                             int* out, int N, int S, int K, int cluster_2d,
                             float margin, cudaStream_t stream) {
    if (S < 1 || K < 1 || K > MAX_EXPERTS) return (int)cudaErrorInvalidValue;
    if (N > 0) {
        const int threads = 128;
        coherent_expert_kernel<<<nerf_blocks(N, threads), threads, 0,
                                 stream>>>(
            pts, centroids, out, N, S, K, cluster_2d ? 1 : 0,
            cluster_2d ? 2 : 3, margin, margin > 1.0f ? 1 : 0);
    }
    return (int)cudaGetLastError();
}
