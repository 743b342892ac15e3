// Kernel 3: inverse-CDF sample placement over the probe intervals.
//
// Replaces: nerfsys_tpu/ops/occupancy.py `sample_tvals_from_cdf` (:468),
// without the optional per-sample mask (with_mask).
//
// Per ray, for each of the S samples with target u (shared (S,) or per ray
// (N, S) when jittered):
//   idx  = clip(#{q in 1..P : cdf[q] <= u}, 0, P-1)     (the same `<=` count)
//   frac = (u - cdf[idx]) / max(cdf[idx+1] - cdf[idx], 1e-12)
//   s    = edges[idx] + frac * (edges[1] - edges[0])
//   t    = near + (far - near) * s
// then the S values are sorted ascending. The sort is kept: the values are
// not assumed monotone. Built with --fmad=false so the lerps round like the
// plain PyTorch version.
//
// Bound on the H100: bytes (cdf row in, S floats out: ~43 MB per 65,536-ray
// chunk at P=128, S=32), though the literal count costs S*P compares per
// ray (268M per chunk) from shared memory. Design: one warp per ray; the
// warp stages its cdf row in shared memory once, each lane places S/32
// samples, and the sort is a rank sort (each value's position = the number
// of values before it in (value, index) order), so no lane waits on a
// serial insertion sort and equal values keep a well-defined order.
#include "common.cuh"

#define SAMPLE_WARPS 4

__global__ void sample_tvals_kernel(
        const float* __restrict__ cdf, const float* __restrict__ near,
        const float* __restrict__ far, const float* __restrict__ u,
        const float* __restrict__ edges, float* __restrict__ t_out, int N,
        int P, int S, int u_per_ray) {
    extern __shared__ float smem[];
    const int wib = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const long long ray = (long long)blockIdx.x * SAMPLE_WARPS + wib;
    if (ray >= N) return;  // uniform over the warp
    float* c = smem + wib * (P + 1 + S);
    float* tv = c + (P + 1);

    const float* crow = cdf + ray * (P + 1);
    for (int q = lane; q <= P; q += 32) c[q] = crow[q];
    __syncwarp();

    const float nr = near[ray];
    const float span = far[ray] - nr;
    const float width = edges[1] - edges[0];
    const float* urow = u_per_ray ? u + ray * S : u;
    for (int i = lane; i < S; i += 32) {
        const float uu = urow[i];
        int cnt = 0;
        for (int q = 1; q <= P; ++q) cnt += (c[q] <= uu) ? 1 : 0;
        const int idx = min(max(cnt, 0), P - 1);
        const float lo = c[idx];
        const float frac = (uu - lo) / fmaxf(c[idx + 1] - lo, 1e-12f);
        const float s = edges[idx] + frac * width;
        tv[i] = nr + span * s;
    }
    __syncwarp();

    float* orow = t_out + ray * S;
    for (int i = lane; i < S; i += 32) {
        const float ti = tv[i];
        int rank = 0;
        for (int j = 0; j < S; ++j) {
            const float tj = tv[j];
            rank += (tj < ti || (tj == ti && j < i)) ? 1 : 0;
        }
        orow[rank] = ti;
    }
}

// cdf: (N, P+1); near, far: (N,); u: (S,) or (N, S); edges: (P+1,).
// Out: t_vals (N, S), sorted per ray.
NERF_API int sample_tvals_from_cdf(const float* cdf, const float* near,
                                   const float* far, const float* u,
                                   const float* edges, float* t_out, int N,
                                   int P, int S, int u_per_ray,
                                   cudaStream_t stream) {
    if (N > 0) {
        const size_t smem = (size_t)SAMPLE_WARPS * (P + 1 + S) * sizeof(float);
        const unsigned int blocks =
            (unsigned int)((N + SAMPLE_WARPS - 1) / SAMPLE_WARPS);
        sample_tvals_kernel<<<blocks, SAMPLE_WARPS * 32, smem, stream>>>(
            cdf, near, far, u, edges, t_out, N, P, S, u_per_ray);
    }
    return (int)cudaGetLastError();
}
