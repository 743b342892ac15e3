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
// Bound on the H100: bytes. Reading every point is N*S*12 B and writing
// the ids N*4 B (25,427,968 B for a 65,536 x 32 chunk, 0.0076 ms at
// 3.35 TB/s; the S*K distances a ray are ~14 operations each, ~0.002 ms at
// K=4). But a ray is decided at its first incoherent sample, so what the
// data needs is each ray's points up to that sample: all of them on the
// skew frame's coherent chunks, one a ray on the bench chunk, where every
// ray breaks at sample 0 (1,048,576 B, 0.0003 ms). The first design (one
// thread a ray walking its samples, stopping at the first break) was
// latency-bound on coherent chunks, ~6x the bound; it stopped after one
// sample on the bench chunk. Lanes over samples alone (a ray a warp) were
// no faster: each warp loaded 384 B, waited, then ran a serial chain of K
// square roots. This design is kernel 4's lane map (volrend_common.cuh)
// with two changes, each measured (PERF.md, row 10b):
//   - a ray's samples on `lanes` consecutive lanes in pieces: lanes the
//     power of 2 at or above S, at most COHERENT_LANES = 8 (the plan's);
//     the pieces' verdicts are ANDed, and after each piece the warp votes
//     and stops once every ray it holds has broken. On a coherent chunk
//     pieces of 16 and 32 lanes took 1% less and 3% more; on the bench
//     chunk 1.65x and 3x as long;
//   - a warp takes COHERENT_GROUPS = 2 groups of 32 / lanes rays at once:
//     it issues every lane's point loads of both first (each lane reads its
//     own point, so a warp reads its rays' contiguous rows), then runs
//     their K distances interleaved, each centroid read from shared memory
//     once for both; a grid-stride loop walks the groups;
//   - each lane computes its sample's K distances (the first design's
//     arithmetic, in its order; the routing coordinates a template
//     parameter), the first-index argmin with a strict <, the two
//     smallest clamped distances and the singleton test;
//   - the segment's first lane broadcasts sample 0's argmin by shuffle,
//     the segment votes on `argmin == a0 && singleton` with one ballot
//     (every lane takes part) masked to its lanes, and its first lane
//     writes the id or -1.
// Staging a warp's rows in shared memory with 16-byte loads (plain or
// cp.async) measured slower than each lane reading its own point.
// The plan comes from Python (ops/volrend.py `ray_lane_plan`, cached per
// shape; row 8 takes the same kind of plan). ptxas for sm_90a: 40-51
// registers a thread over the twelve instances, no spills.
#include <math.h>

#include "volrend_common.cuh"

#define MAX_EXPERTS 64     // models/container.py MAX_EXPERTS
#define COHERENT_GROUPS 2  // models/container.py COHERENT_GROUPS

template <int W, int ND>
__global__ void __launch_bounds__(256) coherent_expert_kernel(
        const float* __restrict__ pts, const float* __restrict__ cent,
        int* __restrict__ out, int N, int S, int K, float margin, int soft,
        int pieces) {
    constexpr int RAYS = 32 / W;          // rays a group
    constexpr int G = COHERENT_GROUPS;    // groups a warp at once
    constexpr int FIRST = 3 - ND;         // cluster_2d routes on (y, z)
    __shared__ float s_c[MAX_EXPERTS * ND];
    __shared__ float s_sc[MAX_EXPERTS];
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
        float sc = 0.0f;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
            const float c = cent[k * 3 + FIRST + j];
            s_c[k * ND + j] = c;
            sc = j == 0 ? c * c : sc + c * c;
        }
        s_sc[k] = sc;
    }
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int sl = lane & (W - 1);  // the lane's place in its ray's segment
    const int r = lane / W;         // its ray's place in the group
    const unsigned seg = (FULL_MASK >> (32 - W)) << (r * W);
    const long long stride =
        (long long)gridDim.x * (blockDim.x >> 5) * RAYS * G;
    for (long long first =
             ((long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) *
             RAYS * G;
         first < N; first += stride) {  // warp-uniform
        long long ray[G];
        bool live[G], same[G];
        int a0[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
            ray[g] = first + g * RAYS + r;
            live[g] = ray[g] < N;
            same[g] = true;
            a0[g] = 0;
        }
        for (int p = 0; p < pieces; ++p) {
            const int cnt = min(W, S - p * W);  // the piece's samples a ray
            const int s = p * W + sl;
            float x2[G][ND], sx[G];
            bool on[G];
#pragma unroll
            for (int g = 0; g < G; ++g) {  // every load first
                on[g] = live[g] && sl < cnt;
                const float* xp = pts + (ray[g] * S + s) * 3 + FIRST;
#pragma unroll
                for (int j = 0; j < ND; ++j)
                    x2[g][j] = on[g] ? __ldg(xp + j) : 0.0f;
            }
#pragma unroll
            for (int g = 0; g < G; ++g) {
                float v = x2[g][0] * x2[g][0];
#pragma unroll
                for (int j = 1; j < ND; ++j) v = v + x2[g][j] * x2[g][j];
                sx[g] = v;
#pragma unroll
                for (int j = 0; j < ND; ++j) x2[g][j] = 2.0f * x2[g][j];
            }
            float best[G], m1[G], m2[G];
            int a[G];
#pragma unroll
            for (int g = 0; g < G; ++g) {
                best[g] = m1[g] = m2[g] = INFINITY;
                a[g] = 0;
            }
            for (int k = 0; k < K; ++k) {
                float c[ND];
#pragma unroll
                for (int j = 0; j < ND; ++j) c[j] = s_c[k * ND + j];
                const float sc = s_sc[k];
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    float dot = x2[g][0] * c[0];
#pragma unroll
                    for (int j = 1; j < ND; ++j) dot = dot + x2[g][j] * c[j];
                    const float d = sqrtf(fmaxf((sx[g] - dot) + sc, 0.0f));
                    if (d < best[g]) {  // strict: the first index on ties
                        best[g] = d;
                        a[g] = k;
                    }
                    const float dc = fmaxf(d, 1e-6f);
                    if (dc < m1[g]) {
                        m2[g] = m1[g];
                        m1[g] = dc;
                    } else if (dc < m2[g]) {
                        m2[g] = dc;
                    }
                }
            }
            bool any = false;
#pragma unroll
            for (int g = 0; g < G; ++g) {
                if (p == 0) a0[g] = __shfl_sync(FULL_MASK, a[g], 0, W);
                const bool ok = !on[g] || (a[g] == a0[g] &&
                                           (!soft || m2[g] > margin * m1[g]));
                // every lane votes, also where its ray has broken already
                const unsigned vote = __ballot_sync(FULL_MASK, ok);
                same[g] = same[g] && (vote & seg) == seg;
                any = any || (same[g] && live[g]);
            }
            if (pieces > 1 && !__any_sync(FULL_MASK, any)) break;
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
            if (live[g] && sl == 0) out[ray[g]] = same[g] ? a0[g] : -1;
    }
}

// pts (N, S, 3), centroids (K, 3) -> out (N,) int32; plan from
// ops/volrend.py `ray_lane_plan(N, S, COHERENT_GROUPS, COHERENT_LANES)`.
NERF_API int coherent_expert(const float* pts, const float* centroids,
                             int* out, int N, int S, int K, int cluster_2d,
                             float margin, RayLanePlan plan,
                             cudaStream_t stream) {
    if (K < 1 || K > MAX_EXPERTS ||
        !ray_lane_plan_ok(plan, S, COHERENT_GROUPS))
        return (int)cudaErrorInvalidValue;
    if (N <= 0) return (int)cudaGetLastError();
    const int soft = margin > 1.0f ? 1 : 0;
#define COHERENT_LAUNCH(LANES)                                               \
    if (cluster_2d)                                                          \
        coherent_expert_kernel<LANES, 2>                                     \
            <<<plan.blocks, plan.threads, 0, stream>>>(                      \
                pts, centroids, out, N, S, K, margin, soft, plan.pieces);    \
    else                                                                     \
        coherent_expert_kernel<LANES, 3>                                     \
            <<<plan.blocks, plan.threads, 0, stream>>>(                      \
                pts, centroids, out, N, S, K, margin, soft, plan.pieces)
    switch (plan.lanes) {
        case 1: COHERENT_LAUNCH(1); break;
        case 2: COHERENT_LAUNCH(2); break;
        case 4: COHERENT_LAUNCH(4); break;
        case 8: COHERENT_LAUNCH(8); break;
        case 16: COHERENT_LAUNCH(16); break;
        default: COHERENT_LAUNCH(32); break;
    }
#undef COHERENT_LAUNCH
    return (int)cudaGetLastError();
}
