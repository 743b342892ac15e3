// Kernel 3: inverse-CDF sample placement over the probe intervals.
//
// Replaces: nerfsys_tpu/ops/occupancy.py `sample_tvals_from_cdf` (:468),
// with its optional per-sample mask (with_mask, kernel 3m).
//
// Per ray, for each of the S samples with target u (shared (S,) or per ray
// (N, S) when jittered):
//   idx  = clip(#{q in 1..P : cdf[q] <= u}, 0, P-1)     (the same `<=` count)
//   frac = (u - cdf[idx]) / max(cdf[idx+1] - cdf[idx], 1e-12)
//   s    = edges[idx] + frac * (edges[1] - edges[0])
//   t    = near + (far - near) * s
// then the S values are sorted ascending. Built with --fmad=false so the
// lerps round like the plain PyTorch version.
//
// With the probe bits `occ` (N, P) (kernel 2's output; null: no mask),
// sample i's bit occ[ray, idx_i] is written to `mask` (N, S) at the
// sample's sorted position: position i on a row written out sorted, its
// rank in (value, index) order on a row that takes the rank sort. That is
// jnp.argsort's stable order (the reference takes the bits through it):
// samples of equal t keep their index order, so a tie between two
// intervals with different bits resolves as in the reference.
//
// Bound on the H100: bytes (the cdf row in, S floats out: ~43 MB per
// 65,536-ray chunk at P=128, S=32). Counting every interval (P compares
// from shared memory a sample) and rank-sorting every row (S x S
// compares) is issue-bound at ~7x the byte bound. This design, a warp a
// ray (`SamplePlan`, ops/occupancy.py `sample_plan`):
//   - the warps walk the rays: the grid is at most the blocks resident at
//     once (the occupancy calculator's, per instance and device), so it
//     runs in one wave; each warp stages its next cdf row with cp.async
//     into the second of two shared rows while it places the current one,
//     so a warp always has a row in flight. Rows are skewed by one word
//     every 32 so that the binary search's lanes spread over the banks;
//   - one vote tests every adjacent pair c[q] <= c[q+1] (a NaN fails). On a
//     row that never decreases the count is an upper-bound search, so such
//     a row takes a binary search (log2 P + 1 shared loads a sample); a row
//     that dips (a Kogge-Stone scan can dip by an ulp over dead probes)
//     keeps the literal count. Both give the same idx;
//   - a second vote tests each placement against its neighbour. A sorted
//     row (the usual case: u rises across i and t rises with u) is written
//     straight out; only an unsorted one takes the rank sort (each value's
//     position = the number of values before it in (value, index) order,
//     so equal values keep a well-defined order and the values are
//     torch.sort's);
//   - `counts`, when not null, receives the rows that took the count
//     (counts[0]) and the rank sort (counts[1]): the edge checks' proof
//     that both fallbacks are reached;
//   - the mask (3m): each placement reads its interval's bit (one byte of
//     the ray's P, in the L1 after the first) into a per-warp byte row
//     beside the placements, and the write-out stores it beside its t.
#include "common.cuh"

#define SAMPLE_THREADS 128  // ops/occupancy.py SAMPLE_WARPS x 32

struct SamplePlan {
    int warps;    // warps a block, a ray each at a time
    int threads;  // warps * 32
    int blocks;   // ceil(N / warps); the launch takes at most the blocks
                  // resident at once, and the warps walk the rays
    int stride;   // floats of a staged cdf row: skew(P) + 1
    int smem;     // warps * (2 * stride + S) floats, then warps * S mask
                  // bytes, in bytes
    int top;      // the largest power of 2 <= P: the search's first step
};

// the largest power of 2 <= p (p >= 1)
__host__ __device__ constexpr int pow2_floor(int p) {
    return p < 2 ? 1 : 2 * pow2_floor(p / 2);
}

// shared-memory word of cdf entry q: one word of padding every 32
__device__ __forceinline__ int skew(int q) { return q + (q >> 5); }

// cp.async of cdf row `crow` into the skewed shared row `c`
__device__ __forceinline__ void stage_row(float* c, const float* crow, int P,
                                          int lane) {
#pragma unroll
    for (int q = lane; q <= P; q += 32) cp_async(c + skew(q), crow + q, 4);
}

// PT, ST > 0 fix P and S at compile time (the serve chunk's and the
// step's P = 128, S = 32: every loop unrolled); 0 takes them at run time
template <int PT, int ST>
__global__ void __launch_bounds__(SAMPLE_THREADS) sample_tvals_kernel(
        const float* __restrict__ cdf, const float* __restrict__ near,
        const float* __restrict__ far, const float* __restrict__ u,
        const float* __restrict__ edges, const uint8_t* __restrict__ occ,
        float* __restrict__ t_out, uint8_t* __restrict__ mask,
        int* __restrict__ counts, int N, int P_, int S_, int u_per_ray,
        SamplePlan plan) {
    extern __shared__ float smem[];
    const int P = PT > 0 ? PT : P_;
    const int S = ST > 0 ? ST : S_;
    const int top = PT > 0 ? pow2_floor(PT) : plan.top;
    const int wib = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const long long step_rays = (long long)gridDim.x * plan.warps;
    float* rows = smem + wib * (2 * plan.stride + S);
    float* tv = rows + 2 * plan.stride;
    uint8_t* mb = reinterpret_cast<uint8_t*>(
                      smem + plan.warps * (2 * plan.stride + S)) +
                  wib * S;  // the placements' probe bits
    const float width = edges[1] - edges[0];
    long long ray = (long long)blockIdx.x * plan.warps + wib;
    if (ray < N) stage_row(rows, cdf + ray * (P + 1), P, lane);
    cp_async_commit();
    for (int buf = 0; ray < N; ray += step_rays, buf ^= 1) {  // warp-uniform
        const long long next = ray + step_rays;
        if (next < N)
            stage_row(rows + (buf ^ 1) * plan.stride, cdf + next * (P + 1), P,
                      lane);
        cp_async_commit();
        cp_async_wait_one();  // this ray's row has landed
        __syncwarp();
        const float* c = rows + buf * plan.stride;
        bool mono = true;
#pragma unroll
        for (int q = lane; q < P; q += 32)
            mono = mono && c[skew(q)] <= c[skew(q + 1)];
        const bool search = __all_sync(FULL_MASK, mono);

        const float nr = near[ray];
        const float span = far[ray] - nr;
        const float* urow = u_per_ray ? u + ray * S : u;
#pragma unroll
        for (int i = lane; i < S; i += 32) {
            const float uu = urow[i];
            int cnt = 0;
            if (search) {  // the last q with c[q] <= u: a prefix of 1..P
#pragma unroll
                for (int step = top; step > 0; step >>= 1) {
                    const int q = cnt + step;
                    if (q <= P && c[skew(q)] <= uu) cnt = q;
                }
            } else {
                for (int q = 1; q <= P; ++q)
                    cnt += (c[skew(q)] <= uu) ? 1 : 0;
            }
            const int idx = min(max(cnt, 0), P - 1);
            const float lo = c[skew(idx)];
            const float frac =
                (uu - lo) / fmaxf(c[skew(idx + 1)] - lo, 1e-12f);
            const float s = edges[idx] + frac * width;
            tv[i] = nr + span * s;
            if (occ != nullptr) mb[i] = occ[ray * P + idx];
        }
        __syncwarp();

        bool in_order = true;
#pragma unroll
        for (int i = lane; i + 1 < S; i += 32)
            in_order = in_order && tv[i] <= tv[i + 1];
        const bool sorted = __all_sync(FULL_MASK, in_order);
        float* orow = t_out + ray * S;
        uint8_t* mrow = mask != nullptr ? mask + ray * S : nullptr;
        if (sorted) {
            for (int i = lane; i < S; i += 32) {
                orow[i] = tv[i];
                if (mrow != nullptr) mrow[i] = mb[i];
            }
        } else {
            for (int i = lane; i < S; i += 32) {
                const float ti = tv[i];
                int rank = 0;
                for (int j = 0; j < S; ++j) {
                    const float tj = tv[j];
                    rank += (tj < ti || (tj == ti && j < i)) ? 1 : 0;
                }
                orow[rank] = ti;
                if (mrow != nullptr) mrow[rank] = mb[i];
            }
        }
        if (counts != nullptr && lane == 0) {
            if (!search) atomicAdd(&counts[0], 1);
            if (!sorted) atomicAdd(&counts[1], 1);
        }
        __syncwarp();  // every lane is done with this row, tv and mb
    }
}

template <int PT, int ST>
static int launch_sample(const float* cdf, const float* near,
                         const float* far, const float* u,
                         const float* edges, const uint8_t* occ,
                         float* t_out, uint8_t* mask, int* counts, int N,
                         int P, int S, int u_per_ray, SamplePlan plan,
                         cudaStream_t stream) {
    static LaunchCache cache;
    auto kern = sample_tvals_kernel<PT, ST>;
    int resident = 0;
    const cudaError_t e =
        cached_resident(cache, kern, plan.threads, plan.smem, &resident);
    if (e != cudaSuccess) return (int)e;
    if (resident < 1) return (int)cudaErrorInvalidConfiguration;
    kern<<<min(plan.blocks, resident), plan.threads, plan.smem, stream>>>(
        cdf, near, far, u, edges, occ, t_out, mask, counts, N, P, S,
        u_per_ray, plan);
    return (int)cudaGetLastError();
}

// cdf: (N, P+1); near, far: (N,); u: (S,) or (N, S); edges: (P+1,);
// occ: (N, P) bool probe bits or null; counts: (2,) int32 or null.
// Out: t_vals (N, S), sorted per ray; mask (N, S) bool, null iff occ is.
NERF_API int sample_tvals_from_cdf(const float* cdf, const float* near,
                                   const float* far, const float* u,
                                   const float* edges, const uint8_t* occ,
                                   float* t_out, uint8_t* mask, int* counts,
                                   int N, int P, int S, int u_per_ray,
                                   SamplePlan plan, cudaStream_t stream) {
    if (P < 1 || S < 1 || plan.threads != SAMPLE_THREADS ||
        plan.threads != plan.warps * 32 || plan.blocks < 1 ||
        plan.stride != P + (P >> 5) + 1 || plan.top < 1 || plan.top > P ||
        2 * plan.top <= P ||
        plan.smem != plan.warps * (4 * (2 * plan.stride + S) + S) ||
        plan.smem > 48 * 1024 || (occ == nullptr) != (mask == nullptr))
        return (int)cudaErrorInvalidValue;
    if (N < 1) return (int)cudaGetLastError();
    return P == 128 && S == 32
               ? launch_sample<128, 32>(cdf, near, far, u, edges, occ, t_out,
                                        mask, counts, N, P, S, u_per_ray,
                                        plan, stream)
               : launch_sample<0, 0>(cdf, near, far, u, edges, occ, t_out,
                                     mask, counts, N, P, S, u_per_ray, plan,
                                     stream);
}
