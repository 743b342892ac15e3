// Kernel 2: union occupancy probe + importance pdf + normalised CDF.
//
// Replaces: nerfsys_tpu/ops/occupancy.py `occupancy_probe_cdf` (:394) with
// `query_pair` (:196) and `_finest_level_index` (:121), unioned over the K
// experts by `union_pair_fn` (nerfsys_tpu/models/occupancy.py:92). It reads
// the (binary, EMA value) grids in place; it does not build the fused
// (L*R^3, 2) table the TPU layout builds per call.
//
// Per ray (N rays, P probes at the interval midpoints `mids`):
//   t_p  = near + (far - near) * mids[p];  x_p = o + d * t_p
//   for every expert k: the FINEST level l whose box contains x_p decides:
//     rel = (x_p - lo_kl) / (hi_kl - lo_kl)   (a true division), inside iff
//     0 <= rel < 1 on all axes; cell = clip(int(rel * R), 0, R - 1)
//     occ_k = binary[k, l, cell]; val_k = max(occs[k, l, cell], 0)
//     (a point inside no level: occ_k = false, val_k = 0)
//   occ = any_k occ_k; val = max_k val_k
//   importance: val *= occ; imp = val / sum(val) (uniform-over-occupied
//     when sum(val) <= 1e-12); w = (1-uf) * imp + uf * occ / max(sum occ,
//     1e-12); else w = occ
//   ray_floor > 0: w = (1-rf) * w / max(sum w, 1e-12) + rf / P
//   w += 1e-12; cdf = [0, cumsum(w) / sum(w)]; alive = any(occ)
// The scalar constants (1-uf, uf, 1-rf, rf/P) arrive pre-rounded to
// float32 from the host, exactly as the reference's weak-typed constants.
// Built with --fmad=false: the probe points and rel coordinates then round
// like the plain PyTorch version, so the selected cells agree.
//
// Bound on the H100: the operations. At bench width the K=4 experts' grids
// (4 x 4 levels x 128^3 cells x (4 B value + 1 B bit), ~212 MB) exceed the
// 50 MB L2, but a serve chunk's selected cells touch ~48 MB of distinct
// sectors (neighbouring pixels' probes fall on the same or adjacent
// cells), while each of its 8.4M probes tests levels, divides and indexes
// once per expert: the kernel is bound by instruction issue. Design:
//   - phase 1, lanes across rays (plan lane_map "rays"): a block takes 32
//     consecutive rays and its warps take interleaved probe indices, so the
//     32 lanes of a load hit the cells of 32 neighbouring rays at one probe
//     index: a few sectors an instruction, not 32. For a few scattered rays
//     (the training step's task rays, lane_map "probes") a warp takes a ray
//     and its lanes the probes, as the first design did;
//   - one read per (probe, expert): the K bits first (bytes), and the K
//     values only where the union is set and the pdf uses them (a probe no
//     expert occupies has val * occ = 0);
//   - no division to find the level: rel >= 0 and rel < 1 are monotone in
//     x, so each level's inside test is x >= a and x < b with float bounds
//     a, b that the wrapper finds once per box tensor (ops/occupancy.py
//     `level_bounds`); only the deciding level divides, so the selected
//     cells stay bit for bit those of the plain version (`locate`, in
//     occ_common.cuh, shared with kernel 11q's point queries);
//   - the probe results go to a rays x P tile in shared memory (the value,
//     or -1 for a probe no expert occupies); phase 2 takes one ray a warp
//     with lanes over its probes (the first design's order of the sums and
//     the scan; J probes a lane, J the power of 2 at or above P / 32) and
//     writes the cdf rows and occupancy bytes coalesced.
// The plan comes from Python (ops/occupancy.py `occ_probe_plan`).
#include "occ_common.cuh"  // BOX_FLOATS, locate

struct ProbePlan {  // ops/occupancy.py ProbeLaunchPlan
    int lane_map;   // 0 "probes": a warp a ray; 1 "rays": lanes over rays
    int rays;       // rays a block: 32 ("rays") or its warps ("probes")
    int threads;    // per block, a multiple of 32, at most 256
    int blocks;     // enough for N rays
    int stride;     // floats a staged row: P, rounded up to an odd number
    int smem;       // dynamic shared bytes: the level table, then the tile
    int group;      // experts located at once: 1 or 4
    int chunks;     // probes a lane in phase 2: 1, 2, 4 or 8 (P <= 32 x)
};

__device__ __forceinline__ float warp_sum(float v) {
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(FULL_MASK, v, off);
    return v;  // butterfly: every lane holds the same rounded sum
}

__device__ __forceinline__ float warp_inclusive_scan(float v, int lane) {
    for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(FULL_MASK, v, off);
        if (lane >= off) v += y;
    }
    return v;
}

// One probe against the union of the K experts: -1 when no expert's
// deciding cell is occupied, else max_k val_k (0 without importance).
// Experts are located G at a time, their cells' bits read together; the
// values follow only for an occupied probe, from the kept indices when
// one group holds every expert, else from the group located again.
template <int G>
__device__ __forceinline__ float probe_union(
        const float4* box, const float* __restrict__ occs,
        const uint8_t* __restrict__ binary, int K, int L, int R,
        int importance, float x, float y, float z) {
    const int groups = (K + G - 1) / G;
    int flat[G];
    bool oc = false;
    for (int g = 0; g < groups; ++g) {
#pragma unroll
        for (int j = 0; j < G; ++j)
            flat[j] = g * G + j < K ? locate(box, g * G + j, L, R, x, y, z)
                                    : -1;
#pragma unroll
        for (int j = 0; j < G; ++j)
            oc = oc || (flat[j] >= 0 && __ldg(binary + flat[j]) != 0);
    }
    if (!oc) return -1.0f;
    if (!importance) return 0.0f;
    float vmax = 0.0f;
    for (int g = 0; g < groups; ++g) {
        if (groups > 1) {
#pragma unroll
            for (int j = 0; j < G; ++j)
                flat[j] = g * G + j < K
                              ? locate(box, g * G + j, L, R, x, y, z)
                              : -1;
        }
#pragma unroll
        for (int j = 0; j < G; ++j)
            if (flat[j] >= 0)
                vmax = fmaxf(vmax, fmaxf(__ldg(occs + flat[j]), 0.0f));
    }
    return vmax;
}

template <int G, int J>
__global__ void __launch_bounds__(256) occupancy_probe_cdf_kernel(
        const float* __restrict__ rays_o, const float* __restrict__ rays_d,
        const float* __restrict__ near, const float* __restrict__ far,
        const float* __restrict__ mids, const float* __restrict__ occs,
        const uint8_t* __restrict__ binary, const float* __restrict__ levels,
        float* __restrict__ cdf, uint8_t* __restrict__ alive,
        uint8_t* __restrict__ occ_out, int N, int P, int K, int L, int R,
        int importance, float c_imp, float c_uni, float c_keep,
        float c_floor, ProbePlan plan) {
    extern __shared__ float4 smem_v[];  // 16-byte aligned: float4 reads
    float* smem = reinterpret_cast<float*>(smem_v);
    float* box = smem;                           // K * L levels
    float* tile = smem + K * L * BOX_FLOATS;     // plan.rays x plan.stride
    for (int i = threadIdx.x; i < K * L * BOX_FLOATS; i += blockDim.x)
        box[i] = __ldg(levels + i);
    __syncthreads();
    const float4* box4 = reinterpret_cast<const float4*>(box);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    const long long ray0 = (long long)blockIdx.x * plan.rays;

    // phase 1: the probes of this thread's ray, into the tile
    const int r = plan.lane_map ? lane : warp;
    const int p0 = plan.lane_map ? warp : lane;
    const int dp = plan.lane_map ? warps : 32;
    const long long ray = ray0 + r;
    if (ray < N) {
        const float ox = rays_o[ray * 3 + 0], oy = rays_o[ray * 3 + 1],
                    oz = rays_o[ray * 3 + 2];
        const float dx = rays_d[ray * 3 + 0], dy = rays_d[ray * 3 + 1],
                    dz = rays_d[ray * 3 + 2];
        const float nr = near[ray];
        const float span = far[ray] - nr;
        float* row = tile + r * plan.stride;
        for (int p = p0; p < P; p += dp) {
            const float t = nr + span * __ldg(mids + p);
            row[p] = probe_union<G>(box4, occs, binary, K, L, R, importance,
                                    ox + dx * t, oy + dy * t, oz + dz * t);
        }
    }
    __syncthreads();

    // phase 2: a ray a warp, lanes over its probes
    for (int rr = warp; rr < plan.rays; rr += warps) {
        const long long ray = ray0 + rr;
        if (ray >= N) break;  // uniform over the warp
        const float* staged = tile + rr * plan.stride;
        float occf[J];
        float val[J];
        bool any_occ = false;
#pragma unroll
        for (int j = 0; j < J; ++j) {
            const int p = lane + 32 * j;
            const float e = p < P ? staged[p] : -1.0f;
            const bool oc = e >= 0.0f;
            if (p < P) occ_out[ray * P + p] = oc ? 1 : 0;
            occf[j] = oc ? 1.0f : 0.0f;
            val[j] = oc ? e : 0.0f;
            any_occ = any_occ || oc;
        }
        const bool ray_alive = __any_sync(FULL_MASK, any_occ);

        float w[J];
        if (importance) {
            float vs = 0.0f, os = 0.0f;
#pragma unroll
            for (int j = 0; j < J; ++j) {
                vs += val[j];
                os += occf[j];
            }
            const float vsum = warp_sum(vs);
            // occf / osum is 0 or 1 / osum: one division a ray, same bits
            const float r_osum = 1.0f / fmaxf(warp_sum(os), 1e-12f);
#pragma unroll
            for (int j = 0; j < J; ++j) {
                const float uni = occf[j] != 0.0f ? r_osum : 0.0f;
                const float imp =
                    vsum > 1e-12f ? val[j] / fmaxf(vsum, 1e-12f) : uni;
                w[j] = c_imp * imp + c_uni * uni;
            }
        } else {
#pragma unroll
            for (int j = 0; j < J; ++j) w[j] = occf[j];
        }
        if (c_floor > 0.0f) {
            float ws = 0.0f;
#pragma unroll
            for (int j = 0; j < J; ++j)
                if (lane + 32 * j < P) ws += w[j];
            const float wsum = fmaxf(warp_sum(ws), 1e-12f);
#pragma unroll
            for (int j = 0; j < J; ++j)
                w[j] = c_keep * (w[j] / wsum) + c_floor;
        }

        // inclusive prefix sum over the P probes, 32 at a time with a carry
        float* out = cdf + ray * (P + 1);
        float cum[J];
        float carry = 0.0f;
#pragma unroll
        for (int j = 0; j < J; ++j) {
            const float x = (lane + 32 * j < P) ? w[j] + 1e-12f : 0.0f;
            const float s = warp_inclusive_scan(x, lane);
            cum[j] = s + carry;
            carry = carry + __shfl_sync(FULL_MASK, s, 31);
        }
        const float total = carry;  // == cum at p = P-1: cdf[P] == 1
#pragma unroll
        for (int j = 0; j < J; ++j) {
            const int p = lane + 32 * j;
            if (p < P) out[1 + p] = cum[j] / total;
        }
        if (lane == 0) {
            out[0] = 0.0f;
            alive[ray] = ray_alive ? 1 : 0;
        }
    }
}

// rays_o, rays_d: (N, 3); near, far: (N,); mids: (P,); occs: (K, L, R, R, R)
// float; binary: same shape, bool bytes; levels: (K, L, 12) float, each
// level's inside bounds a[3], b[3], its lo[3] and width w[3]
// (ops/occupancy.py `level_bounds`). K * L * R^3 < 2^31.
// Out: cdf (N, P+1) float, alive (N,) bool, occ (N, P) bool.
NERF_API int occupancy_probe_cdf(
        const float* rays_o, const float* rays_d, const float* near,
        const float* far, const float* mids, const float* occs,
        const uint8_t* binary, const float* levels, float* cdf,
        uint8_t* alive, uint8_t* occ_out, int N, int P, int K, int L, int R,
        int importance, float c_imp, float c_uni, float c_keep, float c_floor,
        ProbePlan plan, cudaStream_t stream) {
    const int warps = plan.threads / 32;
    const long long stride_min = P | 1;
    int chunks = 1;  // the power of 2 at or above ceil(P / 32)
    while (32 * chunks < P) chunks <<= 1;
    if (P < 1 || P > 256 || plan.chunks != chunks || K < 1 || L < 1 ||
        R < 1 ||
        (long long)K * L * R * R * R >= (1LL << 31) || plan.threads < 32 ||
        plan.threads > 256 || plan.threads % 32 ||
        plan.rays != (plan.lane_map ? 32 : warps) ||
        plan.stride < stride_min || !(plan.stride & 1) ||
        (long long)plan.blocks * plan.rays < N ||
        plan.smem != 4 * (K * L * BOX_FLOATS + plan.rays * plan.stride) ||
        plan.smem > 48 * 1024 || (plan.group != 1 && plan.group != 4))
        return (int)cudaErrorInvalidValue;
    if (N <= 0) return (int)cudaGetLastError();
#define OCC_PROBE_LAUNCH(GROUP, CHUNKS)                                      \
    occupancy_probe_cdf_kernel<GROUP, CHUNKS><<<plan.blocks, plan.threads,   \
                                                plan.smem, stream>>>(        \
        rays_o, rays_d, near, far, mids, occs, binary, levels, cdf, alive,  \
        occ_out, N, P, K, L, R, importance, c_imp, c_uni, c_keep, c_floor,  \
        plan)
#define OCC_PROBE_CHUNKS(GROUP)                                              \
    switch (plan.chunks) {                                                   \
        case 1: OCC_PROBE_LAUNCH(GROUP, 1); break;                           \
        case 2: OCC_PROBE_LAUNCH(GROUP, 2); break;                           \
        case 4: OCC_PROBE_LAUNCH(GROUP, 4); break;                           \
        case 8: OCC_PROBE_LAUNCH(GROUP, 8); break;                           \
        default: return (int)cudaErrorInvalidValue;                          \
    }
    if (plan.group == 1) {
        OCC_PROBE_CHUNKS(1);
    } else {
        OCC_PROBE_CHUNKS(4);
    }
#undef OCC_PROBE_CHUNKS
#undef OCC_PROBE_LAUNCH
    return (int)cudaGetLastError();
}
