// Kernel 11q: the occupancy point query, unioned over K experts.
//
// Replaces: nerfsys_tpu/ops/occupancy.py `query_binary` (:159),
// `query_values` (:179) and `query_pair` (:196), each of which selects
// the finest level holding a point (`_finest_level_index`, :121) and reads
// one row through the `row_gather` primitive (nerfsys_tpu/ops/gather.py:
// 40-115, row 11 of PERF.md's kernel table), unioned over the experts as
// `union_binary_fn` / `union_value_fn` / `union_pair_fn`
// (nerfsys_tpu/models/occupancy.py:47-118) do. A single expert is a K=1
// slice of the stacked grids.
//
// Per point x (M points), for every expert k: the finest level l of
// expert k whose box holds x decides its cell (occ_common.cuh `locate`,
// the same float-bound test as kernel 2; only the deciding level
// divides), bit_k = binary[k, l, cell], val_k = max(occs[k, l, cell], 0);
// a point inside no level of expert k reads (false, 0) for it. Outputs:
// bits = any_k bit_k (bool), values = max_k val_k (float); the mode is
// the outputs given (bits, values or both: the pair). Built with
// --fmad=false like kernel 2, so rel and its cell round like the plain
// PyTorch version.
//
// Bound on the H100: bytes. A point reads its 12 bytes and writes 1
// and / or 4; its K cell reads are scattered, but the points come in
// flat order, a ray's samples one after another, so a warp's lanes take
// neighbouring samples of one or two rays and hit the same or
// neighbouring 32-byte sectors. Each point's level tests and divisions
// are a few dozen instructions an expert. Design, a first one that is
// right and simple: a thread a point, the K x L level table in shared
// memory (every thread reads the same level at once: a broadcast), one
// read a (point, expert) of each grid the mode needs, writes coalesced.
#include "occ_common.cuh"  // BOX_FLOATS, locate: shared with kernel 2

#define QUERY_THREADS 256  // ops/occupancy.py QUERY_THREADS

template <bool BITS, bool VALUES>
__global__ void __launch_bounds__(QUERY_THREADS) occupancy_query_kernel(
        const float* __restrict__ pts, const float* __restrict__ occs,
        const uint8_t* __restrict__ binary, const float* __restrict__ levels,
        uint8_t* __restrict__ out_bits, float* __restrict__ out_vals,
        long long M, int K, int L, int R) {
    extern __shared__ float4 smem_q[];  // 16-byte aligned: float4 reads
    float* box = reinterpret_cast<float*>(smem_q);
    for (int i = threadIdx.x; i < K * L * BOX_FLOATS; i += blockDim.x)
        box[i] = __ldg(levels + i);
    __syncthreads();
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= M) return;
    const float x = pts[3 * i + 0], y = pts[3 * i + 1], z = pts[3 * i + 2];
    bool bit = false;
    float val = 0.0f;
    for (int k = 0; k < K; ++k) {
        const int flat = locate(smem_q, k, L, R, x, y, z);
        if (flat < 0) continue;
        if (BITS) bit = bit || __ldg(binary + flat) != 0;
        if (VALUES) val = fmaxf(val, fmaxf(__ldg(occs + flat), 0.0f));
    }
    if (BITS) out_bits[i] = bit ? 1 : 0;
    if (VALUES) out_vals[i] = val;
}

// pts: (M, 3) float; occs: (K, L, R, R, R) float, null without values;
// binary: the same shape, bool bytes, null without bits; levels: (K, L,
// 12) float (ops/occupancy.py `level_bounds`). K * L * R^3 < 2^31, K * L
// * 48 bytes of level table at most 48 KB. Out: bits (M,) bool and / or
// values (M,) float; at least one of the two.
NERF_API int occupancy_query(const float* pts, const float* occs,
                             const uint8_t* binary, const float* levels,
                             uint8_t* out_bits, float* out_vals, long long M,
                             int K, int L, int R, cudaStream_t stream) {
    const bool bits = out_bits != nullptr, values = out_vals != nullptr;
    const int smem = 4 * K * L * BOX_FLOATS;
    if (M < 0 || K < 1 || L < 1 || R < 1 ||
        (long long)K * L * R * R * R >= (1LL << 31) || smem > 48 * 1024 ||
        (!bits && !values) || (bits && binary == nullptr) ||
        (values && occs == nullptr))
        return (int)cudaErrorInvalidValue;
    if (M == 0) return (int)cudaGetLastError();
    const long long blocks = (M + QUERY_THREADS - 1) / QUERY_THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
#define OCC_QUERY_LAUNCH(B, V)                                               \
    occupancy_query_kernel<B, V><<<(unsigned)blocks, QUERY_THREADS, smem,    \
                                   stream>>>(pts, occs, binary, levels,      \
                                             out_bits, out_vals, M, K, L, R)
    if (bits && values)
        OCC_QUERY_LAUNCH(true, true);
    else if (bits)
        OCC_QUERY_LAUNCH(true, false);
    else
        OCC_QUERY_LAUNCH(false, true);
#undef OCC_QUERY_LAUNCH
    return (int)cudaGetLastError();
}
