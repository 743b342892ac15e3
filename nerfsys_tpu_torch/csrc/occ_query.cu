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
// expert k whose box holds x decides its cell, bit_k = binary[k, l, cell],
// val_k = max(occs[k, l, cell], 0); a point inside no level of expert k
// reads (false, 0) for it. Outputs: bits = any_k bit_k (bool), values =
// max_k val_k (float); the mode is the outputs given (bits, values or
// both: the pair).
//
// Bound on the H100: bytes. A point reads its 12 bytes and writes 1
// and / or 4; its K cell reads are scattered, but the points come in
// flat order, a ray's samples one after another, so a warp's lanes hit
// the same or neighbouring 32-byte sectors. What held the first design
// (a thread a point, kernel 2's `locate`) at 8x that bound was the cell
// selection, not the reads: `locate` returns at the first level holding
// the point, so a warp whose points lie in 2-3 levels ran its level tests
// and three IEEE divisions once per level present, for each expert
// (`kernel_ab.py`'s variants of it, PERF.md row 11q).
//
// Design: no division and no early return. For each expert every lane
// tests all L levels on the float bounds a <= x < b of `level_bounds`
// (kernel 2's table: rel = (x - lo) / w is monotone in x, so 0 <= rel < 1
// holds exactly there) and keeps the finest level holding its point by a
// select, so the lanes of a warp stay together whatever their levels. On
// each axis the lane then guesses the cell from q = (x - lo) * s, s = R /
// w rounded. q lies within R 2^-21 of the plain version's rel * R (two
// roundings on each side), so where q's fraction is at least R 2^-20 from
// an integer, trunc(q) is the plain cell. Elsewhere, a few ulps from a
// cell's step or with q not finite, the level's step row decides: t_j,
// the least float whose plain cell trunc(fl(fl(x - lo) / w) * R) is at
// least j, so the cell is the c with t_c <= x < t_{c+1}
// (ops/occupancy.py `cell_steps` finds the t_j by bisection, on the
// device, cached with the level table). The clamped guess is checked
// against t_g, t_{g+1}, and where they do not bracket x a bisection over
// the row's R + 1 entries finds the cell however far off the guess was.
// The cells are the plain version's bit for bit; the build keeps
// --fmad=false like kernel 2.
//
// The level table holds 16 floats a level (a, b.x | b.y, b.z, w.x, w.y |
// lo, s.x | s.y, s.z, w.z, 0; ops/occupancy.py `query_table`, which
// computes s), read in the same place by every lane: a broadcast. The step
// rows (12 (R + 1) bytes a level) are read on the rare cells near a step.
// Each block copies the level table to shared memory. Calls of at most one
// wave of 256-thread blocks take a thread a point and copy the rows too
// where both fit in 48 KB: there a warp whose lane meets a step would
// otherwise wait on device memory, and the one wave ends with its slowest
// warp. Larger calls read the rows through L1 and take QUERY_PTS points a
// thread, so a level's bounds are read once for four points. In bits
// mode a point's later experts are skipped once its bit is set.
#include "common.cuh"

#define QUERY_THREADS 256            // a block
#define QUERY_PTS 4                  // points a thread on the resident grid
#define QUERY_MAX_LEVELS 8           // ops/occupancy.py QUERY_MAX_LEVELS
#define QUERY_SMEM_MAX (227 * 1024)  // ops/occupancy.py QUERY_SMEM

static LaunchCache query_cache[6];  // (bits, values, pair) x (1, QUERY_PTS)

// The guessed cell of x on one axis of a level whose box holds x:
// trunc(q) for q = (x - lo) * s, from the bits of q + 2^23 rounded toward
// zero (0 <= q < 2^23 inside a level: no conversion instruction). `near`
// unless q's fraction f has margin <= f <= top = 1 - margin (near a step,
// or q not finite).
__device__ __forceinline__ int guess_cell(float x, float lo, float s,
                                          float margin, float top,
                                          bool& near) {
    const float q = (x - lo) * s;
    const float big = __fadd_rz(q, 0x1p23f);  // 2^23 + trunc(q)
    const float f = q - (big - 0x1p23f);      // q's fraction, exact
    near = !(f >= margin && f <= top);
    return __float_as_int(big) - 0x4b000000;
}

// The step row's verdict on x from guess c: row: t_0 = -inf, t_1 ..
// t_{R-1} the step points, t_R = +inf; the cell is the c with t_c <= x <
// t_{c+1}. `row` lies in shared or in device memory.
__device__ __forceinline__ int step_row(const float* row, float x, int c,
                                        int R) {
    c = min(max(c, 0), R - 1);
    if (x < row[c] || x >= row[c + 1]) {
        c = 0;  // the guess missed: bisect
        for (int n = R; n > 1;) {
            const int h = n >> 1;
            c = row[c + h] <= x ? c + h : c;
            n -= h;
        }
    }
    return c;
}

// Tile `base`'s points of this thread; NaN past M (inside no level).
template <int PTS>
__device__ __forceinline__ void load_points(const float* __restrict__ pts,
                                            long long base, long long M,
                                            float (&x)[PTS], float (&y)[PTS],
                                            float (&z)[PTS]) {
#pragma unroll
    for (int p = 0; p < PTS; ++p) {
        const long long i = base + p * QUERY_THREADS + threadIdx.x;
        x[p] = i < M ? pts[3 * i + 0] : __int_as_float(0x7fffffff);
        y[p] = i < M ? pts[3 * i + 1] : 0.0f;
        z[p] = i < M ? pts[3 * i + 2] : 0.0f;
    }
}

template <bool BITS, bool VALUES, int PTS>
__global__ void __launch_bounds__(QUERY_THREADS) occupancy_query_kernel(
        const float* __restrict__ pts, const float* __restrict__ occs,
        const uint8_t* __restrict__ binary, const float* __restrict__ table,
        uint8_t* __restrict__ out_bits, float* __restrict__ out_vals,
        long long M, int K, int L, int R, int rows_shared) {
    extern __shared__ float4 smem_q[];  // 4 float4 a level, [the rows]
    const long long tile = (long long)QUERY_THREADS * PTS;
    long long base = blockIdx.x * tile;
    float x[PTS], y[PTS], z[PTS];
    load_points<PTS>(pts, base, M, x, y, z);  // in flight during the copy
    const int levels = K * L;
    const int n4 =
        4 * levels + (rows_shared ? (3 * levels * (R + 1) + 3) / 4 : 0);
    for (int j = threadIdx.x; j < n4; j += blockDim.x)
        smem_q[j] = __ldg(reinterpret_cast<const float4*>(table) + j);
    __syncthreads();
    const float* steps =  // (K, L, 3, R + 1)
        (rows_shared ? reinterpret_cast<const float*>(smem_q) : table) +
        16 * levels;
    const int row = R + 1;
    const float margin = (float)R * 0x1p-20f, top = 1.0f - margin;
    for (; base < M; base += (long long)gridDim.x * tile) {
        bool bit[PTS];
        float val[PTS];
#pragma unroll
        for (int p = 0; p < PTS; ++p) {
            bit[p] = false;
            val[p] = 0.0f;
        }
        for (int k = 0; k < K; ++k) {
            int sel[PTS];  // the finest level holding each point
#pragma unroll
            for (int p = 0; p < PTS; ++p) sel[p] = -1;
#pragma unroll
            for (int l = QUERY_MAX_LEVELS - 1; l >= 0; --l) {
                if (l >= L) continue;  // the same for every lane
                const float4 q0 = smem_q[4 * (k * L + l)];
                const float2 q1 = *reinterpret_cast<const float2*>(
                    smem_q + 4 * (k * L + l) + 1);  // b.y, b.z
#pragma unroll
                for (int p = 0; p < PTS; ++p) {
                    const bool in = (x[p] >= q0.x) & (x[p] < q0.w) &
                                    (y[p] >= q0.y) & (y[p] < q1.x) &
                                    (z[p] >= q0.z) & (z[p] < q1.y);
                    sel[p] = in ? l : sel[p];
                }
            }
#pragma unroll
            for (int p = 0; p < PTS; ++p) {
                // bits alone: a set bit decides the union
                if (sel[p] < 0 || (!VALUES && bit[p])) continue;
                const int kl = k * L + sel[p];
                const float4 c0 = smem_q[4 * kl + 2];  // lo, s.x
                const float2 c1 =  // s.y, s.z
                    *reinterpret_cast<const float2*>(smem_q + 4 * kl + 3);
                bool n0, n1, n2;  // the three guesses first, then rows
                int i0 = guess_cell(x[p], c0.x, c0.w, margin, top, n0);
                int i1 = guess_cell(y[p], c0.y, c1.x, margin, top, n1);
                int i2 = guess_cell(z[p], c0.z, c1.y, margin, top, n2);
                const float* r = steps + kl * 3 * row;
                if (n0) i0 = step_row(r, x[p], i0, R);
                if (n1) i1 = step_row(r + row, y[p], i1, R);
                if (n2) i2 = step_row(r + 2 * row, z[p], i2, R);
                const int flat = ((kl * R + i0) * R + i1) * R + i2;
                if (BITS) bit[p] = bit[p] || __ldg(binary + flat) != 0;
                if (VALUES)
                    val[p] = fmaxf(val[p], fmaxf(__ldg(occs + flat), 0.0f));
            }
        }
#pragma unroll
        for (int p = 0; p < PTS; ++p) {
            const long long i = base + p * QUERY_THREADS + threadIdx.x;
            if (i < M) {
                if (BITS) out_bits[i] = bit[p] ? 1 : 0;
                if (VALUES) out_vals[i] = val[p];
            }
        }
        load_points<PTS>(pts, base + (long long)gridDim.x * tile, M, x, y,
                         z);
    }
}

template <bool B, bool V>
static int query_launch(LaunchCache* cache, const float* pts,
                        const float* occs, const uint8_t* binary,
                        const float* table, uint8_t* out_bits,
                        float* out_vals, long long M, int K, int L, int R,
                        int smem, cudaStream_t stream) {
    auto one = occupancy_query_kernel<B, V, 1>;
    auto many = occupancy_query_kernel<B, V, QUERY_PTS>;
    // one wave stages the step rows too where they fit without an opt-in
    const long long rows = 16 * ((3LL * K * L * (R + 1) + 3) / 4);
    const int rows_shared = smem + rows <= 48 * 1024;
    const int smem_one = (int)(smem + (rows_shared ? rows : 0));
    int resident = 0;
    cudaError_t e =
        cached_resident(cache[0], one, QUERY_THREADS, smem_one, &resident);
    if (e != cudaSuccess) return (int)e;
    if (resident < 1) return (int)cudaErrorInvalidConfiguration;
    const long long blocks = (M + QUERY_THREADS - 1) / QUERY_THREADS;
    if (blocks <= resident) {  // one wave: a thread a point
        one<<<(unsigned)blocks, QUERY_THREADS, smem_one, stream>>>(
            pts, occs, binary, table, out_bits, out_vals, M, K, L, R,
            rows_shared);
        return (int)cudaGetLastError();
    }
    if (smem > 48 * 1024 &&
        (e = cached_resident(cache[1], many, QUERY_THREADS, smem,
                             &resident)) != cudaSuccess)
        return (int)e;  // the opt-in above 48 KB
    const long long tiles = (M + QUERY_THREADS * QUERY_PTS - 1) /
                            (QUERY_THREADS * QUERY_PTS);
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    many<<<(unsigned)tiles, QUERY_THREADS, smem, stream>>>(
        pts, occs, binary, table, out_bits, out_vals, M, K, L, R, 0);
    return (int)cudaGetLastError();
}

// pts: (M, 3) float; occs: (K, L, R, R, R) float, null without values;
// binary: the same shape, bool bytes, null without bits; table: the (K,
// L, 16) level table followed by the (K, L, 3, R + 1) rows of
// `cell_steps` (ops/occupancy.py `query_table`). K * L * R^3 <
// 2^31, L <= QUERY_MAX_LEVELS, 64 K L bytes of shared table at most
// QUERY_SMEM_MAX. Out: bits (M,) bool and / or values (M,) float; at
// least one of the two.
NERF_API int occupancy_query(const float* pts, const float* occs,
                             const uint8_t* binary, const float* table,
                             uint8_t* out_bits, float* out_vals, long long M,
                             int K, int L, int R, cudaStream_t stream) {
    const bool bits = out_bits != nullptr, values = out_vals != nullptr;
    const long long smem = 64LL * K * L;
    if (M < 0 || K < 1 || L < 1 || L > QUERY_MAX_LEVELS || R < 1 ||
        (long long)K * L * R * R * R >= (1LL << 31) ||
        smem > QUERY_SMEM_MAX || (!bits && !values) ||
        (bits && binary == nullptr) || (values && occs == nullptr))
        return (int)cudaErrorInvalidValue;
    if (M == 0) return (int)cudaGetLastError();
    if (bits && values)
        return query_launch<true, true>(query_cache + 4, pts, occs, binary,
                                        table, out_bits, out_vals, M, K, L,
                                        R, (int)smem, stream);
    if (bits)
        return query_launch<true, false>(query_cache, pts, occs, binary,
                                         table, out_bits, out_vals, M, K, L,
                                         R, (int)smem, stream);
    return query_launch<false, true>(query_cache + 2, pts, occs, binary,
                                     table, out_bits, out_vals, M, K, L, R,
                                     (int)smem, stream);
}
