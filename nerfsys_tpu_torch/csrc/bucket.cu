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
// 10a-i `bucket_dispatch`: a memset of the scratch's ticket and tile
// status, then two launches on the caller's stream (plan: `DispatchPlan`,
// models/container.py `dispatch_plan`).
//   1. `bucket_dispatch_kernel`, a single pass (a scan with decoupled
//      look-back, the pattern of CUB's single-pass prefix scan). A block
//      draws a ticket t from a counter and takes tile t (plan.tile points:
//      2,048 for E <= 2, else 256), so every tile it waits on belongs to a
//      block that started before it. Each of its 8 warps takes an eighth
//      of the tile, 32 points a round, with no block barrier between
//      rounds (the next round's point is loaded during this one). A lane
//      routes its point: routing distances to the K centroids,
//      sum x^2 - 2 x.c + sum c^2, clamped at 0, sqrt, each sum left to
//      right (built with --fmad=false, so they round as the plain version's
//      elementwise torch ops do); the E nearest by an insertion over
//      ascending k with a strict less-than, so equal distances keep the
//      lower expert first (lax.top_k's order); the weights; idx and w are
//      written at once. Each round the warp ORs its lanes into one bitmask
//      per expert (a point's E experts are distinct, so the order inside a
//      point never matters): a kept pair's rank in the tile is the
//      popcount of the lower lanes, plus the warp's running count of the
//      expert and the earlier warps' totals; it is kept in shared memory
//      with its expert. Warp 0 then publishes the tile's
//      per-expert aggregates and looks back over the earlier tiles for its
//      exclusive offsets (below), while the other warps stage the kept
//      pairs by (expert, rank). Ranks depend only on tile and pair order,
//      never on which block finished first: this is the reference's stable
//      counting sort, bit for bit, and the same pairs overflow to the trash
//      slot K*C. The block then streams out dest for its pairs and each
//      expert's run of bucket rows and pts|dirs rows, contiguous slots
//      written as contiguous streams. The last tile writes counts.
//   2. `bucket_fill_kernel`: the empty slots [counts[k], C) of each bucket
//      hold point 0 (the reference scatters into zeros): a grid-stride loop
//      of 16-byte stores over each bucket's empty tail only.
// Tile status: one 32-bit word a (tile, expert), its flag in the top two
// bits (0 nothing yet, 1 the tile's aggregate, 2 the inclusive count over
// tiles 0..t) and the count below. A word is stored whole, so a reader
// that sees a flag sees its count: no other data passes through a flag,
// and relaxed device-scope loads and stores suffice. The look-back reads
// a window of 32 earlier tiles a step, one word a lane for each of up to 8
// experts at once (one round trip), and sums each expert back to its
// nearest inclusive word; an expert whose window still holds an empty
// word before that is read again, the others move on. The memset clears
// the ticket and the status on every call, so a second call on the same
// scratch starts clean.
// 10a-ii `bucket_combine_fwd`: one thread per point, sigma = sum over e in
// e order of wk * sigma_b[dest] (wk = w on kept pairs, 0 on the trash slot,
// which reads 0); the same for rgb.
// 10a-iii `bucket_combine_bwd`: the transpose, g_sigma_b[dest] = w *
// g_sigma[n] on the kept slots (each the destination of exactly one pair,
// one product a slot) and 0 on the rest, with every output byte written
// once (plan: `CombinePlan`, models/container.py `combine_bwd_plan`). One
// grid: its first fill_blocks * K blocks zero each bucket's empty tail
// [min(counts[k], C), C) with 16-byte stores (the pattern of
// `bucket_fill_kernel`); each later block takes a tile of points (1,024
// at E <= 2, 4 a thread, w and dest read as 8-byte vectors at E = 2; 256
// above), reads g once a point, and stages the products in shared memory
// by (expert, slot): within a tile the kept pairs of an expert hold
// consecutive slots (the dispatch's stable counting sort), so shared
// atomics find each expert's run (its first slot and length) and a warp
// an expert writes each run out as one contiguous stream of 16-byte
// stores, where one thread a pair would store the 12-byte rgb rows as
// three scalars each. dest must be as bucket_dispatch wrote it.
//
// Bound on the H100: bytes. 10a-i reads N*12 B of points (and N*12 of
// directions) and writes N*E*12 B (idx, w, dest) + K*C*(4 + 24) B; 10a-ii
// reads N*E*(4 + 4 + 16) B and writes N*16 B; 10a-iii reads N*E*8 B (w,
// dest) and N*16 B (g) and writes K*C*16 B, which a zero fill before a
// scatter of the kept slots would write twice. A four-pass dispatch
// (route, a scan, place, fill) would read the points twice, write idx and
// w to read them back, ballot once per expert in every warp and write
// each row on its own; this one reads them once and streams the runs.
#include <math.h>

#include "common.cuh"

#define MAX_EXPERTS 64  // models/container.py MAX_EXPERTS
#define MAX_E 8         // experts per point the dispatch takes
#define DISPATCH_THREADS 256
// points a thread of a tile when E <= 2: 8 rounds, tiles of 2,048 points
// (models/container.py `dispatch_tile`); one above (tiles of 256), where
// the pair table of E = 8 fills the shared memory
#define DISPATCH_PPT_E12 8
#define STATUS_AGGREGATE (1u << 30)
#define STATUS_INCLUSIVE (2u << 30)
#define STATUS_COUNT 0x3fffffffu
#define PAIR_NONE 0xffffffffu  // a pair with weight 0
#define TOP_DONE (-0x7fffffff)

struct DispatchPlan {
    int tile;          // points a tile: 2,048 for E <= 2, else 256
    int tiles;         // ceil(N / tile)
    int fill_blocks;   // blocks a bucket of the fill launch
    int fill_threads;
};

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

// (nd is 2 or 3; fixed indices keep the arrays in registers)
__device__ __forceinline__ float sum_sq(const float* v, int nd) {
    float s = v[0] * v[0];
    s = s + v[1] * v[1];
    if (nd == 3) s = s + v[2] * v[2];
    return s;
}

// the centroids' routing coordinates and squared norms, in shared memory
__device__ __forceinline__ void load_centroids(const float* __restrict__ cent,
                                               int K, RouteDims rd,
                                               float* s_c, float* s_sc) {
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
        float c[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            c[j] = j < rd.nd ? cent[k * 3 + rd.first + j] : 0.0f;
            s_c[k * 3 + j] = c[j];
        }
        s_sc[k] = sum_sq(c, rd.nd);
    }
}

__device__ __forceinline__ float route_dist(const float* x, float sx,
                                           const float* c, float sc,
                                           int nd) {
    float dot = (2.0f * x[0]) * c[0];
    dot = dot + (2.0f * x[1]) * c[1];
    if (nd == 3) dot = dot + (2.0f * x[2]) * c[2];
    const float d2 = (sx - dot) + sc;
    return sqrtf(fmaxf(d2, 0.0f));
}

// The E nearest experts of point x (nearest first, a tie keeps the lower
// expert) and their weights: margin weights renormalised over E when soft,
// else [1, 0, ...]. MAXE bounds E at compile time so the arrays stay in
// registers.
template <int MAXE>
__device__ __forceinline__ void route_point(const float* x, const float* s_c,
                                            const float* s_sc, int K, int E,
                                            int nd, float margin, int soft,
                                            int (&bk)[MAXE],
                                            float (&wv)[MAXE]) {
    const float sx = sum_sq(x, nd);
    float bd[MAXE];
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
        bd[e] = INFINITY;
        bk[e] = 0;
    }
    for (int k = 0; k < K; ++k) {
        float cd = route_dist(x, sx, s_c + k * 3, s_sc[k], nd);
        int ck = k;
        bool shift = false;  // strict: a tie keeps the lower expert
#pragma unroll
        for (int e = 0; e < MAXE; ++e) {
            if (e < E && (shift || cd < bd[e])) {
                shift = true;
                const float td = bd[e];
                const int tk = bk[e];
                bd[e] = cd;
                bk[e] = ck;
                cd = td;
                ck = tk;
            }
        }
    }
    if (soft) {
        const float lim = margin * fmaxf(bd[0], 1e-6f);
        float tot = 0.0f;
#pragma unroll
        for (int e = 0; e < MAXE; ++e) {
            if (e < E) {
                const float ds = fmaxf(bd[e], 1e-6f);
                wv[e] = (1.0f / ds) * (ds <= lim ? 1.0f : 0.0f);
                tot = e == 0 ? wv[0] : tot + wv[e];
            }
        }
        const float den = fmaxf(tot, 1e-6f);
#pragma unroll
        for (int e = 0; e < MAXE; ++e)
            if (e < E) wv[e] = wv[e] / den;
    } else {
#pragma unroll
        for (int e = 0; e < MAXE; ++e) wv[e] = e == 0 ? 1.0f : 0.0f;
    }
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
    return v;
}

// Warp 0 of tile t > 0: the exclusive count of each expert's kept pairs
// over tiles 0..t-1, into s_goff. s_top[k] is the newest tile expert k has
// not summed yet (TOP_DONE once it met an inclusive word). Each sweep reads,
// for up to 8 experts at once, the words of tiles top - 31..top (lane l
// tile top - l; tile -1 reads as inclusive 0) and, for each expert whose
// words up to its first inclusive one are all published, adds them and
// moves its window on.
__device__ __forceinline__ void look_back(const unsigned* status, int t,
                                          int K, int lane, int* s_top,
                                          int* s_goff) {
    for (int k = lane; k < K; k += 32) {
        s_top[k] = t - 1;
        s_goff[k] = 0;
    }
    __syncwarp();
    int left = K;
    unsigned polls = 0;
    while (left > 0) {
        bool moved = false;
        for (int k0 = 0; k0 < K; k0 += 8) {
            int top[8];
            unsigned wd[8];
#pragma unroll
            for (int g = 0; g < 8; ++g) {
                const int k = k0 + g;
                top[g] = k < K ? s_top[k] : TOP_DONE;
                const int j = top[g] - lane;
                wd[g] = top[g] == TOP_DONE || j < 0
                            ? STATUS_INCLUSIVE
                            : load_relaxed(status + (long long)j * K + k);
            }
#pragma unroll
            for (int g = 0; g < 8; ++g) {
                if (top[g] == TOP_DONE) continue;  // uniform
                const unsigned flag = wd[g] & ~STATUS_COUNT;
                const unsigned pm =
                    __ballot_sync(FULL_MASK, flag == STATUS_INCLUSIVE);
                const unsigned xm = __ballot_sync(FULL_MASK, flag == 0u);
                const int lim = pm ? __ffs(pm) - 1 : 31;
                const unsigned need =
                    lim == 31 ? FULL_MASK : (2u << lim) - 1u;
                if (xm & need) continue;  // read this window again
                const int s = warp_sum(
                    lane <= lim ? (int)(wd[g] & STATUS_COUNT) : 0);
                if (lane == 0) {
                    s_goff[k0 + g] += s;
                    s_top[k0 + g] = pm ? TOP_DONE : top[g] - 32;
                }
                moved = true;
                if (pm) --left;
            }
            __syncwarp();
        }
        if (!moved) {
            // every earlier tile's block has started (tickets), so a wait
            // this long means a fault: trap rather than hang the card
            if (++polls > (1u << 24)) __trap();
            __nanosleep(32);
        }
    }
    __syncwarp();
}

template <int PPT, int MAXE, bool DIRS>
__global__ void __launch_bounds__(DISPATCH_THREADS, 4) bucket_dispatch_kernel(
        const float* __restrict__ pts, const float* __restrict__ dirs,
        const float* __restrict__ cent, int* __restrict__ idx,
        float* __restrict__ w, int* __restrict__ dest,
        int* __restrict__ counts, int* __restrict__ bucket_rows,
        float* __restrict__ rows, unsigned* ticket, unsigned* status, int N,
        int K, int E, int C, RouteDims rd, float margin, int soft,
        int tiles) {
    constexpr int THREADS = DISPATCH_THREADS;
    constexpr int TILE = THREADS * PPT;
    constexpr int WARPS = THREADS / 32;
    constexpr int W = DIRS ? 6 : 3;
    constexpr int GATHER = 2 * THREADS;  // rows gathered a chunk
    __shared__ float s_c[MAX_EXPERTS * 3];
    __shared__ float s_sc[MAX_EXPERTS];
    __shared__ unsigned s_mask[WARPS][MAX_EXPERTS];  // a round's lanes
    __shared__ int s_wrun[WARPS][MAX_EXPERTS];  // a warp's kept pairs
    __shared__ int s_wofs[WARPS][MAX_EXPERTS];  // the warps' offsets
    __shared__ int s_run[MAX_EXPERTS];  // the tile's kept pairs an expert
    __shared__ int s_lbase[MAX_EXPERTS + 1];
    __shared__ int s_goff[MAX_EXPERTS];
    __shared__ int s_top[MAX_EXPERTS];
    __shared__ unsigned s_pair[TILE * MAXE];  // (k << 24) | rank, or NONE
    __shared__ unsigned short s_src[TILE * MAXE];  // pair at each position
    __shared__ float s_rows[GATHER * W];  // a chunk of gathered rows
    __shared__ int s_tile;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    if (tid == 0) s_tile = (int)atomicAdd(ticket, 1u);
    load_centroids(cent, K, rd, s_c, s_sc);
    for (int i = tid; i < WARPS * MAX_EXPERTS; i += THREADS) {
        (&s_mask[0][0])[i] = 0u;
        (&s_wrun[0][0])[i] = 0;
    }
    __syncthreads();
    const int t = s_tile;
    const long long n0 = (long long)t * TILE;
    const int cnt = (int)min((long long)TILE, (long long)N - n0);
    // warp v takes the tile's points [v, v + 1) x 32 * PPT in PPT rounds of
    // 32, its kept pairs ranked among the warp's by one bitmask an expert a
    // round and its running count an expert (s_wrun); the warps' offsets
    // follow once all have finished
    const unsigned bit = 1u << lane;
    const int i0 = warp * 32 * PPT + lane;  // this lane's first point
    float xn[3] = {0.0f, 0.0f, 0.0f};  // the next round's coordinates
    if (i0 < cnt) {
#pragma unroll
        for (int j = 0; j < 3; ++j)
            if (j < rd.nd) xn[j] = pts[(n0 + i0) * 3 + rd.first + j];
    }
    for (int r = 0; r < PPT; ++r) {
        const int i = i0 + 32 * r;  // the tile's point
        const bool valid = i < cnt;
        float x[3] = {xn[0], xn[1], xn[2]};
        if (r + 1 < PPT && i + 32 < cnt) {
#pragma unroll
            for (int j = 0; j < 3; ++j)
                if (j < rd.nd) xn[j] = pts[(n0 + i + 32) * 3 + rd.first + j];
        }
        int bk[MAXE];
        float wv[MAXE];
        if (valid) {
            const long long n = n0 + i;
            route_point<MAXE>(x, s_c, s_sc, K, E, rd.nd, margin, soft, bk,
                              wv);
#pragma unroll
            for (int e = 0; e < MAXE; ++e) {
                if (e < E) {
                    idx[n * E + e] = bk[e];
                    w[n * E + e] = wv[e];
                    if (wv[e] > 0.0f) atomicOr(&s_mask[warp][bk[e]], bit);
                }
            }
        }
        __syncwarp();
        if (valid) {
#pragma unroll
            for (int e = 0; e < MAXE; ++e) {
                if (e < E) {
                    const int k = bk[e];
                    s_pair[i * E + e] =
                        wv[e] > 0.0f
                            ? ((unsigned)k << 24) |
                                  (unsigned)(s_wrun[warp][k] +
                                             __popc(s_mask[warp][k] &
                                                    (bit - 1u)))
                            : PAIR_NONE;
                }
            }
        }
        __syncwarp();
        for (int k = lane; k < K; k += 32) {
            s_wrun[warp][k] += __popc(s_mask[warp][k]);
            s_mask[warp][k] = 0u;
        }
        __syncwarp();
    }
    __syncthreads();
    if (warp == 0) {  // each expert's warp offsets and tile aggregate
        for (int k = lane; k < K; k += 32) {
            int run = 0;
            for (int v = 0; v < WARPS; ++v) {
                s_wofs[v][k] = run;
                run += s_wrun[v][k];
            }
            s_run[k] = run;
        }
        __syncwarp();
    }

    if (warp == 0) {
        // publish the aggregates (tile 0: its inclusive counts) and scan
        // them into the tile-local base of each expert's run
        const unsigned flag = t == 0 ? STATUS_INCLUSIVE : STATUS_AGGREGATE;
        for (int k = lane; k < K; k += 32)
            store_relaxed(status + (long long)t * K + k,
                          flag | (unsigned)s_run[k]);
        int carry = 0;
        for (int k0 = 0; k0 < K; k0 += 32) {
            const int k = k0 + lane;
            const int a = k < K ? s_run[k] : 0;
            int v = a;
            for (int o = 1; o < 32; o <<= 1) {
                const int y = __shfl_up_sync(FULL_MASK, v, o);
                if (lane >= o) v += y;
            }
            if (k < K) s_lbase[k] = carry + v - a;
            carry += __shfl_sync(FULL_MASK, v, 31);
        }
        if (lane == 0) s_lbase[K] = carry;
    }
    __syncthreads();

    if (warp == 0) {
        if (t == 0) {
            for (int k = lane; k < K; k += 32) s_goff[k] = 0;
        } else {
            look_back(status, t, K, lane, s_top, s_goff);
            for (int k = lane; k < K; k += 32)
                store_relaxed(status + (long long)t * K + k,
                              STATUS_INCLUSIVE |
                                  (unsigned)(s_goff[k] + s_run[k]));
        }
        __syncwarp();
        if (t == tiles - 1)
            for (int k = lane; k < K; k += 32)
                counts[k] = s_goff[k] + s_run[k];
    }
    // the kept pairs' ranks in the tile (plus their warp's offset), staged
    // by (expert, rank)
    const int pairs = cnt * E;
    for (int s = tid; s < pairs; s += THREADS) {
        const unsigned v = s_pair[s];
        if (v != PAIR_NONE) {
            const int k = (int)(v >> 24);
            const int rank = (int)(v & 0xffffffu) +
                             s_wofs[(s / E) / (32 * PPT)][k];
            s_pair[s] = ((unsigned)k << 24) | (unsigned)rank;
            s_src[s_lbase[k] + rank] = (unsigned short)s;
        }
    }
    __syncthreads();

    const int trash = K * C;
    for (int s = tid; s < pairs; s += THREADS) {
        const unsigned v = s_pair[s];
        int d = trash;
        if (v != PAIR_NONE) {
            const int k = (int)(v >> 24);
            const int slot = s_goff[k] + (int)(v & 0xffffffu);
            if (slot < C) d = k * C + slot;
        }
        dest[n0 * E + s] = d;
    }
    // each expert's run of slots, as contiguous streams, GATHER staged
    // positions at a time: a thread gathers two rows (their loads in
    // flight together) into shared memory, then the chunk's bucket rows
    // and floats go out in slot order
    const int total = s_lbase[K];
    for (int p0 = 0; p0 < total; p0 += GATHER) {
#pragma unroll
        for (int h = 0; h < GATHER / THREADS; ++h) {
            const int pl = h * THREADS + tid;
            const int p = p0 + pl;
            if (p < total) {
                const int s = s_src[p];
                const long long n = n0 + (MAXE <= 2 ? s / MAXE : s / E);
                const int k = (int)(s_pair[s] >> 24);
                const int slot = s_goff[k] + (p - s_lbase[k]);
                if (slot < C) bucket_rows[k * C + slot] = (int)n;
#pragma unroll
                for (int j = 0; j < W; ++j)
                    s_rows[pl * W + j] =
                        j < 3 ? pts[n * 3 + j] : dirs[n * 3 + j - 3];
            }
        }
        __syncthreads();
        const int m = min(GATHER, total - p0);
        for (int f = tid; f < m * W; f += THREADS) {
            const int q = p0 + f / W;
            const int k = (int)(s_pair[s_src[q]] >> 24);
            const int slot = s_goff[k] + (q - s_lbase[k]);
            if (slot < C)
                rows[((long long)k * C + slot) * W + (f % W)] = s_rows[f];
        }
        __syncthreads();
    }
}

// slots [counts[k], C) of bucket k = blockIdx.y hold point 0: bucket rows
// 0 and the row pts[0] | dirs[0], in 16-byte stores (C is a multiple of
// 128, so each bucket's int and float ranges start and end 16-byte aligned)
template <bool DIRS>
__global__ void bucket_fill_kernel(const float* __restrict__ pts,
                                   const float* __restrict__ dirs,
                                   const int* __restrict__ counts,
                                   int* __restrict__ bucket_rows,
                                   float* __restrict__ rows, int C) {
    constexpr int W = DIRS ? 6 : 3;
    __shared__ float s_row[W];
    const int k = blockIdx.y;
    const int s0 = min(counts[k], C);
    if (s0 >= C) return;  // uniform over the block
    if (threadIdx.x < W)
        s_row[threadIdx.x] =
            threadIdx.x < 3 ? pts[threadIdx.x] : dirs[threadIdx.x - 3];
    __syncthreads();
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    const int step = gridDim.x * blockDim.x;
    int* br = bucket_rows + (long long)k * C;
    const int a0 = (s0 + 3) & ~3;
    for (int s = s0 + g; s < a0; s += step) br[s] = 0;
    for (int q = a0 / 4 + g; q < C / 4; q += step)
        reinterpret_cast<int4*>(br)[q] = make_int4(0, 0, 0, 0);
    float* rk = rows + (long long)k * C * W;
    const int f0 = s0 * W;
    const int fa = (f0 + 3) & ~3;
    for (int f = f0 + g; f < fa; f += step) rk[f] = s_row[f % W];
    for (int q = fa / 4 + g; q < C * W / 4; q += step) {
        const int f = 4 * q;
        reinterpret_cast<float4*>(rk)[q] =
            make_float4(s_row[f % W], s_row[(f + 1) % W], s_row[(f + 2) % W],
                        s_row[(f + 3) % W]);
    }
}

template <int PPT, int MAXE, bool DIRS>
static void launch_dispatch(const float* pts, const float* dirs,
                            const float* cent, int* idx, float* w, int* dest,
                            int* counts, int* bucket_rows, float* rows,
                            unsigned* ticket, unsigned* status, int N, int K,
                            int E, int C, RouteDims rd, float margin,
                            DispatchPlan plan, cudaStream_t stream) {
    bucket_dispatch_kernel<PPT, MAXE, DIRS>
        <<<plan.tiles, DISPATCH_THREADS, 0, stream>>>(
            pts, dirs, cent, idx, w, dest, counts, bucket_rows, rows, ticket,
            status, N, K, E, C, rd, margin, margin > 1.0f ? 1 : 0,
            plan.tiles);
    bucket_fill_kernel<DIRS>
        <<<dim3(plan.fill_blocks, K), plan.fill_threads, 0, stream>>>(
            pts, dirs, counts, bucket_rows, rows, C);
}

// pts, dirs (N, 3) (dirs nullable), centroids (K, 3) -> idx, w (N, E),
// dest (N*E,), counts (K,), bucket_rows (K, C), rows (K, C, 6 | 3).
// scratch: (1 + tiles * K,) int32: the ticket, then a status word a (tile,
// expert); all of it is cleared here.
NERF_API int bucket_dispatch(const float* pts, const float* dirs,
                             const float* centroids, int* idx, float* w,
                             int* dest, int* counts, int* bucket_rows,
                             float* rows, int* scratch, int N, int K, int E,
                             int C, int cluster_2d, float margin,
                             DispatchPlan plan, cudaStream_t stream) {
    const int ppt = E <= 2 ? DISPATCH_PPT_E12 : 1;
    if (N < 1 || K < 1 || K > MAX_EXPERTS || E < 1 || E > MAX_E || E > K ||
        C < 1 || C % 128 != 0 || plan.tile != ppt * DISPATCH_THREADS ||
        plan.tiles != (int)nerf_blocks(N, plan.tile) ||
        (long long)N * E > (long long)STATUS_COUNT || plan.fill_blocks < 1 ||
        plan.fill_threads < 32)
        return (int)cudaErrorInvalidValue;
    const RouteDims rd = route_dims(cluster_2d);
    unsigned* ticket = reinterpret_cast<unsigned*>(scratch);
    unsigned* status = ticket + 1;
    cudaError_t err = cudaMemsetAsync(
        scratch, 0, (size_t)(1 + (long long)plan.tiles * K) * sizeof(int),
        stream);
    if (err != cudaSuccess) return (int)err;
#define NERF_DISPATCH(T, M, D)                                               \
    launch_dispatch<T, M, D>(pts, dirs, centroids, idx, w, dest, counts,     \
                             bucket_rows, rows, ticket, status, N, K, E, C,  \
                             rd, margin, plan, stream)
    if (E == 1) {
        if (dirs) NERF_DISPATCH(DISPATCH_PPT_E12, 1, true);
        else NERF_DISPATCH(DISPATCH_PPT_E12, 1, false);
    } else if (E == 2) {
        if (dirs) NERF_DISPATCH(DISPATCH_PPT_E12, 2, true);
        else NERF_DISPATCH(DISPATCH_PPT_E12, 2, false);
    } else {
        if (dirs) NERF_DISPATCH(1, MAX_E, true);
        else NERF_DISPATCH(1, MAX_E, false);
    }
#undef NERF_DISPATCH
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

// Kernel 10a-iii: a grid of plan.fill_blocks * K fill blocks, then
// plan.tiles pair tiles (CombinePlan, models/container.py
// `combine_bwd_plan`).
struct CombinePlan {
    int tile;         // points a pair tile: 1,024 for E <= 2, else 256
    int tiles;        // ceil(N / tile)
    int fill_blocks;  // blocks a bucket of the tail fill
};

#define COMBINE_THREADS 256
#define COMBINE_WARPS (COMBINE_THREADS / 32)
#define COMBINE_PPT_E12 4  // points a thread of a tile when E <= 2
#define COMBINE_PAIRS 2048  // pairs a tile at most: 1,024 x 2 or 256 x 8

// dst[a, b) = 0 for the threads g = 0 .. step-1 of a grid stride: scalar
// stores up to the first 16-byte boundary, then 16-byte stores
__device__ __forceinline__ void zero_range(float* dst, int a, int b, int g,
                                           int step) {
    const int a4 = min((a + 3) & ~3, b);
    for (int f = a + g; f < a4; f += step) dst[f] = 0.0f;
    const int b4 = a4 + ((b - a4) & ~3);
    for (int q = a4 / 4 + g; q < b4 / 4; q += step)
        reinterpret_cast<float4*>(dst)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int f = b4 + g; f < b; f += step) dst[f] = 0.0f;
}

// dst[f0, f0 + n) = src[0, n) by threads i = 0 .. step-1: scalar stores
// up to the first 16-byte boundary of dst, 16-byte stores, a scalar tail
__device__ __forceinline__ void write_run(float* __restrict__ dst,
                                          const float* src, long long f0,
                                          int n, int i, int step) {
    const int head = min(n, (int)((4 - (f0 & 3)) & 3));
    if (i < head) dst[f0 + i] = src[i];
    const int body = (n - head) >> 2;
    float4* d4 = reinterpret_cast<float4*>(dst + f0 + head);
    const float* s = src + head;
    for (int q = i; q < body; q += step)
        d4[q] = make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2],
                            s[4 * q + 3]);
    const int done = head + 4 * body;
    for (int f = done + i; f < n; f += step) dst[f0 + f] = src[f];
}

template <int PPT, int MAXE, bool RGB>
__global__ void __launch_bounds__(COMBINE_THREADS) bucket_combine_bwd_kernel(
        const float* __restrict__ w, const int* __restrict__ dest,
        const int* __restrict__ counts, const float* __restrict__ g_sigma,
        const float* __restrict__ g_rgb, float* __restrict__ g_sigma_b,
        float* __restrict__ g_rgb_b, int N, int K, int E, int C, int n_fill,
        int fill_blocks) {
    __shared__ float s_sig[COMBINE_PAIRS];
    __shared__ float s_rgb[RGB ? 3 * COMBINE_PAIRS : 1];
    __shared__ int s_start[MAX_EXPERTS];  // the tile's first slot of k
    __shared__ int s_count[MAX_EXPERTS];  // its kept pairs of k
    __shared__ int s_off[MAX_EXPERTS];    // their first staged position
    const int tid = threadIdx.x;
    if ((int)blockIdx.x < n_fill) {  // the empty tail [min(counts, C), C)
        const int k = blockIdx.x / fill_blocks;
        const int s0 = min(counts[k], C);
        if (s0 >= C) return;  // uniform over the block
        const int g = (blockIdx.x % fill_blocks) * COMBINE_THREADS + tid;
        const int step = fill_blocks * COMBINE_THREADS;
        zero_range(g_sigma_b + (long long)k * C, s0, C, g, step);
        if (RGB)
            zero_range(g_rgb_b + (long long)k * C * 3, 3 * s0, 3 * C, g,
                       step);
        return;
    }
    const long long n0 =
        (long long)(blockIdx.x - n_fill) * (PPT * COMBINE_THREADS);
    const int n_slots = K * C;
    for (int k = tid; k < K; k += COMBINE_THREADS) {
        s_start[k] = 0x7fffffff;
        s_count[k] = 0;
    }
    __syncthreads();
    // 1. each thread's points, coalesced across the block; a pair's kept
    // slot joins its expert's run: within a tile the kept pairs of an
    // expert hold consecutive slots (the dispatch's stable counting sort)
    int d[PPT][MAXE];
    float wk[PPT][MAXE];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
        const long long n = n0 + i * COMBINE_THREADS + tid;
#pragma unroll
        for (int e = 0; e < MAXE; ++e) {
            d[i][e] = n_slots;
            wk[i][e] = 0.0f;
        }
        if (n >= N) continue;
        if (MAXE == 2) {
            const int2 dd = reinterpret_cast<const int2*>(dest)[n];
            const float2 ww = reinterpret_cast<const float2*>(w)[n];
            d[i][0] = dd.x;
            d[i][1] = dd.y;
            wk[i][0] = ww.x;
            wk[i][1] = ww.y;
        } else {
#pragma unroll
            for (int e = 0; e < MAXE; ++e) {
                if (e < E) {
                    d[i][e] = dest[n * E + e];
                    wk[i][e] = w[n * E + e];
                }
            }
        }
#pragma unroll
        for (int e = 0; e < MAXE; ++e) {
            if (d[i][e] < n_slots) {
                const int k = d[i][e] / C;
                atomicMin(&s_start[k], d[i][e]);
                atomicAdd(&s_count[k], 1);
            }
        }
    }
    __syncthreads();
    // 2. the runs' staged offsets: an exclusive scan of the counts by warp 0
    if (tid < 32) {
        int carry = 0;
        for (int base = 0; base < K; base += 32) {
            const int k = base + tid;
            const int c = k < K ? s_count[k] : 0;
            int incl = c;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int t = __shfl_up_sync(FULL_MASK, incl, o);
                if (tid >= o) incl += t;
            }
            if (k < K) s_off[k] = carry + incl - c;
            carry += __shfl_sync(FULL_MASK, incl, 31);
        }
    }
    __syncthreads();
    // 3. one product a kept slot, staged by (expert, slot); g read once a
    // point
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
        const long long n = n0 + i * COMBINE_THREADS + tid;
        if (n >= N) continue;
        const float gs = g_sigma[n];
        float gr[3] = {0.0f, 0.0f, 0.0f};
        if (RGB) {
#pragma unroll
            for (int c = 0; c < 3; ++c) gr[c] = g_rgb[n * 3 + c];
        }
#pragma unroll
        for (int e = 0; e < MAXE; ++e) {
            const int dd = d[i][e];
            if (dd >= n_slots) continue;  // the trash slot has no gradient
            const int k = dd / C;
            const int r = dd - s_start[k];
            if (r >= s_count[k]) continue;  // not a dispatch's dest
            const int pos = s_off[k] + r;
            s_sig[pos] = wk[i][e] * gs;
            if (RGB) {
#pragma unroll
                for (int c = 0; c < 3; ++c)
                    s_rgb[pos * 3 + c] = wk[i][e] * gr[c];
            }
        }
    }
    __syncthreads();
    // 4. each expert's run goes out as one contiguous stream, a warp an
    // expert
    const int warp = tid >> 5, lane = tid & 31;
    for (int k = warp; k < K; k += COMBINE_WARPS) {
        const int cnt = s_count[k];
        if (cnt == 0) continue;
        const int start = s_start[k], off = s_off[k];
        write_run(g_sigma_b, s_sig + off, start, cnt, lane, 32);
        if (RGB)
            write_run(g_rgb_b, s_rgb + 3 * off, 3LL * start, 3 * cnt, lane,
                      32);
    }
}

template <int PPT, int MAXE, bool RGB>
static void launch_combine_bwd(const float* w, const int* dest,
                               const int* counts, const float* g_sigma,
                               const float* g_rgb, float* g_sigma_b,
                               float* g_rgb_b, int N, int K, int E, int C,
                               CombinePlan plan, cudaStream_t stream) {
    const int n_fill = plan.fill_blocks * K;
    bucket_combine_bwd_kernel<PPT, MAXE, RGB>
        <<<n_fill + plan.tiles, COMBINE_THREADS, 0, stream>>>(
            w, dest, counts, g_sigma, g_rgb, g_sigma_b, g_rgb_b, N, K, E, C,
            n_fill, plan.fill_blocks);
}

// w (N, E), dest (N*E,) and counts (K,) as bucket_dispatch wrote them,
// g_sigma (N,), g_rgb (N, 3) nullable -> g_sigma_b (K*C,) and g_rgb_b
// (K*C, 3) (null when g_rgb is), every slot written: the kept slots with
// their product, the rest 0.
NERF_API int bucket_combine_bwd(const float* w, const int* dest,
                                const int* counts, const float* g_sigma,
                                const float* g_rgb, float* g_sigma_b,
                                float* g_rgb_b, int N, int K, int E, int C,
                                CombinePlan plan, cudaStream_t stream) {
    const int ppt = E <= 2 ? COMBINE_PPT_E12 : 1;
    if (N < 0 || K < 1 || K > MAX_EXPERTS || E < 1 || E > MAX_E || C < 1 ||
        C % 128 != 0 || (long long)K * C * 3 >= (1LL << 31) ||
        (g_rgb == nullptr) != (g_rgb_b == nullptr) ||
        plan.tile != ppt * COMBINE_THREADS ||
        plan.tiles != (int)nerf_blocks(N, plan.tile) || plan.fill_blocks < 1)
        return (int)cudaErrorInvalidValue;
#define NERF_COMBINE(T, M)                                                   \
    do {                                                                     \
        if (g_rgb)                                                           \
            launch_combine_bwd<T, M, true>(w, dest, counts, g_sigma, g_rgb,  \
                                           g_sigma_b, g_rgb_b, N, K, E, C,   \
                                           plan, stream);                    \
        else                                                                 \
            launch_combine_bwd<T, M, false>(w, dest, counts, g_sigma, g_rgb, \
                                            g_sigma_b, g_rgb_b, N, K, E, C,  \
                                            plan, stream);                   \
    } while (0)
    if (E == 1) NERF_COMBINE(COMBINE_PPT_E12, 1);
    else if (E == 2) NERF_COMBINE(COMBINE_PPT_E12, 2);
    else NERF_COMBINE(1, MAX_E);
#undef NERF_COMBINE
    return (int)cudaGetLastError();
}
