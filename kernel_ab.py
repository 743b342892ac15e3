"""Design experiments on kernel 3 (the inverse-CDF sampler), 10a-i (the
bucket dispatch), 10a-iii (the blend's transpose), 10b (the
coherent-expert test), row 8 (the segment compositor), 11q (the
occupancy point query), 5'' / 6'' (the plane encoder's double
backward), 4'' (the compositor's double backward) and row 12
(`trunc_exp`): variants of their CUDA sources, built beside the shipped
libraries and timed through the shipped wrappers at the real shapes.

    python3 kernel_ab.py [--rounds 5] [--kernels OCC_QUERY ...] \
        [--first DIR]

Needs one CUDA card and nvcc. Each variant is the shipped source with a
few lines replaced (`VARIANTS`), or for a first design the same file of
a checkout given with `--first` (`git archive <commit> | tar -x -C DIR`:
1334e6a holds the first designs of 5'' / 6'' and of 4'', 4ec2f81 those
of 4'' and of row 12's three kernels; a first design that the checkout does not hold is left out, and
all of them without `--first`), adapted to
the shipped entry points' arguments; it is built with the shipped flags into
`nerfsys_tpu_torch/_build/variants/` (all nvcc runs at once) and swapped
in for the shipped entry point, so the wrapper's plan, checks and launch
path are the shipped ones. The cases are `serve_ab.py --phase kernels`'s:
kernel 3 at the serve chunk (65,536 rays x 32 samples, P=128, shared
targets) and at one inner step (4,000 rays, per-ray jittered targets),
10a-i at the serve chunk's 2,097,152 points (K=4, E=1 and 2, cf 1.5) and
on one chunk of the K=16 arm (196,608 points, E=2), 10b at the serve
chunk's and a skew chunk's 65,536 x 32 samples, row 8 at the first
segment (65,536 x 8) and a resume slice (16,384 x 24), 10a-iii on the
top-2 dispatches of the serve chunk and of the K=16 chunk, 11q at the
serve chunk in each mode, at one inner step (K=1) and on a K=16 chunk,
5'' at one inner step (128,000 points, one expert and the K=4 stack) and
6'' at one expert, with kernels 5 and 6 timed beside them (no variants),
4'' at one inner step (4,000 x 32, the rgb upstream), row 12's forward
at a frame call's 8,388,608 points and all three kernels at a bench
step's 128,000 (the backward beside `torch.mul(g, y)`, its library
call).
A variant that keeps the outputs is first held to the plain version on
every case of its kernel (the sampler within 1e-5, the dispatch's integer
outputs equal and its weights within 1e-6 on two calls, 10b's ids equal,
row 8 within 1e-5, 10a-iii and 11q equal, 5'' / 6'' within 1e-5 of each
output's max against the plain sums in float64, 4'' within 1e-5 of each
output's max, row 12 bit for bit); a timing-only variant
(its outputs wrong or incomplete) is not. A variant may also change the
Python side's plan (`bwd2_plan`: the tile or threads a block of the
plan of 5'' / 6''; `act_threads`: the threads a block row 12's
`act_launch` sizes its grid with). `--kernels` keeps the variants and
cases of the named kernels (the `kernels` module's attributes, as in
`CASES_OF`). Then `--rounds` rounds time every variant and the shipped
kernel on every case by device time (chip_smoke's `device_ms`), in turn;
the script prints each variant's ptxas register count, each round, and
the median and range per (variant, case).
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# name -> (library stem, timing only, [(shipped text or None for the whole
# source, variant text)], the
# Python side's matching change: {"tile": the dispatch's tile for E <= 2},
# {"groups": 10b's ray groups a warp} or {"lanes": 10b's lanes a ray at
# most}, else None).
# "{sms}" in a variant text is the card's SM count.
VARIANTS = {
    "3: 16 blocks an SM (the grid before the occupancy cap)": (
        "occ_sample", False,
        [("kern<<<min(plan.blocks, resident),",
          "kern<<<min(plan.blocks, 16 * {sms}),")], None),
    "3: literal count on every row": (
        "occ_sample", False,
        [("const bool search = __all_sync(FULL_MASK, mono);",
          "const bool search = false;")], None),
    "3: rank sort on every row": (
        "occ_sample", False,
        [("const bool sorted = __all_sync(FULL_MASK, in_order);",
          "const bool sorted = false;")], None),
    "3: both (the count and the rank sort of every row)": (
        "occ_sample", False,
        [("const bool search = __all_sync(FULL_MASK, mono);",
          "const bool search = false;"),
         ("const bool sorted = __all_sync(FULL_MASK, in_order);",
          "const bool sorted = false;")], None),
    "10a-i: tiles of 256 at E <= 2": (
        "bucket", False,
        [("#define DISPATCH_PPT_E12 8", "#define DISPATCH_PPT_E12 1")],
        {"tile": 256}),
    "10a-i: no rows phase (timing only)": (
        "bucket", True,
        [("for (int p0 = 0; p0 < total; p0 += GATHER) {",
          "for (int p0 = 0; p0 < 0; p0 += GATHER) {")], None),
}
VARIANTS.update({
    f"10b: {g} ray group{'s' if g > 1 else ''} a warp": (
        "coherent", False,
        [("#define COHERENT_GROUPS 2", f"#define COHERENT_GROUPS {g}")],
        {"groups": g})
    for g in (1, 4, 8)})
VARIANTS.update({
    f"10b: pieces of {w} lanes": ("coherent", False, [], {"lanes": w})
    for w in (4, 16, 32)})
VARIANTS["8: the carry read first"] = (
    "composite_seg", False,
    [("    float T = 1.0f;  // the product of the pieces before",
      "    float pre[8];  // output q's carry value, by the lane that writes"
      " it\n#pragma unroll\n    for (int q = 0; q < 8; ++q)\n"
      "        pre[q] = live && q < (FOG ? 8 : 6) && q != 5 &&\n"
      "                 (q & (W - 1)) == sl\n"
      "            ? __ldg(q < 3 ? c_rgb + ray * 3 + q\n"
      "                    : q == 3 ? c_depth + ray : q == 4 ? c_acc + ray\n"
      "                    : q == 6 ? c_wmax + ray : c_wlogw + ray)\n"
      "            : 0.0f;\n"
      "    float T = 1.0f;  // the product of the pieces before"),
     ("__ldg(c_rgb + ray * 3) + cr", "pre[0] + cr"),
     ("__ldg(c_rgb + ray * 3 + 1) + cg", "pre[1] + cg"),
     ("__ldg(c_rgb + ray * 3 + 2) + cb", "pre[2] + cb"),
     ("__ldg(c_depth + ray) + depth", "pre[3] + depth"),
     ("__ldg(c_acc + ray) + acc", "pre[4] + acc"),
     ("fmaxf(__ldg(c_wmax + ray), wmax)", "fmaxf(pre[6], wmax)"),
     ("__ldg(c_wlogw + ray) + wlogw", "pre[7] + wlogw")], None)
VARIANTS["10a-iii: the tail fill as a second launch"] = (
    "bucket", False,
    [("""    bucket_combine_bwd_kernel<PPT, MAXE, RGB>
        <<<n_fill + plan.tiles, COMBINE_THREADS, 0, stream>>>(
            w, dest, counts, g_sigma, g_rgb, g_sigma_b, g_rgb_b, N, K, E, C,
            n_fill, plan.fill_blocks);""",
      """    bucket_combine_bwd_kernel<PPT, MAXE, RGB>
        <<<n_fill, COMBINE_THREADS, 0, stream>>>(
            w, dest, counts, g_sigma, g_rgb, g_sigma_b, g_rgb_b, N, K, E, C,
            n_fill, plan.fill_blocks);
    bucket_combine_bwd_kernel<PPT, MAXE, RGB>
        <<<plan.tiles, COMBINE_THREADS, 0, stream>>>(
            w, dest, counts, g_sigma, g_rgb, g_sigma_b, g_rgb_b, N, K, E, C,
            0, plan.fill_blocks);""")],
    {"kernel": "BUCKET_COMBINE_BWD"})
VARIANTS["10a-iii: each run written by the whole block"] = (
    "bucket", False,
    [("""    const int warp = tid >> 5, lane = tid & 31;
    for (int k = warp; k < K; k += COMBINE_WARPS) {""",
      """    const int lane = tid;
    for (int k = 0; k < K; ++k) {"""),
     ("write_run(g_sigma_b, s_sig + off, start, cnt, lane, 32);",
      "write_run(g_sigma_b, s_sig + off, start, cnt, lane, "
      "COMBINE_THREADS);"),
     ("""3 * cnt, lane,
                      32);""", """3 * cnt, lane,
                      COMBINE_THREADS);""")],
    {"kernel": "BUCKET_COMBINE_BWD"})
# 11q (csrc/occ_query.cu). Its first design, whole (a thread a point,
# kernel 2's `locate`: levels finest first, an early return, three
# divisions; its copy of the level table gathers `level_bounds`' 12 floats
# a level from the shipped table's 16), and its attribution; then the
# shipped design's parts one at a time.
Q_PR18 = r"""#include "occ_common.cuh"  // BOX_FLOATS, locate: shared with kernel 2

#define QUERY_THREADS 256  // ops/occupancy.py QUERY_THREADS

template <bool BITS, bool VALUES>
__global__ void __launch_bounds__(QUERY_THREADS) occupancy_query_kernel(
        const float* __restrict__ pts, const float* __restrict__ occs,
        const uint8_t* __restrict__ binary, const float* __restrict__ levels,
        uint8_t* __restrict__ out_bits, float* __restrict__ out_vals,
        long long M, int K, int L, int R) {
    extern __shared__ float4 smem_q[];  // 16-byte aligned: float4 reads
    float* box = reinterpret_cast<float*>(smem_q);
    for (int i = threadIdx.x; i < K * L * BOX_FLOATS; i += blockDim.x) {
        const int f = i % BOX_FLOATS;  // a, b, lo, w from the 16-float rows
        box[i] = __ldg(levels + 16 * (i / BOX_FLOATS) +
                       (f < 6 ? f : f < 9 ? f + 2 : f == 9 ? 6 : f == 10 ? 7
                                                                   : 14));
    }
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
"""
Q_PR18_READS = """        if (BITS) bit = bit || __ldg(binary + flat) != 0;
        if (VALUES) val = fmaxf(val, fmaxf(__ldg(occs + flat), 0.0f));"""
Q_PR18_NO_READS = """        if (BITS) bit = bit != ((flat & 1) != 0);
        if (VALUES) val = fmaxf(val, (float)flat);"""
Q_PR18_LOCATE = "        const int flat = locate(smem_q, k, L, R, x, y, z);"
Q_PR18_PICK = """        int sel = -1, flat = -1;
        float lx = 0.0f, ly = 0.0f, lz = 0.0f, wx = 1.0f, wy = 1.0f,
              wz = 1.0f;
#pragma unroll
        for (int l = 7; l >= 0; --l) {
            if (l >= L) continue;
            const float4* b = smem_q + (k * L + l) * (BOX_FLOATS / 4);
            const float4 q0 = b[0], q1 = b[1], q2 = b[2];
            const bool in = (x >= q0.x) & (x < q0.w) & (y >= q0.y) &
                            (y < q1.x) & (z >= q0.z) & (z < q1.y);
            sel = in ? l : sel;
            lx = in ? q1.z : lx;
            ly = in ? q1.w : ly;
            lz = in ? q2.x : lz;
            wx = in ? q2.y : wx;
            wy = in ? q2.z : wy;
            wz = in ? q2.w : wz;
        }
        if (sel >= 0) {
            const int i0 = min(max(__float2int_rz((x - lx) / wx * (float)R),
                                   0), R - 1);
            const int i1 = min(max(__float2int_rz((y - ly) / wy * (float)R),
                                   0), R - 1);
            const int i2 = min(max(__float2int_rz((z - lz) / wz * (float)R),
                                   0), R - 1);
            flat = (((k * L + sel) * R + i0) * R + i1) * R + i2;
        }"""
Q_PR18_RCP = """__device__ __forceinline__ int locate_rcp(const float4* box, int k, int L,
                                          int R, float x, float y,
                                          float z) {
    for (int l = 0; l < L; ++l) {
        const float4* b = box + (k * L + l) * (BOX_FLOATS / 4);
        const float4 q0 = b[0], q1 = b[1];
        if (x >= q0.x && x < q0.w && y >= q0.y && y < q1.x && z >= q0.z &&
            z < q1.y) {
            const float4 q2 = b[2];
            const float rx = __fdividef(x - q1.z, q2.y);
            const float ry = __fdividef(y - q1.w, q2.z);
            const float rz = __fdividef(z - q2.x, q2.w);
            const int i0 = min(max(__float2int_rz(rx * (float)R), 0), R - 1);
            const int i1 = min(max(__float2int_rz(ry * (float)R), 0), R - 1);
            const int i2 = min(max(__float2int_rz(rz * (float)R), 0), R - 1);
            return (((k * L + l) * R + i0) * R + i1) * R + i2;
        }
    }
    return -1;
}

template <bool BITS, bool VALUES>"""
Q_CELLS = """                bool n0, n1, n2;  // the three guesses first, then rows
                int i0 = guess_cell(x[p], c0.x, c0.w, margin, top, n0);
                int i1 = guess_cell(y[p], c0.y, c1.x, margin, top, n1);
                int i2 = guess_cell(z[p], c0.z, c1.y, margin, top, n2);
                const float* r = steps + kl * 3 * row;
                if (n0) i0 = step_row(r, x[p], i0, R);
                if (n1) i1 = step_row(r + row, y[p], i1, R);
                if (n2) i2 = step_row(r + 2 * row, z[p], i2, R);"""
Q_DIV_CELLS = """                const float4 w01 = smem_q[4 * kl + 1];  // b.y, b.z, w.x, w.y
                const float wz = smem_q[4 * kl + 3].z;
""" + "\n".join(
    f"                int i{a} = min(max(__float2int_rz(({c}[p] - "
    f"c0.{'xyz'[a]}) / {w} * (float)R), 0), R - 1);"
    for a, (c, w) in enumerate((("x", "w01.z"), ("y", "w01.w"),
                                ("z", "wz"))))
Q_READS = """                if (BITS) bit[p] = bit[p] || __ldg(binary + flat) != 0;
                if (VALUES)
                    val[p] = fmaxf(val[p], fmaxf(__ldg(occs + flat), 0.0f));"""
Q_NO_READS = """                if (BITS) bit[p] = bit[p] != ((flat & 1) != 0);
                if (VALUES) val[p] = fmaxf(val[p], (float)flat);"""
Q_ONE_WAVE = "    if (blocks <= resident) {  // one wave: a thread a point"
VARIANTS["11q: the first design (a thread a point, `locate`)"] = (
    "occ_query", False, [(None, Q_PR18)], None)
VARIANTS["11q: the first design without the grid reads (timing only)"] = (
    "occ_query", True,
    [(None, Q_PR18.replace(Q_PR18_READS, Q_PR18_NO_READS))], None)
VARIANTS["11q: the first design, the divisions as approximate reciprocal "
         "multiplies (timing only)"] = (
    "occ_query", True,
    [(None, Q_PR18.replace("template <bool BITS, bool VALUES>", Q_PR18_RCP)
      .replace("locate(smem_q", "locate_rcp(smem_q"))], None)
VARIANTS["11q: the first design, the finest level picked by selects over "
         "the unrolled level loop (divisions kept)"] = (
    "occ_query", False, [(None, Q_PR18.replace(Q_PR18_LOCATE, Q_PR18_PICK))],
    None)
VARIANTS["11q: the step rows read on every cell (no margin test)"] = (
    "occ_query", False,
    [("    near = !(f >= margin && f <= top);", "    near = true;")], None)
VARIANTS["11q: divisions in place of the guess and the step rows"] = (
    "occ_query", False, [(Q_CELLS, Q_DIV_CELLS)], None)
VARIANTS["11q: the one-wave kernel reading the step rows from device "
         "memory"] = (
    "occ_query", False,
    [("    const int rows_shared = smem + rows <= 48 * 1024;",
      "    const int rows_shared = 0;")], None)
VARIANTS["11q: bits alone without the skip after a set bit"] = (
    "occ_query", False,
    [("                if (sel[p] < 0 || (!VALUES && bit[p])) continue;",
      "                if (sel[p] < 0) continue;")], None)
VARIANTS["11q: no grid reads (timing only)"] = (
    "occ_query", True, [(Q_READS, Q_NO_READS)], None)
VARIANTS["11q: a point a thread at every size"] = (
    "occ_query", False, [(Q_ONE_WAVE, "    if (true) {")], None)
VARIANTS["11q: four points a thread at every size"] = (
    "occ_query", False, [(Q_ONE_WAVE, "    if (false) {")], None)
VARIANTS["11q: 512 threads a block"] = (
    "occ_query", False,
    [("#define QUERY_THREADS 256", "#define QUERY_THREADS 512")], None)
VARIANTS["11q: four points a thread on blocks capped at the resident "
         "count (grid-stride)"] = (
    "occ_query", False,
    [("    if (smem > 48 * 1024 &&", "    if ("),
     ("    many<<<(unsigned)tiles, QUERY_THREADS, smem, stream>>>(",
      "    many<<<(unsigned)(tiles < resident ? tiles : resident), "
      "QUERY_THREADS, smem, stream>>>(")], None)
# 5'' / 6'' (csrc/planes_bwd2.cu). The first design (a warp a 32-point
# run, no tiles: points and cotangent read and d ct stored by each lane in
# device memory, every line level on the global path) is read from a
# checkout of its commit (`--first DIR`, 1334e6a) and given the shipped
# entry points' arguments; then its parts one at a time (the split that
# chose the shipped design), and the shipped design's.
FIRST = [(None, None),  # the whole source: --first's planes_bwd2.cu
         ("\n__device__ __forceinline__ float bf16_round(float v) {",
          "\nstruct PlanePlan {  // the shipped layout; only vec is read\n"
          "    int tile, threads, blocks, smem, vec;\n"
          "    int line_ofs[PLANES_MAX_LEVELS];\n"
          "    int sms;\n"
          "};\n"
          "\n__device__ __forceinline__ float bf16_round(float v) {"),
         ("""                                     int F, int vec, int threads,
                                     cudaStream_t stream) {
    return bwd2(x, ct, lv, vv, gr, dct, K, N, F, false, vec, threads,
                stream);""",
          """                                     int F, PlanePlan plan,
                                     cudaStream_t stream) {
    return bwd2(x, ct, lv, vv, gr, dct, K, N, F, false, plan.vec, 256,
                stream);"""),
         ("""                               float* dct, int K, int N, int F, int vec,
                               int threads, cudaStream_t stream) {
    return bwd2(x, ct, lv, vv, gr, dct, K, N, F, true, vec, threads, stream);""",
          """                               float* dct, int K, int N, int F,
                               PlanePlan plan, cudaStream_t stream) {
    return bwd2(x, ct, lv, vv, gr, dct, K, N, F, true, plan.vec, 256,
                stream);""")]
B2_SCATTER = """    reduce_peers<VEC>(peers, v, lane);
    if (!active || (peers & ((1u << lane) - 1u))) return;  // not the leader
    if (VEC == 4)
        red_add4(dst, v[0], v[1], v[2], v[3]);"""
B2_NO_RED = """    reduce_peers<VEC>(peers, v, lane);
    if (!active || (peers & ((1u << lane) - 1u))) return;  // not the leader
    if (VEC == 4 && __float_as_uint(v[0]) == 0x7fc00001u)  // never
        dst[0] = v[1];
    else if (VEC == 4)
        return;"""
B2_SCALAR = """    reduce_peers<VEC>(peers, v, lane);
    if (!active || (peers & ((1u << lane) - 1u))) return;  // not the leader
    if (VEC == 4)
        for (int i = 0; i < VEC; ++i) atomicAdd(dst + i, v[i]);"""
B2_NO_SCATTER = "    return;  // no match, aggregation or reduction\n" + B2_SCATTER
B2_V_ROWS = """        load_row<VEC>(vp + rows[0] * F + f0, v00);
        load_row<VEC>(vp + rows[1] * F + f0, v01);
        load_row<VEC>(vp + rows[2] * F + f0, v10);
        load_row<VEC>(vp + rows[3] * F + f0, v11);
        load_row<VEC>(lp + w0 * F + f0, m0);
        load_row<VEC>(lp + w1 * F + f0, m1);
        load_row<VEC>(vl + w0 * F + f0, n0);
        load_row<VEC>(vl + w1 * F + f0, n1);"""
B2_REREADS = B2_V_ROWS.replace("vp + rows", "tp + rows").replace(
    "vl + w", "lp + w")
B2_STORE = "        if (active) {\n            if (VEC == 4)\n"
B2_NO_STORE = ("        if (active && __float_as_uint(out[0]) == 0x7fc00001u) {"
               "  // never\n            if (VEC == 4)\n")
B2_ORDER = ("""    const int grp = (int)(task % groups);
    const int lo = (int)((task / groups) % LO);  // level * 3 + orientation""",
            """    const int lo = (int)(task % LO);  // level * 3 + orientation
    const int grp = (int)((task / LO) % groups);""")
VARIANTS.update({
    f"5'': the first design{what}": ("planes_bwd2", timing, FIRST + reps,
                                     None)
    for what, timing, reps in (
        (" (a warp a run, no tiles)", False, []),
        (" without the table scatter (no match, aggregation or reduction; "
         "timing only)", True, [(B2_SCATTER, B2_NO_SCATTER)]),
        (", aggregation kept, no vector reductions (timing only)", True,
         [(B2_SCATTER, B2_NO_RED)]),
        (", scalar atomics in place of red.v4", False,
         [(B2_SCATTER, B2_SCALAR)]),
        (", vP / vL gathers as re-reads of P / L (timing only)", True,
         [(B2_V_ROWS, B2_REREADS)]),
        (" without the d ct store (timing only)", True,
         [(B2_STORE, B2_NO_STORE)]),
        (", (level, orientation) fastest in the task order", False,
         [B2_ORDER]),
        (", (level, orientation) fastest, without the table scatter "
         "(timing only)", True, [B2_ORDER, (B2_SCATTER, B2_NO_SCATTER)]))})
VARIANTS["6'': the first design"] = (
    "planes_bwd2", False, FIRST, {"kernel": "PLANES_BWD2"})
VARIANTS["6'': the first design, (level, orientation) fastest"] = (
    "planes_bwd2", False, FIRST + [B2_ORDER], {"kernel": "PLANES_BWD2"})
# the shipped design's parts
B2_ADD = """    if (VEC == 4) {
        red_add4(gdst, v[0], v[1], v[2], v[3]);"""
B2_DCT = """                reinterpret_cast<float4*>(dg)[i] =
                    reinterpret_cast<const float4*>(obuf)[i];"""
VARIANTS["5'': without the table scatter (timing only)"] = (
    "planes_bwd2", True,
    [("    reduce_peers<VEC>(peers, v, lane);\n", "    return;\n")], None)
VARIANTS["5'': aggregation kept, no vector reductions (timing only)"] = (
    "planes_bwd2", True,
    [(B2_ADD, """    if (VEC == 4 && __float_as_uint(v[0]) == 0x7fc00001u) {  // never
        gdst[0] = v[1];
    } else if (VEC == 4) {""")], None)
VARIANTS["5'': scalar atomics in place of red.v4"] = (
    "planes_bwd2", False,
    [(B2_ADD, """    if (VEC == 4) {
        for (int i = 0; i < VEC; ++i) atomicAdd(gdst + i, v[i]);""")], None)
VARIANTS["5'': vP / vL gathers as re-reads of P / L (timing only)"] = (
    "planes_bwd2", True,
    [(B2_V_ROWS.replace("        load_row", "                load_row"),
      B2_REREADS.replace("        load_row", "                load_row"))],
    None)
VARIANTS["5'': without the d ct store (timing only)"] = (
    "planes_bwd2", True,
    [(B2_DCT, """                if (__float_as_uint(obuf[i]) == 0x7fc00001u)  // never
                    reinterpret_cast<float4*>(dg)[i] =
                        reinterpret_cast<const float4*>(obuf)[i];""")], None)
B2_ONE_LANE = ("""    const int lpp =
        (VEC == 4 && F <= 128 && (F & (F - 1)) == 0) ? F >> 2 : 1;""",
               "    const int lpp = 1;")
VARIANTS["5'': one lane a point (a row's 16-byte quarters in turn)"] = (
    "planes_bwd2", False, [B2_ONE_LANE], None)
VARIANTS["6'': one lane a point"] = (
    "planes_bwd2", False, [B2_ONE_LANE], {"kernel": "PLANES_BWD2"})
VARIANTS["5'': points fastest in a tile's task order (the order before)"] = (
    "planes_bwd2", False,
    [("""            const int lo = task % LO;  // level * 3 + orientation""",
      """            const int lo = task / groups;  // level * 3 + orientation"""),
     ("""            const int p = (task / LO) * ppw + q;""",
      """            const int p = (task - lo * groups) * ppw + q;""")], None)
VARIANTS["6'': points fastest in a tile's task order"] = (
    "planes_bwd2", False,
    VARIANTS["5'': points fastest in a tile's task order (the order before)"][2],
    {"kernel": "PLANES_BWD2"})
VARIANTS["5'': table rows through the L1 (ld.global.nc)"] = (
    "planes_bwd2", False,
    [("        const float4 q = __ldcg(reinterpret_cast<const float4*>(p));",
      "        const float4 q = __ldg(reinterpret_cast<const float4*>(p));")],
    None)
VARIANTS["5'': registers capped for 3 blocks an SM"] = (
    "planes_bwd2", False,
    [("__global__ void __launch_bounds__(BWD2_MAX_THREADS)",
      "__global__ void __launch_bounds__(BWD2_MAX_THREADS, 3)")], None)
VARIANTS.update({
    f"5'': {what}": ("planes_bwd2", False, [], {"bwd2_plan": kw})
    for what, kw in (
        ("8 warps a block (36 tasks a tile in 4.5 rounds)",
         {"threads": 256}),
        ("6 warps a block (6 whole rounds)", {"threads": 192}),
        ("tiles of 32 points", {"tile": 32}),
        ("tiles of 96 points", {"tile": 96}),
        ("tiles of 128 points", {"tile": 128}))})
# 4'' (csrc/volrend_bwd2.cu), at one inner step. Its first design (T, T',
# Q and P as four scans in a row) is read from a checkout of a commit that
# holds it (`--first`, 4ec2f81 or 1334e6a); then the shipped design (the
# forward pair as one scan) with the reverse pair fused too; and where
# the time goes: an empty launch, the loads and d_rs store alone, without the d_rs
# store, the lane scans or the per-ray sums, and the six per-ray sums as
# one transposed tree.
VR_REV = """        // Q_{s+1}: kernel 4''s suffix scan of x -> g alpha + m x
        float qm = q.m, qb = g * q.alpha;
        seg_suffix<W>(qm, qb, sl);
        float qmn = __shfl_down_sync(FULL_MASK, qm, 1, W);
        float qbn = __shfl_down_sync(FULL_MASK, qb, 1, W);
        if (sl == W - 1) {
            qmn = 1.0f;
            qbn = 0.0f;
        }
        const float Qn = qbn + qmn * Q;
        Q = __shfl_sync(FULL_MASK, qb + qm * Q, 0, W);
        const float gq = g - Qn;

        // P_{s+1}: the suffix scan of x -> a' (g - Q_{s+1}) + h alpha + m x
        float pm = q.m, pb = k.ad * gq + h * q.alpha;
        seg_suffix<W>(pm, pb, sl);
        float pmn = __shfl_down_sync(FULL_MASK, pm, 1, W);
        float pbn = __shfl_down_sync(FULL_MASK, pb, 1, W);
        if (sl == W - 1) {
            pmn = 1.0f;
            pbn = 0.0f;
        }
        const float Pn = pbn + pmn * P;
        P = __shfl_sync(FULL_MASK, pb + pm * P, 0, W);
"""
VR_REV_FUSED = """        // (P, Q)_{s+1}: one suffix scan of the affine maps of (P, Q)
        float Ad = q.m, Ac = -k.ad;
        float fp = k.ad * g + h * q.alpha, fq = g * q.alpha;
#pragma unroll
        for (int o = 1; o < W; o <<= 1) {
            const float Ad2 = __shfl_down_sync(FULL_MASK, Ad, o, W);
            const float Ac2 = __shfl_down_sync(FULL_MASK, Ac, o, W);
            const float fp2 = __shfl_down_sync(FULL_MASK, fp, o, W);
            const float fq2 = __shfl_down_sync(FULL_MASK, fq, o, W);
            if (sl + o < W) {
                fp = fp + Ad * fp2 + Ac * fq2;
                fq = fq + Ad * fq2;
                Ac = Ad * Ac2 + Ac * Ad2;
                Ad = Ad * Ad2;
            }
        }
        float nAd = __shfl_down_sync(FULL_MASK, Ad, 1, W);
        float nAc = __shfl_down_sync(FULL_MASK, Ac, 1, W);
        float nfp = __shfl_down_sync(FULL_MASK, fp, 1, W);
        float nfq = __shfl_down_sync(FULL_MASK, fq, 1, W);
        if (sl == W - 1) {
            nAd = 1.0f;
            nAc = 0.0f;
            nfp = 0.0f;
            nfq = 0.0f;
        }
        const float Pn = nfp + nAd * P + nAc * Q;
        const float Qn = nfq + nAd * Q;
        const float P_all = fp + Ad * P + Ac * Q;
        const float Q_all = fq + Ad * Q;
        P = __shfl_sync(FULL_MASK, P_all, 0, W);
        Q = __shfl_sync(FULL_MASK, Q_all, 0, W);
        const float gq = g - Qn;
"""
VR_BODY = ("    extern __shared__ float starts[];  // (warps, pieces, 2) when "
           "pieces > 1\n")
VR_GVB = "    const float gvb = G0 * vb0 + G1 * vb1 + G2 * vb2;\n"
VR_COPY1 = VR_GVB + """    if (N > 0) {  // the loads and the d_rs store alone
        for (int p = pieces - 1; p >= 0; --p) {
            const int s = p * W + sl;
            if (live && s < S) {
                const float4 a =
                    __ldg(reinterpret_cast<const float4*>(rs) + s);
                const float4 b = __ldg(vs + s);
                const float tt = __ldg(t + s);
                reinterpret_cast<float4*>(d_rs + row * S * 4)[s] =
                    make_float4(a.x * b.x + tt, a.y * b.y, a.z * b.z,
                                a.w * b.w + gvb);
            }
        }
        return;
    }
"""
VR_SUMS = """    acc = seg_sum<W>(acc);
    accd = seg_sum<W>(accd);
    rd0 = seg_sum<W>(rd0);
    rd1 = seg_sum<W>(rd1);
    rd2 = seg_sum<W>(rd2);
    dd = seg_sum<W>(dd);
    if (live && sl == 0) {"""
VR_SUMS_T = """    if (W >= 8) {  // one transposed tree: (acc, accd, rd0 | rd1, rd2, dd)
        const int h1 = W >> 1, h2 = W >> 2, h3 = W >> 3;
        const bool k1 = sl & h1, k2 = sl & h2, k3 = sl & h3;
        float a[6] = {acc, accd, rd0, rd1, rd2, dd};
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            const float give = k1 ? a[i] : a[i + 3];
            a[i] = (k1 ? a[i + 3] : a[i]) +
                   __shfl_xor_sync(FULL_MASK, give, h1, W);
        }
        a[3] = 0.0f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const float give = k2 ? a[i] : a[i + 2];
            a[i] = (k2 ? a[i + 2] : a[i]) +
                   __shfl_xor_sync(FULL_MASK, give, h2, W);
        }
        {
            const float give = k3 ? a[0] : a[1];
            a[0] = (k3 ? a[1] : a[0]) + __shfl_xor_sync(FULL_MASK, give, h3, W);
        }
#pragma unroll
        for (int d = h3 >> 1; d > 0; d >>= 1)
            a[0] += __shfl_xor_sync(FULL_MASK, a[0], d, W);
        // index k1 3 + k2 2 + k3: acc at lane 0, accd h3, rd0 h2, rd1 h1,
        // rd2 h1 + h3, dd h1 + h2
        const float acc_all = __shfl_sync(FULL_MASK, a[0], 0, W);
        const float accd_all = __shfl_sync(FULL_MASK, a[0], h3, W);
        if (live) {
            if (sl == h3) {
                if (d_acc != nullptr) d_acc[ray] = accd_all;
                if (d_bg != nullptr) {
                    d_bg[ray * 3 + 0] = -G0 * accd_all;
                    d_bg[ray * 3 + 1] = -G1 * accd_all;
                    d_bg[ray * 3 + 2] = -G2 * accd_all;
                }
            }
            if (sl == h1 + h2 && d_depth != nullptr) d_depth[ray] = a[0];
            const int c = sl == h2 ? 0 : sl == h1 ? 1 : sl == h1 + h3 ? 2
                                                                    : -1;
            if (c >= 0 && d_rgb != nullptr)
                d_rgb[ray * 3 + c] =
                    a[0] - accd_all * (c == 0 ? b0 : c == 1 ? b1 : b2) +
                    (1.0f - acc_all) * (c == 0 ? vb0 : c == 1 ? vb1 : vb2);
        }
        return;
    }
""" + VR_SUMS
VR_STORE = ("            reinterpret_cast<float4*>(d_rs + row * S * 4)[s] = "
            "make_float4(")


VARIANTS["4'': the first design (four scans in a row)"] = (
    "volrend_bwd2", False, [(None, None)], None)
VARIANTS["4'': the reverse pair fused too (one scan of four floats)"] = (
    "volrend_bwd2", False, [(VR_REV, VR_REV_FUSED)], None)
VARIANTS["4'': an empty launch (timing only)"] = (
    "volrend_bwd2", True, [(VR_BODY, "    if (N > 0) return;\n" + VR_BODY)],
    None)
VARIANTS["4'': the loads and the d_rs store alone (timing only)"] = (
    "volrend_bwd2", True, [(VR_GVB, VR_COPY1)], None)
VARIANTS["4'': without the d_rs store (timing only)"] = (
    "volrend_bwd2", True,
    [(VR_STORE, "            if (__float_as_uint(d_sigma) == 0x7fc00001u)"
                "  // never\n" + VR_STORE)], None)
VARIANTS["4'': without the per-ray sums (timing only)"] = (
    "volrend_bwd2", True, [(VR_SUMS, "    if (live && sl == 0) {")], None)
VARIANTS["4'': the per-ray sums as one transposed tree"] = (
    "volrend_bwd2", False, [(VR_SUMS, VR_SUMS_T)], None)
# Row 12 (csrc/activations.cu). Each kernel's first design, read whole
# from a checkout of 4ec2f81 (`--first`; its entry points take the card's
# SMs where the shipped ones take the wrapper's launch): the same
# grid-stride loops, launched by the source itself, so at a frame call the
# forward's first design is the loop the exact-cover grid replaced. The
# forward's exact-cover grid without its streaming hints. The backward at
# a bench step's 128,000 points, where `g * y` (timed beside it in every
# round) is as fast or faster: an empty launch, 32-bit indices, the loop's
# back edges taken out (one trip covers the step), plain loads for
# __ldg, and 128 threads a block (250 blocks, `g * y`'s grid).
A_HINTS = [("if (j < nv) a[k] = __ldcs(reinterpret_cast<const float4*>(x) + j);",
            "if (j < nv) a[k] = __ldg(reinterpret_cast<const float4*>(x) + j);"),
           ("__stcs(reinterpret_cast<float4*>(y) + j,",
            "reinterpret_cast<float4*>(y)[j] = ("),
           ("if (q < n) a[k] = __ldcs(x + q);", "if (q < n) a[k] = __ldg(x + q);"),
           ("if (q < n) __stcs(y + q, fwd1(a[k], m));",
            "if (q < n) y[q] = fwd1(a[k], m);")]
B_SIG = ("                     float* __restrict__ gx, long long n, int vec) "
         "{\n")
B_IDX = """    const long long stride = (long long)gridDim.x * blockDim.x;
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long nv = vec ? n >> 2 : 0;
    for (long long j = i; j < nv; j += stride) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(g) + j);
        const float4 b = __ldg(reinterpret_cast<const float4*>(y) + j);
"""
B_TAIL = ("    for (long long j = 4 * nv + i; j < n; j += stride) "
          "gx[j] = g[j] * y[j];")
B_INT = [(B_SIG + B_IDX, B_SIG + B_IDX.replace(
    "const long long stride = (long long)gridDim.x * blockDim.x;",
    "const int stride = gridDim.x * blockDim.x;  // n < 2^31").replace(
    "long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;",
    "int i = blockIdx.x * blockDim.x + threadIdx.x;").replace(
    "const long long nv = vec ? n >> 2 : 0;",
    "const int nv = vec ? (int)(n >> 2) : 0;").replace(
    "for (long long j = i;", "for (int j = i;")),
         (B_TAIL, B_TAIL.replace("for (long long j = 4 * nv + i; j < n;",
                                 "for (int j = 4 * nv + i; j < (int)n;"))]
B_ONE_TRIP = [
    (B_SIG + B_IDX, B_SIG + B_IDX.replace(
        "for (long long j = i; j < nv; j += stride)",
        "if (long long j = i; j < nv)")),
    (B_TAIL, B_TAIL.replace("for (long long j = 4 * nv + i; j < n; j += stride)",
                            "if (long long j = 4 * nv + i; j < n)"))]
B_INT_ONE_TRIP = [
    (B_INT[0][0], B_INT[0][1].replace("for (int j = i; j < nv; j += stride)",
                                      "if (int j = i; j < nv)")),
    (B_INT[1][0], B_INT[1][1].replace(
        "for (int j = 4 * nv + i; j < (int)n; j += stride)",
        "if (int j = 4 * nv + i; j < (int)n)"))]
B_LDG = [(B_SIG + B_IDX, B_SIG + B_IDX.replace(
    "__ldg(reinterpret_cast<const float4*>(g) + j)",
    "reinterpret_cast<const float4*>(g)[j]").replace(
    "__ldg(reinterpret_cast<const float4*>(y) + j)",
    "reinterpret_cast<const float4*>(y)[j]"))]
B_128 = [("#define ACT_THREADS 256", "#define ACT_THREADS 128")]
VARIANTS.update({
    f"12 {what}: the first design": (
        "activations", False, [(None, None)],
        {"kernel": kern, "first_launch_args": k})
    for what, kern, k in (("fwd", "TRUNC_EXP_FWD", 2),
                          ("bwd", "TRUNC_EXP_BWD", 1),
                          ("bwd2", "TRUNC_EXP_BWD2", 1))})
VARIANTS.update({
    "12 fwd: __ldg and plain stores (no streaming hints)": (
        "activations", False, A_HINTS, {"kernel": "TRUNC_EXP_FWD"}),
    "12 bwd: an empty launch (timing only)": (
        "activations", True,
        [(B_SIG, B_SIG + "    if (n > 0) return;\n")], None),
    "12 bwd: 32-bit indices": ("activations", False, B_INT, None),
    "12 bwd: no back edges (one trip a thread)": (
        "activations", False, B_ONE_TRIP, None),
    "12 bwd: plain loads for __ldg": ("activations", False, B_LDG, None),
    "12 bwd: 128 threads a block": (
        "activations", False, B_128, {"act_threads": 128}),
    "12 bwd: 128 threads a block, 32-bit indices, no back edges": (
        "activations", False, B_128 + B_INT_ONE_TRIP, {"act_threads": 128}),
})
# the kernel a variant of each library replaces unless it names another
KERNEL_OF = {"occ_sample": "OCC_SAMPLE", "bucket": "BUCKET_DISPATCH",
             "coherent": "COHERENT_EXPERT", "composite_seg": "COMPOSITE_SEG",
             "occ_query": "OCC_QUERY", "planes_bwd2": "PLANES_BWD2_LIGHT",
             "volrend_bwd2": "VOLREND_BWD2", "activations": "TRUNC_EXP_BWD"}
# each kernel's cases in `serve_ab.kernel_cases` (kernels 5 and 6 have no
# variants: their cases time them beside 5'' / 6''; the backward of row 12
# has `torch.mul(g, y)`, its library call, timed beside it)
CASES_OF = {"OCC_SAMPLE": (0, 1), "BUCKET_DISPATCH": (2, 3, 4),
            "COHERENT_EXPERT": (5, 6), "COMPOSITE_SEG": (7, 8),
            "BUCKET_COMBINE_BWD": (9, 10), "OCC_QUERY": (11, 12, 13, 14, 15),
            "PLANES_BWD2_LIGHT": (16, 18), "PLANES_BWD2": (17,),
            "PLANES_BWD_LIGHT": (19,), "PLANES_BWD": (20,),
            "VOLREND_BWD2": (21,), "TRUNC_EXP_BWD": (22, 23),
            "TRUNC_EXP_FWD": (24, 25), "TRUNC_EXP_BWD2": (26,)}


def kernel_of(name: str) -> str:
    """The kernels attribute that variant `name` replaces."""
    stem, _, _, patch = VARIANTS[name]
    return (patch or {}).get("kernel", KERNEL_OF[stem])


def variant_source(kernels, name: str, sms: int, first: Path = None):
    """Variant `name`'s source: the shipped one, or for (None, text) that
    text, for (None, None) `first`'s copy of the same file, with its
    replacements; None when `first`'s copy does not hold a replacement's
    text once (it holds another design than the one named)."""
    stem, _, reps, _ = VARIANTS[name]
    src_name = kernels.SOURCES[stem][0]
    text = (kernels.CSRC / src_name).read_text()
    whole = False
    for old, new in reps:
        if old is None:  # the whole source: given, or the first design's
            whole = new is None
            if new is not None:
                text = new
                continue
            path = first / "nerfsys_tpu_torch/csrc" / src_name
            if not path.is_file():
                return None
            text = path.read_text()
            continue
        if text.count(old) != 1:
            if whole:
                return None
            raise SystemExit(f"kernel_ab: {name}: the shipped source "
                             f"no longer holds {old!r} once")
        text = text.replace(old, new.replace("{sms}", str(sms)))
    return text


def build_variants(kernels, sms: int, first: Path = None):
    """Writes and builds every variant in parallel (a whole-source
    replacement reads `first`'s copy of the file; a first design that
    `first` does not hold is left out, with a note); returns name ->
    (library path, ptxas lines)."""
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, name in enumerate(list(VARIANTS)):
        stem = VARIANTS[name][0]
        src_name, extra = kernels.SOURCES[stem]
        text = variant_source(kernels, name, sms, first)
        if text is None:
            print(f"kernel_ab: {name} left out: {first}'s {src_name} holds "
                  f"another design", flush=True)
            del VARIANTS[name]
            continue
        src = out_dir / f"v{i}_{src_name}"
        src.write_text(text)
        lib = out_dir / f"libv{i}_{stem}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *extra, "-I",
               str(kernels.CSRC), "-o", str(lib), str(src)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    built = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"kernel_ab: nvcc failed for {name}:\n{log}")
        built[name] = (lib, [ln.strip() for ln in log.splitlines()
                             if "registers" in ln])
    return built


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--kernels", nargs="+", choices=sorted(CASES_OF),
                    default=sorted(CASES_OF))
    ap.add_argument("--first", type=Path, default=None,
                    help="a checkout of the commit that holds a kernel's "
                    "first design: 1334e6a for 5'' / 6'' and 4'', 4ec2f81 "
                    "for 4'' and row 12 (without it those variants are "
                    "left out)")
    args = ap.parse_args()
    for name in [n for n in VARIANTS if kernel_of(n) not in args.kernels
                 or (args.first is None
                     and VARIANTS[n][2][:1] == [(None, None)])]:
        del VARIANTS[name]
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    import chip_smoke as cs
    import serve_ab
    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.models import container as CO
    from nerfsys_tpu_torch.ops import planes as PL
    from nerfsys_tpu_torch.ops import activations as TA

    print(cs.card_line(), flush=True)
    device = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    stems = sorted({getattr(kernels, k).stem for k in args.kernels})
    kernels.build_all()  # the cases' set-up runs other kernels too
    for stem in stems:
        for ln in kernels.build_log.get(stem, "").splitlines():
            if "registers" in ln:
                print(f"shipped {stem}: {ln.strip()}", flush=True)
    built = build_variants(kernels, sms, args.first)
    for name, (_, regs) in built.items():
        for ln in regs:
            print(f"{name}: {ln}", flush=True)
    torch.manual_seed(cs.SEED)
    cfg, statics, params, occ = cs.bench_setup(device)
    cases = serve_ab.kernel_cases(cs, cfg, statics, params, occ, device)
    timed = sorted(i for k in args.kernels for i in CASES_OF[k])
    for i in timed:  # also loads the shipped entry points
        print(f"shipped / {cases[i][0]}: {cases[i][2]()[0]}", flush=True)
    shipped = {k: getattr(kernels, k) for k in args.kernels}
    fns = {k: kern._fn for k, kern in shipped.items()}
    shipped_tile = CO.dispatch_tile
    shipped_10b = {at: getattr(CO, at) for at in ("COHERENT_GROUPS",
                                                  "COHERENT_LANES")}
    shipped_bwd2 = PL._bwd2_launch
    shipped_threads = TA.ACT_THREADS

    def use(name):
        """Swaps variant `name` (None: the shipped kernels) in."""
        for k, kern in shipped.items():
            kern._fn = fns[k]
        CO.dispatch_tile = shipped_tile
        CO._dispatch_plan.cache_clear()
        for at, v in shipped_10b.items():
            setattr(CO, at, v)
        PL._bwd2_launch = shipped_bwd2
        TA.ACT_THREADS = shipped_threads
        if name is None:
            return
        _, _, _, patch = VARIANTS[name]
        kern = shipped[kernel_of(name)]
        lib = ctypes.CDLL(str(built[name][0]))
        fn = getattr(lib, kern.symbol)
        fn.argtypes = kern.argtypes
        fn.restype = ctypes.c_int
        kern._fn = fn
        if patch and "first_launch_args" in patch:
            # the first design's entry point: the card's SMs in place of
            # the wrapper's launch arguments
            k = patch["first_launch_args"]
            fn.argtypes = kern.argtypes[:-(k + 1)] + [ctypes.c_int,
                                                      kern.argtypes[-1]]
            kern._fn = lambda *a, f=fn, k=k: f(*a[:-(k + 1)], sms, a[-1])
        if patch and "tile" in patch:
            CO.dispatch_tile = (lambda e: patch["tile"] if e <= 2
                                else shipped_tile(e))
        if patch and "groups" in patch:
            CO.COHERENT_GROUPS = patch["groups"]
        if patch and "lanes" in patch:
            CO.COHERENT_LANES = patch["lanes"]
        if patch and "act_threads" in patch:
            TA.ACT_THREADS = patch["act_threads"]
        if patch and "bwd2_plan" in patch:
            def launch(n, *shape, kw=patch["bwd2_plan"]):
                # the shipped plan with another tile (its shared memory,
                # 4 * tile * (3 D + 6) bytes, and grid scaled to it) or
                # block size
                plan, _ = shipped_bwd2.__wrapped__(n, *shape)
                tile = kw.get("tile", plan.tile)
                plan = dataclasses.replace(
                    plan, tile=tile, threads=kw.get("threads", plan.threads),
                    smem=plan.smem // plan.tile * tile,
                    blocks=min(plan.blocks, -(-n // tile)))
                return plan, plan.as_struct()
            PL._bwd2_launch = launch

    for name, (stem, timing_only, _, _) in list(VARIANTS.items()):
        if timing_only:
            continue
        use(name)
        for i in CASES_OF[kernel_of(name)]:
            try:
                text, _ = cases[i][2]()
            except (SystemExit, RuntimeError) as e:  # not timed, not kept
                print(f"{name} / {cases[i][0]}: FAILS its check ({e}); "
                      f"left out of the rounds", flush=True)
                del VARIANTS[name]
                break
            print(f"{name} / {cases[i][0]}: {text}", flush=True)
    use(None)
    names = [None, *VARIANTS]
    times = {(n, i): [] for n in names for i in range(len(cases))}
    for r in range(args.rounds):
        for name in names:
            use(name)
            idx = timed if name is None else CASES_OF[kernel_of(name)]
            row = []
            for i in idx:
                ms = cs.device_ms(cases[i][1])
                times[(name, i)].append(ms)
                row.append(f"{cases[i][0]} {ms:.5f}")
            print(f"round {r} {name or 'shipped'}: " + ", ".join(row),
                  flush=True)
    use(None)
    for (name, i), xs in times.items():
        if xs:
            print(f"{name or 'shipped'} / {cases[i][0]}: device_ms median "
                  f"{statistics.median(xs):.5f} range [{min(xs):.5f}, "
                  f"{max(xs):.5f}] over {len(xs)} rounds", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
