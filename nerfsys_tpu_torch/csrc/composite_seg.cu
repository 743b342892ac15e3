// Kernel row 8: segmented compositing with a carried transmittance.
//
// Replaces: nerfsys_tpu/ops/volrend.py `composite_segment` (:153), the
// segment step of the live early-stop renderer (the partial and resume
// programs of nerfsys_tpu/models/occupancy.py :625, :753).
//
// Per ray, over its s samples of this segment (s >= 1), given the carry
// (rgb, depth, acc, trans[, wmax, wlogw]) of the earlier segments:
//   alpha_j = clip(1 - exp(-sigma_j * dt_j), 0, 1 - 1e-7)
//   one_m_j = 1 - alpha_j + 1e-10
//   T_loc,j = prod_{i<j} one_m_i (exclusive); w_j = (alpha_j * T_loc,j) *
//   T_carry
//   rgb/depth/acc = carry + sum_j w_j (rgb_j, t_j, 1)  (the segment's sum is
//   formed first, then added to the carry, as the reference does)
//   trans = T_carry * prod_j one_m_j
//   with fog: wmax = max(carry, max_j w_j),
//             wlogw = carry + sum_j w_j log(max(w_j, 1e-12)).
// The inputs are taken as given: rgb already clipped to [0, 1], sigma
// already masked and scaled by the caller.
//
// Bound on the H100: bytes (the samples, their t and dt, and the carry in;
// the carry out): 15,728,640 B for the first segment of a 65,536-ray chunk
// (s = 8, 0.0047 ms at 3.35 TB/s) and 10,223,616 B for a 16,384 x 24 resume
// slice (0.0031 ms). The first design (one thread a ray walking its
// samples, loads a row apart across the warp) was latency-bound at ~2x the
// first bound and ~3x the second. This design is kernel 4's lane map and
// scans (volrend_common.cuh):
//   - a ray's samples on `lanes` consecutive lanes (the power of 2 at or
//     above s, at most 32): the first segment puts 4 rays on a warp, the
//     resume slice one ray on 32 lanes (8 idle); above 32 samples, pieces
//     of 32 carry T in a register;
//   - each lane reads its own sample: rgb (N, s, 3) and sigma (N, s) are
//     contiguous, so a warp reads its rays' contiguous rows; t and dt go
//     through their row strides (the first segment passes column slices
//     of (N, 32) tensors, not copies);
//   - T_loc as kernel 4 forms it: an inclusive product scan of one_m
//     across the segment, shifted by one lane, times the pieces before (a
//     product tree, not the reference's left-to-right cumprod: both within
//     an ulp or two a step);
//   - the segment sums of w r, w g, w b, w t and w by butterflies (with
//     fog, w log w a sixth and the max of w a seventh); output q of a ray
//     (r, g, b, depth, acc, trans, wmax, wlogw) is written by its
//     segment's lane q mod lanes, which reads its carry value then.
// Staging a warp's rows in shared memory with 16-byte loads, several rays
// a warp with the carry read first, and capping the registers each
// measured slower, and reading the carry first alone no faster: the
// kernel is bound by its warps' latency, so its registers (the warps
// resident) matter most.
// The plan comes from Python (ops/volrend.py `ray_lane_plan`, one ray
// group a warp, cached per shape). The kernel writes a new carry and never
// updates the old one: the resume program gathers rows of the partial's.
// ptxas for sm_90a: 32-38 registers a thread over the twelve instances,
// no spills.
#include <math.h>

#include "volrend_common.cuh"

template <int W, bool FOG>
__global__ void __launch_bounds__(256) composite_segment_kernel(
        const float* __restrict__ c_rgb, const float* __restrict__ c_depth,
        const float* __restrict__ c_acc, const float* __restrict__ c_trans,
        const float* __restrict__ c_wmax, const float* __restrict__ c_wlogw,
        const float* __restrict__ rgb, const float* __restrict__ sigma,
        const float* __restrict__ t_seg, const float* __restrict__ d_seg,
        float* __restrict__ o_rgb, float* __restrict__ o_depth,
        float* __restrict__ o_acc, float* __restrict__ o_trans,
        float* __restrict__ o_wmax, float* __restrict__ o_wlogw, int N, int s,
        int t_stride, int d_stride, int pieces) {
    constexpr int RAYS = 32 / W;  // rays a warp
    const int lane = threadIdx.x & 31;
    const int sl = lane & (W - 1);  // the lane's place in its ray's segment
    const long long first =
        ((long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) *
        RAYS;
    if (first >= N) return;  // the whole warp: no shuffle is left waiting
    const long long ray = first + lane / W;
    const bool live = ray < N;
    const long long row = live ? ray : first;
    const float T_carry = __ldg(c_trans + row);

    float T = 1.0f;  // the product of the pieces before
    float cr = 0.0f, cg = 0.0f, cb = 0.0f, depth = 0.0f, acc = 0.0f;
    float wmax = -INFINITY, wlogw = 0.0f;
    for (int p = 0; p < pieces; ++p) {
        const int j = p * W + sl;
        float alpha = 0.0f, m = 1.0f, t = 0.0f;  // the identity off samples
        float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
        if (live && j < s) {
            const float sg = __ldg(sigma + row * s + j);
            const float dt = __ldg(d_seg + row * d_stride + j);
            const float* c = rgb + (row * s + j) * 3;
            t = __ldg(t_seg + row * t_stride + j);
            c0 = __ldg(c + 0);
            c1 = __ldg(c + 1);
            c2 = __ldg(c + 2);
            alpha = fminf(fmaxf(1.0f - expf(-sg * dt), 0.0f), 1.0f - 1e-7f);
            m = 1.0f - alpha + 1e-10f;
        }
        const float incl = seg_prod<W>(m, sl);
        float ex = __shfl_up_sync(FULL_MASK, incl, 1, W);
        if (sl == 0) ex = 1.0f;
        const float w = (alpha * (T * ex)) * T_carry;
        cr += w * c0;
        cg += w * c1;
        cb += w * c2;
        depth += w * t;
        acc += w;
        if (FOG) {
            wmax = fmaxf(wmax, w);
            wlogw += w * logf(fmaxf(w, 1e-12f));
        }
        T = T * __shfl_sync(FULL_MASK, incl, W - 1, W);
    }
    cr = seg_sum<W>(cr);
    cg = seg_sum<W>(cg);
    cb = seg_sum<W>(cb);
    depth = seg_sum<W>(depth);
    acc = seg_sum<W>(acc);
    if (FOG) {
        wlogw = seg_sum<W>(wlogw);
        wmax = seg_max<W>(wmax);
    }
    if (!live) return;
#pragma unroll
    for (int q = 0; q < (FOG ? 8 : 6); ++q) {
        if ((q & (W - 1)) != sl) continue;
        switch (q) {
            case 0: o_rgb[ray * 3] = __ldg(c_rgb + ray * 3) + cr; break;
            case 1:
                o_rgb[ray * 3 + 1] = __ldg(c_rgb + ray * 3 + 1) + cg;
                break;
            case 2:
                o_rgb[ray * 3 + 2] = __ldg(c_rgb + ray * 3 + 2) + cb;
                break;
            case 3: o_depth[ray] = __ldg(c_depth + ray) + depth; break;
            case 4: o_acc[ray] = __ldg(c_acc + ray) + acc; break;
            case 5: o_trans[ray] = T_carry * T; break;
            case 6: o_wmax[ray] = fmaxf(__ldg(c_wmax + ray), wmax); break;
            default: o_wlogw[ray] = __ldg(c_wlogw + ray) + wlogw; break;
        }
    }
}

// Carry in: rgb (N, 3), depth, acc, trans (N,), and with fog wmax, wlogw
// (N,) (null without). Segment: rgb (N, s, 3) and sigma (N, s) contiguous;
// t and dt (N, s) with row strides t_stride, d_stride (elements) and unit
// column stride. Carry out: the same keys, fresh buffers. Plan from
// ops/volrend.py `ray_lane_plan(N, s, 1)`: one group a warp, one pass.
NERF_API int composite_segment_fwd(
        const float* c_rgb, const float* c_depth, const float* c_acc,
        const float* c_trans, const float* c_wmax, const float* c_wlogw,
        const float* rgb, const float* sigma, const float* t_seg,
        const float* d_seg, float* o_rgb, float* o_depth, float* o_acc,
        float* o_trans, float* o_wmax, float* o_wlogw, int N, int s,
        int t_stride, int d_stride, int fog, RayLanePlan plan,
        cudaStream_t stream) {
    if (t_stride < s || d_stride < s || !ray_lane_plan_ok(plan, s, 1) ||
        (long long)plan.blocks * (plan.threads / 32) * (32 / plan.lanes) < N)
        return (int)cudaErrorInvalidValue;
    if (N <= 0) return (int)cudaGetLastError();  // empty tensors: null
    if (fog && (c_wmax == nullptr || c_wlogw == nullptr ||
                o_wmax == nullptr || o_wlogw == nullptr))
        return (int)cudaErrorInvalidValue;
#define SEG_LAUNCH(LANES)                                                    \
    if (fog)                                                                 \
        composite_segment_kernel<LANES, true>                                \
            <<<plan.blocks, plan.threads, 0, stream>>>(                      \
                c_rgb, c_depth, c_acc, c_trans, c_wmax, c_wlogw, rgb, sigma, \
                t_seg, d_seg, o_rgb, o_depth, o_acc, o_trans, o_wmax,        \
                o_wlogw, N, s, t_stride, d_stride, plan.pieces);             \
    else                                                                     \
        composite_segment_kernel<LANES, false>                               \
            <<<plan.blocks, plan.threads, 0, stream>>>(                      \
                c_rgb, c_depth, c_acc, c_trans, c_wmax, c_wlogw, rgb, sigma, \
                t_seg, d_seg, o_rgb, o_depth, o_acc, o_trans, o_wmax,        \
                o_wlogw, N, s, t_stride, d_stride, plan.pieces)
    switch (plan.lanes) {
        case 1: SEG_LAUNCH(1); break;
        case 2: SEG_LAUNCH(2); break;
        case 4: SEG_LAUNCH(4); break;
        case 8: SEG_LAUNCH(8); break;
        case 16: SEG_LAUNCH(16); break;
        default: SEG_LAUNCH(32); break;
    }
#undef SEG_LAUNCH
    return (int)cudaGetLastError();
}
