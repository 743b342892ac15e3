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
//   T_loc,0 = 1, T_loc,j+1 = T_loc,j * one_m_j  (exclusive cumprod, left to
//   right); w_j = (alpha_j * T_loc,j) * T_carry
//   rgb/depth/acc = carry + sum_j w_j (rgb_j, t_j, 1)  (the segment's sum is
//   formed first, then added to the carry, as the reference does)
//   trans = T_carry * prod_j one_m_j
//   with fog: wmax = max(carry, max_j w_j),
//             wlogw = carry + sum_j w_j log(max(w_j, 1e-12)).
// The inputs are taken as given: rgb already clipped to [0, 1], sigma
// already masked and scaled by the caller.
//
// Bound on the H100: bytes, and tiny (~15.7 MB for a 65,536-ray x 8-sample
// segment: the samples, their t and dt, and the carry in; the carry out),
// ~0.005 ms at 3.35 TB/s. Design: one thread per ray walks its samples in
// order, so the transmittance product is taken in the reference's
// left-to-right order. Its loads are per-thread row walks, not coalesced
// across the warp, so the kernel is latency-bound at ~10x its byte bound
// (chip_smoke times it); a simple kernel first.
// t and dt are column slices of the (N, S) sample arrays: they are read
// through a row stride, not copied. The kernel writes a new carry and never
// updates the old one: the resume program gathers rows of the partial's.
#include <math.h>

#include "common.cuh"

__global__ void composite_segment_kernel(
        const float* __restrict__ c_rgb, const float* __restrict__ c_depth,
        const float* __restrict__ c_acc, const float* __restrict__ c_trans,
        const float* __restrict__ c_wmax, const float* __restrict__ c_wlogw,
        const float* __restrict__ rgb, const float* __restrict__ sigma,
        const float* __restrict__ t_seg, const float* __restrict__ d_seg,
        float* __restrict__ o_rgb, float* __restrict__ o_depth,
        float* __restrict__ o_acc, float* __restrict__ o_trans,
        float* __restrict__ o_wmax, float* __restrict__ o_wlogw, int N, int s,
        int t_stride, int d_stride, int fog) {
    const long long ray = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (ray >= N) return;
    const float* c = rgb + ray * s * 3;
    const float* sg = sigma + ray * s;
    const float* t = t_seg + ray * t_stride;
    const float* dt = d_seg + ray * d_stride;
    const float T_carry = c_trans[ray];

    float T = 1.0f;
    float sr = 0.0f, sgr = 0.0f, sb = 0.0f, sd = 0.0f, sa = 0.0f;
    float wmax = -INFINITY, wlogw = 0.0f;
    for (int j = 0; j < s; ++j) {
        const float alpha =
            fminf(fmaxf(1.0f - expf(-sg[j] * dt[j]), 0.0f), 1.0f - 1e-7f);
        const float w = (alpha * T) * T_carry;
        sr += w * c[j * 3 + 0];
        sgr += w * c[j * 3 + 1];
        sb += w * c[j * 3 + 2];
        sd += w * t[j];
        sa += w;
        if (fog) {
            wmax = fmaxf(wmax, w);
            wlogw += w * logf(fmaxf(w, 1e-12f));
        }
        T = T * (1.0f - alpha + 1e-10f);
    }
    o_rgb[ray * 3 + 0] = c_rgb[ray * 3 + 0] + sr;
    o_rgb[ray * 3 + 1] = c_rgb[ray * 3 + 1] + sgr;
    o_rgb[ray * 3 + 2] = c_rgb[ray * 3 + 2] + sb;
    o_depth[ray] = c_depth[ray] + sd;
    o_acc[ray] = c_acc[ray] + sa;
    o_trans[ray] = T_carry * T;
    if (fog) {
        o_wmax[ray] = fmaxf(c_wmax[ray], wmax);
        o_wlogw[ray] = c_wlogw[ray] + wlogw;
    }
}

// Carry in: rgb (N, 3), depth, acc, trans (N,), and with fog wmax, wlogw
// (N,) (null without). Segment: rgb (N, s, 3) and sigma (N, s) contiguous;
// t and dt (N, s) with row strides t_stride, d_stride (elements) and unit
// column stride. Carry out: the same keys, fresh buffers.
NERF_API int composite_segment_fwd(
        const float* c_rgb, const float* c_depth, const float* c_acc,
        const float* c_trans, const float* c_wmax, const float* c_wlogw,
        const float* rgb, const float* sigma, const float* t_seg,
        const float* d_seg, float* o_rgb, float* o_depth, float* o_acc,
        float* o_trans, float* o_wmax, float* o_wlogw, int N, int s,
        int t_stride, int d_stride, int fog, cudaStream_t stream) {
    if (s < 1 || t_stride < s || d_stride < s)
        return (int)cudaErrorInvalidValue;
    if (fog && (c_wmax == nullptr || c_wlogw == nullptr ||
                o_wmax == nullptr || o_wlogw == nullptr))
        return (int)cudaErrorInvalidValue;
    if (N > 0) {
        const int threads = 128;
        composite_segment_kernel<<<nerf_blocks(N, threads), threads, 0,
                                   stream>>>(
            c_rgb, c_depth, c_acc, c_trans, c_wmax, c_wlogw, rgb, sigma,
            t_seg, d_seg, o_rgb, o_depth, o_acc, o_trans, o_wmax, o_wlogw, N,
            s, t_stride, d_stride, fog);
    }
    return (int)cudaGetLastError();
}
