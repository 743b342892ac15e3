#!/usr/bin/env python3
"""A/B timing of the port's serve or train phase: this checkout against
another one.

    python3 serve_ab.py OTHER_CHECKOUT [--pairs 10] [--experts planes|hash]
                        [--phase frame|step|kernels] [--exact | --packed]
                        [--maml]

OTHER_CHECKOUT is a second copy of the repository, for example the parent
commit unpacked with `git archive`. One worker process per checkout imports
that checkout's own `chip_smoke.py` and `nerfsys_tpu_torch`, builds its
kernels, sets up chip_smoke's bench-width soft-occupancy configuration
(K=4, seed 0; `--experts hash` swaps in chip_smoke's `hash_setup`, the
runner's default hash-grid experts, in place of the bench-width planes
experts) and runs one warm-up frame or step. Then the workers take rounds
in the order other, this, this, other, other, this, ... (`--pairs` pairs).
A `--phase frame` round (the default) renders chip_smoke's three 800x800
poses through `render_image` and reports each frame's ms on the host
clock, ending with the frame on the host, and the host ms of `frame_rays`
for the first pose. A `--phase step` round takes three of chip_smoke's
bench FoMAML steps (`make_train_step`, K=4 B=3, 8 inner steps of 4,000
rays), each ending with its loss on the host, from the same parameters
and generator seed every round (before the rounds, each worker in turn
profiles one step with its chip_smoke's `profile_device`: device busy ms
and idle share, one side after the other); `--exact` gives the planes
experts the encoder's exact backward (each checkout's own
`chip_smoke.exact_backward`, pos_grad=True) in
place of the light one; `--packed` gives the hash experts the packed
bfloat16-pair table reads (the runner's --packed_gather: each
checkout's own `chip_smoke.with_hash(cfg, packed=True)`) for either
phase, and implies `--experts hash`; `--maml` makes the steps
second-order MAML (chip_smoke's bench meta configuration with
algo="maml", which each checkout's own port must accept) with either
experts and backward. A `--phase kernels` round times,
through each checkout's own wrappers, kernel 3 (the inverse-CDF sampler)
at the serve chunk (65,536 rays x 32 samples of the bench probe's cdf,
shared targets) and at one inner step (4,000 rays, jittered targets from
a fixed seed), and 10a-i (the bucket dispatch) at the serve chunk's
2,097,152 points (K=4, top-1 and top-2, cf 1.5) and on one chunk of the
K=16 arm (196,608 points, top-2), 10b (the coherent-expert test, K=4,
margin 1.1, cluster_2d) on the serve chunk's 65,536 x 32 samples and on
the first chunk of the skew-0.9 frame's (the coherent renderer's probe
samples), and row 8 (the segment compositor) on the serve chunk's first
segment (65,536 x 8, the bench probe's samples through the field, t and
dt column slices) and on a resume slice (16,384 x 24), 10a-iii (the
blend's transpose) on the top-2 dispatches of the serve chunk and of the
K=16 chunk, and 11q (the occupancy point query) at the serve chunk's
2,097,152 samples (K=4 L=4 R=128) in its three modes, at one inner
step's 128,000 samples (the K=1 task slice) and on the first 1,048,576
points of the K=16 arm (K=16 L=4 R=128 grids, 5% occupied, seed 5), and
kernels 5'' and 6'' (the plane encoder's double backward, light and
exact) at those 128,000 samples for expert 0's tables and 5'' on the K=4
stack, with kernels 5 and 6 at the same samples, kernel 4'' (the
compositor's double backward) at one inner step (expert 0's support set,
4,000 x 32, the rgb upstream of MAML's loss), and row 12 (`trunc_exp`) at
the sizes the main path launches it: the backward at a bench step's
128,000 points beside `torch.mul(g, y)`, its library call, timed in the
same worker, the forward at a frame call's 8,388,608 points and at a
step's, the second derivative at a step's, and 5'' under bfloat16 line
matmuls (5''b) for expert 0's tables: each case's device time
(chip_smoke's `device_ms`) and back-to-back time; before the rounds
each worker holds every case against its plain version (the sampler
within 1e-5, the dispatch's integer outputs equal and its weights within
1e-6 on two successive calls, 10b's ids equal, row 8 within 1e-5, 10a-iii
and 11q equal, 5'' / 6'' / 5''b within 1e-5 of each output's max against the
plain version's sums in float64, 5 / 6 within 1e-4, 4'' within 1e-5 of
each output's max, row 12 bit for bit); then, one side
after the other, each profiles ten dispatch calls and ten 10a-iii calls
(device time by kernel launch), one soft early-stop frame at sigma_scale
1 and one coherent skew frame (hash experts),
watching rows 8 and 10b. A worker waits on its pipe between rounds, so
one runs at a time.

Prints every round, then for each side the median, quartiles and range of
the round means; the difference of the medians against the other side's
quartile spread, whether this median lies inside the other's range, and
in how many pairs this side was faster; and the card's name and power
limit. Exits non-zero if the two checkouts render different images or
reach different losses (the mean colour, or the last step's loss, apart
by more than 1e-4 of its size). Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SIDES = ("other", "this")


def worker(root: Path, experts: str, phase: str, exact: bool,
           packed: bool, maml: bool = False) -> int:
    sys.path[0] = str(root)  # that checkout's modules, not this script's
    import torch

    import chip_smoke as cs
    from nerfsys_tpu_torch import kernels

    kernels.build_all()
    device = torch.device("cuda", 0)
    torch.manual_seed(cs.SEED)
    cfg, statics, params, occ = cs.bench_setup(device)
    if experts == "hash":
        cfg, params = cs.hash_setup(device)
    if exact:
        cfg = cs.exact_backward(cfg)
    if packed:
        cfg = cs.with_hash(cfg, packed=True)
    if phase == "step":
        return step_rounds(cs, cfg, statics, params, occ, device, root,
                           maml)
    if phase == "kernels":
        return kernel_rounds(cs, cfg, statics, params, occ, device, root)
    return frame_rounds(cs, cfg, statics, params, occ, device)


def frame_rounds(cs, cfg, statics, params, occ, device) -> int:
    import torch

    from nerfsys_tpu_torch.data.ram_rays import frame_rays
    from nerfsys_tpu_torch.pipelines.online.runtime_adapt import (
        default_chunk_rays,
        make_chunk_renderer,
        render_image,
    )

    S = 32
    chunk = default_chunk_rays(S)
    aabb = statics.global_aabb.cpu().numpy()
    renderer = make_chunk_renderer(cfg, ray_samples=S, occ_state=occ,
                                   occ_importance=True, occ_hard_mask=False,
                                   device=device)
    poses = [cs.pose((0.0, 0.0, 2.0)), cs.pose((0.1, 0.0, 2.0)),
             cs.pose((0.0, -0.1, 2.1))]
    render_image(renderer, params, statics, poses[0], scene_aabb=aabb,
                 chunk_rays=chunk)  # warm-up
    torch.cuda.synchronize()
    print(json.dumps({"ready": "frame"}), flush=True)
    for line in sys.stdin:
        if line.strip() != "run":
            break
        ms = []
        for md in poses:
            t0 = time.perf_counter()
            rgb, _, _ = render_image(renderer, params, statics, md,
                                     scene_aabb=aabb, chunk_rays=chunk)
            ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        frame_rays(poses[0].H, poses[0].W, poses[0].intrinsics,
                   poses[0].c2w, aabb=aabb)
        raygen_ms = 1e3 * (time.perf_counter() - t0)
        print(json.dumps({"ms": ms, "raygen_ms": raygen_ms,
                          "check": float(rgb.mean())}), flush=True)
    return 0


def step_rounds(cs, cfg, statics, params, occ, device, root: Path,
                maml: bool = False) -> int:
    import dataclasses

    import torch

    from nerfsys_tpu_torch.models.container import param_group_labels
    from nerfsys_tpu_torch.pipelines.offline.meta_train_step import (
        make_train_step,
    )
    from nerfsys_tpu_torch.utils.optim import OptimConfig, build_optimizer

    batch = cs.train_batch(device)
    opt = build_optimizer(OptimConfig(outer_steps=10000),
                          param_group_labels(params))
    meta = cs.train_meta()
    if maml:
        meta = dataclasses.replace(meta, algo="maml")
    step = make_train_step(meta, cfg, opt)
    state0 = opt.init(params)
    gen = torch.Generator(device=device).manual_seed(1)
    float(step(params, state0, statics, batch, gen, occ)[2]["loss_out"])
    print(json.dumps({"ready": "step"}), flush=True)
    for line in sys.stdin:
        if line.strip() == "profile":  # one side at a time
            cs.profile_device(f"{root} step", lambda: float(step(
                params, state0, statics, batch, gen, occ)[2]["loss_out"]))
            print(json.dumps({"profiled": True}), flush=True)
            continue
        if line.strip() != "run":
            break
        gen = torch.Generator(device=device).manual_seed(1)
        p, state, ms = params, state0, []
        for _ in range(3):
            t0 = time.perf_counter()
            p, state, aux = step(p, state, statics, batch, gen, occ)
            loss = float(aux["loss_out"])  # the host sync ends the step
            ms.append(1e3 * (time.perf_counter() - t0))
        print(json.dumps({"ms": ms, "raygen_ms": 0.0, "check": loss}),
              flush=True)
    return 0


KERNEL_CASES = ("sample chunk", "sample step", "dispatch K=4 E=1",
                "dispatch K=4 E=2", "dispatch K=16 E=2", "coherent chunk",
                "coherent skew chunk", "composite first segment",
                "composite resume slice", "combine_bwd K=4 E=2",
                "combine_bwd K=16 E=2", "query chunk bits",
                "query chunk values", "query chunk pair", "query step bits",
                "query K=16 bits", "planes bwd2 light step",
                "planes bwd2 exact step", "planes bwd2 light step K=4",
                "planes bwd light step", "planes bwd exact step",
                "volrend bwd2 step", "trunc_exp bwd step", "g * y step",
                "trunc_exp fwd frame call", "trunc_exp fwd step",
                "trunc_exp bwd2 step", "planes bwd2 light lines_bf16 step")
TRUNC_EXP_FRAME = 8_388_608  # a live frame's call: 65,536 x 32 x K=4
QUERY_K16_PTS = 1 << 20  # the union grid build's chunk of points


def combine_bwd_call(CO, w, dest, counts, g_s, g_r, n_slots):
    """The checkout's 10a-iii wrapper, with the dispatch's counts."""
    return CO.bucket_combine_bwd_kernel(w, dest, g_s, g_r, n_slots,
                                        counts=counts)


def segment_inputs(cs, cfg, statics, params, occ, rays, device):
    """Row 8's inputs as chip_smoke's `check_segment_kernel` makes them at
    sigma_scale 1: the bench probe's samples of the serve chunk through the
    field, the first segment (fresh carry; t and dt column slices of the
    (N, 32) arrays) and the resume slice of the first 16,384 rays (their
    carry after the first segment)."""
    import torch

    from nerfsys_tpu_torch.models.container import container_apply
    from nerfsys_tpu_torch.models.occupancy import _ray_validity
    from nerfsys_tpu_torch.ops import occupancy as O
    from nerfsys_tpu_torch.ops import volrend as V
    from nerfsys_tpu_torch.ops.activations import clip

    S, s1 = 32, cs.ES_SEG
    N, cap = rays.shape[0], rays.shape[0] // 4
    o, d = rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous()
    valid, near, far = _ray_validity(rays)
    cdf = O.occupancy_probe_cdf(occ["occs"], occ["binary"],
                                statics.expert_aabbs, o, d, near, far, 128,
                                importance=True, ray_floor=0.25)
    t_vals, _ = O.sample_tvals_from_cdf(cdf, near, far, S)
    dists = V.full_dists(t_vals)
    pts = V.t_to_points(o, d, t_vals).reshape(-1, 3)
    with torch.no_grad():
        rgb, sigma = container_apply(params, cfg, statics, pts,
                                     d[:, None, :].expand(N, S, 3)
                                     .reshape(-1, 3))
    rgb = clip(rgb.reshape(N, S, 3), 0.0, 1.0)
    sigma = torch.clamp(torch.where(valid[:, None], sigma.reshape(N, S),
                                    0.0), min=0.0)
    first = (V.composite_init(N, device=device), rgb[:, :s1].contiguous(),
             sigma[:, :s1].contiguous(), t_vals[:, :s1], dists[:, :s1])
    carry = V.composite_segment_plain(*first)
    ids = torch.arange(cap, device=device)
    rest = ({k: v.index_select(0, ids) for k, v in carry.items()},
            rgb[:cap, s1:].contiguous(), sigma[:cap, s1:].contiguous(),
            t_vals[:cap, s1:], dists[:cap, s1:])
    return first, rest


def kernel_cases(cs, cfg, statics, params, occ, device):
    """(name, call, check) of the `--phase kernels` cases: the call
    launches the checkout's kernel, the check holds it against its plain
    version (raising on a disagreement) and returns a text and a sum of
    its outputs."""
    import torch

    from nerfsys_tpu_torch.data.ram_rays import frame_rays
    from nerfsys_tpu_torch.models import container as CO
    from nerfsys_tpu_torch.models.occupancy import (
        _ray_validity,
        occ_sample_positions,
    )
    from nerfsys_tpu_torch.ops import occupancy as O
    from nerfsys_tpu_torch.ops import volrend as V

    md = cs.pose((0.0, 0.0, 2.0))
    rays_np, _ = frame_rays(md.H, md.W, md.intrinsics, md.c2w,
                            aabb=statics.global_aabb.cpu().numpy())
    rays_np = rays_np[:cs.CHECK_RAYS]
    rays = torch.from_numpy(rays_np).to(device)
    o, d = rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous()
    _, near, far = _ray_validity(rays)
    grids = (occ["occs"], occ["binary"], statics.expert_aabbs)
    kw = dict(importance=True, ray_floor=0.25, use_kernels=False)
    cdf = O.occupancy_probe_cdf(*grids, o, d, near, far, 128, **kw)["cdf"]
    u = O._sample_targets(cdf.shape[0], 32, device, None, False).contiguous()
    sr = cs.train_batch(device)["support_rays"][0, 0]
    so, sd = sr[:, 0:3].contiguous(), sr[:, 3:6].contiguous()
    sn, sf = sr[:, 6].contiguous(), sr[:, 7].contiguous()
    scdf = O.occupancy_probe_cdf(*(g[0:1] for g in grids), so, sd, sn, sf,
                                 128, **kw)["cdf"]
    gen = torch.Generator(device=device).manual_seed(3)
    su = O._sample_targets(sr.shape[0], 32, device, gen, True).contiguous()
    pts_ns, dirs = cs.chunk_samples(statics, occ, rays_np, device)
    pts = pts_ns.reshape(-1, 3).contiguous()
    cents = statics.centroids.contiguous()
    k16_cfg, k16_st, _, k16_pts, k16_dirs = cs.k16_setup(device)
    n16 = cs.K16_PTS // cs.K16_CHUNKS
    k16 = (k16_pts[:n16].contiguous(), k16_dirs[:n16].contiguous(),
           k16_st.centroids.contiguous(), k16_cfg.cluster_2d,
           float(k16_cfg.boundary_margin), 2,
           CO.bucket_capacity(n16, 16, 2, cs.MOE_CF))

    def sampler(args):
        def check():
            got = O.sample_tvals_kernel(*args)
            err = cs.max_err(got, O.sample_tvals_plain(*args))
            if not err <= 1e-5:
                raise SystemExit(f"serve_ab: kernel 3 error {err}")
            return f"max_abs_err={err:.3e}", float(got.double().sum())
        return (lambda: O.sample_tvals_kernel(*args)), check

    skew = torch.from_numpy(cs.skew_frame(cs.SIDE * cs.SIDE)[
        :cs.CHECK_RAYS]).to(device)
    skew_pts = occ_sample_positions(cs.full_occ(device), statics, skew, 32,
                                    importance=True,
                                    hard_mask=False)[0].contiguous()
    segments = segment_inputs(cs, cfg, statics, params, occ, rays, device)

    def coherent(pts_ns):
        args = (cents, pts_ns, True, 1.1)

        def check():
            got = CO.coherent_expert_kernel(*args)
            differ = int((got != CO.coherent_expert_plain(*args)).sum())
            if differ:
                raise SystemExit(f"serve_ab: 10b: {differ} ids differ")
            return (f"ids equal, coherent share "
                    f"{float((got >= 0).float().mean()):.4f}",
                    float(got.double().sum()))
        return (lambda: CO.coherent_expert_kernel(*args)), check

    def composite(args):
        def check():
            got = V.composite_segment(*args)
            want = V.composite_segment_plain(*args)
            err = max(cs.max_err(got[k], want[k]) for k in want)
            if not err <= 1e-5:
                raise SystemExit(f"serve_ab: row 8 error {err}")
            return (f"max_abs_err={err:.3e}",
                    float(sum(v.double().sum() for v in got.values())))
        return (lambda: V.composite_segment(*args)), check

    def dispatch(args):
        def check():
            outs = [CO.bucket_dispatch_kernel(*args) for _ in range(2)]
            want = CO.bucket_dispatch_plain(*args)
            for got in outs:
                for key in ("idx", "dest", "counts", "bucket_rows", "rows"):
                    if not torch.equal(got[key], want[key]):
                        raise SystemExit(f"serve_ab: 10a-i {key} differs")
            err = max(cs.max_err(got["w"], want["w"]) for got in outs)
            if not err <= 1e-6:
                raise SystemExit(f"serve_ab: 10a-i w error {err}")
            return (f"outputs equal on two calls, w max_abs_err={err:.3e}",
                    float(outs[0]["dest"].double().sum()))
        return (lambda: CO.bucket_dispatch_kernel(*args)), check

    def combine_bwd(dispatch_args):
        dsp = CO.bucket_dispatch_kernel(*dispatch_args)
        K, C = dispatch_args[2].shape[0], dispatch_args[-1]
        n = dispatch_args[0].shape[0]
        g = torch.Generator(device=device).manual_seed(13)
        g_s = torch.randn((n,), device=device, generator=g)
        g_r = torch.randn((n, 3), device=device, generator=g)
        args = (CO, dsp["w"], dsp["dest"], dsp["counts"], g_s, g_r, K * C)

        def check():
            got = combine_bwd_call(*args)
            want = CO.bucket_combine_bwd_plain(*args[1:3], *args[4:])
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise SystemExit("serve_ab: 10a-iii differs from its plain "
                                 "version")
            return ("equal to the plain version",
                    float(sum(x.double().sum() for x in got)))
        return (lambda: combine_bwd_call(*args)), check

    def query(grids_q, qpts, mode):
        args = (*grids_q, qpts, mode)

        def check():
            got = O.occupancy_query_kernel(*args)
            want = O.occupancy_query_plain(*args)
            if mode != "pair":
                got, want = (got,), (want,)
            wrong = sum(int((g != w).sum()) for g, w in zip(got, want))
            if wrong:
                raise SystemExit(f"serve_ab: 11q ({mode}): {wrong} outputs "
                                 f"differ from its plain version")
            return ("equal to the plain version",
                    float(sum(g.double().sum() for g in got)))
        return (lambda: O.occupancy_query_kernel(*args)), check

    step_pts = V.t_to_points(so, sd, O.sample_tvals_plain(
        scdf, sn, sf, su)).reshape(-1, 3).contiguous()
    planes = plane_cases(cs, cfg, statics, params, step_pts, device)
    g16 = torch.Generator(device=device).manual_seed(5)
    bin16 = torch.rand((16, 4, 128, 128, 128), generator=g16,
                       device=device) < 0.05
    k16_grids = (torch.where(bin16, 0.1, 0.0), bin16, k16_st.expert_aabbs)
    k16_qpts = k16_pts[:QUERY_K16_PTS].contiguous()
    return [(KERNEL_CASES[0], *sampler((cdf, near, far, u))),
            (KERNEL_CASES[1], *sampler((scdf, sn, sf, su))),
            (KERNEL_CASES[2], *dispatch((pts, dirs, cents, True, 1.1, 1,
                                         CO.bucket_capacity(
                                             pts.shape[0], 4, 1, cs.MOE_CF)))),
            (KERNEL_CASES[3], *dispatch((pts, dirs, cents, True, 1.1, 2,
                                         CO.bucket_capacity(
                                             pts.shape[0], 4, 2, cs.MOE_CF)))),
            (KERNEL_CASES[4], *dispatch(k16)),
            (KERNEL_CASES[5], *coherent(pts_ns)),
            (KERNEL_CASES[6], *coherent(skew_pts)),
            (KERNEL_CASES[7], *composite(segments[0])),
            (KERNEL_CASES[8], *composite(segments[1])),
            (KERNEL_CASES[9], *combine_bwd((pts, dirs, cents, True, 1.1, 2,
                                            CO.bucket_capacity(
                                                pts.shape[0], 4, 2,
                                                cs.MOE_CF)))),
            (KERNEL_CASES[10], *combine_bwd(k16)),
            *((KERNEL_CASES[11 + i], *query(grids, pts, mode))
              for i, mode in enumerate(("bits", "values", "pair"))),
            (KERNEL_CASES[14], *query([g[0:1] for g in grids], step_pts,
                                      "bits")),
            (KERNEL_CASES[15], *query(k16_grids, k16_qpts, "bits")),
            *((KERNEL_CASES[16 + i], *case) for i, case in
              enumerate(planes[:5])),
            (KERNEL_CASES[21], *bwd2_case(cs, cfg, statics, params, sn, sf,
                                          so, sd, scdf, su, device)),
            *((KERNEL_CASES[22 + i], *case) for i, case in
              enumerate(trunc_exp_cases(cs, device))),
            (KERNEL_CASES[27], *planes[5])]


def bwd2_case(cs, cfg, statics, params, near, far, o, d, cdf, u, device):
    """(call, check) of kernel 4'' (the compositor's double backward) at
    one inner step, as chip_smoke's MAML phase takes it: expert 0's first
    support set (4,000 rays x 32 samples through its probe's cdf, jittered
    targets) through expert 0, the rgb upstream of MAML's loss and random
    cotangents from seed 15; held to the plain version within 1e-5 of
    each output's max (chip_smoke's `bwd2_errs`)."""
    import torch

    from nerfsys_tpu_torch.models.container import background_color
    from nerfsys_tpu_torch.models.ngp import ngp_apply
    from nerfsys_tpu_torch.ops import occupancy as O
    from nerfsys_tpu_torch.ops import volrend as V
    from nerfsys_tpu_torch.utils.tree import tree_map

    t_vals = O.sample_tvals_plain(cdf, near, far, u).contiguous()
    N, S = t_vals.shape
    pts = V.t_to_points(o, d, t_vals).reshape(-1, 3)
    expert = tree_map(lambda t: t[0], params["experts"])
    with torch.no_grad():
        rgb, sigma = ngp_apply(expert, cfg.expert, statics.expert_aabbs[0],
                               pts, d[:, None, :].expand(N, S, 3)
                               .reshape(-1, 3))
        bg = background_color(params, cfg, d).contiguous()
    rs = torch.cat([rgb.reshape(N, S, 3), sigma.reshape(N, S, 1)],
                   dim=-1).contiguous()
    gen = torch.Generator(device=device).manual_seed(15)
    grads = (torch.randn((N, 3), device=device, generator=gen), None, None,
             None)
    v_rs = torch.randn((N, S, 4), device=device, generator=gen)
    v_bg = torch.randn((N, 3), device=device, generator=gen)
    args = (rs, t_vals, bg, grads, v_rs, v_bg)

    def check():
        got = V.volume_render_bwd2_kernel(*args)
        errs = cs.bwd2_errs(got, V.volume_render_bwd2_plain(*args), grads,
                            cs.wdot_scale(rs, t_vals, v_rs, 1.0))
        if not all(e <= 1e-5 for _, e in errs):
            raise SystemExit(f"serve_ab: 4'' error {errs}")
        return (" ".join(f"{k}={e:.3e}" for k, e in errs),
                float(sum(x.double().sum() for x in (got[0], got[1],
                                                     got[2][0]))))
    return (lambda: V.volume_render_bwd2_kernel(*args)), check


def trunc_exp_cases(cs, device):
    """(call, check) of row 12 at the sizes the main path launches it (x =
    4 N(0, 1), g and v N(0, 1), from seed 16): the backward beside its
    library call `torch.mul(g, y)` at a bench step's 128,000 points, the
    forward at a frame call's 8,388,608 and at a step's, the second
    derivative at a step's; each kernel held to its plain version bit for
    bit."""
    import torch

    from nerfsys_tpu_torch.ops import activations as TA

    def case(kernel, plain, *args):
        def check():
            got, want = kernel(*args), plain(*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            if not all(cs.bit_equal(a, b) for a, b in zip(got, want)):
                raise SystemExit(f"serve_ab: {kernel.__name__} differs "
                                 f"from its plain version")
            return ("bit-equal to the plain version",
                    float(sum(a.double().nansum() for a in got)))
        return (lambda: kernel(*args)), check

    gen = torch.Generator(device=device).manual_seed(16)
    inputs = {}
    for n in (TRUNC_EXP_FRAME, cs.TRUNC_EXP_STEP):
        x = 4.0 * torch.randn(n, device=device, generator=gen)
        g = torch.randn(n, device=device, generator=gen)
        v = torch.randn(n, device=device, generator=gen)
        inputs[n] = (x, g, v, TA.trunc_exp_fwd_plain(x))
    x, g, v, y = inputs[cs.TRUNC_EXP_STEP]
    return [case(TA.trunc_exp_bwd_kernel, TA.trunc_exp_bwd_plain, g, y),
            case(torch.mul, TA.trunc_exp_bwd_plain, g, y),
            *(case(TA.trunc_exp_fwd_kernel, TA.trunc_exp_fwd_plain,
                   inputs[n][0])
              for n in (TRUNC_EXP_FRAME, cs.TRUNC_EXP_STEP)),
            case(TA.trunc_exp_bwd2_kernel, TA.trunc_exp_bwd2_plain, v, g, x)]


def plane_cases(cs, cfg, statics, params, pts, device):
    """(call, check) of kernels 5'' / 6'' (the plane encoder's double
    backward) at one inner step's 128,000 points (expert 0's support set
    through its probe: light, exact, and the light one on the K=4 stack)
    and of kernels 5 / 6 at the same points, with cotangents from seed
    14; last 5''b (the light one under bfloat16 line matmuls) on one
    expert. 5'' / 6'' are held to the plain version's shares summed in
    float64 (d ct and every table within 1e-5 of its max), 5 / 6 to the
    plain version within 1e-4 of each table's max."""
    import dataclasses

    import torch

    from nerfsys_tpu_torch.models.ngp import world_to_unit
    from nerfsys_tpu_torch.ops import planes as PL

    gen = torch.Generator(device=device).manual_seed(14)
    stack = params["experts"]["planes_enc"]
    one = {k: [t[0] for t in v] for k, v in stack.items()}
    x1 = world_to_unit(pts, statics.expert_aabbs[0],
                       cfg.expert.enc_eps).contiguous()
    xk = world_to_unit(pts, statics.expert_aabbs,
                       cfg.expert.enc_eps).contiguous()
    D = cfg.expert.planes.out_dim

    def rnd(shape):
        return torch.randn(shape, device=device, generator=gen)

    def bwd2(tabs, x, pos_grad, lines_bf16=False):
        pc = dataclasses.replace(cfg.expert.planes, pos_grad=pos_grad)
        if lines_bf16:
            pc = dataclasses.replace(pc, lines_matmul=True,
                                     lines_mm_dtype="bfloat16")
        ct = rnd((*x.shape[:-1], D))
        v = {k: [rnd(t.shape) for t in ts] for k, ts in tabs.items()}
        args = (tabs, x, ct, v, pc)

        def check():
            got = PL.plane_encode_bwd2_kernel(*args)
            want = PL.plane_encode_bwd2_plain(*args,
                                              sum_dtype=torch.float64)
            outs = [got[0], *got[1], *got[2]]
            errs = [cs.rel_err(a, b) for a, b in zip(
                outs, [want[0], *want[1], *want[2]])]
            if not max(errs) <= 1e-5:
                raise SystemExit(f"serve_ab: 5''/6'' error {errs}")
            return (f"err/max d ct {errs[0]:.3e} tables {max(errs[1:]):.3e}",
                    float(sum(t.double().sum() for t in outs)))
        return (lambda: PL.plane_encode_bwd2_kernel(*args)), check

    def bwd(tabs, x, pos_grad):
        pc = dataclasses.replace(cfg.expert.planes, pos_grad=pos_grad)
        args = (tabs, x, rnd((*x.shape[:-1], D)), pc)

        def check():
            got = PL.plane_encode_bwd_kernel(*args)
            want = PL.plane_encode_bwd_plain(*args)
            errs = [cs.rel_err(a, b) for a, b in zip(
                got[0] + got[1], want[0] + want[1])]
            if not max(errs) <= 1e-4:
                raise SystemExit(f"serve_ab: kernel 5/6 error {errs}")
            return (f"tables err/max {max(errs):.3e}",
                    float(sum(t.double().sum() for t in got[0] + got[1])))
        return (lambda: PL.plane_encode_bwd_kernel(*args)), check

    return [bwd2(one, x1, False), bwd2(one, x1, True), bwd2(stack, xk, False),
            bwd(one, x1, False), bwd(one, x1, True),
            bwd2(one, x1, False, lines_bf16=True)]


def profile_frames(cs, cfg, statics, params, occ, device, root: Path):
    """One profiled frame a side, after a warm-up: the soft early-stop
    renderer at sigma_scale 1 (chip_smoke's first pose; row 8) and the
    coherent renderer on the skew-0.9 frame with the hash experts
    (chip_smoke's `coherent_frames` without the union grid; 10b)."""
    from nerfsys_tpu_torch.pipelines.online.runtime_adapt import (
        make_chunk_renderer,
        make_coherent_renderer,
        render_image,
        render_rays_chunked,
    )

    S, chunk = 32, cs.CHUNK or cs.CHECK_RAYS
    aabb = statics.global_aabb.cpu().numpy()
    md = cs.pose((0.0, 0.0, 2.0))
    ren = make_chunk_renderer(cfg, ray_samples=S, occ_state=occ,
                              occ_importance=True, occ_hard_mask=False,
                              early_stop_eps=cs.ES_EPS, sigma_scale=1.0,
                              device=device)

    def frame():
        render_image(ren, params, statics, md, scene_aabb=aabb,
                     chunk_rays=chunk)

    frame()
    cs.profile_device(f"{root} early-stop frame (soft, sigma_scale=1)",
                      frame, watch=(("composite_segment_kernel",),))
    hcfg, hparams = cs.hash_setup(device)
    coh = make_coherent_renderer(hcfg, ray_samples=S,
                                 occ_state=cs.full_occ(device),
                                 occ_importance=True, occ_hard_mask=False,
                                 device=device)
    rays = cs.skew_frame(cs.SIDE * cs.SIDE)

    def skew():
        render_rays_chunked(coh, hparams, statics, rays, chunk)

    skew()
    cs.profile_device(f"{root} coherent skew frame", skew,
                      watch=(("coherent_expert_kernel",),))


def kernel_rounds(cs, cfg, statics, params, occ, device, root: Path) -> int:
    cases = kernel_cases(cs, cfg, statics, params, occ, device)
    check = 0.0
    for name, call, check_fn in cases:
        text, total = check_fn()
        check += total
        print(f"{root} {name}: {text}", flush=True)
    print(json.dumps({"ready": "kernels"}), flush=True)
    for line in sys.stdin:
        if line.strip() == "profile":  # one side at a time
            for name, call, _ in cases[2:5] + cases[9:11]:
                cs.profile_device(f"{root} {name}, 10 calls",
                                  lambda: [call() for _ in range(10)],
                                  watch=(("bucket",), ("Memset",),
                                         ("Fill",)))
            profile_frames(cs, cfg, statics, params, occ, device, root)
            print(json.dumps({"profiled": True}), flush=True)
            continue
        if line.strip() != "run":
            break
        ms = [cs.device_ms(call) for _, call, _ in cases]
        b2b = [cs.cuda_ms(call, 20) for _, call, _ in cases]
        print(json.dumps({"ms": ms, "b2b_ms": b2b, "raygen_ms": 0.0,
                          "check": check}), flush=True)
    return 0


def _reply(proc) -> dict:
    """The worker's next JSON line (other lines pass through)."""
    while True:
        line = proc.stdout.readline()
        if not line:
            raise SystemExit(f"serve_ab: worker {proc.args[-1]} ended")
        if line.startswith("{"):
            return json.loads(line)
        print(line, end="")


def summarize(rounds, roots):
    """Per side: median, quartiles and range of the round means; and the
    verdict of this side against the other, pair by pair."""
    summary = {}
    for name in SIDES:
        means = [r["mean_ms"] for r in rounds[name]]
        q1, med, q3 = statistics.quantiles(means, n=4)
        summary[name] = {
            "root": str(roots[name]), "round_mean_ms": means,
            "median_ms": med, "q1_ms": q1, "q3_ms": q3,
            "min_ms": min(means), "max_ms": max(means),
            "raygen_median_ms": statistics.median(
                r["raygen_ms"] for r in rounds[name]),
            "check": rounds[name][-1]["check"]}
    o, t = summary["other"], summary["this"]
    verdict = {
        "median_diff_ms": t["median_ms"] - o["median_ms"],
        "other_quartile_spread_ms": o["q3_ms"] - o["q1_ms"],
        "this_median_inside_other_range": (
            o["min_ms"] <= t["median_ms"] <= o["max_ms"]),
        "pairs_this_faster": sum(a < b for a, b in zip(
            t["round_mean_ms"], o["round_mean_ms"])),
        "pairs": len(rounds["this"])}
    return summary, verdict


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="the other checkout's root")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--experts", choices=("planes", "hash"), default=None,
                    help="planes (the default) or hash")
    ap.add_argument("--phase", choices=("frame", "step", "kernels"),
                    default="frame")
    ap.add_argument("--exact", action="store_true",
                    help="planes experts with the exact encoder backward")
    ap.add_argument("--packed", action="store_true",
                    help="hash experts reading the table as bfloat16 pairs")
    ap.add_argument("--maml", action="store_true",
                    help="--phase step: second-order MAML steps")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.packed and args.experts == "planes":
        ap.error("--packed takes the hash experts")
    args.experts = args.experts or ("hash" if args.packed else "planes")
    if args.worker:
        return worker(args.other.resolve(), args.experts, args.phase,
                      args.exact, args.packed, args.maml)
    if args.pairs < 2:
        ap.error("--pairs must be at least 2 (quartiles)")
    if args.exact and (args.experts, args.phase) != ("planes", "step"):
        ap.error("--exact takes --experts planes --phase step")
    if args.maml and args.phase != "step":
        ap.error("--maml takes --phase step")
    import torch

    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device available", file=sys.stderr)
        return 1
    roots = {"other": args.other.resolve(),
             "this": Path(__file__).resolve().parent}
    for name, root in roots.items():
        if not (root / "chip_smoke.py").is_file():
            print(f"serve_ab: no chip_smoke.py in {root}", file=sys.stderr)
            return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    procs = {name: subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--worker",
         "--experts", args.experts, "--phase", args.phase,
         *(["--exact"] if args.exact else []),
         *(["--packed"] if args.packed else []),
         *(["--maml"] if args.maml else []), str(root)],
        stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, text=True) for name, root in roots.items()}
    try:
        for name in SIDES:
            _reply(procs[name])
        if args.phase in ("kernels", "step"):
            for name in SIDES:
                procs[name].stdin.write("profile\n")
                procs[name].stdin.flush()
                _reply(procs[name])
        rounds = {name: [] for name in SIDES}
        for i in range(args.pairs):
            for name in (SIDES if i % 2 == 0 else SIDES[::-1]):
                procs[name].stdin.write("run\n")
                procs[name].stdin.flush()
                r = _reply(procs[name])
                r["mean_ms"] = sum(r["ms"]) / len(r["ms"])
                rounds[name].append(r)
                print(f"round {i} {name}: ms_per_{args.phase}="
                      f"{[round(x, 2) for x in r['ms']]} mean_ms="
                      f"{r['mean_ms']:.2f} raygen_ms={r['raygen_ms']:.2f}",
                      flush=True)
    finally:
        for p in procs.values():
            if p.stdin and not p.stdin.closed:
                p.stdin.close()
        for p in procs.values():
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    summary, verdict = summarize(rounds, roots)
    if args.phase == "kernels":
        for i, case in enumerate(KERNEL_CASES):
            for key, what in (("ms", "device_ms"), ("b2b_ms", "b2b_ms")):
                text = []
                for name in SIDES:
                    xs = [r[key][i] for r in rounds[name]]
                    text.append(f"{name} median {statistics.median(xs):.4f} "
                                f"range [{min(xs):.4f}, {max(xs):.4f}]")
                print(f"kernels {case} {what}: " + "; ".join(text),
                      flush=True)
    for name in SIDES:
        s = summary[name]
        print(f"{name}: median_ms={s['median_ms']:.2f} quartiles_ms="
              f"[{s['q1_ms']:.2f}, {s['q3_ms']:.2f}] range_ms="
              f"[{s['min_ms']:.2f}, {s['max_ms']:.2f}] "
              f"raygen_median_ms={s['raygen_median_ms']:.2f} "
              f"({s['root']})")
    print(f"this - other median: {verdict['median_diff_ms']:.2f} ms; "
          f"other's quartile spread {verdict['other_quartile_spread_ms']:.2f}"
          f" ms; this faster in {verdict['pairs_this_faster']} of "
          f"{args.pairs} pairs")
    print(json.dumps({"serve_ab": summary, "verdict": verdict,
                      "experts": args.experts, "phase": args.phase,
                      "exact": args.exact, "packed": args.packed,
                      "maml": args.maml}))
    print(card)
    a, b = summary["this"]["check"], summary["other"]["check"]
    if abs(a - b) > 1e-4 * max(1.0, abs(b)):
        print(f"serve_ab: the two checkouts differ: "
              f"{'mean colour' if args.phase == 'frame' else 'loss'} "
              f"{a} against {b}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
