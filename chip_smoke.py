#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (nerfsys_tpu_torch) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order (any failure raises and the script exits non-zero before
printing its result lines):

1. Card: name and power limit (nvidia-smi).
2. Build: compile every kernel source in nerfsys_tpu_torch/csrc with nvcc
   (one process per source, all at once) and report the seconds.
3. Kernels: hold each forward kernel against its plain PyTorch version on
   the card at one full serve chunk (65,536 rays, S=32 samples, P=128
   probes; K=4 experts at bench width; R=128, L=4 occupancy grids half
   occupied), and each backward kernel at one full inner step of one
   bench-width expert (4,000 rays x 32 samples), and time both with CUDA
   events.
4. Serve: a soft-occupancy chunk renderer at bench width renders one
   warm-up frame and then 3 requests of 800x800 frames through
   `render_image`. Every output must be finite with rgb and acc in [0, 1],
   every serving kernel's launch counter must have moved during the 3
   requests, and one chunk rendered through the kernels must match the
   same chunk rendered through the plain versions.
5. Train: bench.py's FoMAML configuration (K=4, B=3 tasks, 4,000 support
   and 2,000 query rays, 8 inner steps, 32 soft-occupancy samples, the
   light encoder backward) through `make_train_step`: one warm-up step,
   3 timed outer steps, then one step with the encoder's default exact
   backward (pos_grad=True). Loss finite, no step skipped, params moved,
   every kernel's launch counter moved; one step's gradients through the
   kernels match the same step through the plain versions
   (`make_train_step(..., use_kernels=False)`); one step is profiled.
6. A JSON line listing every kernel (launches, error, times, bound).
7. The card line, then the last line:
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

It imports neither jax nor nerfsys_tpu. Weights are random, from a seed.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
SEED = 0
SIDE = 800  # served frame side
CHECK_RAYS = 65536  # rays of the kernel-check chunk (one full serve chunk)
CHUNK = None  # serve chunk; None = default_chunk_rays(32) = 65536


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors) -> int:
    total = 0
    for t in tensors:
        if isinstance(t, (list, tuple)):
            total += nbytes(*t)
        elif t is not None:
            total += t.numel() * t.element_size()
    return total


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def bench_setup(device):
    """The bench-width soft-occupancy serve configuration (K=4)."""
    import torch

    from nerfsys_tpu_torch.models.container import (
        ContainerConfig,
        ContainerStatics,
        init_container_params,
    )
    from nerfsys_tpu_torch.models.ngp import NGPConfig
    from nerfsys_tpu_torch.ops.occupancy import OccGridConfig, init_occ_state
    from nerfsys_tpu_torch.ops.planes import PlaneEncodingConfig

    expert = NGPConfig(
        hidden=64, sigma_depth=2, color_hidden=64, color_depth=2,
        geo_feat_dim=15, sh_levels=4,
        planes=PlaneEncodingConfig(levels=3, base_res=128, growth=2.0,
                                   features=8, pos_grad=False))
    cfg = ContainerConfig(num_experts=4, expert=expert, boundary_margin=1.1,
                          bg_hidden=32)
    cents = torch.tensor([[0.0, -1, -1], [0.0, -1, 1], [0.0, 1, -1],
                          [0.0, 1, 1]])
    boxes = torch.stack([torch.stack([c - 1.2, c + 1.2]) for c in cents])
    statics = ContainerStatics(cents, boxes, torch.tensor(
        [[-2.2, -2.2, -2.2], [2.2, 2.2, 2.2]])).to(device)
    params = init_container_params(cfg, seed=SEED, device=device)
    occ = init_occ_state(OccGridConfig(resolution=128, levels=4,
                                       warmup_steps=0), 4, device=device)
    gen = torch.Generator().manual_seed(2)
    binary = torch.rand(occ["binary"].shape, generator=gen) < 0.5
    occ["binary"] = binary.to(device)
    occ["occs"] = torch.where(binary, 0.1, 0.0).to(device)
    occ["num_updates"] = torch.tensor(1000, dtype=torch.int32, device=device)
    return cfg, statics, params, occ


def pose(t):
    import numpy as np

    W = H = SIDE
    c2w = np.array([[1, 0, 0, t[0]], [0, 1, 0, t[1]], [0, 0, 1, t[2]]],
                   np.float32)
    return SimpleNamespace(H=H, W=W, c2w=c2w, intrinsics=np.array(
        [W * 0.8, W * 0.8, W / 2, H / 2], np.float32))


def check_kernels(cfg, statics, params, occ, rays_np, device):
    """Phase 3: every kernel against its plain version at one full chunk."""
    import torch

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.models.container import container_apply
    from nerfsys_tpu_torch.models.ngp import world_to_unit
    from nerfsys_tpu_torch.models.occupancy import _ray_validity
    from nerfsys_tpu_torch.ops import occupancy as O
    from nerfsys_tpu_torch.ops import planes as PL
    from nerfsys_tpu_torch.ops import volrend as V

    P, S = 128, 32
    rays = torch.from_numpy(rays_np).to(device)
    o, d = rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous()
    valid, near, far = _ray_validity(rays)
    N = rays.shape[0]
    K, L, R = occ["occs"].shape[:3]
    grids = (occ["occs"], occ["binary"], statics.expert_aabbs)
    results = {}

    def report(kern, err, tol, why, ms, plain_ms, n_bytes, n_ops, extra=""):
        b_ms, b_by = bound(n_bytes, n_ops)
        text = (f"max_abs_err={err:.3e} tol={tol:g} ({why}) "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"bytes={n_bytes} bound_ms={b_ms:.4f} ({b_by}) at "
                f"{HBM_BYTES_PER_S / 1e12:g} TB/s{extra}")
        if not err <= tol:
            print(f"kernel {kern.name}: {text}", flush=True)
            raise SystemExit(f"kernel {kern.name} disagrees with its plain "
                             f"version: {err} > {tol}")
        results[kern.name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b_ms, bound_by=b_by, text=text)

    # kernel 2: union probe + CDF (soft mode: importance, uf .25, rf .25)
    probe_kw = dict(n_probes=P, importance=True, uniform_frac=0.25,
                    ray_floor=0.25)
    ker = O.occupancy_probe_cdf_kernel(*grids, o, d, near, far, **probe_kw)
    pln = O.occupancy_probe_cdf(*grids, o, d, near, far, **probe_kw,
                                use_kernels=False)
    torch.cuda.synchronize()
    flips = int((ker["occ"] != pln["occ"]).sum())
    alive_flips = int((ker["alive"] != pln["alive"]).sum())
    if flips or alive_flips:
        raise SystemExit(f"probe kernel selects other cells than the plain "
                         f"version: {flips} probe bits, {alive_flips} rays")
    report(kernels.OCC_PROBE_CDF, max_err(ker["cdf"], pln["cdf"]), 1e-5,
           "cdf in [0,1]; warp scan vs torch.cumsum summation order",
           cuda_ms(lambda: O.occupancy_probe_cdf_kernel(
               *grids, o, d, near, far, **probe_kw), 10),
           cuda_ms(lambda: O.occupancy_probe_cdf(
               *grids, o, d, near, far, **probe_kw, use_kernels=False), 3),
           nbytes(occ["occs"], occ["binary"], o, d, near, far, ker["cdf"],
                  ker["alive"], ker["occ"]),
           N * P * (9 + K * L * 14) + N * P * 12,
           extra=f" occ_bit_flips={flips}")

    # kernel 3: the sampler, fed the same cdf on both sides
    cdf_state = {"cdf": pln["cdf"], "alive": pln["alive"]}
    u = O._sample_targets(N, S, device, None, False).contiguous()
    t_ker = O.sample_tvals_kernel(pln["cdf"], near, far, u)
    t_pln = O.sample_tvals_plain(pln["cdf"], near, far, u)
    report(kernels.OCC_SAMPLE, max_err(t_ker, t_pln), 1e-5,
           "t up to ~6 in float32: a few ulp",
           cuda_ms(lambda: O.sample_tvals_kernel(pln["cdf"], near, far, u),
                   10),
           cuda_ms(lambda: O.sample_tvals_plain(pln["cdf"], near, far, u), 3),
           nbytes(pln["cdf"], near, far, u, t_ker),
           N * S * (P + 8) + N * S * S)

    # kernel 1: the plane/line encoder at the chunk's sample points, K=4
    t_vals, _ = O.sample_tvals_from_cdf(cdf_state, near, far, S)
    pts = V.t_to_points(o, d, t_vals).reshape(-1, 3)
    x01 = world_to_unit(pts, statics.expert_aabbs, cfg.expert.enc_eps)
    enc_p = params["experts"]["planes_enc"]
    pc = cfg.expert.planes
    e_ker = PL.plane_encode_kernel(enc_p, x01, pc)
    e_pln = PL.plane_encode_plain(enc_p, x01, pc)
    n_out = e_ker.numel()
    report(kernels.PLANES_FWD, max_err(e_ker, e_pln), 1e-5,
           "features O(0.3); fused multiply-adds vs separate torch ops",
           cuda_ms(lambda: PL.plane_encode_kernel(enc_p, x01, pc), 10),
           cuda_ms(lambda: PL.plane_encode_plain(enc_p, x01, pc), 3),
           nbytes(x01, enc_p["planes"], enc_p["lines"], e_ker),
           n_out * 15 + (n_out // pc.features) * 20)
    del e_ker, e_pln

    # kernel 4: the compositor on the chunk's routed field values
    dirs = d[:, None, :].expand(N, S, 3).reshape(-1, 3)
    rgb, sigma = container_apply(params, cfg, statics, pts, dirs,
                                 use_kernels=False)
    rgb_sigma = torch.cat([rgb.reshape(N, S, 3),
                           torch.where(valid[:, None], sigma.reshape(N, S),
                                       0.0)[..., None]], dim=-1)
    bg = torch.rand((N, 3), device=device)
    out_k = V.volume_render_kernel(rgb_sigma, t_vals, bg)
    out_p = V.volume_render_plain(rgb_sigma, t_vals, bg)
    err = max(max_err(out_k[0], out_p[0]), max_err(out_k[2], out_p[2]),
              max_err(out_k[3], out_p[3]), max_err(out_k[1], out_p[1]) / 10)
    report(kernels.VOLREND_FWD, err, 1e-5,
           "rgb/weights/acc in [0,1] and depth/10 (t <= ~6): sums of 32 "
           "products in another order than torch.sum",
           cuda_ms(lambda: V.volume_render_kernel(rgb_sigma, t_vals, bg), 10),
           cuda_ms(lambda: V.volume_render_plain(rgb_sigma, t_vals, bg), 3),
           nbytes(rgb_sigma, t_vals, bg, out_k),
           N * S * 24)
    return results


TRAIN_K, TRAIN_B, TRAIN_S, TRAIN_Q, TRAIN_INNER = 4, 3, 4000, 2000, 8


def train_batch(device):
    """bench.py's synthetic episode (numpy seed 0), on the card."""
    import numpy as np
    import torch

    K, B = TRAIN_K, TRAIN_B
    rng = np.random.default_rng(0)

    def rays(n):
        o = rng.normal(size=(K, B, n, 3)).astype(np.float32) * 0.3
        d = rng.normal(size=(K, B, n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        nf = np.tile(np.array([0.1, 2.5], np.float32), (K, B, n, 1))
        return np.concatenate([o, d, nf], -1)

    batch = {
        "support_rays": rays(TRAIN_S),
        "support_rgbs": rng.uniform(size=(K, B, TRAIN_S, 3)).astype(
            np.float32),
        "query_rays": rays(TRAIN_Q),
        "query_rgbs": rng.uniform(size=(K, B, TRAIN_Q, 3)).astype(
            np.float32),
        "valid": np.ones((K, B), np.float32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train_meta():
    from nerfsys_tpu_torch.pipelines.offline.meta_core import MetaConfig

    return MetaConfig(algo="fomaml", inner_iter=TRAIN_INNER, inner_lr=0.015,
                      ray_samples=32, occ_importance=True,
                      occ_hard_mask=False)


def rel_err(got, want) -> float:
    """max |got - want| over max |want| (the gradient's own scale)."""
    return max_err(got, want) / max(float(want.double().abs().max()), 1e-30)


def check_train_kernels(cfg, statics, params, occ, batch, device, results):
    """Phase 3, backward kernels: at one full inner step of one bench-width
    expert (expert 0's first support set: 4,000 rays x 32 samples, its
    K=1 probe, randomized samples), each against its plain version."""
    import dataclasses

    import torch

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.models.container import background_color
    from nerfsys_tpu_torch.models.ngp import ngp_apply, world_to_unit
    from nerfsys_tpu_torch.ops import occupancy as O
    from nerfsys_tpu_torch.ops import planes as PL
    from nerfsys_tpu_torch.ops import volrend as V
    from nerfsys_tpu_torch.utils.tree import tree_map

    S = 32
    rays = batch["support_rays"][0, 0]
    o, d = rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous()
    near, far = rays[:, 6].contiguous(), rays[:, 7].contiguous()
    N = rays.shape[0]
    grid = (occ["occs"][0:1], occ["binary"][0:1], statics.expert_aabbs[0:1])
    cdf = O.occupancy_probe_cdf(*grid, o, d, near, far, 128, importance=True,
                                ray_floor=0.25)
    gen = torch.Generator(device=device).manual_seed(3)
    t_vals, _ = O.sample_tvals_from_cdf(cdf, near, far, S, generator=gen,
                                        randomized=True)
    pts = V.t_to_points(o, d, t_vals).reshape(-1, 3)
    expert = tree_map(lambda t: t[0], params["experts"])
    aabb = statics.expert_aabbs[0]

    def report(kern, checks, why, ms, plain_ms, n_bytes, n_ops):
        """checks: (label, got, want, tol on max error / max |want|)."""
        b_ms, b_by = bound(n_bytes, n_ops)
        rels = [(label, rel_err(a, b), tol) for label, a, b, tol in checks]
        abs_err = max(max_err(a, b) for _, a, b, _ in checks)
        text = (" ".join(f"{label}_err/max={r:.3e} tol={tol:g}"
                         for label, r, tol in rels)
                + f" max_abs_err={abs_err:.3e} ({why}) kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} bytes={n_bytes} "
                f"bound_ms={b_ms:.4f} ({b_by}) at "
                f"{HBM_BYTES_PER_S / 1e12:g} TB/s")
        if not all(r <= tol for _, r, tol in rels):
            print(f"kernel {kern.name}: {text}", flush=True)
            raise SystemExit(f"kernel {kern.name} disagrees with its plain "
                             f"version: {rels}")
        results[kern.name] = dict(max_abs_err=abs_err, ms=ms,
                                  plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=b_by, text=text)

    # kernel 4's VJP, rgb the only upstream (as on the loss path)
    with torch.no_grad():
        rgb, sigma = ngp_apply(expert, cfg.expert, aabb, pts,
                               d[:, None, :].expand(N, S, 3).reshape(-1, 3))
        bg = background_color(params, cfg, d).contiguous()
    rgb_sigma = torch.cat([rgb.reshape(N, S, 3), sigma.reshape(N, S, 1)],
                          dim=-1).contiguous()
    g_rgb = torch.randn((N, 3), device=device, generator=gen)
    grads = (g_rgb, None, None, None)
    k_rs, k_bg = V.volume_render_bwd_kernel(rgb_sigma, t_vals, bg, grads)
    p_rs, p_bg = V.volume_render_bwd_plain(rgb_sigma, t_vals, bg, grads)
    report(kernels.VOLREND_BWD,
           [("rgb_sigma", k_rs, p_rs, 1e-5), ("bg", k_bg, p_bg, 1e-5)],
           "relative to each gradient's max: a division-free reverse scan vs "
           "torch's cumprod backward, other summation orders",
           cuda_ms(lambda: V.volume_render_bwd_kernel(rgb_sigma, t_vals, bg,
                                                      grads), 20),
           cuda_ms(lambda: V.volume_render_bwd_plain(rgb_sigma, t_vals, bg,
                                                     grads), 5),
           nbytes(rgb_sigma, t_vals, bg, g_rgb, k_rs, k_bg), N * S * 40)

    # kernels 5 and 6: the encoder VJPs, one expert's tables (3 levels)
    enc = expert["planes_enc"]
    x01 = world_to_unit(pts, aabb, cfg.expert.enc_eps).contiguous()
    P = x01.shape[0]
    ct = torch.randn((P, cfg.expert.planes.out_dim), device=device,
                     generator=gen)
    tables = list(enc["planes"]) + list(enc["lines"])
    # the exact tables differ from the light ones only by the bf16 rounding
    # of the residuals: the light check must be tighter than that gap
    exact = PL.plane_encode_bwd_plain(
        enc, x01, ct, dataclasses.replace(cfg.expert.planes, pos_grad=True))
    for kern, pos_grad, tol, why in (
            (kernels.PLANES_BWD_LIGHT, False, 1e-4,
             "relative to each table's max; bf16 residuals round alike "
             "(--fmad=false), fp32 atomics add in another order: ~6e-6 "
             "measured; the tolerance must stay below the light-exact gap"),
            (kernels.PLANES_BWD, True, 1e-4,
             "relative to each gradient's max; fp32 atomics add up to "
             "thousands of cancelling shares per line row, and the position "
             "gradient sums 9 blocks of differences times R-1, in another "
             "order than index_add_ and torch.sum: ~5e-6 measured")):
        pc = dataclasses.replace(cfg.expert.planes, pos_grad=pos_grad)
        got = PL.plane_encode_bwd_kernel(enc, x01, ct, pc)
        want = PL.plane_encode_bwd_plain(enc, x01, ct, pc)
        checks = [(f"{key}{l}", a, b, tol) for key, i in (("plane", 0),
                                                        ("line", 1))
                  for l, (a, b) in enumerate(zip(got[i], want[i]))]
        if pos_grad:
            checks.append(("x", got[2], want[2], tol))
        else:
            gap = min(rel_err(w, e) for w, e in zip(want[0] + want[1],
                                                    exact[0] + exact[1]))
            why += f"; light-exact gap/max >= {gap:.3e}"
            if not gap > 2 * tol:
                raise SystemExit(f"kernel {kern.name}: the light tables are "
                                 f"within {gap} of the exact ones, so its "
                                 f"check at {tol} cannot tell them apart")
        n_out = sum(t.numel() for t in got[0] + got[1])
        report(kern, checks, why,
               cuda_ms(lambda: PL.plane_encode_bwd_kernel(enc, x01, ct, pc),
                       10),
               cuda_ms(lambda: PL.plane_encode_bwd_plain(enc, x01, ct, pc),
                       3),
               nbytes(x01, ct, tables, got[0], got[1],
                      got[2] if pos_grad else None),
               P * 9 * cfg.expert.planes.features * (30 if pos_grad else 24)
               + n_out)
        del got, want, checks
    del exact


class GradRecorder:
    """Wraps an optimizer and keeps the gradients each step hands it."""

    def __init__(self, opt):
        self.opt, self.grads = opt, []

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params=None):
        self.grads.append(grads)
        return self.opt.update(grads, state, params)


def grads_through_plain_match(meta, cfg, opt, statics, params, occ, batch,
                              device):
    """One outer step's gradients (all B tasks) through the kernels against
    the same step through the plain versions, both through `make_train_step`
    on the card, from the same random draws (one generator seed each)."""
    import torch

    from nerfsys_tpu_torch.pipelines.offline.meta_train_step import (
        make_train_step,
    )
    from nerfsys_tpu_torch.utils.tree import tree_leaves

    out = []
    for use_kernels in (True, False):
        rec = GradRecorder(opt)
        gen = torch.Generator(device=device).manual_seed(7)
        _, _, aux = make_train_step(meta, cfg, rec, use_kernels=use_kernels)(
            params, rec.init(params), statics, batch, gen, occ)
        out.append((float(aux["loss_out_meta"]), tree_leaves(rec.grads[0])))
    (lk, gk), (lp, gp) = out
    errs = [rel_err(a, b) for a, b in zip(gk, gp)]
    tol = 2.0**-8
    print(f"train: one step through kernels vs plain: loss {lk:.7f} vs "
          f"{lp:.7f}; gradient error / leaf max: worst {max(errs):.3e} "
          f"median {sorted(errs)[len(errs) // 2]:.3e} over {len(errs)} "
          f"leaves (tol {tol:g}: 8 inner SGD steps carry encoder rounding "
          f"and bf16 residual flips, 2^-8 each, into the query gradients)",
          flush=True)
    if abs(lk - lp) > 1e-4 * abs(lp) or not max(errs) <= tol:
        raise SystemExit("train: kernel path gradients disagree with the "
                         "plain path")


def profile_step(step, args):
    """Where one outer step's time goes: device time by kernel under
    torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, aux = step(*args)
        float(aux["loss_out"])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if busy_ms > 0:
        print(f"profile: train step wall_ms={wall_ms:.2f} (profiled) "
              f"device_busy_ms={busy_ms:.2f} "
              f"idle_share={1 - busy_ms / wall_ms:.3f}", flush=True)
        for dev_ms, key, count in rows[:12]:
            print(f"profile: {dev_ms:9.3f} ms {count:6d}x {key[:90]}")
    else:
        print(f"profile: device time not measured (the profiler saw no "
              f"device events); train step wall_ms={wall_ms:.2f}",
              flush=True)


def train(cfg, statics, params, occ, batch, device):
    """Phase 5: bench.py's FoMAML step through the port's entry point, the
    counters zeroed just before the timed steps and read just after the
    exact-backward step."""
    import dataclasses
    import math

    import torch

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.models.container import param_group_labels
    from nerfsys_tpu_torch.pipelines.offline.meta_train_step import (
        make_train_step,
    )
    from nerfsys_tpu_torch.utils.optim import OptimConfig, build_optimizer
    from nerfsys_tpu_torch.utils.tree import tree_leaves

    meta = train_meta()
    opt = build_optimizer(OptimConfig(outer_steps=10000),
                          param_group_labels(params))
    step = make_train_step(meta, cfg, opt)
    gen = torch.Generator(device=device).manual_seed(1)
    state = opt.init(params)
    p, state, aux = step(params, state, statics, batch, gen, occ)  # warm-up
    float(aux["loss_out"])

    kernels.reset_launches()
    times, losses = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        p, state, aux = step(p, state, statics, batch, gen, occ)
        losses.append(float(aux["loss_out"]))  # host sync ends the step
        times.append(time.perf_counter() - t0)
        if not math.isfinite(losses[-1]) or float(
                aux["skipped_nonfinite"]) != 0.0:
            raise SystemExit(f"train: step not finite: {aux}")
    light = kernels.launches()
    # the encoder's default exact backward (pos_grad=True), one step
    cfg_exact = dataclasses.replace(cfg, expert=dataclasses.replace(
        cfg.expert, planes=dataclasses.replace(cfg.expert.planes,
                                               pos_grad=True)))
    _, _, aux_x = make_train_step(meta, cfg_exact, opt)(
        p, state, statics, batch, gen, occ)
    loss_x = float(aux_x["loss_out"])
    launches = kernels.launches()
    print(f"train: launches during 3 bench steps {light}", flush=True)
    print(f"train: launches after the exact-backward step {launches}",
          flush=True)
    if not math.isfinite(loss_x) or float(aux_x["skipped_nonfinite"]):
        raise SystemExit("train: exact-backward step not finite")
    for name, n in launches.items():
        if n <= 0:
            raise SystemExit(f"train: kernel {name} never launched")
    moved = [float((a - b).abs().max()) > 0
             for a, b in zip(tree_leaves(p), tree_leaves(params))]
    if not all(moved):
        raise SystemExit(f"train: {moved.count(False)} param leaves did not "
                         f"move")

    grads_through_plain_match(meta, cfg, opt, statics, params, occ, batch,
                              device)
    profile_step(step, (p, state, statics, batch, gen, occ))

    ms = [1e3 * t for t in times]
    n_rays = TRAIN_K * TRAIN_B * (TRAIN_S * TRAIN_INNER + TRAIN_Q)
    print(f"train: fomaml K={TRAIN_K} B={TRAIN_B} S={TRAIN_S} Q={TRAIN_Q} "
          f"inner={TRAIN_INNER} samples=32 ms_per_step="
          f"{[round(x, 2) for x in ms]} mean_ms={sum(ms) / 3:.2f} "
          f"rays_per_s={n_rays / (sum(times) / 3):.1f} "
          f"(rays/step {n_rays}) loss_out={losses} "
          f"grad_norm={float(aux['grad_norm']):.4f} "
          f"exact_step_loss_out={loss_x:.6f}", flush=True)
    return light, launches


def profile_frame(renderer, params, statics, md, aabb, chunk):
    """Where one served frame's time goes: host ray generation, and the
    device time by kernel under torch.profiler (one extra frame, after the
    launch counts were read)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nerfsys_tpu_torch.data.ram_rays import frame_rays
    from nerfsys_tpu_torch.pipelines.online.runtime_adapt import render_image

    t0 = time.perf_counter()
    frame_rays(md.H, md.W, md.intrinsics, md.c2w, aabb=aabb)
    raygen_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_image(renderer, params, statics, md, scene_aabb=aabb,
                     chunk_rays=chunk)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue  # host-side ops carry their kernels' time too
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if busy_ms > 0:
        print(f"profile: frame wall_ms={wall_ms:.2f} (profiled) "
              f"device_busy_ms={busy_ms:.2f} "
              f"idle_share={1 - busy_ms / wall_ms:.3f} "
              f"host_raygen_ms={raygen_ms:.2f}", flush=True)
        for dev_ms, key, count in rows[:12]:
            print(f"profile: {dev_ms:9.3f} ms {count:5d}x {key[:90]}")
    else:
        print(f"profile: device time not measured (the profiler saw no "
              f"device events); frame wall_ms={wall_ms:.2f} "
              f"host_raygen_ms={raygen_ms:.2f}", flush=True)


SERVE_KERNELS = ("plane_encode_fwd", "occupancy_probe_cdf",
                 "sample_tvals_from_cdf", "volume_render_fwd")


def serve(cfg, statics, params, occ, device):
    """Phase 4: 3 requests of 800x800 frames through the port's entry
    points, the counters zeroed just before them and read just after."""
    import numpy as np
    import torch

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.data.ram_rays import frame_rays
    from nerfsys_tpu_torch.pipelines.online.runtime_adapt import (
        default_chunk_rays,
        make_chunk_renderer,
        render_image,
    )

    S = 32
    chunk = CHUNK or default_chunk_rays(S)
    aabb = statics.global_aabb.cpu().numpy()
    renderer = make_chunk_renderer(cfg, ray_samples=S, occ_state=occ,
                                   occ_importance=True, occ_hard_mask=False,
                                   device=device)
    poses = [pose((0.0, 0.0, 2.0)), pose((0.1, 0.0, 2.0)),
             pose((0.0, -0.1, 2.1))]
    render_image(renderer, params, statics, poses[0], scene_aabb=aabb,
                 chunk_rays=chunk)  # warm-up
    torch.cuda.synchronize()

    kernels.reset_launches()
    times = []
    for md in poses:
        t0 = time.perf_counter()
        rgb, depth, acc = render_image(renderer, params, statics, md,
                                       scene_aabb=aabb, chunk_rays=chunk)
        times.append(time.perf_counter() - t0)
        for name, a in (("rgb", rgb), ("depth", depth), ("acc", acc)):
            if not np.isfinite(a).all():
                raise SystemExit(f"serve: non-finite {name}")
        for name, a in (("rgb", rgb), ("acc", acc)):
            if a.min() < -1e-5 or a.max() > 1 + 1e-5:
                raise SystemExit(f"serve: {name} outside [0, 1]: "
                                 f"[{a.min()}, {a.max()}]")
        if rgb.shape != (SIDE, SIDE, 3):
            raise SystemExit(f"serve: rgb shape {rgb.shape}")
    launches = kernels.launches()
    print(f"serve: launches during 3 requests {launches}", flush=True)
    for k in SERVE_KERNELS:
        if launches[k] <= 0:
            raise SystemExit(f"serve: kernel {k} never launched")

    # one chunk through the kernels vs through the plain versions
    plain = make_chunk_renderer(cfg, ray_samples=S, occ_state=occ,
                                occ_importance=True, occ_hard_mask=False,
                                device=device, use_kernels=False)
    rays, _ = frame_rays(SIDE, SIDE, poses[0].intrinsics, poses[0].c2w,
                         aabb=aabb)
    chunk_rays = torch.from_numpy(rays[:chunk]).to(device)
    got = renderer(params, statics, chunk_rays)
    ref = plain(params, statics, chunk_rays)
    errs = [max_err(a, b) for a, b in zip(got, ref)]
    print(f"serve: kernels vs plain on one chunk: rgb {errs[0]:.3e} "
          f"depth {errs[1]:.3e} acc {errs[2]:.3e} (tol rgb/acc 1e-4, depth "
          f"1e-3: encoder and cdf rounding move t by ulps through the "
          f"MLPs)", flush=True)
    if errs[0] > 1e-4 or errs[2] > 1e-4 or errs[1] > 1e-3:
        raise SystemExit("serve: kernel path disagrees with the plain path")

    profile_frame(renderer, params, statics, poses[0], aabb, chunk)

    ms = [1e3 * t for t in times]
    n = SIDE * SIDE
    print(f"serve: {SIDE}x{SIDE} frames ms={[round(x, 2) for x in ms]} "
          f"mean_ms={sum(ms) / 3:.2f} rays_per_s={n / (sum(times) / 3):.1f} "
          f"chunk_rays={chunk} mean_rgb={float(rgb.mean()):.4f} "
          f"mean_acc={float(acc.mean()):.4f}", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "nerfsys_tpu_torch").is_dir():
        print("chip_smoke: nerfsys_tpu_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.data.ram_rays import frame_rays

    card = card_line()
    print(f"card: {card}", flush=True)

    build_s = kernels.build_all()
    print(f"build: {len(kernels.SOURCES)} libraries in {build_s:.2f} s",
          flush=True)
    for stem, log in kernels.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build[{stem}]: {line.strip()}")

    device = torch.device("cuda", 0)
    torch.manual_seed(SEED)
    cfg, statics, params, occ = bench_setup(device)
    md = pose((0.0, 0.0, 2.0))
    rays, _ = frame_rays(md.H, md.W, md.intrinsics, md.c2w,
                         aabb=statics.global_aabb.cpu().numpy())
    results = check_kernels(cfg, statics, params, occ, rays[:CHECK_RAYS],
                            device)
    batch = train_batch(device)
    check_train_kernels(cfg, statics, params, occ, batch, device, results)
    served = serve(cfg, statics, params, occ, device)
    light, trained = train(cfg, statics, params, occ, batch, device)

    launches = {k: served[k] + trained[k] for k in served}
    for k in kernels.KERNELS:  # one line per kernel, with its launches
        print(f"kernel {k.name}: launches={launches[k.name]} (serve "
              f"{served[k.name]}, train {trained[k.name]}; per bench train "
              f"step {light[k.name] / 3:g}) {results[k.name].pop('text')}")
    line = {"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         **results[k.name], "library_ms": None}
        for k in kernels.KERNELS]}
    print("library_ms: null for every kernel: no single PyTorch call "
          "computes the plane encoder or its table gradient with the "
          "interpolation weights, the union probe + CDF, the inverse-CDF "
          "sampler, or the compositor or its VJP")
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
