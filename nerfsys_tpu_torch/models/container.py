"""Mixture-of-experts NeRF container: spatial routing + background model.

Port of nerfsys_tpu/models/container.py (`ContainerConfig`,
`ContainerStatics`, `init_container_params` :128, `_routing_dist` :158,
`routing_weights` :175, `routing_coherent_expert` :198, the dense
`_eval_all_experts` :256, the bucketed `_bucketed_eval` :279,
`container_density` :400, `container_apply` :419,
`container_apply_multidir` :447, `background_color` :502,
`container_field_fn`, `container_bg_fn`, `_expert_apply_fn` :235,
`param_group_labels` :545). The K experts' parameters are stacked on a
leading axis and evaluated as ONE batched call over that axis (batched
matmuls, one encoder launch), then blended with the dense (N, K) routing
weights before integration.

Bucketed top-E dispatch (`cfg.bucketed`, kernel row 10a): each point goes
to its E nearest experts only; the (point, expert) pairs are counting-sorted
into (K, C) buckets, the experts run batched over the buckets, and each
point blends its E pair results back. `csrc/bucket.cu` holds the dispatch
(top-E, weights, the stable counting sort, the packed row gather) and the
blend with its transpose; `bucket_dispatch_plain`, `bucket_combine_plain`
and `bucket_combine_bwd_plain` are the same functions in plain PyTorch.
`routing_coherent_expert` (row 10b, `csrc/coherent.cu`) finds the rays
whose every sample routes to one expert alone.

The routing distance is computed elementwise, left to right, in the order
the reference writes it (sum x^2 - 2 x.c + sum c^2, clamp, sqrt), so that
the kernels, built with --fmad=false, pick the same experts bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from nerfsys_tpu_torch import kernels
from nerfsys_tpu_torch.models.ngp import (
    NGPConfig,
    _linear_init,
    init_ngp_params,
    ngp_apply,
    ngp_color,
    ngp_density,
    tree_to,
)
from nerfsys_tpu_torch.ops.encodings import sh_encode, sh_out_dim
from nerfsys_tpu_torch.ops.volrend import ray_lane_struct
from nerfsys_tpu_torch.utils.device import num_sms, resolve_device
from nerfsys_tpu_torch.utils.tree import tree_map

Params = Dict

MAX_EXPERTS = 64  # the routing kernels keep the centroids in shared memory
COHERENT_GROUPS = 2  # csrc/coherent.cu COHERENT_GROUPS: ray groups a warp
# 10b's lanes a ray at most: pieces of 8 samples let a warp stop early on
# rays that break, at ~1% on rays that do not (PERF.md, row 10b)
COHERENT_LANES = 8
MAX_E = 8  # experts per point the dispatch kernel takes
DISPATCH_THREADS = 256  # threads a tile of the dispatch, a point a round
DISPATCH_FILL_THREADS = 256


@dataclasses.dataclass(frozen=True)
class ContainerConfig:
    """Static hyperparameters of the MoE container."""

    num_experts: int
    nerf_variant: str = "instant"
    boundary_margin: float = 1.0  # > 1.0 -> soft routing
    cluster_2d: bool = True  # route on (y, z) only
    use_bg_nerf: bool = True
    bg_hidden: int = 32
    bg_encoding: str = "spherical"
    expert: NGPConfig = dataclasses.field(default_factory=NGPConfig)
    # bucketed top-E dispatch: each point evaluates its E nearest experts,
    # batched per expert in buckets of C = ceil(N * E / K * capacity_factor)
    # rows; a call whose demand overflows a bucket takes the exact dense
    # blend instead when bucket_overflow_dense (else the overflow pairs
    # read the trash slot, sigma 0)
    bucketed: bool = False
    experts_per_point: int = 2
    capacity_factor: float = 1.5
    bucket_overflow_dense: bool = True

    def __post_init__(self):
        if self.nerf_variant != "instant":
            raise NotImplementedError(
                f"nerf_variant={self.nerf_variant!r}: only 'instant' is "
                f"ported")
        if self.bg_encoding != "spherical":
            raise NotImplementedError("only the spherical bg encoding is "
                                      "ported")

    @property
    def bg_enc_dim(self) -> int:
        return sh_out_dim(4)


@dataclasses.dataclass(frozen=True)
class ContainerStatics:
    """Non-learnable geometry: centroids (K, 3), expert boxes (K, 2, 3),
    global box (2, 3)."""

    centroids: torch.Tensor
    expert_aabbs: torch.Tensor
    global_aabb: torch.Tensor

    def to(self, device) -> "ContainerStatics":
        return ContainerStatics(self.centroids.to(device),
                                self.expert_aabbs.to(device),
                                self.global_aabb.to(device))


def init_container_params(cfg: ContainerConfig, seed: int = 0,
                          device="cuda") -> Params:
    """{'experts': K stacked experts, 'bg': {...}} drawn from a seeded
    torch.Generator (on the CPU, so the draw is device-independent)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    params: Params = {"experts": init_ngp_params(
        cfg.expert, gen, device="cpu", num_experts=cfg.num_experts)}
    if cfg.use_bg_nerf:
        params["bg"] = {"l0": _linear_init(gen, cfg.bg_enc_dim, cfg.bg_hidden),
                        "l1": _linear_init(gen, cfg.bg_hidden, 3)}
    return tree_to(params, dev)


def _sum_sq(v: torch.Tensor) -> torch.Tensor:
    """sum_j v[..., j]^2, left to right, one rounding per operation."""
    out = v[..., 0] * v[..., 0]
    for j in range(1, v.shape[-1]):
        out = out + v[..., j] * v[..., j]
    return out


def _centroid_dist(centroids: torch.Tensor, cluster_2d: bool,
                   pts: torch.Tensor) -> torch.Tensor:
    """(N, K) centroid distances in the routing subspace (YZ if
    cluster_2d): sqrt(max(sum x^2 - 2 x.c + sum c^2, 0)), each sum taken
    left to right over the coordinates."""
    sl = slice(1, 3) if cluster_2d else slice(0, 3)
    x = pts[:, sl].to(torch.float32)
    c = centroids[:, sl].to(torch.float32)
    x2 = 2.0 * x
    dot = x2[:, None, 0] * c[None, :, 0]
    for j in range(1, x.shape[1]):
        dot = dot + x2[:, None, j] * c[None, :, j]
    d2 = (_sum_sq(x)[:, None] - dot) + _sum_sq(c)[None, :]
    # the correctly rounded float32 square root (the kernels' sqrtf, XLA's
    # sqrt): PyTorch's vectorised float32 sqrt on the CPU is off by an ulp
    # in ~0.5% of inputs, and a float64 root rounded once to float32 is exact
    return torch.sqrt(torch.clamp(d2, min=0.0).double()).float()


def _routing_dist(statics: ContainerStatics, cfg: ContainerConfig,
                  pts: torch.Tensor) -> torch.Tensor:
    return _centroid_dist(statics.centroids, cfg.cluster_2d, pts)


def routing_weights(statics: ContainerStatics, cfg: ContainerConfig,
                    pts: torch.Tensor) -> torch.Tensor:
    """Dense per-point expert weights (N, K): inverse distance over the
    experts within margin * min-distance (soft), else one-hot argmin."""
    dist = _routing_dist(statics, cfg, pts)
    if cfg.boundary_margin > 1.0:
        dist = torch.clamp(dist, min=1e-6)
        invd = 1.0 / dist
        mind = dist.amin(dim=1, keepdim=True)
        mask = dist <= cfg.boundary_margin * mind
        invd = invd * mask
        denom = torch.clamp(invd.sum(dim=1, keepdim=True), min=1e-6)
        return (invd / denom).to(pts.dtype)
    hard = torch.argmin(dist, dim=1)
    return torch.nn.functional.one_hot(hard, cfg.num_experts).to(pts.dtype)


# --------------------------- coherent expert (row 10b) -----------------------
def coherent_expert_plain(centroids: torch.Tensor, pts_ns: torch.Tensor,
                          cluster_2d: bool, margin: float) -> torch.Tensor:
    """Plain PyTorch version of kernel 10b: per-ray coherent expert id
    (N,) int32, or -1. The argmin (first index on ties) must be the same
    at every sample; under soft routing (margin > 1) the second-nearest
    clamped distance must also exceed margin times the nearest at every
    sample."""
    N, S = pts_ns.shape[0], pts_ns.shape[1]
    K = centroids.shape[0]
    dist = _centroid_dist(centroids, cluster_2d,
                          pts_ns.reshape(N * S, 3)).reshape(N, S, K)
    a1 = torch.argmin(dist, dim=-1)  # (N, S), first index on ties
    same = (a1 == a1[:, :1]).all(dim=1)
    if margin > 1.0 and K > 1:
        # the 1e-6 clamp of routing_weights: its margin mask is built on
        # clamped distances, so the singleton test reads them too
        top2 = torch.sort(torch.clamp(dist, min=1e-6), dim=-1).values
        singleton = (top2[..., 1] > margin * top2[..., 0]).all(dim=1)
        same = same & singleton
    return torch.where(same, a1[:, 0], -1).to(torch.int32)


def coherent_expert_kernel(centroids: torch.Tensor, pts_ns: torch.Tensor,
                           cluster_2d: bool, margin: float) -> torch.Tensor:
    """Kernel 10b's wrapper: the plain version for CPU tensors; on CUDA
    tensors it launches `coherent_expert` (with `ray_lane_plan`'s plan for
    COHERENT_GROUPS groups a warp) or raises."""
    if pts_ns.device.type == "cpu":
        return coherent_expert_plain(centroids, pts_ns, cluster_2d, margin)
    if pts_ns.device.type != "cuda":
        raise ValueError(f"coherent_expert: unsupported device "
                         f"{pts_ns.device}")
    dev = pts_ns.device
    N, S, K = pts_ns.shape[0], pts_ns.shape[1], centroids.shape[0]
    if K > MAX_EXPERTS:
        raise ValueError(f"coherent_expert: the kernel takes K <= "
                         f"{MAX_EXPERTS}")
    kernels.check_cuda_tensors("coherent_expert", dev, pts=pts_ns,
                               centroids=centroids)
    out = torch.empty((N,), dtype=torch.int32, device=dev)
    kernels.COHERENT_EXPERT(pts_ns.data_ptr(), centroids.data_ptr(),
                            out.data_ptr(), N, S, K, int(cluster_2d),
                            float(margin),
                            ray_lane_struct(N, S, COHERENT_GROUPS,
                                            COHERENT_LANES),
                            kernels.stream_ptr(pts_ns))
    return out


def routing_coherent_expert(statics: ContainerStatics, cfg: ContainerConfig,
                            pts_ns: torch.Tensor, *,
                            use_kernels: bool = True) -> torch.Tensor:
    """Per-ray coherent expert id (N,) int32, or -1 for boundary rays: a ray
    is coherent on expert k iff at EVERY sample the routed blend is expert k
    alone (argmin k everywhere and, under soft routing, no other expert
    inside the margin support). For such rays the full routed render and
    the single-expert render are the same function."""
    fn = coherent_expert_kernel if use_kernels else coherent_expert_plain
    return fn(statics.centroids.contiguous(), pts_ns.contiguous(),
              cfg.cluster_2d, float(cfg.boundary_margin))


# --------------------------- expert evaluation -------------------------------
def _expert_params(params: Params, k: int) -> Params:
    return tree_map(lambda t: t[k], params["experts"])


def _eval_all_experts(params: Params, cfg: ContainerConfig,
                      statics: ContainerStatics, pts: torch.Tensor,
                      dirs: Optional[torch.Tensor], *,
                      use_kernels: bool = True):
    """All K experts at once -> (rgb (K, N, 3) or None, sigma (K, N)).
    pts and dirs are (N, 3) shared by the experts, or (K, C, 3) per
    expert (the buckets)."""
    if dirs is None:
        return None, ngp_density(params["experts"], cfg.expert,
                                 statics.expert_aabbs, pts,
                                 use_kernels=use_kernels)
    return ngp_apply(params["experts"], cfg.expert, statics.expert_aabbs,
                     pts, dirs, use_kernels=use_kernels)


def _dense_eval(params: Params, cfg: ContainerConfig,
                statics: ContainerStatics, pts: torch.Tensor,
                dirs: Optional[torch.Tensor], use_kernels: bool):
    """The dense blend -> (rgb (N, 3) or None, sigma (N,))."""
    rgb_k, sigma_k = _eval_all_experts(params, cfg, statics, pts, dirs,
                                       use_kernels=use_kernels)
    w = routing_weights(statics, cfg, pts)  # (N, K)
    sigma = (w.T * sigma_k).sum(dim=0)
    if rgb_k is None:
        return None, sigma
    return (w.T[..., None] * rgb_k).sum(dim=0), sigma


# --------------------------- bucketed dispatch (row 10a) ---------------------
def bucket_capacity(n: int, k: int, e: int, capacity_factor: float) -> int:
    """Rows per bucket: ceil(N * E / K * cf), rounded up to a multiple of
    128, at least 128 (the reference's lane-aligned rule)."""
    c = int(math.ceil(n * e / k * capacity_factor))
    return max(128, (c + 127) // 128 * 128)


def _top_e(dist: torch.Tensor, E: int):
    """The E nearest experts, nearest first; on equal distances the lower
    expert index first (as lax.top_k orders ties) -> (d (N, E), idx)."""
    d, idx = torch.sort(dist, dim=1, stable=True)
    return d[:, :E], idx[:, :E]


def bucket_dispatch_plain(pts: torch.Tensor, dirs: Optional[torch.Tensor],
                          centroids: torch.Tensor, cluster_2d: bool,
                          margin: float, E: int, C: int):
    """Plain PyTorch version of kernel 10a-i -> dict of idx (N, E) int32,
    w (N, E) f32, dest (N*E,) int32, counts (K,) int32, bucket_rows (K, C)
    int32 and rows (K, C, 6) f32 (pts|dirs; (K, C, 3) without dirs).

    Top-E with margin weights renormalised over E (hard routing: w = [1,
    0, ...]); the pairs n*E+e with w > 0 are counting-sorted into their
    expert's bucket in pair order (an exclusive one-hot cumsum, the
    reference's); a pair whose rank reaches C, or whose weight is 0, goes
    to the trash slot K*C. Empty bucket slots hold point 0. counts is each
    expert's demand (its pairs with w > 0), which the overflow test
    reads."""
    N, K = pts.shape[0], centroids.shape[0]
    dist = _centroid_dist(centroids, cluster_2d, pts)  # (N, K)
    dsel, idx = _top_e(dist, E)
    if margin > 1.0:
        dsel = torch.clamp(dsel, min=1e-6)
        mind = dsel[:, :1]  # top-1 IS the global min distance
        invd = (1.0 / dsel) * (dsel <= margin * mind)
        tot = invd[:, 0]
        for e in range(1, E):
            tot = tot + invd[:, e]
        w = invd / torch.clamp(tot, min=1e-6)[:, None]
    else:
        w = torch.zeros((N, E), dtype=torch.float32, device=pts.device)
        w[:, 0] = 1.0
    k_flat = idx.reshape(-1)
    w_flat = w.reshape(-1)
    live = (w_flat > 0).to(torch.int32)
    onehot = torch.nn.functional.one_hot(k_flat, K).to(torch.int32)
    onehot = onehot * live[:, None]
    rank = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    slot = (rank * onehot).sum(dim=1, dtype=torch.int32)
    keep = (slot < C) & (live > 0)
    trash = K * C
    dest = torch.where(keep, k_flat * C + slot,
                       torch.full_like(k_flat, trash)).to(torch.int32)
    n_flat = torch.arange(N, dtype=torch.int32,
                          device=pts.device).repeat_interleave(E)
    buf = torch.zeros(trash + 1, dtype=torch.int32, device=pts.device)
    buf[dest[keep].long()] = n_flat[keep]
    bucket_rows = buf[:trash].reshape(K, C)
    src = pts if dirs is None else torch.cat([pts, dirs], dim=1)
    return {"idx": idx.to(torch.int32), "w": w.to(torch.float32),
            "dest": dest, "counts": onehot.sum(dim=0, dtype=torch.int32),
            "bucket_rows": bucket_rows, "rows": src[bucket_rows.long()]}


@dataclasses.dataclass(frozen=True)
class DispatchLaunchPlan:
    """Launch geometry of kernel 10a-i (csrc/bucket.cu `DispatchPlan`)."""

    tile: int  # points a tile, a thread each
    tiles: int  # tiles of the single pass, one block each
    scratch: int  # int32 words, all cleared before the pass: the ticket,
    # then a status word a (tile, expert): its flag and the tile's
    # aggregate or inclusive count
    fill_blocks: int  # blocks a bucket of the empty-slot fill
    fill_threads: int

    def as_struct(self) -> "kernels.DispatchPlan":
        return kernels.DispatchPlan(self.tile, self.tiles, self.fill_blocks,
                                    self.fill_threads)


def dispatch_tile(e: int) -> int:
    """Points a tile: 2,048 (8 rounds of 256) when E <= 2, so that few
    tiles keep the look-back's chain short; 256 above, where a pair table
    of E = 8 fills the block's shared memory."""
    return 8 * DISPATCH_THREADS if e <= 2 else DISPATCH_THREADS


def dispatch_plan(n: int, k: int, e: int, c: int,
                  sms: int) -> DispatchLaunchPlan:
    """Kernel 10a-i's plan for N points, K experts, E a point and buckets
    of C rows on a card of `sms` SMs: one block of 256 threads a tile of
    `dispatch_tile(E)` points in ticket order, then about 4 fill blocks an
    SM shared by the K buckets, each looping over its bucket's empty
    tail."""
    if not (n >= 1 and 1 <= e <= min(k, MAX_E) and k <= MAX_EXPERTS
            and c >= 128 and c % 128 == 0):
        raise ValueError(f"bucket_dispatch: the kernel takes N >= 1, 1 <= E "
                         f"<= min(K, {MAX_E}), K <= {MAX_EXPERTS} and C a "
                         f"multiple of 128; got N={n} K={k} E={e} C={c}")
    if n * e >= 2 ** 30 or k * c * 6 >= 2 ** 31:
        raise ValueError("bucket_dispatch: too many pairs or slots for "
                         "32-bit indices")
    tile = dispatch_tile(e)
    tiles = -(-n // tile)
    return DispatchLaunchPlan(
        tile=tile, tiles=tiles, scratch=1 + tiles * k,
        fill_blocks=max(1, -(-4 * sms // k)),
        fill_threads=DISPATCH_FILL_THREADS)


@functools.lru_cache(maxsize=256)
def _dispatch_plan(n: int, k: int, e: int, c: int, sms: int
                   ) -> Tuple[DispatchLaunchPlan, "kernels.DispatchPlan"]:
    """`dispatch_plan` and its struct, per shape."""
    plan = dispatch_plan(n, k, e, c, sms)
    return plan, plan.as_struct()


def bucket_dispatch_kernel(pts: torch.Tensor, dirs: Optional[torch.Tensor],
                           centroids: torch.Tensor, cluster_2d: bool,
                           margin: float, E: int, C: int):
    """Kernel 10a-i's wrapper: the plain version for CPU tensors; on CUDA
    tensors it launches `bucket_dispatch` (a memset of its scratch and two
    launches on the current stream, with `dispatch_plan`'s plan) or
    raises."""
    if pts.device.type == "cpu":
        return bucket_dispatch_plain(pts, dirs, centroids, cluster_2d,
                                     margin, E, C)
    if pts.device.type != "cuda":
        raise ValueError(f"bucket_dispatch: unsupported device {pts.device}")
    dev = pts.device
    N, K = pts.shape[0], centroids.shape[0]
    plan, struct = _dispatch_plan(N, K, E, C, num_sms(dev))
    kernels.check_cuda_tensors("bucket_dispatch", dev, pts=pts, dirs=dirs,
                               centroids=centroids)
    width = 3 if dirs is None else 6
    idx = torch.empty((N, E), dtype=torch.int32, device=dev)
    w = torch.empty((N, E), dtype=torch.float32, device=dev)
    dest = torch.empty((N * E,), dtype=torch.int32, device=dev)
    counts = torch.empty((K,), dtype=torch.int32, device=dev)
    bucket_rows = torch.empty((K, C), dtype=torch.int32, device=dev)
    rows = torch.empty((K, C, width), dtype=torch.float32, device=dev)
    scratch = torch.empty((plan.scratch,), dtype=torch.int32, device=dev)
    kernels.BUCKET_DISPATCH(
        pts.data_ptr(), 0 if dirs is None else dirs.data_ptr(),
        centroids.data_ptr(), idx.data_ptr(), w.data_ptr(), dest.data_ptr(),
        counts.data_ptr(), bucket_rows.data_ptr(), rows.data_ptr(),
        scratch.data_ptr(), N, K, E, C, int(cluster_2d), float(margin),
        struct, kernels.stream_ptr(pts))
    return {"idx": idx, "w": w, "dest": dest, "counts": counts,
            "bucket_rows": bucket_rows, "rows": rows}


def bucket_combine_plain(w: torch.Tensor, dest: torch.Tensor,
                         sigma_b: torch.Tensor,
                         rgb_b: Optional[torch.Tensor]):
    """Plain PyTorch version of kernel 10a-ii: sigma (N,) = sum over e, in
    e order, of wk[n, e] * sigma_b[dest[n, e]], where wk is w on kept pairs
    and 0 on the trash slot (which reads 0); the same for rgb (N, 3)."""
    N, E = w.shape
    trash = sigma_b.shape[0]
    d = dest.reshape(N, E).long()
    keep = d < trash
    wk = torch.where(keep, w, torch.zeros_like(w))
    s_flat = torch.cat([sigma_b, sigma_b.new_zeros(1)])
    sigma = wk[:, 0] * s_flat[d[:, 0]]
    for e in range(1, E):
        sigma = sigma + wk[:, e] * s_flat[d[:, e]]
    if rgb_b is None:
        return sigma, None
    r_flat = torch.cat([rgb_b, rgb_b.new_zeros(1, 3)])
    rgb = wk[:, 0, None] * r_flat[d[:, 0]]
    for e in range(1, E):
        rgb = rgb + wk[:, e, None] * r_flat[d[:, e]]
    return sigma, rgb


def bucket_combine_bwd_plain(w: torch.Tensor, dest: torch.Tensor,
                             g_sigma: torch.Tensor,
                             g_rgb: Optional[torch.Tensor], n_slots: int):
    """Plain PyTorch version of kernel 10a-iii, the transpose of the blend:
    g_sigma_b[dest[n, e]] = wk[n, e] * g_sigma[n] (each kept slot is the
    destination of exactly one pair), zero elsewhere; the same for rgb."""
    N, E = w.shape
    d = dest.long()
    keep = d < n_slots
    wk = torch.where(keep, w.reshape(-1), torch.zeros_like(w.reshape(-1)))
    n_flat = torch.arange(N, device=w.device).repeat_interleave(E)
    g_s = g_sigma.new_zeros(n_slots + 1)
    g_s.index_add_(0, d, wk * g_sigma[n_flat])
    g_r = None
    if g_rgb is not None:
        g_r = g_rgb.new_zeros((n_slots + 1, 3))
        g_r.index_add_(0, d, wk[:, None] * g_rgb[n_flat])
        g_r = g_r[:n_slots]
    return g_s[:n_slots], g_r


def bucket_combine_kernel(w, dest, sigma_b, rgb_b):
    """Kernel 10a-ii's wrapper: the plain version for CPU tensors; on CUDA
    tensors it launches `bucket_combine_fwd` or raises."""
    if w.device.type == "cpu":
        return bucket_combine_plain(w, dest, sigma_b, rgb_b)
    if w.device.type != "cuda":
        raise ValueError(f"bucket_combine: unsupported device {w.device}")
    dev = w.device
    N, E = w.shape
    kernels.check_no_grad("bucket_combine_fwd", sigma_b, rgb_b)
    kernels.check_cuda_tensors("bucket_combine_fwd", dev, w=w, dest=dest,
                               sigma_b=sigma_b, rgb_b=rgb_b)
    sigma = torch.empty((N,), dtype=torch.float32, device=dev)
    rgb = (None if rgb_b is None
           else torch.empty((N, 3), dtype=torch.float32, device=dev))
    kernels.BUCKET_COMBINE_FWD(
        w.data_ptr(), dest.data_ptr(), sigma_b.data_ptr(),
        0 if rgb_b is None else rgb_b.data_ptr(), sigma.data_ptr(),
        0 if rgb is None else rgb.data_ptr(), N, E, sigma_b.shape[0],
        kernels.stream_ptr(w))
    return sigma, rgb


COMBINE_THREADS = 256  # csrc/bucket.cu COMBINE_THREADS


@dataclasses.dataclass(frozen=True)
class CombineLaunchPlan:
    """Launch geometry of kernel 10a-iii (csrc/bucket.cu `CombinePlan`)."""

    tile: int  # points a pair tile, a block each
    tiles: int
    fill_blocks: int  # blocks a bucket that zero its empty tail

    def as_struct(self) -> "kernels.CombinePlan":
        return kernels.CombinePlan(self.tile, self.tiles, self.fill_blocks)


def combine_bwd_plan(n: int, k: int, e: int, c: int,
                     sms: int) -> CombineLaunchPlan:
    """Kernel 10a-iii's plan for N points, K buckets of C slots and E pairs
    a point on a card of `sms` SMs: about 4 fill blocks an SM shared by the
    K buckets' empty tails, then a block a tile of points (1,024 when E <=
    2, 4 a thread; 256 above), at most 2,048 pairs, whose products a block
    stages in shared memory."""
    if not (n >= 0 and 1 <= e <= MAX_E and 1 <= k <= MAX_EXPERTS
            and c >= 128 and c % 128 == 0):
        raise ValueError(f"bucket_combine_bwd: the kernel takes 1 <= E <= "
                         f"{MAX_E}, K <= {MAX_EXPERTS} and C a multiple of "
                         f"128; got N={n} K={k} E={e} C={c}")
    if k * c * 3 >= 2 ** 31 or n * e >= 2 ** 31:
        raise ValueError("bucket_combine_bwd: too many pairs or slots for "
                         "32-bit indices")
    tile = (4 if e <= 2 else 1) * COMBINE_THREADS
    return CombineLaunchPlan(tile=tile, tiles=-(-n // tile),
                             fill_blocks=max(1, -(-4 * sms // k)))


@functools.lru_cache(maxsize=256)
def _combine_struct(n: int, k: int, e: int, c: int,
                    sms: int) -> "kernels.CombinePlan":
    return combine_bwd_plan(n, k, e, c, sms).as_struct()


def bucket_combine_bwd_kernel(w, dest, g_sigma, g_rgb, n_slots: int, *,
                              counts: torch.Tensor):
    """Kernel 10a-iii's wrapper: the plain version for CPU tensors; on CUDA
    tensors it launches `bucket_combine_bwd` (one grid, `combine_bwd_plan`'s
    plan) or raises. w, dest and counts must be as the dispatch wrote them:
    counts (K,) gives each bucket's empty tail, and n_slots is K * C. The
    outputs are allocated empty: the kernel writes every slot once."""
    if w.device.type == "cpu":
        return bucket_combine_bwd_plain(w, dest, g_sigma, g_rgb, n_slots)
    if w.device.type != "cuda":
        raise ValueError(f"bucket_combine_bwd: unsupported device "
                         f"{w.device}")
    dev = w.device
    N, E = w.shape
    K = counts.shape[0]
    if n_slots % K:
        raise ValueError(f"bucket_combine_bwd: {n_slots} slots are not K={K} "
                         f"buckets")
    C = n_slots // K
    struct = _combine_struct(N, K, E, C, num_sms(dev))
    kernels.check_cuda_tensors("bucket_combine_bwd", dev, w=w, dest=dest,
                               counts=counts, g_sigma=g_sigma, g_rgb=g_rgb)
    g_s = torch.empty((n_slots,), dtype=torch.float32, device=dev)
    g_r = (None if g_rgb is None
           else torch.empty((n_slots, 3), dtype=torch.float32, device=dev))
    kernels.BUCKET_COMBINE_BWD(
        w.data_ptr(), dest.data_ptr(), counts.data_ptr(), g_sigma.data_ptr(),
        0 if g_rgb is None else g_rgb.data_ptr(), g_s.data_ptr(),
        0 if g_r is None else g_r.data_ptr(), N, K, E, C, struct,
        kernels.stream_ptr(w))
    return g_s, g_r


class BucketCombine(torch.autograd.Function):
    """The blend of the bucket results back to the points (10a-ii), with
    its transpose (10a-iii) as the backward. Gradients reach the bucket
    results only: the weights are functions of the sample positions, which
    nothing differentiated moves. `counts` (the dispatch's demand) is saved
    beside (w, dest) so that the backward knows each bucket's empty
    tail."""

    @staticmethod
    def forward(ctx, w, dest, counts, sigma_b, rgb_b, use_kernels):
        fn = bucket_combine_kernel if use_kernels else bucket_combine_plain
        sigma, rgb = fn(w, dest, sigma_b, rgb_b)
        ctx.save_for_backward(w, dest, counts)
        ctx.use_kernels = use_kernels
        ctx.n_slots = sigma_b.shape[0]
        ctx.has_rgb = rgb_b is not None
        if rgb is None:
            return sigma
        return sigma, rgb

    @staticmethod
    def backward(ctx, g_sigma, g_rgb=None):
        w, dest, counts = ctx.saved_tensors
        if g_sigma is None:
            g_sigma = w.new_zeros(w.shape[0])
        if ctx.has_rgb and g_rgb is None:
            g_rgb = w.new_zeros((w.shape[0], 3))
        args = (w, dest, g_sigma.contiguous(),
                None if g_rgb is None else g_rgb.contiguous(), ctx.n_slots)
        if ctx.use_kernels:
            g_s, g_r = bucket_combine_bwd_kernel(*args, counts=counts)
        else:
            g_s, g_r = bucket_combine_bwd_plain(*args)
        return None, None, None, g_s, g_r, None


# Calls of the bucketed container and how many took the dense branch
# because a bucket overflowed (read by chip_smoke and the tests).
bucket_stats = {"calls": 0, "dense": 0}


def _bucketed_eval(params: Params, cfg: ContainerConfig,
                   statics: ContainerStatics, pts: torch.Tensor,
                   dirs: Optional[torch.Tensor], use_kernels: bool):
    """Top-E block-sparse expert dispatch -> (rgb (N, 3) or None,
    sigma (N,)): dispatch (10a-i), the K experts batched over their (K, C)
    buckets, blend (10a-ii). When any expert's demand exceeds C and
    cfg.bucket_overflow_dense, the call takes the exact dense blend
    instead: the host reads `counts` (one small device-to-host copy per
    call) where the reference branches with lax.cond."""
    N, K = pts.shape[0], cfg.num_experts
    E = min(cfg.experts_per_point, K)
    C = bucket_capacity(N, K, E, cfg.capacity_factor)
    dispatch = bucket_dispatch_kernel if use_kernels else bucket_dispatch_plain
    pts_c = pts.contiguous()
    dirs_c = None if dirs is None else dirs.contiguous()
    dsp = dispatch(pts_c, dirs_c, statics.centroids.contiguous(),
                   cfg.cluster_2d, float(cfg.boundary_margin), E, C)
    bucket_stats["calls"] += 1
    if cfg.bucket_overflow_dense and bool((dsp["counts"] > C).any()):
        bucket_stats["dense"] += 1
        return _dense_eval(params, cfg, statics, pts, dirs, use_kernels)
    rows = dsp["rows"]
    rgb_b, sigma_b = _eval_all_experts(
        params, cfg, statics, rows[..., 0:3],
        None if dirs is None else rows[..., 3:6], use_kernels=use_kernels)
    sigma_b = sigma_b.reshape(-1).contiguous()
    if rgb_b is None:
        return None, BucketCombine.apply(dsp["w"], dsp["dest"],
                                         dsp["counts"], sigma_b, None,
                                         use_kernels)
    sigma, rgb = BucketCombine.apply(dsp["w"], dsp["dest"], dsp["counts"],
                                     sigma_b,
                                     rgb_b.reshape(-1, 3).contiguous(),
                                     use_kernels)
    return rgb, sigma


# --------------------------- public API --------------------------------------
def container_density(params: Params, cfg: ContainerConfig,
                      statics: ContainerStatics, pts: torch.Tensor,
                      active_expert: Optional[int] = None, *,
                      use_kernels: bool = True) -> torch.Tensor:
    """Routed density (N,): one expert's, the bucketed blend, or the dense
    blend."""
    if active_expert is not None:
        return ngp_density(_expert_params(params, active_expert), cfg.expert,
                           statics.expert_aabbs[active_expert], pts,
                           use_kernels=use_kernels)
    if cfg.bucketed:
        return _bucketed_eval(params, cfg, statics, pts, None,
                              use_kernels)[1]
    return _dense_eval(params, cfg, statics, pts, None, use_kernels)[1]


def container_apply(params: Params, cfg: ContainerConfig,
                    statics: ContainerStatics, pts: torch.Tensor,
                    dirs: torch.Tensor, active_expert: Optional[int] = None,
                    *, use_kernels: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed field evaluation -> (rgb (N,3), sigma (N,)): soft weights
    blend both sigma and rgb before integration."""
    if active_expert is not None:
        return ngp_apply(_expert_params(params, active_expert), cfg.expert,
                         statics.expert_aabbs[active_expert], pts, dirs,
                         use_kernels=use_kernels)
    if cfg.bucketed:
        return _bucketed_eval(params, cfg, statics, pts, dirs, use_kernels)
    return _dense_eval(params, cfg, statics, pts, dirs, use_kernels)


def container_apply_multidir(params: Params, cfg: ContainerConfig,
                             statics: ContainerStatics, pts: torch.Tensor,
                             dirs_m: torch.Tensor, *,
                             use_kernels: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed field at N points under M shared view directions -> (rgb
    (M, N, 3), sigma (N,)). The encoder, sigma trunk, geometry head and
    routing weights run once for all K experts; only the color head sweeps
    the M directions (one direction at a time, as the reference maps
    them). Bucketed routing falls back to one container_apply per
    direction (its buckets depend on the call's points), as the reference
    does."""
    n = pts.shape[0]
    if cfg.bucketed:
        outs = [container_apply(params, cfg, statics, pts,
                                d[None, :].expand(n, 3),
                                use_kernels=use_kernels) for d in dirs_m]
        return torch.stack([o[0] for o in outs]), outs[0][1]
    sigma_k, geo_k = ngp_density(params["experts"], cfg.expert,
                                 statics.expert_aabbs, pts,
                                 return_feats=True, use_kernels=use_kernels)
    w = routing_weights(statics, cfg, pts)  # (N, K)
    sigma = (w.T * sigma_k).sum(dim=0)
    rgb = torch.stack([
        torch.einsum("nk,knc->nc", w,
                     ngp_color(params["experts"], cfg.expert, d, geo_k))
        for d in dirs_m])
    return rgb, sigma


def background_color(params: Params, cfg: ContainerConfig,
                     d: torch.Tensor) -> torch.Tensor:
    """Learned background RGB from view direction."""
    if not cfg.use_bg_nerf or "bg" not in params:
        raise RuntimeError("background_color called but use_bg_nerf=False")
    lead = d.shape[:-1]
    dn = d.reshape(-1, 3)
    dn = dn / torch.clamp(torch.linalg.norm(dn, dim=-1, keepdim=True),
                          min=1e-9)
    enc = sh_encode(dn, 4)
    bg = params["bg"]
    h = torch.relu(torch.matmul(enc, bg["l0"]["w"]) + bg["l0"]["b"])
    rgb = torch.sigmoid(torch.matmul(h, bg["l1"]["w"]) + bg["l1"]["b"])
    return rgb.reshape(*lead, 3)


def container_field_fn(params: Params, cfg: ContainerConfig,
                       statics: ContainerStatics,
                       active_expert: Optional[int] = None, *,
                       use_kernels: bool = True):
    """Bind into a FieldFn for the renderers."""

    def field(pts, dirs):
        return container_apply(params, cfg, statics, pts, dirs,
                               active_expert, use_kernels=use_kernels)

    return field


def container_bg_fn(params: Params, cfg: ContainerConfig):
    """The learned background for renderers, or None if disabled."""
    if not cfg.use_bg_nerf or "bg" not in params:
        return None

    def bg(dirs):
        return background_color(params, cfg, dirs)

    return bg


def _expert_apply_fn(cfg: ContainerConfig):
    """(apply, density) of one expert: 'instant' is the only variant
    ported (ContainerConfig refuses the others)."""
    return ngp_apply, ngp_density


def param_group_labels(params: Params) -> Params:
    """Label every leaf with its optimizer group, in the params' nesting:
    'encoding' (the hash table or the plane/line tables), 'sigma' (density
    trunk and heads), 'color' (color MLP), 'background' (the bg MLP)."""

    def label(tree, name):
        return tree_map(lambda _: name, tree)

    labels: Params = {"experts": {
        k: label(v, "encoding" if k in ("hash_table", "planes_enc") else
                 "color" if k == "color_mlp" else "sigma")
        for k, v in params["experts"].items()}}
    if "bg" in params:
        labels["bg"] = label(params["bg"], "background")
    return labels
