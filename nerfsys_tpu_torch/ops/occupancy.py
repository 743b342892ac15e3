"""Multi-level occupancy grids: state, queries, probe CDF and sampler.

Port of nerfsys_tpu/ops/occupancy.py (`OccGridConfig` :42, `init_occ_state`
:69, `level_aabbs` :90, `_finest_level_index` :121, `query_pair` :196,
`occupancy_probe_cdf` :394, `sample_tvals_from_cdf` :468,
`render_rays_occ_field` :556 in soft mode). Grid updates are not ported
yet.

The grids of the K experts are stacked: occs (K, L, R, R, R) float EMA
values and binary (K, L, R, R, R) bool. Level l of an expert covers its box
scaled by 2^l about the centre, and the finest level containing a point
decides its cell.

Kernel 2 (`csrc/occ_probe.cu`) computes the union probe + CDF on the card,
kernel 3 (`csrc/occ_sample.cu`) the inverse-CDF sampler; the `*_plain`
functions are the same math in plain PyTorch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from nerfsys_tpu_torch import kernels
from nerfsys_tpu_torch.utils.device import resolve_device

PairFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class OccGridConfig:
    """Static occupancy-grid hyperparameters used so far (the grid update
    keys arrive with the update's port)."""

    resolution: int = 128
    levels: int = 4
    warmup_steps: int = 256
    update_interval: int = 16


def init_occ_state(cfg: OccGridConfig, num_experts: int,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """Occupancy state for K stacked experts (all cells empty)."""
    dev = resolve_device(device)
    R, L = cfg.resolution, cfg.levels
    shape = (num_experts, L, R, R, R)
    return {
        "occs": torch.zeros(shape, dtype=torch.float32, device=dev),
        "binary": torch.zeros(shape, dtype=torch.bool, device=dev),
        "num_updates": torch.zeros((), dtype=torch.int32, device=dev),
        "ready_after": torch.tensor(
            max(1, cfg.warmup_steps // max(cfg.update_interval, 1)),
            dtype=torch.int32, device=dev),
    }


def linspace01(n: int, device=None) -> torch.Tensor:
    """float32 linspace(0, 1, n) rounded as the reference computes it
    (iota times float32(1/(n-1)), exact endpoint)."""
    if n == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    # built on `device`: a host-to-device copy would synchronise the stream
    step = float(np.float32(1.0 / (n - 1)))
    head = torch.arange(n - 1, dtype=torch.float32, device=device) * step
    return torch.cat([head, torch.ones(1, device=device)])


def level_aabbs(aabb: torch.Tensor, levels: int) -> torch.Tensor:
    """(..., levels, 2, 3) from boxes (..., 2, 3): level l = roi aabb
    scaled by 2^l about its center."""
    center = 0.5 * (aabb[..., 0, None, :] + aabb[..., 1, None, :])
    half = 0.5 * (aabb[..., 1, None, :] - aabb[..., 0, None, :])
    scales = 2.0 ** torch.arange(levels, dtype=aabb.dtype, device=aabb.device)
    los = center - half * scales[:, None]
    his = center + half * scales[:, None]
    return torch.stack([los, his], dim=-2)


def _finest_level_index(aabb: torch.Tensor, L: int, R: int,
                        pts: torch.Tensor):
    """(decided (...,) bool, flat_idx (...,) int64 into the (L*R^3,)
    table): the finest level containing each point selects its cell."""
    la = level_aabbs(aabb, L)
    inside, rels = [], []
    for l in range(L):
        lo, hi = la[l, 0], la[l, 1]
        rel = (pts - lo) / (hi - lo)
        inside.append(((rel >= 0.0) & (rel < 1.0)).all(dim=-1))
        rels.append(rel)
    decided = inside[0]
    level = torch.zeros(pts.shape[:-1], dtype=torch.int64, device=pts.device)
    rel_sel = rels[0]
    for l in range(1, L):
        take = inside[l] & ~decided
        level = torch.where(take, l, level)
        rel_sel = torch.where(take[..., None], rels[l], rel_sel)
        decided = decided | inside[l]
    ijk = torch.clamp((rel_sel * R).to(torch.int32).long(), 0, R - 1)
    flat_idx = ((level * R + ijk[..., 0]) * R + ijk[..., 1]) * R + ijk[..., 2]
    return decided, flat_idx


def query_pair(occs: torch.Tensor, binary: torch.Tensor, aabb: torch.Tensor,
               pts: torch.Tensor):
    """One expert's (occ (...,) bool, value (...,) >= 0) at world points from
    the finest containing level; (False, 0) outside every level."""
    L, R = occs.shape[0], occs.shape[1]
    decided, flat_idx = _finest_level_index(aabb, L, R, pts)
    occ = binary.reshape(-1)[flat_idx] & decided
    val = torch.where(decided, occs.reshape(-1)[flat_idx],
                      torch.zeros((), dtype=occs.dtype, device=occs.device))
    return occ, torch.clamp(val, min=0.0)


def union_pair(occs: torch.Tensor, binary: torch.Tensor, aabbs: torch.Tensor,
               pts: torch.Tensor):
    """(any-expert occ, max-over-experts value) of the stacked grids."""
    occ_k, val_k = zip(*(query_pair(occs[k], binary[k], aabbs[k], pts)
                         for k in range(occs.shape[0])))
    return torch.stack(occ_k).any(dim=0), torch.stack(val_k).amax(dim=0)


def _probe_mids(P: int, device) -> torch.Tensor:
    """(P,) probe positions: the midpoints of P equal intervals of [0, 1]."""
    edges = linspace01(P + 1, device)
    return (0.5 * (edges[:-1] + edges[1:])).contiguous()


def _probe_points(rays_o, rays_d, near, far, P: int) -> torch.Tensor:
    mids = _probe_mids(P, rays_o.device)
    t_probe = near[:, None] + (far - near)[:, None] * mids[None, :]
    return rays_o[:, None, :] + rays_d[:, None, :] * t_probe[..., None]


def occupancy_probe_cdf_plain(
    pair_fn: PairFn,  # pts (M, 3) -> (occ (M,) bool, value (M,))
    rays_o: torch.Tensor,  # (N, 3)
    rays_d: torch.Tensor,  # (N, 3)
    near: torch.Tensor,  # (N,)
    far: torch.Tensor,  # (N,)
    n_probes: int = 128,
    importance: bool = False,
    uniform_frac: float = 0.25,
    ray_floor: float = 0.0,
) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of kernel 2: probe P midpoints per ray and
    build {cdf (N, P+1), alive (N,), occ (N, P)}. importance=True mixes the
    EMA values into the pdf (the reference's pair_fn path); False uses the
    occupancy bits alone."""
    N, P = rays_o.shape[0], n_probes
    pts = _probe_points(rays_o, rays_d, near, far, P)
    occ, val = pair_fn(pts.reshape(-1, 3))
    occ = occ.reshape(N, P)
    alive = occ.any(dim=1)
    occf = occ.to(rays_o.dtype)
    if importance:
        val = torch.clamp(val.reshape(N, P), min=0.0).to(rays_o.dtype) * occf
        vsum = val.sum(dim=1, keepdim=True)
        osum = torch.clamp(occf.sum(dim=1, keepdim=True), min=1e-12)
        uni = occf / osum
        imp = torch.where(vsum > 1e-12, val / torch.clamp(vsum, min=1e-12),
                          uni)
        w = (1.0 - uniform_frac) * imp + uniform_frac * uni
    else:
        w = occf
    if ray_floor > 0.0:
        wsum = torch.clamp(w.sum(dim=1, keepdim=True), min=1e-12)
        w = (1.0 - ray_floor) * (w / wsum) + ray_floor / P
    w = w + 1e-12
    cdf = torch.cumsum(w, dim=1)
    cdf = cdf / cdf[:, -1:]
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=1)
    return {"cdf": cdf, "alive": alive, "occ": occ}


def occupancy_probe_cdf_kernel(
    occs: torch.Tensor,  # (K, L, R, R, R) float32
    binary: torch.Tensor,  # (K, L, R, R, R) bool
    aabbs: torch.Tensor,  # (K, 2, 3) expert boxes
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    n_probes: int = 128,
    importance: bool = False,
    uniform_frac: float = 0.25,
    ray_floor: float = 0.0,
) -> Dict[str, torch.Tensor]:
    """Kernel 2's wrapper: the plain version for CPU tensors; on CUDA
    tensors it launches `occupancy_probe_cdf` or raises."""
    if rays_o.device.type == "cpu":
        return occupancy_probe_cdf_plain(
            lambda pts: union_pair(occs, binary, aabbs, pts), rays_o, rays_d,
            near, far, n_probes, importance, uniform_frac, ray_floor)
    if rays_o.device.type != "cuda":
        raise ValueError(f"occupancy_probe_cdf: unsupported device "
                         f"{rays_o.device}")
    dev = rays_o.device
    N, P = rays_o.shape[0], n_probes
    K, L, R = occs.shape[0], occs.shape[1], occs.shape[2]
    if P > 256:
        raise ValueError("occupancy_probe_cdf: the kernel takes P <= 256")
    if tuple(binary.shape) != tuple(occs.shape) or aabbs.shape[0] != K:
        raise ValueError("occupancy_probe_cdf: grid/box shapes disagree")
    laabb = level_aabbs(aabbs, L).contiguous()
    mids = _probe_mids(P, dev)
    kernels.check_cuda_tensors(
        "occupancy_probe_cdf", dev, rays_o=rays_o, rays_d=rays_d, near=near,
        far=far, occs=occs, binary=binary, laabb=laabb)
    cdf = torch.empty((N, P + 1), dtype=torch.float32, device=dev)
    alive = torch.empty((N,), dtype=torch.bool, device=dev)
    occ = torch.empty((N, P), dtype=torch.bool, device=dev)
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    kernels.OCC_PROBE_CDF(
        rays_o.data_ptr(), rays_d.data_ptr(), near.data_ptr(), far.data_ptr(),
        mids.data_ptr(), occs.data_ptr(), binary.data_ptr(),
        laabb.data_ptr(), cdf.data_ptr(), alive.data_ptr(), occ.data_ptr(),
        N, P, K, L, R, int(importance), f32(1.0 - uniform_frac),
        f32(uniform_frac), f32(1.0 - ray_floor),
        f32(ray_floor / P) if ray_floor > 0.0 else 0.0,
        kernels.stream_ptr(rays_o))
    return {"cdf": cdf, "alive": alive, "occ": occ}


def occupancy_probe_cdf(
    occs: torch.Tensor,
    binary: torch.Tensor,
    aabbs: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    n_probes: int = 128,
    importance: bool = False,
    uniform_frac: float = 0.25,
    ray_floor: float = 0.0,
    *,
    use_kernels: bool = True,
) -> Dict[str, torch.Tensor]:
    """Pass 1 of occupancy sampling over the UNION of the stacked experts'
    grids (a single expert is a K=1 slice). use_kernels=False runs the
    plain version on any device."""
    if use_kernels:
        return occupancy_probe_cdf_kernel(
            occs, binary, aabbs, rays_o, rays_d, near, far, n_probes,
            importance, uniform_frac, ray_floor)
    return occupancy_probe_cdf_plain(
        lambda pts: union_pair(occs, binary, aabbs, pts), rays_o, rays_d,
        near, far, n_probes, importance, uniform_frac, ray_floor)


def _sample_targets(N: int, S: int, device, generator, randomized: bool):
    """(S,) midpoint targets, or (N, S) jittered ones when randomized. The
    jitter is drawn on `device` by `generator`, which must live there (a
    CUDA generator for the card: no host draw, no copy)."""
    u = (torch.arange(S, dtype=torch.float32, device=device) + 0.5) / S
    if not randomized:
        return u
    if generator is None:
        raise ValueError("randomized occupancy sampling requires a generator")
    noise = torch.rand((N, S), generator=generator, device=device)
    jit = (noise - 0.5) / S
    return torch.clamp(u + jit, 0.0, 1.0 - 1e-6)


def sample_tvals_plain(cdf: torch.Tensor, near: torch.Tensor,
                       far: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel 3: sorted t_vals (N, S) for targets
    u, (S,) or (N, S)."""
    N, P = cdf.shape[0], cdf.shape[1] - 1
    edges = linspace01(P + 1, cdf.device)
    u = u.expand(N, u.shape[-1])
    idx = (cdf[:, None, 1:] <= u[:, :, None]).sum(dim=-1)
    idx = torch.clamp(idx, 0, P - 1)
    cdf_lo = torch.gather(cdf, 1, idx)
    cdf_hi = torch.gather(cdf, 1, idx + 1)
    frac = (u - cdf_lo) / torch.clamp(cdf_hi - cdf_lo, min=1e-12)
    e_lo = edges[:-1][idx]
    width = edges[1] - edges[0]
    s = e_lo + frac * width
    t_vals = near[:, None] + (far - near)[:, None] * s
    return torch.sort(t_vals, dim=1).values


def sample_tvals_kernel(cdf: torch.Tensor, near: torch.Tensor,
                        far: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Kernel 3's wrapper: the plain version for CPU tensors; on CUDA
    tensors it launches `sample_tvals_from_cdf` or raises."""
    if cdf.device.type == "cpu":
        return sample_tvals_plain(cdf, near, far, u)
    if cdf.device.type != "cuda":
        raise ValueError(f"sample_tvals_from_cdf: unsupported device "
                         f"{cdf.device}")
    dev = cdf.device
    N, P = cdf.shape[0], cdf.shape[1] - 1
    S = u.shape[-1]
    per_ray = u.dim() == 2
    if per_ray and tuple(u.shape) != (N, S):
        raise ValueError("sample_tvals_from_cdf: u must be (S,) or (N, S)")
    if 4 * (P + 1 + S) * 4 > 48 * 1024:  # 4 warps' rows in static smem
        raise ValueError("sample_tvals_from_cdf: the kernel takes "
                         "P + S <= 3071")
    edges = linspace01(P + 1, dev)
    kernels.check_cuda_tensors("sample_tvals_from_cdf", dev, cdf=cdf,
                               near=near, far=far, u=u)
    t_vals = torch.empty((N, S), dtype=torch.float32, device=dev)
    kernels.OCC_SAMPLE(cdf.data_ptr(), near.data_ptr(), far.data_ptr(),
                       u.data_ptr(), edges.data_ptr(), t_vals.data_ptr(),
                       N, P, S, int(per_ray), kernels.stream_ptr(cdf))
    return t_vals


def sample_tvals_from_cdf(
    cdf_state: Dict[str, torch.Tensor],
    near: torch.Tensor,
    far: torch.Tensor,
    n_samples: int,
    generator: Optional[torch.Generator] = None,
    randomized: bool = False,
    *,
    use_kernels: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 2: place S samples by inverse CDF over the probe intervals ->
    (t_vals (N, S) sorted, alive (N,)). The per-sample mask (with_mask) is
    not ported yet."""
    cdf = cdf_state["cdf"]
    u = _sample_targets(cdf.shape[0], n_samples, cdf.device, generator,
                        randomized)
    fn = sample_tvals_kernel if use_kernels else sample_tvals_plain
    return fn(cdf, near, far, u.contiguous()), cdf_state["alive"]


def render_rays_occ_field(
    field_fn,  # (pts (M, 3), dirs (M, 3)) -> (rgb (M, 3), sigma (M,))
    occ_grid,  # (occs (1, L, R, R, R), binary, aabbs (1, 2, 3)): one expert
    rays: torch.Tensor,  # (N, 8)
    n_samples: int,
    generator: Optional[torch.Generator] = None,
    *,
    randomized: bool = False,
    n_probes: int = 128,
    bg_policy: str = "white",
    bg_fn=None,
    sigma_scale: float = 1.0,
    importance: bool = False,  # probe (occ, EMA value) pairs (pair_fn)
    uniform_frac: float = 0.25,
    cdf_state: Optional[Dict[str, torch.Tensor]] = None,
    mask_from_probes: bool = False,
    hard_mask: bool = True,
    ray_floor: Optional[float] = None,
    use_kernels: bool = True,
):
    """Occupancy-guided dense render of ONE field (no routing), soft mode:
    the grid steers sample PLACEMENT and never deletes density. Used by the
    meta inner loop, which trains each expert alone -> (rgb (N, 3),
    depth (N,), weights (N, S), acc (N,)).

    Probe + CDF (kernel 2 on the K=1 grid slice, skipped when `cdf_state`
    is given) -> inverse-CDF samples (kernel 3) -> field -> compositor
    (kernel 4 and its backward). Hard-mask rendering and probe-bit masks
    are not ported."""
    from nerfsys_tpu_torch.ops.volrend import (
        background_rgb,
        t_to_points,
        volume_render,
    )

    if hard_mask or mask_from_probes:
        raise NotImplementedError(
            "hard-mask occupancy rendering (and mask_from_probes) is not "
            "ported; pass hard_mask=False (the soft mode)")
    o = rays[:, 0:3].contiguous()
    d = rays[:, 3:6].contiguous()
    near, far = rays[:, 6], rays[:, 7]
    n_rays = o.shape[0]
    valid = (torch.isfinite(near) & torch.isfinite(far) & (far > near)
             & (far < 1e9))
    near_s = torch.where(valid, near, torch.zeros_like(near))
    far_s = torch.where(valid, far, torch.ones_like(far))
    if ray_floor is None:
        ray_floor = 0.25  # soft mode: unmarked space stays reachable
    if cdf_state is None:
        occs, binary, aabbs = occ_grid
        cdf_state = occupancy_probe_cdf(
            occs, binary, aabbs, o, d, near_s, far_s, n_probes,
            importance=importance, uniform_frac=uniform_frac,
            ray_floor=ray_floor, use_kernels=use_kernels)
    t_vals, _ = sample_tvals_from_cdf(
        cdf_state, near_s, far_s, n_samples, generator=generator,
        randomized=randomized, use_kernels=use_kernels)
    pts = t_to_points(o, d, t_vals)
    dirs = d[:, None, :].expand(pts.shape)
    rgb, sigma = field_fn(pts.reshape(-1, 3), dirs.reshape(-1, 3))
    rgb = rgb.reshape(n_rays, n_samples, 3)
    sigma = sigma.reshape(n_rays, n_samples)
    sigma = torch.where(valid[:, None], sigma, torch.zeros_like(sigma))
    if bg_fn is not None:
        bg = bg_fn(d)
    else:
        bg = background_rgb(bg_policy, n_rays, generator=generator,
                            last_sample_rgb=rgb[:, -1, :], dtype=rgb.dtype)
    rgb_sigma = torch.cat([rgb, sigma[..., None]], dim=-1)
    return volume_render(rgb_sigma, t_vals,
                         bg_rgb=None if bg is None else bg.contiguous(),
                         sigma_scale=sigma_scale, use_kernels=use_kernels)
