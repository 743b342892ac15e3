"""Occupancy-guided MoE rendering (soft mode).

Port of nerfsys_tpu/models/occupancy.py (`occ_ready` :188,
`_ray_validity` :307,
`union_pair_fn` :92, `expert_pair_fn` :110, `render_rays_occ` :436) for
the soft mode: the union of the experts' occupancy grids steers sample
PLACEMENT (probe CDF with a whole-ray floor) and never deletes density.
Hard-mask rendering and the two-wave, early-stop and union-probe-grid
dispatchers are not ported yet and raise NotImplementedError.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from nerfsys_tpu_torch.models.container import (
    ContainerConfig,
    ContainerStatics,
    container_apply,
    container_bg_fn,
)
from nerfsys_tpu_torch.ops.occupancy import (
    occupancy_probe_cdf,
    query_pair,
    sample_tvals_from_cdf,
    union_pair,
)
from nerfsys_tpu_torch.ops.volrend import (
    background_rgb,
    t_to_points,
    volume_render,
)

Render = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def union_pair_fn(occ_state: Dict, statics: ContainerStatics):
    """pts (M, 3) -> (occ under ANY expert (M,), max EMA value (M,))."""

    def query(pts):
        return union_pair(occ_state["occs"], occ_state["binary"],
                          statics.expert_aabbs, pts)

    return query


def expert_pair_fn(occ_state: Dict, statics: ContainerStatics, k: int):
    """pts (M, 3) -> (occ, value) of expert k's grid alone."""

    def query(pts):
        return query_pair(occ_state["occs"][k], occ_state["binary"][k],
                          statics.expert_aabbs[k], pts)

    return query


def occ_ready(occ_state: Dict, min_updates: int = 1) -> torch.Tensor:
    """Grid usable for rendering once warmup-many updates have run AND any
    cell is occupied -> bool scalar tensor on the grid's device."""
    thresh = occ_state.get("ready_after")
    if thresh is None:
        thresh = torch.tensor(min_updates, dtype=torch.int32,
                              device=occ_state["binary"].device)
    return (occ_state["num_updates"] >= thresh) & occ_state["binary"].any()


def _ray_validity(rays: torch.Tensor):
    """(valid, near_s, far_s): sanitized bounds shared by probe and render."""
    near, far = rays[:, 6], rays[:, 7]
    valid = (torch.isfinite(near) & torch.isfinite(far) & (far > near)
             & (far < 1e9))
    near_s = torch.where(valid, near, torch.zeros_like(near))
    far_s = torch.where(valid, far, torch.ones_like(far))
    return valid, near_s, far_s


def render_rays_occ(
    params,
    cfg: ContainerConfig,
    statics: ContainerStatics,
    occ_state: Dict,
    rays: torch.Tensor,  # (N, 8)
    n_samples: int,
    generator: Optional[torch.Generator] = None,
    *,
    randomized: bool = False,
    n_probes: int = 128,
    bg_policy: str = "white",
    use_bg_fn: bool = True,
    active_expert: Optional[int] = None,
    sigma_scale: float = 1.0,
    importance: bool = False,
    uniform_frac: float = 0.25,
    cdf_state: Optional[Dict] = None,
    probe_fns=None,
    hard_mask: bool = True,
    ray_floor: Optional[float] = None,
    mask_from_probes: bool = False,
    field_expert=None,
    use_kernels: bool = True,
) -> Render:
    """Dense occupancy-guided MoE render, soft mode (hard_mask=False) ->
    (rgb (N,3), depth (N,), weights (N,S), acc (N,)).

    Probe (kernel 2) -> inverse-CDF placement (kernel 3) -> routed field
    (encoder kernel 1 + MLPs) -> compositing (kernel 4)."""
    if hard_mask:
        raise NotImplementedError(
            "hard-mask occupancy rendering is not ported; pass "
            "hard_mask=False (the soft mode)")
    if (cdf_state is not None or probe_fns is not None or mask_from_probes
            or field_expert is not None):
        raise NotImplementedError(
            "cdf_state / probe_fns / mask_from_probes / field_expert are not "
            "ported")
    o = rays[:, 0:3].contiguous()
    d = rays[:, 3:6].contiguous()
    n_rays = o.shape[0]
    valid, near_s, far_s = _ray_validity(rays)
    if ray_floor is None:
        ray_floor = 0.25  # soft mode: unmarked space stays reachable

    occs, binary, aabbs = (occ_state["occs"], occ_state["binary"],
                           statics.expert_aabbs)
    if active_expert is not None:
        k = int(active_expert)
        occs, binary, aabbs = occs[k:k + 1], binary[k:k + 1], aabbs[k:k + 1]
    cdf_state = occupancy_probe_cdf(
        occs, binary, aabbs, o, d, near_s, far_s, n_probes,
        importance=importance, uniform_frac=uniform_frac,
        ray_floor=ray_floor, use_kernels=use_kernels)
    t_vals, _ = sample_tvals_from_cdf(
        cdf_state, near_s, far_s, n_samples, generator=generator,
        randomized=randomized, use_kernels=use_kernels)

    pts = t_to_points(o, d, t_vals)
    dirs = d[:, None, :].expand(pts.shape)
    rgb, sigma = container_apply(params, cfg, statics, pts.reshape(-1, 3),
                                 dirs.reshape(-1, 3), active_expert,
                                 use_kernels=use_kernels)
    rgb = rgb.reshape(n_rays, n_samples, 3)
    sigma = sigma.reshape(n_rays, n_samples)
    # soft: the grid steered placement only; density is never deleted
    sigma = torch.where(valid[:, None], sigma, torch.zeros_like(sigma))

    if use_bg_fn and cfg.use_bg_nerf and "bg" in params:
        bg = container_bg_fn(params, cfg)(d)
    else:
        bg = background_rgb(bg_policy, n_rays, generator=generator,
                            last_sample_rgb=rgb[:, -1, :], dtype=rgb.dtype,
                            device=rgb.device)
    rgb_sigma = torch.cat([rgb, sigma[..., None]], dim=-1)
    return volume_render(rgb_sigma, t_vals,
                         bg_rgb=None if bg is None else bg.contiguous(),
                         sigma_scale=sigma_scale, use_kernels=use_kernels)
