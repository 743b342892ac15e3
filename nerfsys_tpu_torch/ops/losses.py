"""Training losses over rendered rays, and the image-quality score.

Port of nerfsys_tpu/ops/losses.py (`mse` :21, `psnr_from_mse` :25, `psnr`
:30, `compute_mse_loss` :34): render a packed ray batch, align the
prediction and ground-truth color spaces, MSE. This is the loss the meta
inner loop differentiates.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from nerfsys_tpu_torch.ops.color_space import color_space_transformer
from nerfsys_tpu_torch.ops.occupancy import render_rays_occ_field
from nerfsys_tpu_torch.ops.volrend import render_rays_stratified


def mse(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - gt))


def psnr_from_mse(m: torch.Tensor) -> torch.Tensor:
    """PSNR = -10 log10(mse + 1e-24)."""
    return -10.0 * torch.log10(m + 1e-24)


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return psnr_from_mse(mse(pred, gt))


def compute_mse_loss(
    field_fn,
    rays: torch.Tensor,  # (N, 8)
    rgbs: torch.Tensor,  # (N, 3) ground truth, sRGB in [0, 1]
    *,
    ray_samples: int,
    generator: Optional[torch.Generator] = None,
    randomized: bool = False,
    color_space: str = "srgb",
    bg_policy: str = "white",
    bg_fn=None,
    sigma_scale: float = 1.0,
    occ_grid=None,  # (occs, binary, aabbs) of ONE expert, K=1 slices
    occ_on: Optional[bool] = None,  # grid ready; None = use it
    importance: bool = False,  # probe the EMA values too (pair_fn)
    occ_cdf: Optional[Dict[str, torch.Tensor]] = None,
    occ_probe_mask: bool = False,
    occ_hard_mask: bool = True,
    occ_ray_floor: float = 0.25,
    n_probes: int = 128,
    use_kernels: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Render rays and compute the color-space-aligned MSE -> (loss, aux
    with rgb_map, depth_map, acc_map and psnr).

    Without an occupancy grid, or while it is not ready (occ_on False), the
    stratified renderer runs; otherwise the single-field occupancy renderer
    (the reference's lax.cond on occ_on, decided here on the host)."""
    if occ_grid is None or (occ_on is not None and not bool(occ_on)):
        rgb_map, depth, _, acc = render_rays_stratified(
            field_fn, rays, ray_samples, generator, randomized=randomized,
            bg_policy=bg_policy, bg_fn=bg_fn, sigma_scale=sigma_scale,
            use_kernels=use_kernels)
    else:
        rgb_map, depth, _, acc = render_rays_occ_field(
            field_fn, occ_grid, rays, ray_samples, generator,
            randomized=randomized, n_probes=n_probes, bg_policy=bg_policy,
            bg_fn=bg_fn, sigma_scale=sigma_scale, importance=importance,
            cdf_state=occ_cdf, mask_from_probes=occ_probe_mask,
            hard_mask=occ_hard_mask,
            ray_floor=0.0 if occ_hard_mask else occ_ray_floor,
            use_kernels=use_kernels)
    pred, gt = color_space_transformer(rgb_map, rgbs, color_space)
    loss = mse(pred, gt)
    aux = {"rgb_map": rgb_map, "depth_map": depth, "acc_map": acc,
           "psnr": psnr_from_mse(loss.detach())}
    return loss, aux
