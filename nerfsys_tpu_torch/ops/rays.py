"""Ray generation and near/far clamping.

Port of nerfsys_tpu/ops/rays.py (`get_ray_directions` :41, `get_rays` :81,
`clamp_rays_near_far` :120). Conventions: RUB cameras (pixel (i, j) ->
[(i - cx)/fx, -(j - cy)/fy, -1], unit-normalised), DRB world, packed rays
(..., 8) = [ox, oy, oz, dx, dy, dz, near, far], invalid rays inf-tagged.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from nerfsys_tpu_torch.ops.scene_box import SceneBox
from nerfsys_tpu_torch.utils.device import resolve_device


def get_ray_directions(H: int, W: int, fx: float, fy: float, cx: float,
                       cy: float, center_pixels: bool = True,
                       dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Unit camera-frame (RUB) directions (H, W, 3), on the card unless
    `device` says otherwise."""
    device = resolve_device(device)
    j = torch.arange(H, dtype=dtype, device=device)[:, None]
    i = torch.arange(W, dtype=dtype, device=device)[None, :]
    if center_pixels:
        i = i + 0.5
        j = j + 0.5
    x = ((i - cx) / fx).expand(H, W)
    y = (-(j - cy) / fy).expand(H, W)
    z = -torch.ones((H, W), dtype=dtype, device=device)
    dirs = torch.stack([x, y, z], dim=-1)
    norm = torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return dirs / torch.clamp(norm, min=1e-12)


def get_rays(
    directions: torch.Tensor,  # (H, W, 3) or (N, 3) camera-frame unit dirs
    c2w: torch.Tensor,  # (3, 4) or (4, 4)
    scene_box: Optional[SceneBox] = None,
    near: Optional[float] = None,
    far: Optional[float] = None,
    *,
    aabb_max_bound: float = 1e10,
    aabb_invalid_value: float = 1e10,
) -> torch.Tensor:
    """Packed rays (..., 8); near/far from the box intersection or from the
    scalar arguments."""
    lead = directions.shape[:-1]
    c2w = torch.as_tensor(c2w, dtype=directions.dtype,
                          device=directions.device)
    d_flat = (directions @ c2w[:3, :3].T).reshape(-1, 3)
    o_flat = c2w[:3, 3].expand(d_flat.shape)
    if scene_box is not None:
        tmin, tmax = scene_box.ray_aabb_intersect(
            o_flat, d_flat, eps=1e-8, max_bound=aabb_max_bound,
            invalid_value=aabb_invalid_value)
        near_v, far_v = tmin[:, None], tmax[:, None]
    else:
        if near is None or far is None:
            raise ValueError("Provide near/far when scene_box is None")
        near_v = torch.full_like(o_flat[:, :1], float(near))
        far_v = torch.full_like(o_flat[:, :1], float(far))
    packed = torch.cat([o_flat, d_flat, near_v, far_v], dim=-1)
    return packed.reshape(*lead, 8)


def clamp_rays_near_far(
    rays: torch.Tensor,  # (N, 8)
    near_override: Optional[float] = None,
    far_override: Optional[float] = None,
    *,
    eps: float = 1e-6,
    invalid_value: float = math.inf,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rays_clamped, valid): invalid rays (non-finite, far <= near + eps, or
    the 1e10 miss tags) get near = far = invalid_value."""
    near, far = rays[:, 6], rays[:, 7]
    if near_override is not None:
        near = torch.clamp(near, min=float(near_override))
    if far_override is not None:
        far = torch.clamp(far, max=float(far_override))
    valid = torch.isfinite(near) & torch.isfinite(far) & (far > near + eps)
    valid = valid & (near < 1e9) & (far < 1e10)
    inv = torch.full_like(near, invalid_value)
    rays = rays.clone()
    rays[:, 6] = torch.where(valid, near, inv)
    rays[:, 7] = torch.where(valid, far, inv)
    return rays, valid
