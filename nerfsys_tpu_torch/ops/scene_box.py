"""Axis-aligned scene boxes and ray/AABB intersection.

Port of nerfsys_tpu/ops/scene_box.py (`SceneBox.aabb` and its
`ray_aabb_intersect`, :153). Conventions: aabb[0] = per-axis minima,
aabb[1] = per-axis maxima; rays that miss (tmax <= tmin) are tagged with
`invalid_value` in both near and far.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SceneBox:
    """An axis-aligned bounding box, (2, 3): row 0 = min, row 1 = max."""

    aabb: torch.Tensor

    def ray_aabb_intersect(self, rays_o, rays_d, eps: float = 1e-8,
                           max_bound: float = 1e10,
                           invalid_value: float = 1e10):
        return ray_aabb_intersect(self.aabb, rays_o, rays_d, eps=eps,
                                  max_bound=max_bound,
                                  invalid_value=invalid_value)


def ray_aabb_intersect(
    aabb: torch.Tensor,  # (2, 3)
    rays_o: torch.Tensor,  # (..., 3)
    rays_d: torch.Tensor,  # (..., 3)
    eps: float = 1e-8,
    max_bound: float = 1e10,
    invalid_value: float = 1e10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab-method ray/AABB intersection. Returns (tmin, tmax), misses
    tagged. Degenerate direction components (|d| < eps) become signed eps
    so 1/d stays finite; tmin is clamped to >= 0."""
    aabb = torch.as_tensor(aabb, dtype=rays_o.dtype, device=rays_o.device)
    d = rays_d
    pos = torch.full_like(d, eps)
    safe_d = torch.where(d.abs() < eps, torch.where(d >= 0, pos, -pos), d)
    inv_d = 1.0 / safe_d

    t0 = (aabb[0] - rays_o) * inv_d
    t1 = (aabb[1] - rays_o) * inv_d
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    tmin = torch.clamp(tmin, 0.0, max_bound)
    tmax = torch.clamp(tmax, -max_bound, max_bound)

    valid = tmax > tmin
    inv = torch.full_like(tmin, invalid_value)
    return torch.where(valid, tmin, inv), torch.where(valid, tmax, inv)
