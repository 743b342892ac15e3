"""Host-side frame ray generation (numpy).

The port's own copy of the numpy ray path of nerfsys_tpu/data/ram_rays.py
(`np_ray_directions`, `np_ray_aabb_intersect`, `np_get_rays`,
`np_clamp_rays`, `frame_rays`; :28-137). The reference's C++ ray generator
(data/native) is host code and is not part of the port; `frame_rays` here
is always the numpy path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_MISS = 1e10  # AABB miss tag, matches ops/scene_box.py


def np_ray_directions(H: int, W: int, fx, fy, cx, cy,
                      center_pixels: bool = True) -> np.ndarray:
    j, i = np.mgrid[0:H, 0:W].astype(np.float32)
    if center_pixels:
        i = i + 0.5
        j = j + 0.5
    dirs = np.stack([(i - cx) / fx, -(j - cy) / fy, -np.ones_like(i)], axis=-1)
    dirs /= np.maximum(np.linalg.norm(dirs, axis=-1, keepdims=True), 1e-12)
    return dirs


def np_ray_aabb_intersect(aabb: np.ndarray, o: np.ndarray, d: np.ndarray,
                          eps: float = 1e-8) -> Tuple[np.ndarray, np.ndarray]:
    safe_d = np.where(np.abs(d) < eps, np.where(d >= 0, eps, -eps), d)
    inv = 1.0 / safe_d
    t0 = (aabb[0] - o) * inv
    t1 = (aabb[1] - o) * inv
    tmin = np.minimum(t0, t1).max(-1)
    tmax = np.maximum(t0, t1).min(-1)
    tmin = np.clip(tmin, 0.0, _MISS)
    tmax = np.clip(tmax, -_MISS, _MISS)
    valid = tmax > tmin
    return np.where(valid, tmin, _MISS), np.where(valid, tmax, _MISS)


def np_get_rays(dirs: np.ndarray, c2w: np.ndarray,
                aabb: Optional[np.ndarray] = None,
                near: Optional[float] = None,
                far: Optional[float] = None) -> np.ndarray:
    lead = dirs.shape[:-1]
    R, t = c2w[:3, :3], c2w[:3, 3]
    d = dirs.reshape(-1, 3) @ R.T
    o = np.broadcast_to(t, d.shape).astype(np.float32)
    if aabb is not None:
        tmin, tmax = np_ray_aabb_intersect(aabb.astype(np.float32), o, d)
        nf = np.stack([tmin, tmax], axis=-1)
    else:
        nf = np.broadcast_to(np.array([near, far], dtype=np.float32),
                             (d.shape[0], 2))
    return np.concatenate(
        [o, d.astype(np.float32), nf.astype(np.float32)], -1
    ).reshape(*lead, 8)


def np_clamp_rays(rays: np.ndarray, near_override: Optional[float] = None,
                  far_override: Optional[float] = None,
                  eps: float = 1e-6) -> Tuple[np.ndarray, np.ndarray]:
    near = rays[:, 6].copy()
    far = rays[:, 7].copy()
    if near_override is not None:
        near = np.maximum(near, np.float32(near_override))
    if far_override is not None:
        far = np.minimum(far, np.float32(far_override))
    valid = (np.isfinite(near) & np.isfinite(far) & (far > near + eps)
             & (near < 1e9) & (far < 1e10))
    rays = rays.copy()
    rays[:, 6] = np.where(valid, near, np.inf)
    rays[:, 7] = np.where(valid, far, np.inf)
    return rays, valid


def frame_rays(H: int, W: int, intrinsics, c2w: np.ndarray, *,
               aabb: Optional[np.ndarray] = None,
               near: Optional[float] = None, far: Optional[float] = None,
               center_pixels: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """All H*W rays of one pinhole frame -> (rays (H*W, 8) f32, valid)."""
    fx, fy, cx, cy = [float(v) for v in intrinsics[:4]]
    if aabb is None:
        near = 0.0 if near is None else near
        far = _MISS if far is None else far
    dirs = np_ray_directions(H, W, fx, fy, cx, cy, center_pixels)
    rays = np_get_rays(dirs, np.asarray(c2w),
                       aabb=None if aabb is None else np.asarray(aabb),
                       near=near, far=far)
    rays = rays.reshape(-1, 8).astype(np.float32)
    return np_clamp_rays(rays, near, far)
