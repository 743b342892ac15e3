"""Host-side ray generation and the in-RAM ray store of a split.

The port's own copy of nerfsys_tpu/data/ram_rays.py: the numpy ray path
(`np_ray_directions`, `np_ray_aabb_intersect`, `np_get_rays`,
`np_clamp_rays`, `frame_rays`; :28-137), Mega-NeRF val balancing
(`apply_meganerf_val_balancing` :141), the per-image worker
(`process_single_image` :165) and `RamRaysDataset` (:228). Per image: load
the pixels, apply the expert's keep-mask (and optionally the val
balancing), generate rays against the expert's scene box, clamp near/far,
drop invalid rays, normalize rgb to [0, 1]. Images are processed by a
thread pool when there are more than 8.

`frame_rays` and `process_single_image` run through the native C++
generator (data/native: one multithreaded call a frame, and a compaction
pass per image), as the reference does whenever g++ builds it. The numpy
path is their plain version, reached only through `native=False`; the two
agree as the reference's own test holds them (valid masks equal, o/d
within 1e-5, near/far within 1e-4 on valid rays), and the native path
equals the JAX package's native path bit for bit.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from nerfsys_tpu_torch.data import native as _native
from nerfsys_tpu_torch.data.image_metadata import ImageMetadata

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
               center_pixels: bool = True,
               native: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """All H*W rays of one pinhole frame -> (rays (H*W, 8) f32, valid):
    np_ray_directions + np_get_rays + np_clamp_rays (invalid rays
    inf-tagged), through the native generator unless native=False."""
    if native:
        return _native.compute_rays_native(
            H, W, intrinsics, c2w, aabb=aabb, near=near, far=far,
            center_pixels=center_pixels)
    fx, fy, cx, cy = [float(v) for v in intrinsics[:4]]
    if aabb is None:
        # the native kernel's None defaults (far=_MISS rays fail the
        # < 1e10 check)
        near = 0.0 if near is None else near
        far = _MISS if far is None else far
    dirs = np_ray_directions(H, W, fx, fy, cx, cy, center_pixels)
    rays = np_get_rays(dirs, np.asarray(c2w),
                       aabb=None if aabb is None else np.asarray(aabb),
                       near=near, far=far)
    rays = rays.reshape(-1, 8).astype(np.float32)
    return np_clamp_rays(rays, near, far)


# --------------------- Mega-NeRF val balancing ------------------------------
def apply_meganerf_val_balancing(keep_mask: np.ndarray,
                                 rng: np.random.Generator) -> np.ndarray:
    """Keep the left half; re-add as many discarded left pixels as right
    pixels were dropped (the ray count stays roughly constant)."""
    H, W = keep_mask.shape
    mask = keep_mask.copy()
    left = mask[:, : W // 2]
    right = mask[:, W // 2:]
    n_discard = int(right.sum())
    if n_discard > 0:
        cand = np.arange(H * W).reshape(H, W)[:, : W // 2]
        not_kept = cand[~left]
        if not_kept.size > 0:
            take = rng.permutation(not_kept.size)[:n_discard]
            flat = mask.reshape(-1)
            flat[not_kept[take]] = True
            mask = flat.reshape(H, W)
    mask[:, W // 2:] = False
    return mask


# --------------------- per-image worker --------------------------------------
def process_single_image(
    md: Optional[ImageMetadata],
    center_pixels: bool,
    val_balancing: bool,
    aabb: Optional[np.ndarray],
    near_far_override: Optional[Tuple[Optional[float],
                                      Optional[float]]] = None,
    seed: int = 0,
    native: bool = True,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """-> (rgbs (M, 3) float32, rays (M, 8) float32, img_indices (M,)
    int32), or None when the image keeps no valid ray. The rays and the
    compaction (valid & keep, rgb / 255) run natively unless
    native=False."""
    if md is None:
        return None
    img = md.load_image()  # (H, W, 3) uint8
    keep = md.load_mask()

    if md.is_val and val_balancing:
        if keep is None:
            keep = np.ones((md.H, md.W), dtype=bool)
        keep = apply_meganerf_val_balancing(
            keep, np.random.default_rng(seed + md.image_index))

    if keep is not None and keep.sum() == 0:
        return None

    no, fo = near_far_override or (None, None)
    if native:
        all_rays, valid = _native.compute_rays_native(
            md.H, md.W, md.intrinsics, md.c2w, aabb=aabb, near=no, far=fo,
            center_pixels=center_pixels)
        rays, rgb = _native.compact_rays_native(
            all_rays, valid, None if keep is None else keep.reshape(-1),
            img.reshape(-1, 3))
        if rays.shape[0] == 0:
            return None
        idx = np.full((rgb.shape[0],), md.image_index, dtype=np.int32)
        return rgb, rays, idx

    fx, fy, cx, cy = md.intrinsics
    dirs = np_ray_directions(md.H, md.W, fx, fy, cx, cy, center_pixels)
    rays = np_get_rays(dirs, md.c2w, aabb=aabb).reshape(-1, 8)
    rgb = img.reshape(-1, 3)

    if keep is not None:
        flat = keep.reshape(-1)
        rays = rays[flat]
        rgb = rgb[flat]

    rays, valid = np_clamp_rays(rays, no, fo)
    if not valid.any():
        return None
    rays = rays[valid]
    rgb = rgb[valid].astype(np.float32) / 255.0
    idx = np.full((rgb.shape[0],), md.image_index, dtype=np.int32)
    return rgb, rays, idx


# --------------------- dataset ------------------------------------------------
class RamRaysDataset:
    """All rays of a split, flattened into contiguous numpy arrays:
    rays (N, 8), rgbs (N, 3), img_indices (N,), what TaskDataset and the
    train loop consume."""

    def __init__(
        self,
        metadata_items: List[ImageMetadata],
        center_pixels: bool = True,
        val_balancing: bool = False,
        scene_aabb: Optional[np.ndarray] = None,  # (2, 3) or None
        near_far_override: Optional[Tuple] = None,
        num_workers: Optional[int] = None,
        seed: int = 0,
    ):
        if num_workers is None:
            num_workers = min(8, max(1, (os.cpu_count() or 1) // 2))

        def work(md):
            return process_single_image(md, center_pixels, val_balancing,
                                        scene_aabb, near_far_override, seed)

        if len(metadata_items) > 8 and num_workers > 1:
            with ThreadPoolExecutor(max_workers=num_workers) as ex:
                results = list(ex.map(work, metadata_items))
        else:
            results = [work(md) for md in metadata_items]

        results = [r for r in results if r is not None]
        if not results:
            self.rgbs = np.zeros((0, 3), dtype=np.float32)
            self.rays = np.zeros((0, 8), dtype=np.float32)
            self.img_indices = np.zeros((0,), dtype=np.int32)
            self.num_images = 0
        else:
            self.rgbs = np.concatenate([r[0] for r in results], 0)
            self.rays = np.concatenate([r[1] for r in results], 0)
            self.img_indices = np.concatenate([r[2] for r in results], 0)
            self.num_images = len(results)
        self.unique_image_ids = np.unique(self.img_indices).tolist()

    def __len__(self) -> int:
        return self.rgbs.shape[0]

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        return {"rgbs": self.rgbs[idx], "rays": self.rays[idx],
                "img_indices": self.img_indices[idx]}
