"""Online stage: chunked full-frame rendering (the serving path).

Port of nerfsys_tpu/pipelines/online/runtime_adapt.py (`make_chunk_renderer`
:532, `default_chunk_rays` :909, `render_image` :919, `render_rays_chunked`
:1598 with the plain chunk loop of `two_wave_dispatch` :1480-1491,
`_pad_chunk`, `_pack5`). Two renderer kinds are ported: the soft-occupancy
one-shot renderer (how soft-trained checkpoints render) and the stratified
renderer without an occupancy grid. Test-time adaptation, the two-wave,
early-stop, union-probe and coherent dispatchers, and mesh sharding are not
ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from nerfsys_tpu_torch.data.ram_rays import frame_rays
from nerfsys_tpu_torch.models.container import (
    ContainerConfig,
    ContainerStatics,
    container_bg_fn,
    container_field_fn,
)
from nerfsys_tpu_torch.models.occupancy import render_rays_occ
from nerfsys_tpu_torch.ops.volrend import render_rays_stratified
from nerfsys_tpu_torch.utils.device import resolve_device


class ChunkRenderer:
    """(params, statics, rays (C, 8) tensor) -> (rgb (C,3), depth, acc) on
    `device`; chunks are rendered without autograd."""

    def __init__(self, fn, device: torch.device):
        self._fn = fn
        self.device = device

    def __call__(self, params, statics, rays):
        with torch.no_grad():
            return self._fn(params, statics, rays)


def make_chunk_renderer(
    cfg: ContainerConfig,
    *,
    ray_samples: int,
    bg_policy: str = "white",
    active_expert: Optional[int] = None,
    occ_state: Optional[Dict] = None,
    occ_importance: bool = False,
    occ_hard_mask: bool = True,
    use_bg_fn: bool = True,
    sigma_scale: float = 1.0,
    mesh=None,
    occ_probe_grid_res: int = 0,
    occ_probe_mask: bool = False,
    fog_stats: bool = False,
    early_stop_eps: float = 0.0,
    device="cuda",
    use_kernels: bool = True,
) -> ChunkRenderer:
    """Fixed-size ray-chunk renderer. With occ_state and
    occ_hard_mask=False: the soft-occupancy one-shot renderer; without
    occ_state: the stratified renderer. `occ_state` is moved to `device`.
    use_kernels=False renders through the plain versions of the kernels
    (the card's own reference)."""
    dev = resolve_device(device)
    if mesh is not None:
        raise NotImplementedError("mesh-sharded rendering is not ported")
    if occ_probe_grid_res or occ_probe_mask or fog_stats or early_stop_eps:
        raise NotImplementedError(
            "union-probe grids, probe masks, fog stats and early stop are "
            "not ported")

    if occ_state is not None:
        if occ_hard_mask:
            raise NotImplementedError(
                "hard-mask occupancy rendering (two-wave dispatch) is not "
                "ported; soft-trained checkpoints render with "
                "occ_hard_mask=False")
        occ_dev = {k: v.to(dev) for k, v in occ_state.items()}

        def render_fn(params, statics, rays):
            rgb, depth, _, acc = render_rays_occ(
                params, cfg, statics, occ_dev, rays, ray_samples,
                randomized=False, bg_policy=bg_policy,
                active_expert=active_expert, importance=occ_importance,
                hard_mask=False, use_bg_fn=use_bg_fn,
                sigma_scale=sigma_scale, use_kernels=use_kernels)
            return rgb, depth, acc
    else:
        def render_fn(params, statics, rays):
            field = container_field_fn(params, cfg, statics, active_expert,
                                       use_kernels=use_kernels)
            rgb, depth, _, acc = render_rays_stratified(
                field, rays, ray_samples, randomized=False,
                bg_policy=bg_policy,
                bg_fn=container_bg_fn(params, cfg) if use_bg_fn else None,
                sigma_scale=sigma_scale, use_kernels=use_kernels)
            return rgb, depth, acc

    return ChunkRenderer(render_fn, dev)


def default_chunk_rays(ray_samples: int, budget_pts: int = 3_145_728) -> int:
    """The reference's render chunk: the largest multiple of 1024 rays with
    rays x samples <= budget_pts, within [4096, 65536]."""
    c = budget_pts // max(int(ray_samples), 1)
    return int(max(4096, min(65536, (c // 1024) * 1024)))


def _pad_chunk(chunk: np.ndarray, chunk_rays: int) -> np.ndarray:
    pad = chunk_rays - chunk.shape[0]
    if pad:
        chunk = np.concatenate([chunk, np.zeros((pad, 8), np.float32)], 0)
    return chunk


def _pack5(rgb, depth, acc):
    return torch.cat([rgb, depth[:, None], acc[:, None]], dim=1)


def render_rays_chunked(
    chunk_renderer: ChunkRenderer,
    params,
    statics: ContainerStatics,
    rays: np.ndarray,  # (n, 8) float32, host
    chunk_rays: int,
) -> np.ndarray:
    """Render a host ray batch through fixed-size zero-padded chunks ->
    (n, 5) float32 [rgb, depth, acc] on the host. Every chunk is dispatched
    before the first fetch, so the card runs ahead of the readbacks."""
    n = rays.shape[0]
    spans = [(s, min(chunk_rays, n - s)) for s in range(0, n, chunk_rays)]
    dev = chunk_renderer.device
    pending = []
    for s, m in spans:
        chunk = torch.from_numpy(_pad_chunk(rays[s:s + m], chunk_rays))
        if dev.type == "cuda":  # a pageable upload would wait for the card
            chunk = chunk.pin_memory().to(dev, non_blocking=True)
        pending.append((s, m, _pack5(*chunk_renderer(params, statics,
                                                     chunk))))
    out = np.zeros((n, 5), np.float32)
    for s, m, dev_out in pending:
        out[s:s + m] = dev_out[:m].cpu().numpy()
    return out


def render_image(
    chunk_renderer: ChunkRenderer,
    params,
    statics: ContainerStatics,
    md,  # any object with H, W, intrinsics (fx, fy, cx, cy) and c2w (3, 4)
    *,
    scene_aabb: Optional[np.ndarray] = None,
    near: Optional[float] = None,
    far: Optional[float] = None,
    chunk_rays: int = 65536,
):
    """Full-frame render -> (rgb (H,W,3) linear, depth (H,W), acc (H,W))
    as numpy."""
    H, W = md.H, md.W
    rays, _ = frame_rays(H, W, md.intrinsics, md.c2w, aabb=scene_aabb,
                         near=near, far=far)
    out = render_rays_chunked(chunk_renderer, params, statics, rays,
                              chunk_rays)
    return (out[:, 0:3].reshape(H, W, 3).copy(),
            out[:, 3].reshape(H, W).copy(),
            out[:, 4].reshape(H, W).copy())
