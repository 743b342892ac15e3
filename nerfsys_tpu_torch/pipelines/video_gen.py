"""Orbit / path video rendering with DRB-native camera paths (`--op video`).

Port of nerfsys_tpu/pipelines/video_gen.py: the pose builders
(`_normalize`, `rub_pose_from_pos`, `rub_pose_look_same_D`,
`rub_pose_from_fwd` :23-53), the path generators (`poses_turntable_drb`,
`gen_path_*`, `PATH_GENERATORS` :55-206; numpy float32, so the poses are
equal bit for bit), `suppress_fog` (:207) and `render_video` (:239).

Conventions: world translations in DRB; c2w stores RUB columns [right,
up, back]; world 'up' is -D = [-1, 0, 0].

`render_video` renders every frame of a camera path on the params'
device through one of four renderers, as the reference picks them:
- the baked snapshot (`--render_baked`): the baked camera renderer on the
  pose path, else the baked chunk renderer;
- the pose path (rays generated on the device from the pose; the fog
  suppression, sRGB and uint8 tail fused into each chunk's program): the
  live camera renderer, unless the hard-mask two-wave dispatcher, early
  stop or coherent dispatch needs per-ray bits on the host;
- `--render_coherent`: the coherent-expert renderer over host rays;
- otherwise `make_chunk_renderer` over host rays (the hard-mask two-wave
  dispatch, early stop, the stratified renderer).
Host rays come from `data.ram_rays.frame_rays` (the native generator)
with the reference's near bias and re-clamp. The frames are written as an
mp4 through `imageio` (libx264), or, on any exception there, as a PNG
sequence through PIL (`write_video`).

Mesh-sharded rendering (`maybe_render_mesh`) is not ported: the runner
refuses `--mesh_shape`. `--occ_probe_mask` reaches every occupancy
renderer above.
"""
from __future__ import annotations

import math
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from nerfsys_tpu_torch.data.ram_rays import frame_rays, np_clamp_rays
from nerfsys_tpu_torch.models import baked as baked_mod
from nerfsys_tpu_torch.ops.color_space import linear_to_srgb
from nerfsys_tpu_torch.pipelines.online.runtime_adapt import (
    default_chunk_rays,
    make_chunk_renderer,
    make_coherent_renderer,
    make_live_camera_renderer,
    render_rays_chunked,
)
from nerfsys_tpu_torch.utils.tree import tree_leaves

UP_WORLD = np.array([-1.0, 0.0, 0.0], dtype=np.float32)


# --------------------------- pose builders -----------------------------------
def _normalize(v):
    return v / max(np.linalg.norm(v), 1e-12)


def rub_pose_from_pos(center, cam, up_world=UP_WORLD) -> np.ndarray:
    """c2w (4,4) with RUB columns, camera at `cam` looking at `center`."""
    fwd = _normalize(np.asarray(center, np.float32) - cam)
    right = _normalize(np.cross(fwd, up_world))
    up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.stack([right, up, -fwd], axis=1)
    c2w[:3, 3] = cam
    return c2w


def rub_pose_look_same_D(center, cam, up_world=UP_WORLD) -> np.ndarray:
    """Look at the scene center projected to the camera's height (D axis)."""
    look = np.array([cam[0], center[1], center[2]], np.float32)
    return rub_pose_from_pos(look, cam, up_world)


def rub_pose_from_fwd(cam, fwd, up_world=UP_WORLD) -> np.ndarray:
    fwd = _normalize(np.asarray(fwd, np.float32))
    right = _normalize(np.cross(fwd, up_world))
    up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.stack([right, up, -fwd], axis=1)
    c2w[:3, 3] = cam
    return c2w


# --------------------------- path generators ----------------------------------
def poses_turntable_drb(
    center_drb, radius: float, phi_deg: float = 20.0, n_poses: int = 120,
    tilt_deg: float = 0.0,
) -> np.ndarray:
    """Turntable orbit. Returns (T, 4, 4)."""
    center = np.asarray(center_drb, np.float32)
    phi = math.radians(max(phi_deg, 12.0))
    thetas = np.linspace(0, 2 * math.pi, n_poses + 1, dtype=np.float32)[:-1]
    s_tilt = math.sin(math.radians(tilt_deg))
    c_tilt = math.cos(math.radians(tilt_deg))

    poses = []
    for th in thetas:
        cam = center + np.array(
            [-radius * math.sin(phi),
             radius * math.cos(phi) * math.cos(th),
             radius * math.cos(phi) * math.sin(th)],
            np.float32,
        )
        c2w = rub_pose_from_pos(center, cam)
        if abs(tilt_deg) > 1e-6:  # Rodrigues roll about the back axis
            k = _normalize(c2w[:3, 2])
            K = np.array(
                [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]],
                np.float32)
            R_t = np.eye(3, dtype=np.float32) * c_tilt + (
                1 - c_tilt
            ) * np.outer(k, k) + s_tilt * K
            c2w[:3, :3] = c2w[:3, :3] @ R_t
        poses.append(c2w)
    return np.stack(poses)


def gen_path_east_west(
    center, extent, n_poses: int, height_frac: float = -0.12,
    margin: float = 0.90,
) -> np.ndarray:
    """West-to-east sweep at constant height."""
    center = np.asarray(center, np.float32)
    halfD, halfR, halfB = 0.5 * np.asarray(extent, np.float32)
    D = height_frac * halfD
    R0, R1 = -margin * halfR, margin * halfR
    Boff = 0.15 * halfB
    ts = np.linspace(0, 1, n_poses, dtype=np.float32)
    u = 0.5 * (1 - np.cos(np.pi * ts))
    poses = []
    for t, w in zip(ts, u):
        cam = center + np.array(
            [D, (1 - w) * R0 + w * R1, Boff * math.sin(2 * math.pi * t)],
            np.float32)
        poses.append(rub_pose_look_same_D(center, cam))
    return np.stack(poses)


def gen_path_north_south(
    center, extent, n_poses: int, height_frac: float = -0.12,
    margin: float = 0.90,
) -> np.ndarray:
    """North-to-south sweep."""
    center = np.asarray(center, np.float32)
    halfD, halfR, halfB = 0.5 * np.asarray(extent, np.float32)
    D = height_frac * halfD
    B0, B1 = -margin * halfB, margin * halfB
    Roff = 0.15 * halfR
    ts = np.linspace(0, 1, n_poses, dtype=np.float32)
    u = 0.5 * (1 - np.cos(np.pi * ts))
    poses = []
    for t, w in zip(ts, u):
        cam = center + np.array(
            [D, Roff * math.sin(2 * math.pi * t), (1 - w) * B0 + w * B1],
            np.float32)
        poses.append(rub_pose_look_same_D(center, cam))
    return np.stack(poses)


def gen_path_spiral_inside(
    center, extent, n_poses: int, turns: float = 2.0,
    radial_frac: float = 0.6, height_center_frac: float = -0.15,
    height_amp_frac: float = 0.10,
) -> np.ndarray:
    """Spiral inside the AABB with mild height variation."""
    center = np.asarray(center, np.float32)
    extent = np.asarray(extent, np.float32)
    halfD, halfR, halfB = 0.5 * extent
    min_half = 0.5 * float(extent.min())
    r_base = radial_frac * min_half
    d_center = height_center_frac * halfD
    d_amp = height_amp_frac * halfD
    thetas = np.linspace(0, 2 * math.pi * turns, n_poses, dtype=np.float32)
    poses = []
    for th in thetas:
        rad = r_base * (0.85 + 0.15 * math.cos(th * 0.5))
        r = np.clip(rad * math.cos(th), -halfR * 0.95, halfR * 0.95)
        b = np.clip(rad * math.sin(th), -halfB * 0.95, halfB * 0.95)
        d = np.clip(d_center + d_amp * math.sin(0.5 * th), -halfD * 0.90,
                    halfD * 0.90)
        cam = center + np.array([d, r, b], np.float32)
        poses.append(rub_pose_from_pos(center, cam))
    return np.stack(poses)


def gen_path_full_coverage(
    center, extent, n_poses: int, rows: int = 6, cols: int = 9,
    height_start_frac: float = -0.18, height_end_frac: float = 0.18,
) -> np.ndarray:
    """Boustrophedon grid sweep over the scene."""
    center = np.asarray(center, np.float32)
    halfD, halfR, halfB = 0.5 * np.asarray(extent, np.float32)
    Rvals = np.linspace(-0.85 * halfR, 0.85 * halfR, cols)
    Bvals = np.linspace(-0.85 * halfB, 0.85 * halfB, rows)
    waypoints = []
    for i, b in enumerate(Bvals):
        Rs = Rvals if i % 2 == 0 else Rvals[::-1]
        waypoints.extend((float(r), float(b)) for r in Rs)
    legs = max(1, len(waypoints) - 1)
    f_per_leg = max(2, math.ceil(n_poses / legs))
    total = legs * f_per_leg
    t_heights = np.linspace(0.0, 1.0, total)
    d_start = height_start_frac * halfD
    d_end = height_end_frac * halfD

    poses = []
    idx = 0
    for k in range(legs):
        r0, b0 = waypoints[k]
        r1, b1 = waypoints[k + 1]
        for j in range(f_per_leg):
            w = 0.5 * (1 - math.cos(math.pi * j / f_per_leg))
            r = (1 - w) * r0 + w * r1
            b = (1 - w) * b0 + w * b1
            d = (1 - t_heights[idx]) * d_start + t_heights[idx] * d_end
            idx += 1
            cam = center + np.array([d, r, b], np.float32)
            poses.append(rub_pose_from_pos(center, cam))
    poses = np.stack(poses)
    if poses.shape[0] > n_poses:
        poses = poses[:n_poses]
    elif poses.shape[0] < n_poses:
        pad = np.repeat(poses[-1:], n_poses - poses.shape[0], axis=0)
        poses = np.concatenate([poses, pad])
    return poses


PATH_GENERATORS = {
    "turntable": lambda c, e, n: poses_turntable_drb(
        c, radius=0.9 * float(np.asarray(e).max()) / 2, n_poses=n
    ),
    "east_west": gen_path_east_west,
    "north_south": gen_path_north_south,
    "spiral_in": gen_path_spiral_inside,
    "full_coverage": gen_path_full_coverage,
}


# --------------------------- fog suppression ----------------------------------
def suppress_fog(
    rgb: np.ndarray,  # (N, 3)
    weights: Optional[np.ndarray],  # (N, S); None with wmax_entropy given
    acc: np.ndarray,  # (N,)
    bg_val: float,
    acc_thr: float = 0.05,
    wmax_thr: float = 0.08,
    entropy_thr: float = 1.5,
    wmax_entropy=None,  # precomputed ((N,), (N,)): the renderers compute
    # them on the device (fog_stats), so (N, S) weights never reach the host
):
    """Blank low-opacity / hazy pixels -> (rgb, stats)."""
    rgb = rgb.copy()
    low = acc < acc_thr
    rgb[low] = bg_val
    if wmax_entropy is not None:
        wmax, entropy = wmax_entropy
    else:
        wsum = np.maximum(weights.sum(1, keepdims=True), 1e-12)
        p = weights / wsum
        entropy = -(p * np.log(np.maximum(p, 1e-12))).sum(1)
        wmax = weights.max(1)
    fog = (acc < max(acc_thr * 1.3, 0.10)) & (
        (wmax < wmax_thr) | (entropy > entropy_thr))
    rgb[fog] = bg_val
    return rgb, {"pct_low": float(low.mean()), "pct_fog": float(fog.mean())}


# --------------------------- frame tails and the writer -----------------------
def fused_frame_tail(suppress: bool):
    """The pose path's device tail, `map_outputs(rgb, depth, acc[, wmax,
    entropy])` -> (C, 3) uint8: fog suppression (when on; entropy_thr
    1.4), linear -> sRGB, a truncating * 255 cast. The host tail below on
    the device."""
    def tail(rgb, depth, acc, *rest):
        if suppress:
            wmax, entropy = rest
            rgb = torch.where((acc < 0.05)[:, None], 1.0, rgb)
            fog = (acc < 0.10) & ((wmax < 0.08) | (entropy > 1.4))
            rgb = torch.where(fog[:, None], 1.0, rgb)
        srgb = linear_to_srgb(rgb)
        return (torch.clamp(srgb, 0.0, 1.0) * 255.0).to(torch.uint8)
    return tail


def host_frame_u8(out: np.ndarray, H: int, W: int,
                  suppress: bool) -> np.ndarray:
    """The host-ray path's tail: `render_rays_chunked`'s (H*W, 5 or 7)
    rows -> (H, W, 3) uint8 (`suppress_fog` with entropy_thr 1.4, linear ->
    sRGB, a truncating * 255 cast)."""
    rgb_lin = out[:, 0:3]
    if suppress:
        rgb_lin, _ = suppress_fog(rgb_lin, None, out[:, 4], bg_val=1.0,
                                  wmax_entropy=(out[:, 5], out[:, 6]),
                                  entropy_thr=1.4)
    with torch.no_grad():
        frame = linear_to_srgb(torch.from_numpy(
            np.ascontiguousarray(rgb_lin.reshape(H, W, 3)))).numpy()
    return (np.clip(frame, 0, 1) * 255).astype(np.uint8)


def write_video(frames: Sequence[np.ndarray], out_dir, camera_path: str,
                fps: int) -> Path:
    """<out_dir>/video_<path>.mp4 through imageio (libx264); on any
    exception there, the PNG sequence <out_dir>/video_<path>/00000.png ...
    through PIL -> the path written."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"video_{camera_path}.mp4"
    try:
        import imageio.v3 as iio

        iio.imwrite(out_path, np.stack(frames), fps=fps, codec="libx264")
    except Exception as e:  # the PNG-sequence fallback when no encoder
        print(f"[video] mp4 write failed ({e}); dumping PNG sequence")
        from PIL import Image as PILImage

        seq_dir = out_dir / f"video_{camera_path}"
        seq_dir.mkdir(exist_ok=True)
        for i, f in enumerate(frames):
            PILImage.fromarray(f).save(seq_dir / f"{i:05d}.png")
        out_path = seq_dir
    print(f"[video] wrote {out_path}")
    return out_path


# --------------------------- main entry ---------------------------------------
def render_video(ctx) -> Path:
    """Render a camera-path video from a trained checkpoint (--op video)
    on the params' device -> the path written.

    Intrinsics come from the first test image when test metadata is
    loaded (the video_width / height / fov flags are the fallback); the
    turntable uses the inside radius 0.6 * half the smallest extent and
    phi 45 deg; every path gets the camera drop 0.15 * extent_D and the
    near bias 0.15 * the scene radius, capped below t_far; the learned
    background MLP is off; fog suppression runs unless --no_suppress_fog,
    with the opacity / weight-shape signals computed on the device."""
    P = ctx["P"]
    statics = ctx["statics"]
    params = ctx["params"]
    cfg = ctx["cfg"]
    dev = tree_leaves(params)[0].device
    occ_state = ctx.get("occ_state")
    aabb = statics.global_aabb.detach().cpu().numpy().astype(np.float32)
    center = 0.5 * (aabb[0] + aabb[1])
    extent = aabb[1] - aabb[0]

    n_poses = int(getattr(P, "video_frames", 210))
    fps = int(getattr(P, "video_fps", 30))
    test_md = ctx.get("test_metadata") or []
    if test_md:
        md0 = test_md[0]
        H, W = int(md0.H), int(md0.W)
        fx, fy, cx, cy = [float(x) for x in np.asarray(md0.intrinsics[:4])]
    else:
        W = int(getattr(P, "video_width", 800))
        H = int(getattr(P, "video_height", 600))
        fx = fy = 0.9 * max(W, H)
        cx, cy = W / 2, H / 2

    if P.camera_path == "turntable":
        radius = 0.6 * 0.5 * float(extent.min())
        poses = poses_turntable_drb(center, radius=radius, phi_deg=45.0,
                                    n_poses=n_poses)
    else:
        poses = PATH_GENERATORS[P.camera_path](center, extent, n_poses)
    # camera drop: every camera 15% of the D extent down
    poses[:, 0, 3] += 0.15 * extent[0]
    # the near bias clips camera-adjacent haze
    near_bias = 0.15 * (0.5 * float(np.linalg.norm(extent)))
    print(f"[video] path={P.camera_path} frames={len(poses)} {W}x{H}")

    suppress = not getattr(P, "no_suppress_fog", False)
    baked_res = int(getattr(P, "render_baked", 0))
    coherent = bool(getattr(P, "render_coherent", False))
    early_stop = float(getattr(P, "render_early_stop", 0.0))
    occ_importance = bool(getattr(P, "occ_importance", False))
    occ_hard_mask = not getattr(P, "occ_no_hard_mask", False)
    occ_probe_mask = bool(getattr(P, "occ_probe_mask", False))
    probe_res = int(getattr(P, "occ_union_probe_res", 0))
    # pose-path eligibility: every one-program frame mode serves from the
    # camera (rays generated on the device, the fog / sRGB / uint8 tail
    # fused in: the host sends a pose and fetches 3 bytes a pixel). The
    # hard-mask two-wave dispatcher, early stop and coherent dispatch keep
    # host rays: their dispatch needs per-ray bits on the host.
    occ_hard_live = (baked_res == 0 and occ_state is not None
                     and occ_hard_mask)
    pose_path = not occ_hard_live and early_stop == 0.0 and not coherent
    chunk_rays = default_chunk_rays(P.ray_samples)
    fused_frame = fused_frame_tail(suppress)

    cam_renderer = renderer = None
    if baked_res > 0:
        # serving mode: one bake, then each frame costs trilinear lookups
        if coherent:
            print("[video] --render_coherent ignored with --render_baked "
                  "(the snapshot has no expert routing)")
        sh = int(getattr(P, "render_baked_sh", 3))
        bcfg = baked_mod.BakedConfig(
            resolution=baked_res, sh_levels=sh, n_dirs=max(32, 2 * sh ** 2),
            sparse_block=int(getattr(P, "render_baked_sparse", 0)))
        bake_occ = bool(getattr(P, "render_baked_occ", False))
        dilate = int(getattr(P, "render_baked_occ_dilate", 2))
        if bake_occ and occ_state is None:
            print("[video] WARNING: --render_baked_occ requested but the "
                  "checkpoint has no occupancy state — baking dense")
        cache = str(getattr(P, "render_baked_cache", "") or "")
        fp = baked_mod.params_fingerprint(params) if cache else ""
        ok = baked_mod.occ_bake_fingerprint(
            occ_state if bake_occ else None, dilate) if cache else ""
        baked = baked_mod.load_baked(cache, bcfg, fingerprint=fp,
                                     occ_key=ok, device=dev) if cache \
            else None
        if baked is not None:
            print(f"[video] loaded baked snapshot cache {cache}")
        else:
            t0 = time.perf_counter()
            baked = baked_mod.bake_field(
                params, cfg, statics, bcfg,
                occ_state=occ_state if bake_occ else None,
                occ_dilate=dilate, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            print(f"[video] baked {bcfg.resolution}³ SH-{bcfg.sh_levels} "
                  f"grid in {time.perf_counter() - t0:.1f}s")
            if cache:
                baked_mod.save_baked(cache, baked, bcfg, fingerprint=fp,
                                     occ_key=ok)
                print(f"[video] saved baked snapshot cache {cache}")
        if pose_path:
            cam_renderer = baked_mod.make_baked_camera_renderer(
                baked, bcfg, cfg, H=H, W=W, ray_samples=P.ray_samples,
                chunk_rays=chunk_rays, scene_aabb=aabb, near_bias=near_bias,
                bg_policy="white", use_bg_fn=False, fog_stats=suppress,
                map_outputs=fused_frame, device=dev)
        else:
            renderer = baked_mod.make_baked_chunk_renderer(
                baked, bcfg, cfg, ray_samples=P.ray_samples,
                bg_policy="white", use_bg_fn=False, fog_stats=suppress,
                device=dev)
    elif pose_path:
        cam_renderer = make_live_camera_renderer(
            cfg, H=H, W=W, ray_samples=P.ray_samples, chunk_rays=chunk_rays,
            scene_aabb=aabb, near_bias=near_bias, occ_state=occ_state,
            occ_importance=occ_importance, occ_hard_mask=occ_hard_mask,
            occ_probe_mask=occ_probe_mask, occ_probe_grid_res=probe_res,
            bg_policy="white", use_bg_fn=False, fog_stats=suppress,
            map_outputs=fused_frame, device=dev)
    elif coherent and early_stop == 0.0:
        # coherent-expert dispatch over host rays (exact)
        if probe_res > 0:
            print(f"[video] coherent + union-probe grid (res {probe_res}): "
                  "probe rows /K in every program")
        renderer = make_coherent_renderer(
            cfg, ray_samples=P.ray_samples, bg_policy="white",
            use_bg_fn=False, fog_stats=suppress, occ_state=occ_state,
            occ_importance=occ_importance, occ_hard_mask=occ_hard_mask,
            occ_probe_mask=occ_probe_mask, occ_probe_grid_res=probe_res,
            device=dev)
    else:
        if coherent:
            print("[video] --render_coherent ignored: unsharded renders "
                  "without --render_early_stop only")
        renderer = make_chunk_renderer(
            cfg, ray_samples=P.ray_samples, bg_policy="white",
            occ_state=occ_state, occ_importance=occ_importance,
            occ_probe_grid_res=probe_res, occ_hard_mask=occ_hard_mask,
            occ_probe_mask=occ_probe_mask, use_bg_fn=False,
            fog_stats=suppress, early_stop_eps=early_stop, device=dev)

    intr = np.array([fx, fy, cx, cy], np.float32)
    frames = []
    for i, c2w in enumerate(poses):
        if cam_renderer is not None:
            # pose path: the host sends the pose, fetches the uint8 frame
            frames.append(np.asarray(
                cam_renderer(params, statics, c2w[:3], intr), np.uint8))
        else:
            rays, _ = frame_rays(H, W, (fx, fy, cx, cy), c2w[:3], aabb=aabb)
            # t_near = max(t_near, 0) + near_bias, capped below t_far;
            # invalid rays stay inf-tagged (inf flows through the bias
            # arithmetic and the re-clamp unchanged)
            t_near = np.maximum(rays[:, 6], 0.0) + np.float32(near_bias)
            rays[:, 6] = np.minimum(t_near, rays[:, 7] - 1e-4)
            rays, _ = np_clamp_rays(rays)
            out = render_rays_chunked(renderer, params, statics, rays,
                                      chunk_rays, fog_stats=suppress)
            frames.append(host_frame_u8(out, H, W, suppress))
        if i % 10 == 0:
            print(f"[video] frame {i}/{len(poses)}")
    return write_video(frames, ctx["run_dir"], P.camera_path, fps)
