"""Multi-level occupancy grids: state, queries, probe CDF and sampler.

Port of nerfsys_tpu/ops/occupancy.py (`OccGridConfig` :42, `init_occ_state`
:69, `level_aabbs` :90, `cell_centers` :100, `_finest_level_index` :121, `query_binary` :159, `query_values` :179,
`query_pair` :196, `dilate_binary` :221, `update_occ_grid` :240,
`mark_invisible_cells` :343, `occupancy_probe_cdf` :394,
`sample_tvals_from_cdf` :468, `render_rays_occ_field` :556, soft and hard
mask). The grid's lifecycle: premark the cells no camera sees (-1, never
occupied), then EMA updates from the field at jittered cell centres; an
update takes its random draws from an explicit torch.Generator.

The grids of the K experts are stacked: occs (K, L, R, R, R) float EMA
values and binary (K, L, R, R, R) bool. Level l of an expert covers its box
scaled by 2^l about the centre, and the finest level containing a point
decides its cell.

Kernel 2 (`csrc/occ_probe.cu`) computes the union probe + CDF on the card
(launch plan from `occ_probe_plan`; level tables from `level_bounds`,
cached per box tensor), kernel 3 (`csrc/occ_sample.cu`) the inverse-CDF
sampler and, with the probe bits, each sample's interval bit (3m, the
reference's with_mask), and kernel 11q (`csrc/occ_query.cu`) the point
queries unioned over the stacked experts (`occupancy_query`: the hard
mask, the union probe grid's build, the bake's alive cells); the
`*_plain` functions are the same math in plain PyTorch.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from nerfsys_tpu_torch import kernels
from nerfsys_tpu_torch.utils.device import resolve_device

PairFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class OccGridConfig:
    """Static occupancy-grid hyperparameters: the reference's keys and
    defaults that the grid and its update read (its alpha-threshold anneal
    and cone_angle keys, which nothing reads, are dropped on import)."""

    resolution: int = 128
    levels: int = 4
    ema_decay: float = 0.95
    occ_thre: float = 1e-2
    warmup_steps: int = 256
    update_interval: int = 16
    # fraction of cells re-evaluated by an update after warmup (a
    # random-phase strided subset; every cell during warmup)
    sample_fraction: float = 0.5
    # passes of 3^3 box dilation of the binary field after each update
    dilate: int = 0


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


def cell_centers(aabb: torch.Tensor, cfg: OccGridConfig) -> torch.Tensor:
    """(L, R^3, 3) world-space cell centres of every level, cells in
    (i, j, k) row-major order."""
    R = cfg.resolution
    ar = torch.arange(R, device=aabb.device)
    idx = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"),
                      dim=-1).reshape(-1, 3)
    frac = (idx.to(torch.float32) + 0.5) / R
    la = level_aabbs(aabb, cfg.levels)
    return (la[:, 0][:, None, :]
            + frac[None] * (la[:, 1] - la[:, 0])[:, None, :])


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


def query_binary(binary: torch.Tensor, aabb: torch.Tensor,
                 pts: torch.Tensor) -> torch.Tensor:
    """One expert's occupancy (...,) bool at world points: the finest level
    containing each point decides; False outside every level."""
    L, R = binary.shape[0], binary.shape[1]
    decided, flat_idx = _finest_level_index(aabb, L, R, pts)
    return binary.reshape(-1)[flat_idx] & decided


def query_values(occs: torch.Tensor, aabb: torch.Tensor,
                 pts: torch.Tensor) -> torch.Tensor:
    """One expert's EMA occupancy value (...,) at world points from the
    finest containing level, clamped at 0 (invisible -1 tags read 0); 0
    outside every level."""
    L, R = occs.shape[0], occs.shape[1]
    decided, flat_idx = _finest_level_index(aabb, L, R, pts)
    val = torch.where(decided, occs.reshape(-1)[flat_idx],
                      torch.zeros((), dtype=occs.dtype, device=occs.device))
    return torch.clamp(val, min=0.0)


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


def dilate_binary(binary: torch.Tensor, passes: int = 1) -> torch.Tensor:
    """(L, R, R, R) bool -> box-dilated by `passes` cells on the three
    spatial axes, edges clamped (no wrap): each pass ORs every cell with
    its neighbours along one axis at a time, the full 3^3 box."""
    b = binary
    for _ in range(passes):
        for ax in (1, 2, 3):
            n = b.shape[ax]
            pad = torch.zeros_like(b.narrow(ax, 0, 1))
            fwd = torch.cat([pad, b.narrow(ax, 0, n - 1)], dim=ax)
            bwd = torch.cat([b.narrow(ax, 1, n - 1), pad], dim=ax)
            b = b | fwd | bwd
    return b


# ------------------------------ updates ------------------------------------
UPDATE_CHUNK = 131_072  # field evaluations of an update at once


def update_occ_grid(
    occ_state_k: Dict[str, torch.Tensor],  # one expert's occs, binary
    aabb: torch.Tensor,  # (2, 3)
    density_fn: Callable[[torch.Tensor], torch.Tensor],  # (M, 3) -> (M,)
    render_step_size: float,
    cfg: OccGridConfig,
    generator: Optional[torch.Generator],
    warmup: bool,
) -> Dict[str, torch.Tensor]:
    """One EMA occupancy update of one expert -> {occs, binary} (L, R, R,
    R). During warmup every cell is re-evaluated; after it, one
    random-phase strided subset of about sample_fraction of the cells (a
    lattice of stride m = ceil(1 / fraction) from a phase drawn in [0, m),
    the same cells at every level), and the field is evaluated only
    there. The draws, on the grid's device from `generator`: a jitter
    uniform in [0, 1) of shape (L, M, 3) (M the cells evaluated a level),
    then the phase."""
    L, flat = cfg.levels, occ_state_k["occs"].reshape(cfg.levels, -1)
    m = _subset_stride(cfg)
    n_eval = flat.shape[1] if warmup else max(1, -(-flat.shape[1] // m))
    dev = flat.device
    jitter = torch.rand((L, n_eval, 3), generator=generator, device=dev)
    phase = torch.randint(0, m, (), generator=generator, device=dev)
    return _update_occ_grid(occ_state_k, aabb, density_fn, render_step_size,
                            cfg, warmup, jitter, phase)


def _subset_stride(cfg: OccGridConfig) -> int:
    """m: an update after warmup evaluates every m-th cell."""
    return max(1, math.ceil(1.0 / max(cfg.sample_fraction, 1e-6) - 1e-9))


def _update_occ_grid(occ_state_k, aabb, density_fn, render_step_size, cfg,
                     warmup: bool, jitter: torch.Tensor, phase: int):
    """`update_occ_grid` with its draws given: jitter (L, M, 3) in [0, 1)
    and the subset's phase in [0, m) (an int or a scalar tensor on the
    grid's device)."""
    R, L = cfg.resolution, cfg.levels
    occs = occ_state_k["occs"]
    flat = occs.reshape(L, -1)
    n_cells = flat.shape[1]
    la = level_aabbs(aabb, L)
    cell_size = (la[:, 1] - la[:, 0]) / R  # (L, 3)

    def eval_new_vals(idx):  # (L, M) cell indices -> (L, M) sigma * step
        i = torch.div(idx, R * R, rounding_mode="floor")
        j = torch.div(idx, R, rounding_mode="floor") % R
        k = idx % R
        frac = (torch.stack([i, j, k], dim=-1).to(torch.float32) + 0.5) / R
        centers = (la[:, 0][:, None, :]
                   + frac * (la[:, 1] - la[:, 0])[:, None, :])
        # jitter inside the cell (nerfacc samples uniformly within cells)
        pts = (centers + (jitter - 0.5) * cell_size[:, None, :]).reshape(-1,
                                                                          3)
        with torch.no_grad():
            sigma = torch.cat([density_fn(pts[s:s + UPDATE_CHUNK])
                               for s in range(0, pts.shape[0],
                                              UPDATE_CHUNK)])
        return sigma.reshape(L, -1) * render_step_size

    invisible = flat < 0.0  # premarked cells stay -1 forever
    if warmup:
        idx = torch.arange(n_cells, dtype=torch.int32,
                           device=flat.device).expand(L, n_cells)
        ema = torch.maximum(flat * cfg.ema_decay, eval_new_vals(idx))
        updated = torch.where(~invisible, ema, flat)
    else:
        m = _subset_stride(cfg)
        n_sub = max(1, -(-n_cells // m))
        # the lattice reaches the last cells when m does not divide
        # n_cells; the overshoot wraps to the front (unique within a call)
        idx1 = (torch.arange(n_sub, dtype=torch.int64, device=flat.device)
                * m + phase) % n_cells
        idx = idx1.expand(L, n_sub)
        new_val = eval_new_vals(idx)
        cur = torch.gather(flat, 1, idx)
        upd = torch.where(cur < 0.0, cur,
                          torch.maximum(cur * cfg.ema_decay, new_val))
        updated = flat.clone()
        updated.scatter_(1, idx, upd)

    # binary = occ > min(occ_thre, mean of the visible occs)
    visible_vals = torch.where(invisible, torch.zeros_like(updated), updated)
    mean_occ = visible_vals.sum() / torch.clamp((~invisible).sum(), min=1)
    thre = torch.clamp(mean_occ, max=cfg.occ_thre)
    binary = (updated > thre) & ~invisible
    if cfg.dilate > 0:
        binary = dilate_binary(binary.reshape(occs.shape),
                               cfg.dilate).reshape(L, -1)
    return {"occs": updated.reshape(occs.shape),
            "binary": binary.reshape(occs.shape)}


def mark_invisible_cells(
    aabb: torch.Tensor,  # (2, 3)
    cfg: OccGridConfig,
    c2ws: torch.Tensor,  # (N, 3, 4) camera-to-world, RUB camera frame
    intrinsics: torch.Tensor,  # (N, 4) fx fy cx cy
    wh: torch.Tensor,  # (N, 2) W, H
    near: float = 0.0,
) -> torch.Tensor:
    """occs (L, R, R, R) of {0, -1}: -1 for the cells whose centre no
    camera sees (it projects outside every image or lies behind every
    camera), computed over chunks of UPDATE_CHUNK cells."""
    pts = cell_centers(aabb, cfg).reshape(-1, 3)
    r_w2c = c2ws[:, :3, :3].transpose(1, 2)  # (N, 3, 3) world -> camera
    t = c2ws[:, :3, 3]
    fx, fy, cx, cy = (intrinsics[:, i:i + 1] for i in range(4))
    W, H = wh[:, 0:1], wh[:, 1:2]

    def visible_chunk(p):  # (C, 3) -> (C,) bool
        rel = p[None, :, :] - t[:, None, :]  # (N, C, 3)
        cam = torch.einsum("nij,ncj->nci", r_w2c, rel)  # RUB frame
        z = -cam[..., 2]  # RUB: forward is -z
        in_front = z > near
        x = cam[..., 0] / torch.clamp(z, min=1e-8)
        y = cam[..., 1] / torch.clamp(z, min=1e-8)
        u = fx * x + cx
        v = -fy * y + cy  # image v grows downward; camera y is up
        in_img = (u >= 0) & (u < W) & (v >= 0) & (v < H)
        return (in_front & in_img).any(dim=0)

    visible = torch.cat([visible_chunk(pts[s:s + UPDATE_CHUNK])
                         for s in range(0, pts.shape[0], UPDATE_CHUNK)])
    occs = torch.where(visible, 0.0, -1.0)
    R = cfg.resolution
    return occs.reshape(cfg.levels, R, R, R)


def union_pair(occs: torch.Tensor, binary: torch.Tensor, aabbs: torch.Tensor,
               pts: torch.Tensor):
    """(any-expert occ, max-over-experts value) of the stacked grids."""
    occ_k, val_k = zip(*(query_pair(occs[k], binary[k], aabbs[k], pts)
                         for k in range(occs.shape[0])))
    return torch.stack(occ_k).any(dim=0), torch.stack(val_k).amax(dim=0)


QUERY_MODES = ("bits", "values", "pair")
QUERY_SMEM = 227 * 1024  # csrc/occ_query.cu: a block's level table
QUERY_MAX_LEVELS = 8  # csrc/occ_query.cu: its level loop, unrolled


def occupancy_query_plain(occs: Optional[torch.Tensor],
                          binary: Optional[torch.Tensor],
                          aabbs: torch.Tensor, pts: torch.Tensor, mode: str):
    """Plain PyTorch version of kernel 11q: the point queries of the K
    stacked experts unioned, as the reference's union_binary_fn /
    union_value_fn / union_pair_fn do -> any-expert bits (...,) bool
    ("bits"), max-over-experts values (...,) ("values"), or both
    ("pair")."""
    if mode == "bits":
        occ = query_binary(binary[0], aabbs[0], pts)
        for k in range(1, binary.shape[0]):
            occ = occ | query_binary(binary[k], aabbs[k], pts)
        return occ
    if mode == "values":
        val = query_values(occs[0], aabbs[0], pts)
        for k in range(1, occs.shape[0]):
            val = torch.maximum(val, query_values(occs[k], aabbs[k], pts))
        return val
    return union_pair(occs, binary, aabbs, pts)


def occupancy_query_kernel(occs: Optional[torch.Tensor],
                           binary: Optional[torch.Tensor],
                           aabbs: torch.Tensor, pts: torch.Tensor,
                           mode: str):
    """Kernel 11q's wrapper: the plain version for CPU tensors; on CUDA
    tensors it launches `occupancy_query` (one or four points a thread;
    its level table and step rows from `query_table`, cached per box
    tensor, level count and resolution) or raises. `occs` may be None in "bits" mode and
    `binary` in "values" mode."""
    if mode not in QUERY_MODES:
        raise ValueError(f"occupancy_query: mode={mode!r}, expected one of "
                         f"{QUERY_MODES}")
    if pts.device.type == "cpu":
        return occupancy_query_plain(occs, binary, aabbs, pts, mode)
    if pts.device.type != "cuda":
        raise ValueError(f"occupancy_query: unsupported device {pts.device}")
    dev = pts.device
    bits, values = mode != "values", mode != "bits"
    grid = binary if bits else occs
    K, L, R = grid.shape[0], grid.shape[1], grid.shape[2]
    if (grid.dim() != 5 or tuple(aabbs.shape) != (K, 2, 3)
            or (bits and values and binary.shape != occs.shape)):
        raise ValueError("occupancy_query: grid/box shapes disagree")
    if K * L * R ** 3 >= 2 ** 31:
        raise ValueError("occupancy_query: the kernel takes grids of fewer "
                         "than 2^31 cells")
    if L > QUERY_MAX_LEVELS or query_smem(K, L) > QUERY_SMEM:
        raise ValueError(f"occupancy_query: the kernel takes at most "
                         f"{QUERY_MAX_LEVELS} levels and {QUERY_SMEM} bytes "
                         f"of level table (K={K} x L={L} levels: "
                         f"{query_smem(K, L)})")
    if aabbs.dtype != torch.float32:
        raise TypeError(f"occupancy_query: aabbs has dtype {aabbs.dtype}, "
                        f"expected torch.float32")
    if pts.shape[-1] != 3:
        raise ValueError("occupancy_query: pts must be (..., 3)")
    table = _cached_table(aabbs, L, R)
    flat = pts.reshape(-1, 3)
    kernels.check_cuda_tensors(
        "occupancy_query", dev, pts=flat, table=table,
        occs=occs if values else None, binary=binary if bits else None)
    M = flat.shape[0]
    out_bits = (torch.empty((M,), dtype=torch.bool, device=dev) if bits
                else None)
    out_vals = (torch.empty((M,), dtype=torch.float32, device=dev)
                if values else None)
    if M:
        kernels.OCC_QUERY(
            flat.data_ptr(), occs.data_ptr() if values else 0,
            binary.data_ptr() if bits else 0, table.data_ptr(),
            0 if out_bits is None else out_bits.data_ptr(),
            0 if out_vals is None else out_vals.data_ptr(), M, K, L, R,
            kernels.stream_ptr(pts))
    shape = pts.shape[:-1]
    if mode == "bits":
        return out_bits.reshape(shape)
    if mode == "values":
        return out_vals.reshape(shape)
    return out_bits.reshape(shape), out_vals.reshape(shape)


def occupancy_query(occs: Optional[torch.Tensor],
                    binary: Optional[torch.Tensor], aabbs: torch.Tensor,
                    pts: torch.Tensor, mode: str, *,
                    use_kernels: bool = True):
    """The occupancy at world points pts (..., 3) under the UNION of the
    stacked experts' grids, occs / binary (K, L, R, R, R) and aabbs (K, 2,
    3) (a single expert is a K=1 slice): "bits" -> any expert's bit,
    "values" -> the max over experts of the EMA value clamped at 0,
    "pair" -> (bits, values). A point inside no level of an expert reads
    (False, 0) for it. use_kernels=False runs the plain version on any
    device."""
    if use_kernels:
        return occupancy_query_kernel(occs, binary, aabbs, pts, mode)
    if mode not in QUERY_MODES:
        raise ValueError(f"occupancy_query: mode={mode!r}, expected one of "
                         f"{QUERY_MODES}")
    return occupancy_query_plain(occs, binary, aabbs, pts, mode)


@functools.lru_cache(maxsize=64)
def _probe_mids(P: int, device) -> torch.Tensor:
    """(P,) probe positions: the midpoints of P equal intervals of [0, 1],
    cached per (P, device): callers only read them."""
    edges = linspace01(P + 1, device)
    return (0.5 * (edges[:-1] + edges[1:])).contiguous()


def _probe_points(rays_o, rays_d, near, far, P: int) -> torch.Tensor:
    mids = _probe_mids(P, rays_o.device)
    t_probe = near[:, None] + (far - near)[:, None] * mids[None, :]
    return rays_o[:, None, :] + rays_d[:, None, :] * t_probe[..., None]


def _lanes(x: torch.Tensor) -> torch.Tensor:
    """(N, P) -> (N, J, 32), J = ceil(P / 32), zero-padded: probe p on lane
    p % 32 in chunk p // 32, as kernel 2's phase 2 holds a ray's probes."""
    N, P = x.shape
    J = -(-P // 32)
    return torch.nn.functional.pad(x, (0, 32 * J - P)).reshape(N, J, 32)


def _lane_sum(x: torch.Tensor) -> torch.Tensor:
    """(N, P) -> (N, 1) row sums in kernel 2's order: each lane adds its
    probes chunk by chunk, then a butterfly over the 32 lanes (every lane
    ends with the same rounded sum). Equal to the kernel's sums bit for
    bit, so the pdf and cdf built from them are too."""
    lanes = _lanes(x)
    v = lanes[:, 0]
    for j in range(1, lanes.shape[1]):
        v = v + lanes[:, j]
    lane = torch.arange(32, device=x.device)
    for off in (16, 8, 4, 2, 1):
        v = v + v[:, lane ^ off]
    return v[:, :1]


def _lane_cumsum(x: torch.Tensor) -> torch.Tensor:
    """(N, P) -> (N, P) inclusive prefix sums in kernel 2's order: a
    Hillis-Steele scan over each chunk of 32 probes, plus the running sum
    of the earlier chunks' totals."""
    N, P = x.shape
    lanes = _lanes(x)
    lane = torch.arange(32, device=x.device)
    for off in (1, 2, 4, 8, 16):
        up = torch.nn.functional.pad(lanes[..., :-off], (off, 0))
        lanes = torch.where(lane >= off, lanes + up, lanes)
    out, carry = [lanes[:, 0]], lanes[:, 0, 31:]
    for j in range(1, lanes.shape[1]):
        out.append(lanes[:, j] + carry)
        carry = carry + lanes[:, j, 31:]
    return torch.cat(out, dim=1)[:, :P]


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
    kernel_order: Optional[bool] = None,
) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of kernel 2: probe P midpoints per ray and
    build {cdf (N, P+1), alive (N,), occ (N, P)}. importance=True mixes the
    EMA values into the pdf (the reference's pair_fn path); False uses the
    occupancy bits alone.

    `kernel_order` (default: for CUDA tensors) runs the sums and the scan
    in the kernel's order (`_lane_sum`, `_lane_cumsum`), so on the same
    probes the cdf is the kernel's bit for bit: a rounding difference
    there moves the samples kernel 3 draws, and with them every gradient
    of a training step. Otherwise torch's reductions, whose rounding on
    the CPU stays near the reference's on XLA's CPU."""
    if kernel_order is None:
        kernel_order = rays_o.device.type == "cuda"
    if kernel_order:
        row_sum, cumsum = _lane_sum, _lane_cumsum
    else:
        row_sum = functools.partial(torch.sum, dim=1, keepdim=True)
        cumsum = functools.partial(torch.cumsum, dim=1)
    N, P = rays_o.shape[0], n_probes
    pts = _probe_points(rays_o, rays_d, near, far, P)
    occ, val = pair_fn(pts.reshape(-1, 3))
    occ = occ.reshape(N, P)
    alive = occ.any(dim=1)
    occf = occ.to(rays_o.dtype)
    if importance:
        val = torch.clamp(val.reshape(N, P), min=0.0).to(rays_o.dtype) * occf
        vsum = row_sum(val)
        osum = torch.clamp(row_sum(occf), min=1e-12)
        uni = occf / osum
        imp = torch.where(vsum > 1e-12, val / torch.clamp(vsum, min=1e-12),
                          uni)
        w = (1.0 - uniform_frac) * imp + uniform_frac * uni
    else:
        w = occf
    if ray_floor > 0.0:
        wsum = torch.clamp(row_sum(w), min=1e-12)
        w = (1.0 - ray_floor) * (w / wsum) + ray_floor / P
    cdf = cumsum(w + 1e-12)
    cdf = cdf / cdf[:, -1:]
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=1)
    return {"cdf": cdf, "alive": alive, "occ": occ}


PROBE_THREADS = 256  # 8 warps a block
PROBE_RAYS_MIN = 16_384  # calls of this many rays take lanes across rays
PROBE_SMEM = 48 * 1024  # the level table and the tile, without an opt-in
PROBE_LANE_MAPS = ("probes", "rays")  # kernel lane_map 0, 1
BOX_FLOATS = 12  # a level's bounds a, b, its lo and its width


@dataclasses.dataclass(frozen=True)
class ProbeLaunchPlan:
    """Launch geometry of kernel 2 (csrc/occ_probe.cu `ProbePlan`)."""

    lane_map: str  # "rays": a block's lanes across 32 consecutive rays,
    # its warps across probes; "probes": a warp a ray, lanes over probes
    rays: int  # rays a block
    threads: int
    blocks: int
    stride: int  # floats a staged row of the tile: P rounded up to odd
    smem: int  # the level table, then the rays x stride tile
    group: int  # experts located together: 1, or 4 (K > 1)
    chunks: int  # probes a lane in phase 2: the power of 2 at or above
    # ceil(P / 32)

    def as_struct(self) -> "kernels.ProbePlan":
        return kernels.ProbePlan(
            PROBE_LANE_MAPS.index(self.lane_map), self.rays, self.threads,
            self.blocks, self.stride, self.smem, self.group, self.chunks)


def occ_probe_plan(n: int, p: int, k: int, l: int,
                   lane_map: Optional[str] = None) -> ProbeLaunchPlan:
    """Kernel 2's plan for N rays of P probes over K experts' L-level
    grids: lanes across rays from PROBE_RAYS_MIN rays a call (a serve
    chunk's neighbouring pixels probe neighbouring cells), lanes over a
    ray's probes below it (a training task's scattered rays), unless
    `lane_map` says which; the probe results of a block's rays staged in a
    tile of odd row stride (conflict-free in both directions)."""
    if not 1 <= p <= 256:
        raise ValueError(f"occupancy_probe_cdf: P={p}, the kernel takes "
                         f"1 <= P <= 256")
    if lane_map is None:
        lane_map = "rays" if n >= PROBE_RAYS_MIN else "probes"
    if lane_map not in PROBE_LANE_MAPS:
        raise ValueError(f"lane_map={lane_map!r}: expected one of "
                         f"{PROBE_LANE_MAPS}")
    warps = PROBE_THREADS // 32
    rays = 32 if lane_map == "rays" else warps
    stride = p | 1
    smem = 4 * (k * l * BOX_FLOATS + rays * stride)
    if smem > PROBE_SMEM:
        raise ValueError(f"occupancy_probe_cdf: K={k} x L={l} levels and "
                         f"{rays} rays of {p} probes exceed {PROBE_SMEM} "
                         f"bytes of shared memory")
    return ProbeLaunchPlan(lane_map=lane_map, rays=rays,
                           threads=PROBE_THREADS,
                           blocks=max(1, -(-n // rays)), stride=stride,
                           smem=smem, group=1 if k == 1 else 4,
                           chunks=1 << (-(-p // 32) - 1).bit_length())


@functools.lru_cache(maxsize=256)
def _probe_struct(n: int, p: int, k: int, l: int) -> "kernels.ProbePlan":
    """`occ_probe_plan` as the kernel's struct, per shape."""
    return occ_probe_plan(n, p, k, l).as_struct()


def _float_key(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 keys in the floats' order (-0.0 just below +0.0)."""
    u = x.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(u >= 0, u, -(u + 2 ** 31) - 1)


def _key_float(key: torch.Tensor) -> torch.Tensor:
    bits = torch.where(key >= 0, key, -(key + 1) - 2 ** 31)
    return bits.to(torch.int32).view(torch.float32)


def _first_float(pred, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The least float x in (lo, hi] with pred(x), elementwise, for a pred
    monotone in x that is false at lo and true at hi: a bisection over the
    floats' order (any two keys lie within 2^33), with no host sync."""
    lo_k, hi_k = _float_key(lo), _float_key(hi)
    for _ in range(33):
        mid = lo_k + (hi_k - lo_k) // 2
        take = pred(_key_float(mid))
        hi_k = torch.where(take, mid, hi_k)
        lo_k = torch.where(take, lo_k, mid)
    return _key_float(hi_k)


def level_bounds(aabbs: torch.Tensor, levels: int) -> torch.Tensor:
    """(K, L, 12) float32: per level of each box, the float bounds a, b of
    its inside test, its lo and its width. With rel = (x - lo) / (hi - lo)
    as `_finest_level_index` rounds it, rel >= 0 and rel < 1 are monotone
    in x, so on each axis 0 <= rel < 1 holds exactly for a <= x < b: kernel
    2 tests levels by comparison and divides only for the deciding one,
    selecting the plain version's cells bit for bit. Levels must have a
    positive finite width (every box the port builds has); others are
    never inside."""
    la = level_aabbs(aabbs.to(torch.float32), levels)
    lo, hi = la[..., 0, :], la[..., 1, :]
    w = hi - lo
    a = _first_float(lambda x: (x - lo) / w >= 0.0,
                     torch.full_like(lo, float("-inf")), lo)
    b = _first_float(lambda x: (x - lo) / w >= 1.0, lo, hi)
    empty = ~((w > 0.0) & torch.isfinite(w))
    a = torch.where(empty, float("inf"), a)
    b = torch.where(empty, float("-inf"), b)
    return torch.cat([a, b, lo, w], dim=-1).contiguous()


def cell_steps(lo: torch.Tensor, hi: torch.Tensor, R: int) -> torch.Tensor:
    """(..., R + 1) float32 step rows of levels spanning lo to hi (...,) on
    one axis: t_0 = -inf, t_j (0 < j < R) the least float x with
    trunc(fl(fl(x - lo) / (hi - lo)) * R) >= j, the cell formula of
    `_finest_level_index`, and t_R = +inf. That cell is monotone in x, so
    for x in the level (a <= x < b of `level_bounds`) the plain version's
    cell is the c with t_c <= x < t_{c+1}: the number of step points <= x.
    Found by `_first_float`'s bisection, on the tensors' device. Levels
    without a positive finite width get rows of +inf (they hold no
    point)."""
    lo = lo.to(torch.float32)
    hi = hi.to(torch.float32)
    w = hi - lo
    j = torch.arange(1, R, dtype=torch.float32, device=lo.device)
    shape = lo.shape + (R - 1,)
    lo_, w_ = lo[..., None], w[..., None]
    t = _first_float(lambda x: (x - lo_) / w_ * R >= j, lo_.expand(shape),
                     hi[..., None].expand(shape))
    empty = ~((w > 0.0) & torch.isfinite(w))
    t = torch.where(empty[..., None], float("inf"), t)
    inf = torch.full(lo.shape + (1,), float("inf"), device=lo.device)
    return torch.cat([-inf, t, inf], dim=-1)


def query_smem(K: int, L: int) -> int:
    """Bytes of kernel 11q's shared level table: 16 floats a level."""
    return 64 * K * L


def query_table(aabbs: torch.Tensor, levels: int, R: int) -> torch.Tensor:
    """Kernel 11q's table, flat float32: per level of each box 16 floats,
    a, b.x | b.y, b.z, w.x, w.y | lo, s.x | s.y, s.z, w.z, 0, where a, b,
    lo, w are `level_bounds`' and s = R / w is the cell guess's scale;
    then the (K, L, 3, R + 1) `cell_steps` rows of every level and axis,
    zero-padded to whole float4s."""
    lb = level_bounds(aabbs, levels)  # (K, L, 12): a, b, lo, w
    a, b, lo, w = (lb[..., 3 * i:3 * i + 3] for i in range(4))
    s = torch.full_like(w, float(R)) / w
    zero = torch.zeros_like(w[..., :1])
    head = torch.cat([a, b, w[..., :2], lo, s, w[..., 2:], zero], dim=-1)
    la = level_aabbs(aabbs.to(torch.float32), levels)
    steps = cell_steps(la[..., 0, :], la[..., 1, :], R)  # (K, L, 3, R + 1)
    pad = steps.new_zeros(-steps.numel() % 4)  # whole float4s
    return torch.cat([head.reshape(-1), steps.reshape(-1), pad]).contiguous()


_LEVEL_TABLES: "OrderedDict[tuple, Tuple[torch.Tensor, torch.Tensor]]" = (
    OrderedDict())
LEVEL_TABLES_KEPT = 64


def _cached_table(aabbs: torch.Tensor, levels: int,
                  R: Optional[int] = None) -> torch.Tensor:
    """`level_bounds` (R None: kernel 2's) or `query_table` (kernel 11q's),
    cached per box tensor (its storage, offset, shape, strides and version
    counter), level count and R. An entry holds the boxes, so their storage
    is not freed and its address not reused while the entry lives; writing
    to the boxes in place bumps the version and misses the cache."""
    key = (aabbs.untyped_storage().data_ptr(), aabbs.storage_offset(),
           tuple(aabbs.shape), aabbs.stride(), aabbs._version, aabbs.device,
           aabbs.dtype, levels, R)
    hit = _LEVEL_TABLES.get(key)
    if hit is not None:
        _LEVEL_TABLES.move_to_end(key)
        return hit[1]
    table = (level_bounds(aabbs, levels) if R is None
             else query_table(aabbs, levels, R))
    _LEVEL_TABLES[key] = (aabbs, table)
    if len(_LEVEL_TABLES) > LEVEL_TABLES_KEPT:
        _LEVEL_TABLES.popitem(last=False)
    return table


def _level_table(aabbs: torch.Tensor, levels: int) -> torch.Tensor:
    """Kernel 2's level table, `level_bounds` through `_cached_table`."""
    return _cached_table(aabbs, levels)


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
    *,
    lane_map: Optional[str] = None,
) -> Dict[str, torch.Tensor]:
    """Kernel 2's wrapper: the plain version for CPU tensors; on CUDA
    tensors it launches `occupancy_probe_cdf` (with `occ_probe_plan`'s
    plan; `lane_map` overrides its choice) or raises."""
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
    if tuple(binary.shape) != tuple(occs.shape) or tuple(aabbs.shape) != (
            K, 2, 3):
        raise ValueError("occupancy_probe_cdf: grid/box shapes disagree")
    if K * L * R ** 3 >= 2 ** 31:
        raise ValueError("occupancy_probe_cdf: the kernel takes grids of "
                         "fewer than 2^31 cells")
    if aabbs.dtype != torch.float32:
        raise TypeError(f"occupancy_probe_cdf: aabbs has dtype "
                        f"{aabbs.dtype}, expected torch.float32")
    plan = (_probe_struct(N, P, K, L) if lane_map is None
            else occ_probe_plan(N, P, K, L, lane_map).as_struct())
    table = _level_table(aabbs, L)
    mids = _probe_mids(P, dev)
    kernels.check_cuda_tensors(
        "occupancy_probe_cdf", dev, rays_o=rays_o, rays_d=rays_d, near=near,
        far=far, occs=occs, binary=binary, levels=table)
    cdf = torch.empty((N, P + 1), dtype=torch.float32, device=dev)
    alive = torch.empty((N,), dtype=torch.bool, device=dev)
    occ = torch.empty((N, P), dtype=torch.bool, device=dev)
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    kernels.OCC_PROBE_CDF(
        rays_o.data_ptr(), rays_d.data_ptr(), near.data_ptr(), far.data_ptr(),
        mids.data_ptr(), occs.data_ptr(), binary.data_ptr(),
        table.data_ptr(), cdf.data_ptr(), alive.data_ptr(), occ.data_ptr(),
        N, P, K, L, R, int(importance), f32(1.0 - uniform_frac),
        f32(uniform_frac), f32(1.0 - ray_floor),
        f32(ray_floor / P) if ray_floor > 0.0 else 0.0, plan,
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
                       far: torch.Tensor, u: torch.Tensor,
                       occ: Optional[torch.Tensor] = None):
    """Plain PyTorch version of kernel 3: sorted t_vals (N, S) for targets
    u, (S,) or (N, S). With the probe bits occ (N, P) -> (t_vals, mask (N,
    S) bool): each sample's interval bit, taken through the stable sort's
    order as the reference's jnp.argsort takes it (samples of equal t keep
    their index order: an unstable sort could swap two tied samples from
    intervals with different bits)."""
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
    if occ is None:
        return torch.sort(t_vals, dim=1).values
    t_sorted, order = torch.sort(t_vals, dim=1, stable=True)
    return t_sorted, torch.gather(occ, 1, torch.gather(idx, 1, order))


SAMPLE_WARPS = 4  # warps a block of kernel 3, a ray each at a time
SAMPLE_SMEM = 48 * 1024  # the staged rows, without an opt-in


@dataclasses.dataclass(frozen=True)
class SampleLaunchPlan:
    """Launch geometry of kernel 3 (csrc/occ_sample.cu `SamplePlan`)."""

    warps: int  # warps a block, a ray each at a time
    threads: int
    blocks: int  # a block per SAMPLE_WARPS rays; the launch takes at most
    # the blocks resident at once, and the warps walk the rays, staging the
    # next row while they place the current one
    stride: int  # floats of a staged cdf row, one word of skew every 32
    smem: int  # warps x (2 rows + S placements) floats, then warps x S
    # bytes: the placements' probe bits (3m)
    top: int  # the largest power of 2 <= P: the binary search's first step

    def as_struct(self) -> "kernels.SamplePlan":
        return kernels.SamplePlan(self.warps, self.threads, self.blocks,
                                  self.stride, self.smem, self.top)


def sample_plan(n: int, p: int, s: int) -> SampleLaunchPlan:
    """Kernel 3's plan for N rays of P intervals and S samples: a warp a
    ray at a time, SAMPLE_WARPS warps a block, each warp's two cdf rows
    and placements in shared memory. The launch caps the grid at the
    blocks the card holds at once (the occupancy calculator's, per kernel
    instance and device), so the warps loop over the rays in one wave."""
    if p < 1 or s < 1:
        raise ValueError(f"sample_tvals_from_cdf: P={p}, S={s}")
    stride = p + (p >> 5) + 1
    smem = SAMPLE_WARPS * (4 * (2 * stride + s) + s)
    if smem > SAMPLE_SMEM:
        raise ValueError(f"sample_tvals_from_cdf: P={p} and S={s} exceed "
                         f"{SAMPLE_SMEM} bytes of shared memory")
    return SampleLaunchPlan(
        warps=SAMPLE_WARPS, threads=32 * SAMPLE_WARPS,
        blocks=max(1, -(-n // SAMPLE_WARPS)), stride=stride, smem=smem,
        top=1 << (p.bit_length() - 1))


@functools.lru_cache(maxsize=256)
def _sample_struct(n: int, p: int, s: int) -> "kernels.SamplePlan":
    """`sample_plan` as the kernel's struct, per shape."""
    return sample_plan(n, p, s).as_struct()


@functools.lru_cache(maxsize=64)
def _sample_edges(P: int, device) -> torch.Tensor:
    """linspace01(P + 1) per (P, device): the kernel only reads it."""
    return linspace01(P + 1, device)


def sample_tvals_kernel(cdf: torch.Tensor, near: torch.Tensor,
                        far: torch.Tensor, u: torch.Tensor,
                        occ: Optional[torch.Tensor] = None, *,
                        branch_counts: Optional[torch.Tensor] = None):
    """Kernel 3's wrapper: the plain version for CPU tensors; on CUDA
    tensors it launches `sample_tvals_from_cdf` (with `sample_plan`'s
    plan) or raises. With the probe bits occ (N, P) it returns (t_vals,
    mask), as `sample_tvals_plain` does (3m). `branch_counts`, a zeroed
    (2,) int32 tensor on the card, receives the rows that took the literal
    count and the rank sort."""
    if cdf.device.type == "cpu":
        return sample_tvals_plain(cdf, near, far, u, occ)
    if cdf.device.type != "cuda":
        raise ValueError(f"sample_tvals_from_cdf: unsupported device "
                         f"{cdf.device}")
    dev = cdf.device
    N, P = cdf.shape[0], cdf.shape[1] - 1
    S = u.shape[-1]
    per_ray = u.dim() == 2
    if per_ray and tuple(u.shape) != (N, S):
        raise ValueError("sample_tvals_from_cdf: u must be (S,) or (N, S)")
    plan = _sample_struct(N, P, S)
    edges = _sample_edges(P, dev)
    kernels.check_cuda_tensors("sample_tvals_from_cdf", dev, cdf=cdf,
                               near=near, far=far, u=u, occ=occ,
                               branch_counts=branch_counts)
    if branch_counts is not None and tuple(branch_counts.shape) != (2,):
        raise ValueError("sample_tvals_from_cdf: branch_counts must be (2,)")
    if occ is not None and tuple(occ.shape) != (N, P):
        raise ValueError("sample_tvals_from_cdf: occ must be (N, P)")
    t_vals = torch.empty((N, S), dtype=torch.float32, device=dev)
    mask = (None if occ is None
            else torch.empty((N, S), dtype=torch.bool, device=dev))
    kernels.OCC_SAMPLE(cdf.data_ptr(), near.data_ptr(), far.data_ptr(),
                       u.data_ptr(), edges.data_ptr(),
                       0 if occ is None else occ.data_ptr(),
                       t_vals.data_ptr(),
                       0 if mask is None else mask.data_ptr(),
                       0 if branch_counts is None
                       else branch_counts.data_ptr(),
                       N, P, S, int(per_ray), plan, kernels.stream_ptr(cdf))
    return t_vals if occ is None else (t_vals, mask)


def sample_tvals_from_cdf(
    cdf_state: Dict[str, torch.Tensor],
    near: torch.Tensor,
    far: torch.Tensor,
    n_samples: int,
    generator: Optional[torch.Generator] = None,
    randomized: bool = False,
    with_mask: bool = False,
    *,
    use_kernels: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """Pass 2: place S samples by inverse CDF over the probe intervals ->
    (t_vals (N, S) sorted, alive (N,)). with_mask=True also returns each
    sample's probe-interval occupancy bit (N, S), from cdf_state["occ"]
    (kernel 2's probe bits): the grid-query-free alternative to the point
    query of every sample (interval-resolution masking keeps a sample's
    sigma wherever its probe interval is occupied)."""
    cdf = cdf_state["cdf"]
    u = _sample_targets(cdf.shape[0], n_samples, cdf.device, generator,
                        randomized)
    fn = sample_tvals_kernel if use_kernels else sample_tvals_plain
    if not with_mask:
        return fn(cdf, near, far, u.contiguous()), cdf_state["alive"]
    t_vals, mask = fn(cdf, near, far, u.contiguous(), cdf_state["occ"])
    return t_vals, cdf_state["alive"], mask


def render_rays_occ_field(
    field_fn,  # (pts (M, 3), dirs (M, 3)) -> (rgb (M, 3), sigma (M,))
    occ_grid,  # (occs (K, L, R, R, R), binary, aabbs (K, 2, 3)): K=1 for
    # one expert, all K for the routed container (their union)
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
    """Occupancy-guided dense render of ONE field function: an expert (the
    meta inner loop, K=1 grid slice) or the routed container over the union
    of its K grids (test-time adaptation) -> (rgb (N, 3),
    depth (N,), weights (N, S), acc (N,)). Soft mode (hard_mask=False):
    the grid steers sample PLACEMENT and never deletes density. Hard mode:
    sigma is also zeroed where the binary grid is empty at the final
    sample points (point-exact: one query of the grid a sample, kernel
    11q) or, with mask_from_probes, where the sample's probe interval is
    empty (the bit kernel 2 already found; kernel 3 carries it to the
    sample), and on rays whose probes found nothing.

    Probe + CDF (kernel 2 over the stacked grids, skipped when `cdf_state`
    is given) -> inverse-CDF samples (kernel 3) -> field -> the hard mask
    -> compositor (kernel 4 and its backward)."""
    from nerfsys_tpu_torch.ops.volrend import (
        background_rgb,
        t_to_points,
        volume_render,
    )

    o = rays[:, 0:3].contiguous()
    d = rays[:, 3:6].contiguous()
    near, far = rays[:, 6], rays[:, 7]
    n_rays = o.shape[0]
    valid = (torch.isfinite(near) & torch.isfinite(far) & (far > near)
             & (far < 1e9))
    near_s = torch.where(valid, near, torch.zeros_like(near))
    far_s = torch.where(valid, far, torch.ones_like(far))
    if ray_floor is None:
        # soft mode needs unmarked space reachable; hard mode would zero
        # those samples anyway
        ray_floor = 0.0 if hard_mask else 0.25
    occs, binary, aabbs = occ_grid
    if cdf_state is None:
        cdf_state = occupancy_probe_cdf(
            occs, binary, aabbs, o, d, near_s, far_s, n_probes,
            importance=importance, uniform_frac=uniform_frac,
            ray_floor=ray_floor, use_kernels=use_kernels)
    occ_mask = None
    if mask_from_probes and hard_mask:
        t_vals, alive, occ_mask = sample_tvals_from_cdf(
            cdf_state, near_s, far_s, n_samples, generator=generator,
            randomized=randomized, with_mask=True, use_kernels=use_kernels)
    else:
        t_vals, alive = sample_tvals_from_cdf(
            cdf_state, near_s, far_s, n_samples, generator=generator,
            randomized=randomized, use_kernels=use_kernels)
    pts = t_to_points(o, d, t_vals)
    dirs = d[:, None, :].expand(pts.shape)
    flat_pts = pts.reshape(-1, 3)
    rgb, sigma = field_fn(flat_pts, dirs.reshape(-1, 3))
    rgb = rgb.reshape(n_rays, n_samples, 3)
    sigma = sigma.reshape(n_rays, n_samples)
    keep = valid[:, None]
    if hard_mask:
        if occ_mask is None:
            # point-exact: occupied under ANY of the stacked grids (one
            # for an expert)
            occ_mask = occupancy_query(occs, binary, aabbs, flat_pts, "bits",
                                       use_kernels=use_kernels)
        keep = occ_mask.reshape(n_rays, n_samples) & alive[:, None] & keep
    sigma = torch.where(keep, sigma, torch.zeros_like(sigma))
    if bg_fn is not None:
        bg = bg_fn(d)
    else:
        bg = background_rgb(bg_policy, n_rays, generator=generator,
                            last_sample_rgb=rgb[:, -1, :], dtype=rgb.dtype)
    rgb_sigma = torch.cat([rgb, sigma[..., None]], dim=-1)
    return volume_render(rgb_sigma, t_vals,
                         bg_rgb=None if bg is None else bg.contiguous(),
                         sigma_scale=sigma_scale, use_kernels=use_kernels)
