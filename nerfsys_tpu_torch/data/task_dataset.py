"""Episodic support/query task sampling over a region's ray pool (numpy).

The port's own copy of nerfsys_tpu/data/task_dataset.py: `Task`, the AABB
helpers, `build_cell_bounds`, the numpy DDA and alpha-point routers
(`_dda_route_numpy` :126, `_alpha_route_numpy` :198), the weak-overlap
filter, `route_rays_to_cells`, `route_rays_exact` and `TaskDataset`
(:357-684), with the reference's episode semantics:

  - Region AABB: given, or inferred from the rays' near points.
  - The region box is subdivided into a micro-cell grid cells = (1, cd, cd).
  - Routing: every ray is clipped to the region segment and routed to the
    micro-cell it overlaps most by exact 3D-DDA voxel traversal
    (max_steps 64), or by the alpha point and its 6 neighbours; a cheap
    sampled majority vote is kept as an approximation.
  - Weak-overlap filter: rays whose overlap with their selected cell is
    below max(1e-6 * ||cell size||, 1e-9) are dropped.
  - Per-cell pools are fully shuffled flat arrays; a cell is eligible from
    a minimum ray count.
  - An episode picks an eligible cell, splits S/Q preserving the ratio when
    the cell is underfilled, chooses support images (min/max with
    borrowing from the forbidden set), samples support rays with a greedy
    per-image cap, chooses query images avoiding the support images,
    samples query rays disjoint from the support rays, and borrows from
    all images (still ray-disjoint) when the query set is underfilled.
  - Fixed shapes: underfilled selections are padded by resampling the
    selected rays with replacement (pad_to_target=False keeps raw sizes).
  - With no eligible cell, one pool over every routed ray (the single-pool
    fallback).

The draws come from numpy's `default_rng(seed)`, as in the reference, so
the same seed gives the same episodes in both packages. The sampled and
DDA routers run through the native C++ kernels (data/native, one
multithreaded call over all rays), as the reference's do whenever g++
builds them; their numpy versions are the plain versions, reached only
through `native=False`, and the native DDA equals the numpy DDA bit for
bit. The alpha policy is numpy only, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from nerfsys_tpu_torch.data import native as _native
from nerfsys_tpu_torch.data.ram_rays import RamRaysDataset


@dataclasses.dataclass
class Task:
    """One episode (reference Task, task_dataset.py:10-22)."""

    support: Dict[str, np.ndarray]
    query: Dict[str, np.ndarray]
    cell_id: Optional[int] = None  # region (expert) id
    block_id: Optional[int] = None  # selected micro-cell id
    bounds: Optional[np.ndarray] = None  # (2, 3) cell AABB
    warnings: List[str] = dataclasses.field(default_factory=list)
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)


# --------------------------- geometry helpers --------------------------------
def _aabb_intersect_np(o, d, lo, hi, eps: float = 1e-12):
    """Reference slab test (task_dataset.py:129-152): IEEE 1/d (inf on
    parallel axes), explicit outside-parallel miss, NO clamping."""
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / d
        t0 = (lo - o) * inv
        t1 = (hi - o) * inv
    tmin = np.minimum(t0, t1)  # NaN-propagating, like torch.minimum
    tmax = np.maximum(t0, t1)
    parallel = np.abs(d) < eps
    outside_parallel = parallel & ~((o >= lo) & (o <= hi))
    miss_parallel = outside_parallel.any(axis=-1)
    t_entry = tmin.max(axis=-1)
    t_exit = tmax.min(axis=-1)
    hit = (t_exit >= t_entry) & ~miss_parallel
    return hit, t_entry, t_exit


def _region_segment_np(rays, aabb):
    """Clip rays to region AND [near, far] (task_dataset.py:154-171)."""
    o, d = rays[:, 0:3], rays[:, 3:6]
    hit, te, tx = _aabb_intersect_np(o, d, aabb[0], aabb[1])
    t0 = np.maximum(np.maximum(te, 0.0), rays[:, 6])
    t1 = np.minimum(tx, rays[:, 7])
    seg = t1 - t0
    with np.errstate(invalid="ignore"):
        valid = hit & (seg > 0) & np.isfinite(seg)
    return valid, t0, t1, seg


def build_cell_bounds(aabb: np.ndarray, cells: Tuple[int, int, int]):
    """Per-cell AABBs (C, 2, 3) by uniform subdivision (task_dataset.py:173-194)."""
    nx, ny, nz = cells
    lo, hi = aabb[0], aabb[1]
    size = np.maximum(hi - lo, 1e-9)
    fx = np.linspace(0, 1, nx + 1)
    fy = np.linspace(0, 1, ny + 1)
    fz = np.linspace(0, 1, nz + 1)
    X0, Y0, Z0 = np.meshgrid(fx[:-1], fy[:-1], fz[:-1], indexing="ij")
    X1, Y1, Z1 = np.meshgrid(fx[1:], fy[1:], fz[1:], indexing="ij")
    lo_n = np.stack([X0, Y0, Z0], -1).reshape(-1, 3)
    hi_n = np.stack([X1, Y1, Z1], -1).reshape(-1, 3)
    return np.stack([lo + size * lo_n, lo + size * hi_n], 1).astype(np.float32)


def _overlap_len_with_cells(rays, cell_aabbs):
    """Per-ray overlap length with a per-ray cell box (task_dataset.py:210-226).
    cell_aabbs: (N, 2, 3) or (2, 3)."""
    if cell_aabbs.ndim == 2:
        lo, hi = cell_aabbs[0], cell_aabbs[1]
    else:
        lo, hi = cell_aabbs[:, 0, :], cell_aabbs[:, 1, :]
    o, d = rays[:, :3], rays[:, 3:6]
    hit, te, tx = _aabb_intersect_np(o, d, lo, hi)
    t0 = np.maximum(np.maximum(te, 0.0), rays[:, 6])
    t1 = np.minimum(tx, rays[:, 7])
    seg = t1 - t0
    with np.errstate(invalid="ignore"):
        len_t = np.where(hit & np.isfinite(seg), np.maximum(seg, 0.0), 0.0)
    return len_t


def _dda_route_numpy(
    rays: np.ndarray,
    aabb: np.ndarray,
    cells: Tuple[int, int, int],
    max_steps: int = 64,
) -> np.ndarray:
    """Vectorized-numpy spec of the exact DDA max-overlap routing
    (task_dataset.py:242-351) + weak-overlap filter (:589-599).
    Returns (N,) int64 cell ids, -1 = segment miss / weak overlap."""
    N = rays.shape[0]
    out = np.full(N, -1, np.int64)
    valid, t0, t1, _ = _region_segment_np(rays, aabb)
    if not valid.any():
        return out
    idx = np.flatnonzero(valid)
    r = rays[idx]
    t0v, t1v = t0[idx], t1[idx]
    nx, ny, nz = cells
    dims = np.array(cells, np.float32)
    lo, hi = aabb[0], aabb[1]
    cell = np.maximum((hi - lo) / dims, 1e-12)

    g_o = (r[:, :3] - lo) / cell
    g_d = r[:, 3:6] / cell
    p = g_o + g_d * (t0v + 1e-6)[:, None]
    ix = np.floor(p).astype(np.int64)
    step = np.sign(g_d).astype(np.int64)
    nb = np.where(step > 0, np.floor(p) + 1.0, np.ceil(p) - 1.0)
    big = 1e30
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / g_d
        tMax = (nb - p) * inv
        tDelta = step * inv
    tMax = np.nan_to_num(tMax, nan=big, posinf=big, neginf=big)
    tDelta = np.nan_to_num(tDelta, nan=big, posinf=big, neginf=big)
    ix = np.clip(ix, 0, np.array([nx - 1, ny - 1, nz - 1]))

    nyz = ny * nz
    t = t0v.copy()
    best_len = np.zeros(len(idx), np.float32)
    best_cid = ix[:, 0] * nyz + ix[:, 1] * nz + ix[:, 2]
    for _ in range(max_steps):
        m = tMax.min(axis=1)
        t_next = np.minimum(m, t1v)
        dt = np.maximum(t_next - t, 0.0)
        cid = ix[:, 0] * nyz + ix[:, 1] * nz + ix[:, 2]
        improve = dt > best_len
        best_len = np.where(improve, dt, best_len)
        best_cid = np.where(improve, cid, best_cid)
        if (t_next >= t1v).all():
            break
        adv_x = (tMax[:, 0] <= tMax[:, 1]) & (tMax[:, 0] <= tMax[:, 2])
        adv_y = ~(tMax[:, 0] <= tMax[:, 1]) & (tMax[:, 1] <= tMax[:, 2])
        adv_z = ~(adv_x | adv_y)
        ix[:, 0] = np.where(adv_x, np.clip(ix[:, 0] + step[:, 0], 0, nx - 1),
                            ix[:, 0])
        ix[:, 1] = np.where(adv_y, np.clip(ix[:, 1] + step[:, 1], 0, ny - 1),
                            ix[:, 1])
        ix[:, 2] = np.where(adv_z, np.clip(ix[:, 2] + step[:, 2], 0, nz - 1),
                            ix[:, 2])
        tMax[:, 0] = np.where(adv_x, tMax[:, 0] + tDelta[:, 0], tMax[:, 0])
        tMax[:, 1] = np.where(adv_y, tMax[:, 1] + tDelta[:, 1], tMax[:, 1])
        tMax[:, 2] = np.where(adv_z, tMax[:, 2] + tDelta[:, 2], tMax[:, 2])
        t = t_next

    cb = build_cell_bounds(np.asarray(aabb, np.float32), cells)
    keep = _weak_overlap_keep(r, best_cid, cb)
    out[idx[keep]] = best_cid[keep]
    return out


def _alpha_route_numpy(
    rays: np.ndarray,
    aabb: np.ndarray,
    cells: Tuple[int, int, int],
    alpha: float = 0.7,
) -> np.ndarray:
    """Alpha-point + 6-neighbor local max-overlap policy
    (task_dataset.py:354-417) + weak-overlap filter. Same contract as
    _dda_route_numpy."""
    N = rays.shape[0]
    out = np.full(N, -1, np.int64)
    valid, t0, t1, seg = _region_segment_np(rays, aabb)
    if not valid.any():
        return out
    idx = np.flatnonzero(valid)
    r = rays[idx]
    t0v, t1v, segv = t0[idx], t1[idx], seg[idx]
    nx, ny, nz = cells
    nyz = ny * nz
    lo, hi = aabb[0], aabb[1]

    t_assign = t0v + alpha * (t1v - t0v) + 1e-6 * (t1v - t0v)
    p = r[:, :3] + r[:, 3:6] * t_assign[:, None]
    rel = np.clip((p - lo) / np.maximum(hi - lo, 1e-9), 0.0, 1.0 - 1e-7)
    pix = np.floor(rel[:, 0] * nx).astype(np.int64).clip(0, nx - 1)
    piy = np.floor(rel[:, 1] * ny).astype(np.int64).clip(0, ny - 1)
    piz = np.floor(rel[:, 2] * nz).astype(np.int64).clip(0, nz - 1)
    cid_primary = pix * nyz + piy * nz + piz

    dx = np.array([-1, 1, 0, 0, 0, 0, 0])
    dy = np.array([0, 0, -1, 1, 0, 0, 0])
    dz = np.array([0, 0, 0, 0, -1, 1, 0])
    cx = np.clip(pix[:, None] + dx, 0, nx - 1)
    cy = np.clip(piy[:, None] + dy, 0, ny - 1)
    cz = np.clip(piz[:, None] + dz, 0, nz - 1)
    cx[:, -1], cy[:, -1], cz[:, -1] = pix, piy, piz  # last = primary
    cand = cx * nyz + cy * nz + cz  # (M, 7)

    cb = build_cell_bounds(np.asarray(aabb, np.float32), cells)
    overlaps = np.stack(
        [_overlap_len_with_cells(r, cb[cand[:, k]]) for k in range(7)], 1
    )
    best_k = overlaps.argmax(1)
    rows = np.arange(len(idx))
    cid_best = cand[rows, best_k]
    len_best = overlaps[rows, best_k]

    sizes = cb[:, 1] - cb[:, 0]
    cell_diag = float(np.median(np.sqrt((sizes**2).sum(1))))
    tol_abs = max(1e-6 * cell_diag, 1e-9)
    ok = len_best >= np.maximum(tol_abs, 1e-6 * segv)
    cid_final = np.where(ok, cid_best, cid_primary)

    keep = _weak_overlap_keep(r, cid_final, cb)
    out[idx[keep]] = cid_final[keep]
    return out


def _weak_overlap_keep(rays, cid, cell_bounds):
    """Weak-overlap bin filter vs the SELECTED cell (task_dataset.py:589-599):
    keep when overlap >= max(1e-6 * ||cell size||, 1e-9) of that cell."""
    cb = cell_bounds[cid]
    len_t = _overlap_len_with_cells(rays, cb)
    size = np.linalg.norm(cell_bounds[:, 1] - cell_bounds[:, 0], axis=1)
    tol = np.maximum(1e-6 * size, 1e-9)[cid]
    return len_t >= tol


def route_rays_to_cells(
    rays: np.ndarray,  # (N, 8)
    aabb: np.ndarray,  # (2, 3) region box
    cells: Tuple[int, int, int],
    samples_per_ray: int = 16,
    rng: Optional[np.random.Generator] = None,
    chunk: int = 500_000,
    native: bool = True,
) -> np.ndarray:
    """APPROXIMATE majority-vote routing (cheap 'sampled' policy): max-overlap
    micro-cell id per ray (N,), -1 for rays missing the box. Kept for speed
    comparisons; the reference-exact policies are _dda_route_numpy /
    _alpha_route_numpy. The sample fractions are drawn from rng first, then
    the vote runs natively unless native=False."""
    rng = rng or np.random.default_rng(0)
    dims = np.asarray(cells, dtype=np.int64)
    n_cells = int(dims.prod())
    lo = aabb[0].astype(np.float32)
    extent = np.maximum(aabb[1] - aabb[0], 1e-8).astype(np.float32)

    ts = rng.uniform(0.0, 1.0, size=samples_per_ray).astype(np.float32)
    if native:
        return _native.route_rays_native(rays, aabb, cells, ts)

    out = np.full(rays.shape[0], -1, dtype=np.int64)
    for s in range(0, rays.shape[0], chunk):
        r = rays[s : s + chunk]
        o, d = r[:, :3], r[:, 3:6]
        near = np.nan_to_num(r[:, 6], nan=0.0, posinf=0.0)
        far = np.nan_to_num(r[:, 7], nan=0.0, posinf=0.0)
        valid = far > near
        t = near[:, None] + (far - near)[:, None] * ts[None, :]  # (M, P)
        pts = o[:, None, :] + d[:, None, :] * t[..., None]  # (M, P, 3)
        ijk = np.floor((pts - lo) / extent * dims).astype(np.int64)
        inside = ((ijk >= 0) & (ijk < dims)).all(-1)  # (M, P)
        ijk = np.clip(ijk, 0, dims - 1)
        flat = (ijk[..., 0] * dims[1] + ijk[..., 1]) * dims[2] + ijk[..., 2]
        flat = np.where(inside, flat, n_cells)  # out-of-box -> overflow bin
        # per-ray majority vote over cells: one flat bincount (np.add.at is
        # ~100x slower on scattered updates at this scale)
        M = flat.shape[0]
        rows = np.repeat(np.arange(M, dtype=np.int64), flat.shape[1])
        comb = rows * (n_cells + 1) + flat.reshape(-1)
        counts = np.bincount(comb, minlength=M * (n_cells + 1)).reshape(
            M, n_cells + 1
        )
        counts[:, n_cells] = 0  # never pick the overflow bin
        best = counts.argmax(1)
        hit = counts[np.arange(M), best] > 0
        out[s : s + chunk] = np.where(valid & hit, best, -1)
    return out


def route_rays_exact(
    rays: np.ndarray,
    aabb: np.ndarray,
    cells: Tuple[int, int, int],
    policy: str = "dda",
    alpha: float = 0.7,
    max_steps: int = 64,
    native: bool = True,
) -> np.ndarray:
    """Reference-exact routing dispatch: DDA and sampled through the native
    kernels unless native=False, alpha in numpy."""
    if policy == "dda":
        if native:
            return _native.dda_route_native(
                rays, np.asarray(aabb, np.float32), cells, max_steps)
        return _dda_route_numpy(rays, np.asarray(aabb, np.float32), cells,
                                max_steps)
    if policy == "alpha":
        return _alpha_route_numpy(rays, np.asarray(aabb, np.float32), cells,
                                  alpha)
    if policy == "sampled":
        return route_rays_to_cells(rays, np.asarray(aabb, np.float32), cells,
                                   native=native)
    raise ValueError(f"unknown routing policy: {policy!r}")


# ------------------------------ TaskDataset ----------------------------------
class TaskDataset:
    """Endless episodic sampler for one region (expert).

    Reference-parity knobs mirror the reference runner's wrapper_kwargs
    (nerf_runner.py:202-209): image_cap=0.4, min_rays = (S+Q)*0.5,
    assignment_checkpoint=0.7, routing_policy='dda', cells=(1, cd, cd).
    """

    def __init__(
        self,
        dataset: RamRaysDataset,
        region_aabb: Optional[np.ndarray] = None,  # (2, 3); None = infer
        support_rays: int = 4000,
        query_rays: int = 2000,
        cell_dim: int = 5,
        image_cap: Optional[float] = 0.4,
        min_rays_per_cell: Optional[int] = None,
        max_images_support: Optional[int] = 8,
        max_images_query: Optional[int] = 4,
        min_images_support: int = 2,
        min_images_query: int = 1,
        routing_policy: str = "dda",
        assignment_checkpoint: float = 0.7,
        cell_pick: str = "uniform",
        image_disjoint_splits: bool = True,
        seed: int = 0,
        debug_checks: bool = False,
        pad_to_target: bool = True,
        fallback_single_pool: bool = True,
    ):
        self.ds = dataset
        self.S = int(support_rays)
        self.Q = int(query_rays)
        self.image_cap = image_cap
        self.max_images_support = max_images_support
        self.max_images_query = max_images_query
        self.min_images_support = int(min_images_support)
        self.min_images_query = int(min_images_query)
        self.cell_pick = cell_pick
        self.image_disjoint_splits = bool(image_disjoint_splits)
        self.debug_checks = bool(debug_checks)
        self.pad_to_target = bool(pad_to_target)
        self.seed = int(seed)
        self.rng = np.random.default_rng(seed)
        self.cells = (1, int(cell_dim), int(cell_dim))
        self.min_rays_cell = int(
            min_rays_per_cell
            if min_rays_per_cell is not None
            else (self.S + self.Q) // 2
        )

        rays = dataset.rays
        if region_aabb is None:
            # reference default: infer from near points (task_dataset.py:228-239)
            pts = rays[:, 0:3] + rays[:, 3:6] * rays[:, 6:7]
            finite = np.isfinite(pts).all(axis=1)
            src = pts[finite] if finite.any() else np.zeros((1, 3), np.float32)
            region_aabb = np.stack([src.min(0), src.max(0)])
        self.aabb = np.asarray(region_aabb, np.float32)
        self.cell_bounds = build_cell_bounds(self.aabb, self.cells)

        cell_of = route_rays_exact(
            rays, self.aabb, self.cells, policy=routing_policy,
            alpha=assignment_checkpoint,
        )
        self.routing_hit_rate = (
            float((cell_of >= 0).mean()) if len(cell_of) else 0.0
        )

        # per-cell fully shuffled flat pools (task_dataset.py:630-678)
        n_cells = int(np.prod(self.cells))
        self._cell_flat_idx: List[np.ndarray] = []
        self._cell_flat_img: List[np.ndarray] = []
        self._cell_total_counts: List[int] = []
        for c in range(n_cells):
            idx = np.flatnonzero(cell_of == c)
            if idx.size:
                idx = self.rng.permutation(idx)
            self._cell_flat_idx.append(idx.astype(np.int64))
            self._cell_flat_img.append(
                dataset.img_indices[idx].astype(np.int64)
            )
            self._cell_total_counts.append(int(idx.size))

        self._cursor = 0
        self.eligible_cells = [
            i for i, n in enumerate(self._cell_total_counts)
            if n >= self.min_rays_cell
        ]
        if not self.eligible_cells:
            warnings.warn(
                f"[TaskDataset] no eligible cells "
                f"(min_rays_cell={self.min_rays_cell})"
            )
            if fallback_single_pool:
                # TPU-build extension: rather than yielding nothing (the
                # reference warns and goes silent, starving the region),
                # collapse to one pool over every routed ray so tiny scenes
                # still produce masked fixed-shape episodes
                idx = np.flatnonzero(cell_of >= 0)
                if idx.size == 0:
                    idx = np.arange(len(dataset), dtype=np.int64)
                idx = self.rng.permutation(idx).astype(np.int64)
                self._cell_flat_idx = [idx]
                self._cell_flat_img = [
                    dataset.img_indices[idx].astype(np.int64)
                ]
                self._cell_total_counts = [int(idx.size)]
                self.cell_bounds = self.aabb[None].repeat(1, axis=0).reshape(
                    1, 2, 3
                )
                self.eligible_cells = [0] if idx.size else []

    def __len__(self):
        return len(self.eligible_cells)

    # ------------------------- selection helpers -------------------------
    @staticmethod
    def _split_support_query(N: int, S_target: int, Q_target: int):
        """Preserve S:Q ratio when underfilled (task_dataset.py:681-690)."""
        if N >= (S_target + Q_target):
            return S_target, Q_target
        r = float(S_target) / float(Q_target)
        S = int(round(N * r / (1.0 + r)))
        S = max(0, min(S, N))
        return S, N - S

    def _pick_cell(self) -> Optional[int]:
        if not self.eligible_cells:
            return None
        if self.cell_pick == "sequential":
            cid = self.eligible_cells[self._cursor % len(self.eligible_cells)]
            self._cursor += 1
            return int(cid)
        return int(
            self.eligible_cells[
                int(self.rng.integers(len(self.eligible_cells)))
            ]
        )

    def _choose_images_for_split(
        self, cid: int, min_imgs: int, max_imgs: Optional[int],
        forbid_imgs: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Random image subset honoring min/max and forbid constraints, with
        borrow-from-forbidden relaxation (task_dataset.py:420-483)."""
        all_imgs = np.unique(self._cell_flat_img[cid])
        if all_imgs.size == 0:
            return all_imgs
        if forbid_imgs is not None and forbid_imgs.size > 0:
            pool = all_imgs[~np.isin(all_imgs, forbid_imgs)]
        else:
            pool = all_imgs
        Kmax = (
            all_imgs.size
            if (max_imgs is None or max_imgs <= 0)
            else min(max_imgs, all_imgs.size)
        )
        Kmin = max(0, min(min_imgs, Kmax))
        if pool.size >= Kmin:
            k = min(Kmax, pool.size)
            return self.rng.permutation(pool)[:k]
        chosen = pool
        if forbid_imgs is not None and forbid_imgs.size > 0 and chosen.size < Kmin:
            borrow = all_imgs[np.isin(all_imgs, forbid_imgs)]
            need = min(Kmin, Kmax) - chosen.size
            if need > 0 and borrow.size > 0:
                take = self.rng.permutation(borrow)[: min(need, borrow.size)]
                chosen = np.concatenate([chosen, take])
        if chosen.size > Kmax:
            chosen = self.rng.permutation(chosen)[:Kmax]
        return chosen

    def _sample_split_from_images(
        self, cid: int, target: int, images: Optional[np.ndarray],
        forbid_indices: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Random rays from the cell's shuffled pool restricted to `images`,
        ray-disjoint from `forbid_indices`, with a greedy per-image cap of
        ceil(image_cap * need) when image_cap is set (task_dataset.py:485-542).
        The greedy python loop is replaced by an equivalent vectorized
        occurrence-rank filter."""
        empty = np.zeros(0, np.int64)
        if target <= 0 or images is None or images.size == 0:
            return empty
        flat_idx = self._cell_flat_idx[cid]
        flat_img = self._cell_flat_img[cid]
        if flat_idx.size == 0:
            return empty
        mask = np.isin(flat_img, images)
        if forbid_indices is not None and forbid_indices.size > 0:
            mask &= ~np.isin(flat_idx, forbid_indices)
        pool_idx = flat_idx[mask]
        pool_img = flat_img[mask]
        if pool_idx.size == 0:
            return empty
        need = min(int(target), int(pool_idx.size))
        order = self.rng.permutation(pool_idx.size)
        if not (self.image_cap is not None and self.image_cap > 0):
            return pool_idx[order[:need]]
        cap = max(1, int(math.ceil(float(self.image_cap) * need)))
        # occurrence rank of each position within its image, along `order`:
        # keeping positions with rank < cap and taking the first `need` is
        # exactly the reference's greedy loop
        img_ord = pool_img[order]
        perm = np.argsort(img_ord, kind="stable")
        sorted_img = img_ord[perm]
        starts = np.r_[0, np.flatnonzero(sorted_img[1:] != sorted_img[:-1]) + 1]
        lengths = np.diff(np.r_[starts, sorted_img.size])
        grp = np.repeat(np.arange(starts.size), lengths)
        occ_sorted = np.arange(sorted_img.size) - starts[grp]
        occ = np.empty(img_ord.size, np.int64)
        occ[perm] = occ_sorted
        kept = np.flatnonzero(occ < cap)[:need]
        if kept.size == 0:
            return empty
        return pool_idx[order[kept]]

    def _pad_with_resample(self, sel: np.ndarray, target: int) -> np.ndarray:
        """Fixed-shape padding: resample already-selected rays w/ replacement."""
        if not self.pad_to_target or sel.size >= target or sel.size == 0:
            return sel
        extra = self.rng.choice(sel, target - sel.size, replace=True)
        return np.concatenate([sel, extra])

    # ------------------------- episode sampling -------------------------
    def sample_task(self) -> Optional[Task]:
        """One episode, the reference __iter__ body (task_dataset.py:826-965)."""
        cid = self._pick_cell()
        if cid is None:
            return None
        N = self._cell_total_counts[cid]
        S, Q = self._split_support_query(N, self.S, self.Q)

        supp_imgs = self._choose_images_for_split(
            cid, min_imgs=self.min_images_support,
            max_imgs=self.max_images_support, forbid_imgs=None,
        )
        sel_S = self._sample_split_from_images(cid, S, supp_imgs)
        if sel_S.size == 0:
            return None

        query_imgs = self._choose_images_for_split(
            cid, min_imgs=self.min_images_query,
            max_imgs=self.max_images_query,
            forbid_imgs=supp_imgs if self.image_disjoint_splits else None,
        )
        sel_Q = self._sample_split_from_images(
            cid, Q, query_imgs, forbid_indices=np.unique(sel_S)
        )
        task_warnings: List[str] = []
        if sel_Q.size < Q and self.image_disjoint_splits:
            borrow = self._sample_split_from_images(
                cid, Q - sel_Q.size,
                np.unique(self._cell_flat_img[cid]),
                forbid_indices=np.unique(np.concatenate([sel_S, sel_Q])),
            )
            if borrow.size > 0:
                sel_Q = np.concatenate([sel_Q, borrow])
        if sel_Q.size == 0:
            return None

        imgs_S = self.ds.img_indices[sel_S]
        imgs_Q = self.ds.img_indices[sel_Q]
        image_disjoint_ok = float(not bool(np.isin(imgs_S, imgs_Q).any()))
        if self.image_disjoint_splits and image_disjoint_ok == 0.0:
            task_warnings.append(
                "[fallback] borrowed from support images (still ray-disjoint)"
            )

        if self.debug_checks:
            assert sel_S.size == np.unique(sel_S).size
            assert sel_Q.size == np.unique(sel_Q).size
            assert not np.isin(sel_S, sel_Q).any(), "S/Q rays not disjoint"
            self._assert_cell_hits(cid, sel_S)
            self._assert_cell_hits(cid, sel_Q)

        metrics = {
            "S": float(sel_S.size),
            "Q": float(sel_Q.size),
            "total_cell": float(N),
            "num_cells": float(self.cell_bounds.shape[0]),
            "image_disjoint_ok": image_disjoint_ok,
        }

        sel_S = self._pad_with_resample(sel_S, self.S)
        sel_Q = self._pad_with_resample(sel_Q, self.Q)

        return Task(
            support={
                "rays": self.ds.rays[sel_S],
                "rgbs": self.ds.rgbs[sel_S],
                "img_indices": self.ds.img_indices[sel_S],
                "idx": sel_S,
            },
            query={
                "rays": self.ds.rays[sel_Q],
                "rgbs": self.ds.rgbs[sel_Q],
                "img_indices": self.ds.img_indices[sel_Q],
                "idx": sel_Q,
            },
            block_id=int(cid),
            bounds=self.cell_bounds[cid],
            warnings=task_warnings,
            metrics=metrics,
        )

    def _assert_cell_hits(self, cid: int, idx: np.ndarray):
        """>=99% of selected rays must overlap the cell (task_dataset.py:981-1004)."""
        if idx.size == 0:
            return
        cell = self.cell_bounds[cid]
        len_t = _overlap_len_with_cells(self.ds.rays[idx], cell)
        size = np.abs(cell[1] - cell[0])
        tol = 1e-6 * max(float(size.max()), 1.0)
        frac = float((len_t > tol).mean())
        assert frac > 0.99, f"only {frac*100:.1f}% of rays overlap the cell"

    def __iter__(self):
        while True:
            t = self.sample_task()
            if t is not None:
                yield t
