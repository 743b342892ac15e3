"""Occupancy-guided MoE rendering (soft and hard mask, probe, dead program,
early ray termination) and the grids' lifecycle (premark, EMA updates).

Port of nerfsys_tpu/models/occupancy.py (`expert_render_step_sizes` :39,
`union_binary_fn` :47, `expert_binary_fn` :60, `union_value_fn` :69,
`union_pair_fn` :92, `expert_pair_fn` :110,
`premark_invisible_expert_cells` :121, `make_occ_update_fn` :140,
`occ_ready` :188, `build_union_probe_grid` :200,
`union_probe_fns` :289, `_ray_validity` :307, `_occ_query_fns` :315,
`probe_rays_occ` :345, `render_rays_occ_dead` :389, `render_rays_occ` :436,
`occ_sample_positions` :558, `_occ_keep_mask` :613,
`render_rays_occ_et_partial` :625, `render_rays_occ_et_resume` :753). In
soft mode (hard_mask=False) the union of the experts' occupancy grids
steers sample PLACEMENT (probe CDF with a whole-ray floor) and never deletes
density; in hard mode sigma is also zeroed outside the union at the final
sample points.

The probe takes grid stacks, not query functions: the grid slice of
`active_expert` (or all K for the union) goes to kernel 2, or, with
`probe_fns` (`union_probe_fns` of a `build_union_probe_grid` result), the
ONE resampled union grid as a K=1, L=1 stack. The hard sigma mask reads
the exact per-expert union at the sample points (kernel 11q through
`occupancy_query`), or with `mask_from_probes` each sample's probe-interval
bit (kernel 3's mask output; under the union probe grid, that grid's
bit). `field_expert` narrows the field evaluation to one expert while
probing and masking keep the union (the coherent dispatch). The point
queries of the union functions below go through kernel 11q unless
use_kernels=False.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from nerfsys_tpu_torch.models.container import (
    ContainerConfig,
    ContainerStatics,
    _expert_apply_fn,
    _expert_params,
    container_apply,
    container_bg_fn,
)
from nerfsys_tpu_torch.ops.activations import clip
from nerfsys_tpu_torch.ops.occupancy import (
    OccGridConfig,
    level_aabbs,
    mark_invisible_cells,
    occupancy_probe_cdf,
    occupancy_query,
    sample_tvals_from_cdf,
    update_occ_grid,
)
from nerfsys_tpu_torch.ops.volrend import (
    background_rgb,
    composite_finalize,
    composite_init,
    composite_segment,
    composite_segment_plain,
    full_dists,
    t_to_points,
    volume_render,
)

Render = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _query_fn(occ_state: Dict, statics: ContainerStatics,
              k: Optional[int], mode: str, use_kernels: bool):
    """pts (M, 3) -> `occupancy_query` of `mode` over every expert's grid
    (k None) or expert k's alone (its K=1 slice)."""
    sl = slice(None) if k is None else slice(int(k), int(k) + 1)

    def query(pts):
        return occupancy_query(occ_state["occs"][sl],
                               occ_state["binary"][sl],
                               statics.expert_aabbs[sl], pts, mode,
                               use_kernels=use_kernels)

    return query


def union_binary_fn(occ_state: Dict, statics: ContainerStatics, *,
                    use_kernels: bool = True):
    """pts (M, 3) -> (M,) bool: occupied under ANY expert's grid."""
    return _query_fn(occ_state, statics, None, "bits", use_kernels)


def expert_binary_fn(occ_state: Dict, statics: ContainerStatics, k: int, *,
                     use_kernels: bool = True):
    """pts (M, 3) -> (M,) bool: occupied under expert k's grid alone."""
    return _query_fn(occ_state, statics, k, "bits", use_kernels)


def union_value_fn(occ_state: Dict, statics: ContainerStatics, *,
                   use_kernels: bool = True):
    """pts (M, 3) -> (M,) max EMA value over the experts."""
    return _query_fn(occ_state, statics, None, "values", use_kernels)


def union_pair_fn(occ_state: Dict, statics: ContainerStatics, *,
                  use_kernels: bool = True):
    """pts (M, 3) -> (occ under ANY expert (M,), max EMA value (M,))."""
    return _query_fn(occ_state, statics, None, "pair", use_kernels)


def expert_pair_fn(occ_state: Dict, statics: ContainerStatics, k: int, *,
                   use_kernels: bool = True):
    """pts (M, 3) -> (occ, value) of expert k's grid alone."""
    return _query_fn(occ_state, statics, k, "pair", use_kernels)


def occ_ready(occ_state: Dict, min_updates: int = 1) -> torch.Tensor:
    """Grid usable for rendering once warmup-many updates have run AND any
    cell is occupied -> bool scalar tensor on the grid's device."""
    thresh = occ_state.get("ready_after")
    if thresh is None:
        thresh = torch.tensor(min_updates, dtype=torch.int32,
                              device=occ_state["binary"].device)
    return (occ_state["num_updates"] >= thresh) & occ_state["binary"].any()


# --------------------------- grid lifecycle ----------------------------------
def expert_render_step_sizes(statics: ContainerStatics) -> torch.Tensor:
    """(K,) marching step of each expert: its box diagonal / 1000."""
    ext = statics.expert_aabbs[:, 1] - statics.expert_aabbs[:, 0]
    return torch.linalg.norm(ext, dim=-1) / 1000.0


def premark_invisible_expert_cells(occ_state: Dict, statics: ContainerStatics,
                                   occ_cfg: OccGridConfig,
                                   c2ws: torch.Tensor,  # (N, 3, 4)
                                   intrinsics: torch.Tensor,  # (N, 4)
                                   wh: torch.Tensor,  # (N, 2)
                                   near: float = 0.0) -> Dict:
    """Tag every expert's cells that no training camera sees with -1 (they
    never become occupied); the binary fields restart empty."""
    occs = torch.stack([
        mark_invisible_cells(statics.expert_aabbs[k], occ_cfg, c2ws,
                             intrinsics, wh, near)
        for k in range(statics.expert_aabbs.shape[0])])
    return {**occ_state, "occs": occs,
            "binary": torch.zeros_like(occ_state["binary"])}


def make_occ_update_fn(cfg: ContainerConfig, occ_cfg: OccGridConfig, *,
                       use_kernels: bool = True):
    """(occ_state, params, statics, step (a host int), generator) ->
    occ_state. Every `update_interval` steps the EMA update of every expert
    (`update_occ_grid` with the expert's density times its render step
    size; all cells while step < warmup_steps) and num_updates + 1 on the
    grid's device; the state unchanged on other steps, so the train loop
    calls it every step. The field runs through the encoder kernel unless
    use_kernels=False; the draws come from `generator`, expert after
    expert."""
    _, density_fn = _expert_apply_fn(cfg)

    def update(occ_state, params, statics, step: int, generator=None):
        if step % occ_cfg.update_interval != 0:
            return occ_state
        steps = expert_render_step_sizes(statics)
        warmup = step < occ_cfg.warmup_steps
        outs = []
        for k in range(occ_state["occs"].shape[0]):
            p_k, aabb_k = _expert_params(params, k), statics.expert_aabbs[k]

            def fn(x, p_k=p_k, aabb_k=aabb_k, step_size=steps[k]):
                return density_fn(p_k, cfg.expert, aabb_k, x,
                                  use_kernels=use_kernels) * step_size

            outs.append(update_occ_grid(
                {"occs": occ_state["occs"][k],
                 "binary": occ_state["binary"][k]},
                aabb_k, fn, 1.0, occ_cfg, generator, warmup))
        return {**occ_state,
                "occs": torch.stack([o["occs"] for o in outs]),
                "binary": torch.stack([o["binary"] for o in outs]),
                "num_updates": occ_state["num_updates"] + 1}

    return update


# --------------------------- union probe grid -------------------------------
_GRID_CHUNK = 1 << 20  # lattice points queried at once


def _chunked(fn, pts: torch.Tensor) -> torch.Tensor:
    return torch.cat([fn(pts[i:i + _GRID_CHUNK])
                      for i in range(0, pts.shape[0], _GRID_CHUNK)])


def build_union_probe_grid(occ_state: Dict, statics: ContainerStatics,
                           res: int = 128, importance: bool = False,
                           dilate: int = 1, *,
                           use_kernels: bool = True) -> Dict:
    """Resample the K experts' occupancy union into ONE single-level grid
    for PROBING only -> {"binary": (1, res, res, res) bool, "values":
    (1, res, res, res) f32 or None, "aabb": (2, 3)}.

    The box encloses every expert's every level, unioned with the global
    box. A cell is marked when its center or any of its 8 corners is
    occupied under the exact union, then the marked set is dilated `dilate`
    times by one cell (3x3x3, zero-padded edges). With importance, the
    values are the max EMA value over experts at the cell centers. An
    approximation for placement and the dead-ray gate (the reference's
    docstring, nerfsys_tpu/models/occupancy.py:207-232); the hard sigma
    mask stays exact."""
    L = occ_state["binary"].shape[1]
    la = level_aabbs(statics.expert_aabbs, L)  # (K, L, 2, 3)
    lo = torch.minimum(la[:, :, 0].amin(dim=(0, 1)), statics.global_aabb[0])
    hi = torch.maximum(la[:, :, 1].amax(dim=(0, 1)), statics.global_aabb[1])
    aabb = torch.stack([lo, hi])
    bin_fn = union_binary_fn(occ_state, statics, use_kernels=use_kernels)
    dev = aabb.device

    def grid_pts(n, offset_half):
        # corner lattice (n+1 per axis) or cell centers (n per axis)
        if offset_half:
            xs = (torch.arange(n, dtype=torch.float32, device=dev) + 0.5) / n
        else:
            xs = torch.arange(n + 1, dtype=torch.float32, device=dev) / n
        gx, gy, gz = torch.meshgrid(xs, xs, xs, indexing="ij")
        rel = torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)
        return aabb[0] + rel * (aabb[1] - aabb[0])

    c = _chunked(bin_fn, grid_pts(res, False)).reshape(res + 1, res + 1,
                                                       res + 1)
    centers = grid_pts(res, True)
    cell = (_chunked(bin_fn, centers).reshape(res, res, res)
            | c[:-1, :-1, :-1] | c[1:, :-1, :-1] | c[:-1, 1:, :-1]
            | c[:-1, :-1, 1:] | c[1:, 1:, :-1] | c[1:, :-1, 1:]
            | c[:-1, 1:, 1:] | c[1:, 1:, 1:])
    for _ in range(max(int(dilate), 0)):
        p = torch.zeros((res + 2,) * 3, dtype=torch.bool, device=dev)
        p[1:-1, 1:-1, 1:-1] = cell
        cell = torch.zeros_like(cell)
        for dx in (0, 1, 2):
            for dy in (0, 1, 2):
                for dz in (0, 1, 2):
                    cell = cell | p[dx:dx + res, dy:dy + res, dz:dz + res]
    out = {"binary": cell[None], "values": None, "aabb": aabb}
    if importance:
        vals = _chunked(union_value_fn(occ_state, statics,
                                       use_kernels=use_kernels), centers)
        out["values"] = vals.reshape(1, res, res, res)
    return out


class ProbeGrids(NamedTuple):
    """A grid stack kernel 2 probes in place of the experts' grids: occs
    and binary (K, L, R, R, R), aabbs (K, 2, 3), and whether the values
    weight the probe pdf (the reference's val_fn)."""

    occs: torch.Tensor
    binary: torch.Tensor
    aabbs: torch.Tensor
    importance: bool


def union_probe_fns(probe_grid: Dict) -> ProbeGrids:
    """The probe override of a build_union_probe_grid result: its grid as a
    K=1, L=1 stack (values, or zeros without them, for the pdf)."""
    binary = probe_grid["binary"][None]
    values = probe_grid.get("values")
    occs = (torch.zeros(binary.shape, dtype=torch.float32,
                        device=binary.device) if values is None
            else values[None])
    return ProbeGrids(occs, binary, probe_grid["aabb"][None],
                      values is not None)


def _ray_validity(rays: torch.Tensor):
    """(valid, near_s, far_s): sanitized bounds shared by the probe, render
    and dead programs, so all three see the same ray bounds."""
    near, far = rays[:, 6], rays[:, 7]
    valid = (torch.isfinite(near) & torch.isfinite(far) & (far > near)
             & (far < 1e9))
    near_s = torch.where(valid, near, torch.zeros_like(near))
    far_s = torch.where(valid, far, torch.ones_like(far))
    return valid, near_s, far_s


def _occ_query_fns(occ_state: Dict, statics: ContainerStatics,
                   active_expert: Optional[int], use_kernels: bool = True):
    """(bin_fn, grids): the exact mask query of the hard mode, and the
    (occs, binary, aabbs) stack the probe reads (expert k's K=1 slice, or
    all K for the union)."""
    occs, binary, aabbs = (occ_state["occs"], occ_state["binary"],
                           statics.expert_aabbs)
    if active_expert is None:
        return (union_binary_fn(occ_state, statics, use_kernels=use_kernels),
                (occs, binary, aabbs))
    k = int(active_expert)
    return (expert_binary_fn(occ_state, statics, k, use_kernels=use_kernels),
            (occs[k:k + 1], binary[k:k + 1], aabbs[k:k + 1]))


def _sample(cdf_state, near_s, far_s, n_samples, generator, randomized,
            with_mask: bool, use_kernels: bool):
    """(t_vals, alive, probe bits (N, S) or None): kernel 3, with the
    interval bits when the hard mask takes them from the probes."""
    if with_mask:
        return sample_tvals_from_cdf(
            cdf_state, near_s, far_s, n_samples, generator=generator,
            randomized=randomized, with_mask=True, use_kernels=use_kernels)
    t_vals, alive = sample_tvals_from_cdf(
        cdf_state, near_s, far_s, n_samples, generator=generator,
        randomized=randomized, use_kernels=use_kernels)
    return t_vals, alive, None


def _split_rays(rays: torch.Tensor):
    return rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous()


def _background(params, cfg: ContainerConfig, use_bg_fn: bool,
                bg_policy: str, d: torch.Tensor, rgb: torch.Tensor,
                generator=None, last_sample_rgb=None):
    """The learned background MLP when live, else the policy's color."""
    if use_bg_fn and cfg.use_bg_nerf and "bg" in params:
        return container_bg_fn(params, cfg)(d)
    return background_rgb(bg_policy, d.shape[0], generator=generator,
                          last_sample_rgb=last_sample_rgb, dtype=rgb.dtype,
                          device=rgb.device)


def probe_rays_occ(
    statics: ContainerStatics,
    occ_state: Dict,
    rays: torch.Tensor,  # (N, 8)
    *,
    n_probes: int = 128,
    active_expert: Optional[int] = None,
    importance: bool = False,
    uniform_frac: float = 0.25,
    probe_fns=None,
    ray_floor: float = 0.0,  # MUST match the consuming render's floor
    use_kernels: bool = True,
) -> Tuple[Dict, torch.Tensor]:
    """Wave 1 of chunked occupancy rendering: the probe/CDF pass alone ->
    (cdf_state, chunk_alive). cdf_state also holds `alive_valid` (N,) bool,
    the rays that are valid and hit occupied space, computed here so the
    host dispatch shares the device's validity predicate; chunk_alive is a
    bool scalar tensor, True iff any ray is alive_valid. `probe_fns` (a
    union_probe_fns result) probes the resampled union grid instead."""
    o, d = _split_rays(rays)
    valid, near_s, far_s = _ray_validity(rays)
    state = _probe_cdf(occ_state, statics, active_expert, o, d, near_s, far_s,
                       n_probes, importance, uniform_frac, ray_floor,
                       use_kernels, probe_fns)
    state = {**state, "alive_valid": state["alive"] & valid}
    return state, state["alive_valid"].any()


def dead_grid(occ_state: Dict) -> Dict:
    """An all-False grid of the occupancy grids' shape, for
    `render_rays_occ_dead` (build it once per renderer)."""
    binary = occ_state["binary"]
    return {"occs": torch.zeros(binary.shape, dtype=torch.float32,
                                device=binary.device),
            "binary": torch.zeros_like(binary)}


def render_rays_occ_dead(
    params,
    cfg: ContainerConfig,
    statics: ContainerStatics,
    rays: torch.Tensor,  # (N, 8)
    n_samples: int,
    *,
    dead: Dict,  # dead_grid(occ_state)
    n_probes: int = 128,
    bg_policy: str = "white",
    use_bg_fn: bool = True,
    sigma_scale: float = 1.0,
    use_kernels: bool = True,
) -> Render:
    """The exact render_rays_occ output for a chunk with NO alive ray, with
    no field evaluation. A dead ray's probe weights are all 1e-12 (zero
    occupancy mass), its sigma is zeroed by the alive mask, and its color is
    the background. The dead CDF comes from the same probe (kernel 2) on the
    all-False grid `dead`, so the probe, sampler and compositor run the same
    float pipeline as the full program's dead rays and the outputs match it
    bit for bit. Only backgrounds that read no field colors qualify
    (white / black / none, or the learned background MLP)."""
    o, d = _split_rays(rays)
    n_rays = o.shape[0]
    _, near_s, far_s = _ray_validity(rays)
    state = occupancy_probe_cdf(dead["occs"], dead["binary"],
                                statics.expert_aabbs, o, d, near_s, far_s,
                                n_probes, use_kernels=use_kernels)
    t_vals, _ = sample_tvals_from_cdf(state, near_s, far_s, n_samples,
                                      use_kernels=use_kernels)
    rgb_sigma = torch.zeros((n_rays, n_samples, 4), dtype=o.dtype,
                            device=o.device)
    bg = _background(params, cfg, use_bg_fn, bg_policy, d, rgb_sigma)
    return volume_render(rgb_sigma, t_vals,
                         bg_rgb=None if bg is None else bg.contiguous(),
                         sigma_scale=sigma_scale, use_kernels=use_kernels)


def _probe_cdf(occ_state, statics, active_expert, o, d, near_s, far_s,
               n_probes, importance, uniform_frac, ray_floor, use_kernels,
               probe_fns: Optional[ProbeGrids] = None):
    """Kernel 2 over the experts' grids, or over `probe_fns`'s stack (whose
    own importance flag then decides, as the reference's val_fn does)."""
    if probe_fns is not None:
        grids = (probe_fns.occs, probe_fns.binary, probe_fns.aabbs)
        importance = probe_fns.importance
    else:
        _, grids = _occ_query_fns(occ_state, statics, active_expert)
    return occupancy_probe_cdf(
        *grids, o, d, near_s, far_s, n_probes, importance=importance,
        uniform_frac=uniform_frac, ray_floor=ray_floor,
        use_kernels=use_kernels)


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
    cdf_state: Optional[Dict] = None,  # a probe_rays_occ wave 1 result
    probe_fns=None,
    hard_mask: bool = True,
    ray_floor: Optional[float] = None,
    mask_from_probes: bool = False,
    field_expert: Optional[int] = None,
    use_kernels: bool = True,
) -> Render:
    """Dense occupancy-guided MoE render -> (rgb (N,3), depth (N,),
    weights (N,S), acc (N,)).

    Probe (kernel 2, over `probe_fns`'s union grid when given; skipped when
    `cdf_state` from probe_rays_occ on the same rays and grid is given) ->
    inverse-CDF placement (kernel 3) -> routed field (the encoder kernel +
    MLPs; through expert `field_expert` alone when given, while probing and
    masking keep `active_expert`'s semantics) -> hard mode: sigma zeroed
    outside the exact union at the sample points (point-exact, kernel 11q)
    or, with mask_from_probes, where the sample's probe interval is empty
    (the probe's bit, carried by kernel 3; no grid query), and on dead
    rays -> compositing (kernel 4). Soft mode ignores mask_from_probes, as
    the reference does."""
    o, d = _split_rays(rays)
    n_rays = o.shape[0]
    valid, near_s, far_s = _ray_validity(rays)
    if ray_floor is None:
        # hard mode zeroes floor-placed samples anyway; soft mode needs
        # unmarked space reachable
        ray_floor = 0.0 if hard_mask else 0.25
    if cdf_state is None:
        cdf_state = _probe_cdf(occ_state, statics, active_expert, o, d,
                               near_s, far_s, n_probes, importance,
                               uniform_frac, ray_floor, use_kernels,
                               probe_fns)
    t_vals, alive, occ_bits = _sample(
        cdf_state, near_s, far_s, n_samples, generator, randomized,
        mask_from_probes and hard_mask, use_kernels)

    pts = t_to_points(o, d, t_vals).reshape(-1, 3)
    dirs = d[:, None, :].expand(n_rays, n_samples, 3).reshape(-1, 3)
    rgb, sigma = container_apply(
        params, cfg, statics, pts, dirs,
        active_expert if field_expert is None else field_expert,
        use_kernels=use_kernels)
    rgb = rgb.reshape(n_rays, n_samples, 3)
    sigma = sigma.reshape(n_rays, n_samples)
    keep = _occ_keep_mask(occ_state, statics, active_expert, pts, occ_bits,
                          alive, valid, hard_mask, n_rays, n_samples,
                          use_kernels)
    sigma = torch.where(keep, sigma, torch.zeros_like(sigma))

    bg = _background(params, cfg, use_bg_fn, bg_policy, d, rgb,
                     generator=generator, last_sample_rgb=rgb[:, -1, :])
    rgb_sigma = torch.cat([rgb, sigma[..., None]], dim=-1)
    return volume_render(rgb_sigma, t_vals,
                         bg_rgb=None if bg is None else bg.contiguous(),
                         sigma_scale=sigma_scale, use_kernels=use_kernels)


def occ_sample_positions(
    occ_state: Dict,
    statics: ContainerStatics,
    rays: torch.Tensor,  # (N, 8)
    n_samples: int,
    *,
    active_expert: Optional[int] = None,
    importance: bool = False,
    hard_mask: bool = True,
    n_probes: int = 128,
    uniform_frac: float = 0.25,
    probe_fns: Optional[ProbeGrids] = None,  # MUST match the render's
    use_kernels: bool = True,
):
    """Deterministic occupancy sample positions -> (pts (N, S, 3), t_vals
    (N, S), alive (N,)), without evaluating the field: exactly
    render_rays_occ's randomized=False placement (the same probe through
    probe_rays_occ, the same ray_floor policy, the same sampler). The
    coherent dispatch tests the routing at these positions."""
    o, d = _split_rays(rays)
    _, near_s, far_s = _ray_validity(rays)
    cdf_state, _ = probe_rays_occ(
        statics, occ_state, rays, n_probes=n_probes,
        active_expert=active_expert, importance=importance,
        uniform_frac=uniform_frac, probe_fns=probe_fns,
        ray_floor=0.0 if hard_mask else 0.25, use_kernels=use_kernels)
    t_vals, alive = sample_tvals_from_cdf(cdf_state, near_s, far_s,
                                          n_samples, use_kernels=use_kernels)
    return t_to_points(o, d, t_vals), t_vals, alive


# --------------------------- early ray termination ----------------------------
# A ray stops paying for samples once its transmittance is below
# early_stop_eps (nerfacc's OccGridEstimator early_stop_eps). The partial
# program composites the first seg_samples of every ray and reports its
# transmittance; the host compacts the rays still alive and the resume
# program finishes only those (pipelines/online/runtime_adapt early-stop
# dispatch). All sample positions come from ONE sample_tvals_from_cdf call
# whose full-sample step sizes (ops.volrend.full_dists) are sliced per
# segment, so resuming every ray reproduces render_rays_occ up to the order
# of the products and sums.


def _occ_keep_mask(occ_state, statics, active_expert, pts_flat, occ_bits_seg,
                   alive, valid, hard_mask, n_rays, s, use_kernels=True):
    """The sigma keep-mask of render_rays_occ for (n_rays, s) samples at
    pts_flat: hard mode keeps the occupied samples of alive valid rays,
    by the probe bits `occ_bits_seg` (n_rays, s) when given, else by the
    point query; soft mode keeps every sample of a valid ray."""
    if hard_mask:
        if occ_bits_seg is not None:
            occ_mask = occ_bits_seg
        else:
            bin_fn, _ = _occ_query_fns(occ_state, statics, active_expert,
                                       use_kernels)
            occ_mask = bin_fn(pts_flat).reshape(n_rays, s)
        return occ_mask & alive[:, None] & valid[:, None]
    return valid[:, None].expand(n_rays, s)


def _masked_segment(sigma, keep, rgb, sigma_scale):
    """The partial's and resume's compositor inputs: sigma masked, clipped
    at 0 and scaled; rgb clipped to [0, 1] (the segment compositor takes its
    inputs as they are, unlike volume_render)."""
    sigma = torch.clamp(torch.where(keep, sigma, torch.zeros_like(sigma)),
                        min=0.0)
    if sigma_scale != 1.0:
        sigma = sigma * float(sigma_scale)
    return clip(rgb, 0.0, 1.0), sigma


def render_rays_occ_et_partial(
    params,
    cfg: ContainerConfig,
    statics: ContainerStatics,
    occ_state: Dict,
    rays: torch.Tensor,  # (N, 8)
    n_samples: int,
    *,
    seg_samples: int,
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
    early_stop_eps: float = 1e-4,
    fog: bool = False,
    use_kernels: bool = True,
):
    """Wave A of early-stop occupancy rendering: the first seg_samples
    samples of every ray -> (outputs, et_alive, resume_state).

    outputs: (rgb, depth, acc[, wmax, entropy]) finalized as if every ray
    ended here (exact for rays whose remaining transmittance is below
    early_stop_eps, up to that eps); et_alive: (N,) bool, the rays that need
    the remaining samples; resume_state: what render_rays_occ_et_resume
    reads (the carry, the remaining t and dt, masks, the background; with
    the probes' bits as the mask, the remaining samples' bits "occ_rest").
    Backgrounds that read field colors ('last_sample') or need a generator
    ('random') are refused; the caller gates on that."""
    if bg_policy in ("last_sample", "random"):
        raise ValueError(f"early-stop rendering does not support "
                         f"bg_policy={bg_policy!r}")
    o, d = _split_rays(rays)
    n_rays = o.shape[0]
    valid, near_s, far_s = _ray_validity(rays)
    if ray_floor is None:
        ray_floor = 0.0 if hard_mask else 0.25
    if cdf_state is None:
        cdf_state = _probe_cdf(occ_state, statics, active_expert, o, d,
                               near_s, far_s, n_probes, importance,
                               uniform_frac, ray_floor, use_kernels,
                               probe_fns)
    t_vals, alive, occ_bits = _sample(
        cdf_state, near_s, far_s, n_samples, None, False,
        mask_from_probes and hard_mask, use_kernels)
    dists = full_dists(t_vals)
    s1 = int(seg_samples)
    t_seg, d_seg = t_vals[:, :s1], dists[:, :s1]
    pts = t_to_points(o, d, t_seg).reshape(-1, 3)
    dirs = d[:, None, :].expand(n_rays, s1, 3).reshape(-1, 3)
    rgb, sigma = container_apply(params, cfg, statics, pts, dirs,
                                 active_expert, use_kernels=use_kernels)
    keep = _occ_keep_mask(occ_state, statics, active_expert, pts,
                          None if occ_bits is None else occ_bits[:, :s1],
                          alive, valid, hard_mask, n_rays, s1, use_kernels)
    rgb, sigma = _masked_segment(sigma.reshape(n_rays, s1), keep,
                                 rgb.reshape(n_rays, s1, 3), sigma_scale)
    segment = composite_segment if use_kernels else composite_segment_plain
    carry = segment(composite_init(n_rays, t_vals.dtype, fog=fog,
                                   device=o.device), rgb, sigma, t_seg, d_seg)

    bg = _background(params, cfg, use_bg_fn, bg_policy, d, rgb)
    outputs = composite_finalize(carry, bg)
    # a ray fully masked by occupancy (hard mode) keeps trans == 1, but all
    # its remaining sigma is zeroed too: its partial is final
    needs_more = carry["trans"] > early_stop_eps
    if hard_mask:
        needs_more = needs_more & alive
    et_alive = needs_more & valid
    state = {"o": o, "d": d, "t_rest": t_vals[:, s1:],
             "d_rest": dists[:, s1:], "alive": alive, "valid": valid,
             "carry": carry, "bg": bg}
    if occ_bits is not None:
        state["occ_rest"] = occ_bits[:, s1:]
    return outputs, et_alive, state


def render_rays_occ_et_resume(
    params,
    cfg: ContainerConfig,
    statics: ContainerStatics,
    occ_state: Dict,
    state: Dict,  # resume_state of render_rays_occ_et_partial
    ids: torch.Tensor,  # (cap,) row indices into the partial chunk
    *,
    active_expert: Optional[int] = None,
    sigma_scale: float = 1.0,
    hard_mask: bool = True,
    use_kernels: bool = True,
):
    """Wave B: finish the remaining samples of the rows `ids` of a partial
    chunk -> (rgb, depth, acc[, wmax, entropy]); row i is ids[i] (padded,
    duplicate ids compute rows the dispatcher discards). The reference's
    row_gather is `index_select` here."""

    def take(t):
        return t.index_select(0, ids)

    o, d = take(state["o"]), take(state["d"])
    t_rest, d_rest = take(state["t_rest"]), take(state["d_rest"])
    alive, valid = take(state["alive"]), take(state["valid"])
    carry = {k: take(v) for k, v in state["carry"].items()}
    n_rays, s2 = t_rest.shape

    pts = t_to_points(o, d, t_rest).reshape(-1, 3)
    dirs = d[:, None, :].expand(n_rays, s2, 3).reshape(-1, 3)
    rgb, sigma = container_apply(params, cfg, statics, pts, dirs,
                                 active_expert, use_kernels=use_kernels)
    occ_rest = take(state["occ_rest"]) if "occ_rest" in state else None
    keep = _occ_keep_mask(occ_state, statics, active_expert, pts, occ_rest,
                          alive, valid, hard_mask, n_rays, s2, use_kernels)
    rgb, sigma = _masked_segment(sigma.reshape(n_rays, s2), keep,
                                 rgb.reshape(n_rays, s2, 3), sigma_scale)
    segment = composite_segment if use_kernels else composite_segment_plain
    carry = segment(carry, rgb, sigma, t_rest, d_rest)
    bg = None if state["bg"] is None else take(state["bg"])
    return composite_finalize(carry, bg)
