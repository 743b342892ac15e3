"""Online stage: test-time adaptation, evaluation, and chunked full-frame
rendering (the serving path).

Port of nerfsys_tpu/pipelines/online/runtime_adapt.py (`make_adapt_step`
:40, `runtime_adapt` :190, `_union_probe_wrap` :232, `TwoWaveOccRenderer`
:275 with `map_outputs` :319, `EarlyStopOccRenderer` :342, `_pad_ids`
:389, `_early_stop_dispatch` :395, `_fog_stats` :522, `make_chunk_renderer`
:532, `default_chunk_rays` :909, `render_image` :919,
`frame_chunk_rays_biased` :948, `shape_frame_outputs` :971,
`make_live_camera_renderer` :997, `CoherentExpertRenderer` :1145,
`make_coherent_renderer` :1165, `coherent_dispatch` :1339, `_pad_chunk`,
`_pack5`, `_pack7` :1411-1425, `two_wave_dispatch` :1428,
`render_rays_chunked` :1598, `runtime_evaluate` :1665).

Test-time adaptation (`make_adapt_step`, `runtime_adapt`) takes Adam steps
of the whole routed container on support-ray batches; `runtime_evaluate`
adapts on the test images' rays (Phase A), then renders every test image
and scores PSNR / SSIM / LPIPS (Phase B), dumping pred / gt PNGs. The
Fisher-weighted adaptation (`make_fim_adapt_step`, `--fim`) is not ported
(ROADMAP Queue 1 item 7).

The renderer kinds of the occupancy path: the one-shot program (soft mode,
or a hard mask whose background reads field colors), the hard-mask
two-wave renderer (probe, then skip or pack chunks whose rays are all
dead), and the early-stop renderer in soft and hard mode; without an
occupancy grid, the stratified renderer. With `occ_probe_grid_res` the
probes read ONE resampled union grid (`build_union_probe_grid`, built once
per statics). The hard mask zeroes sigma outside the grids at the sample
points (kernel 11q), or with `occ_probe_mask` where the sample's probe
interval is empty (kernel 3's mask output). The coherent-expert renderer
renders rays whose every sample routes to one expert through that expert
alone. The baked renderers are in models/baked.py.

`make_live_camera_renderer` is the viewer's and the video's live path:
rays generated on the device from the pose, all chunks dispatched before
the one fetch of the frame.

The runner's fast live modes map here: `--render_fast` is
`ContainerConfig(bucketed=True, experts_per_point=1)` with
`make_chunk_renderer(..., occ_probe_grid_res=128)`; `--render_coherent` is
`make_coherent_renderer` (with `occ_probe_grid_res` when the union grid is
on) through `render_rays_chunked`.

Every renderer program runs without autograd on its `device`. Mesh
sharding is not ported.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from nerfsys_tpu_torch.data.image_metadata import ImageMetadata
from nerfsys_tpu_torch.data.loaders import EpochBatchSampler
from nerfsys_tpu_torch.data.ram_rays import RamRaysDataset, frame_rays
from nerfsys_tpu_torch.models.container import (
    ContainerConfig,
    ContainerStatics,
    container_bg_fn,
    container_field_fn,
    routing_coherent_expert,
)
from nerfsys_tpu_torch.models.occupancy import (
    _ray_validity,
    build_union_probe_grid,
    dead_grid,
    occ_ready,
    occ_sample_positions,
    probe_rays_occ,
    render_rays_occ,
    render_rays_occ_dead,
    render_rays_occ_et_partial,
    render_rays_occ_et_resume,
    union_probe_fns,
)
from nerfsys_tpu_torch.ops.color_space import (
    color_space_transformer,
    linear_to_srgb,
)
from nerfsys_tpu_torch.ops.losses import compute_mse_loss, psnr_from_mse
from nerfsys_tpu_torch.ops.occupancy import occupancy_probe_cdf
from nerfsys_tpu_torch.ops.rays import clamp_rays_near_far, frame_chunk_rays
from nerfsys_tpu_torch.ops.scene_box import SceneBox
from nerfsys_tpu_torch.ops.volrend import (
    render_rays_stratified,
    stratified_t_vals,
    t_to_points,
)
from nerfsys_tpu_torch.utils.device import resolve_device
from nerfsys_tpu_torch.utils.metrics import load_lpips_weights, lpips, ssim
from nerfsys_tpu_torch.utils.optim import Optimizer, apply_updates
from nerfsys_tpu_torch.utils.tree import tree_leaves, tree_map


# --------------------------- adaptation --------------------------------------
def _to_device(a, dev: torch.device) -> torch.Tensor:
    """A host batch array (or a tensor) as a float32 tensor on `dev`."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    return t.to(device=dev, dtype=torch.float32)


def make_adapt_step(
    cfg: ContainerConfig,
    optimizer: Optimizer,
    *,
    ray_samples: int,
    color_space: str = "linear",
    bg_policy: str = "random",
    active_expert: Optional[int] = None,
    occ_importance: bool = False,
    occ_probe_mask: bool = False,
    occ_hard_mask: bool = True,
    occ_ray_floor: float = 0.25,
    use_kernels: bool = True,
):
    """One Adam step of the routed container on a support batch:
    (params, opt_state, statics, rays (N, 8), rgbs (N, 3), generator,
    occ_state=None) -> (params, opt_state, loss). Batches may be numpy; they
    are uploaded to the params' device. The draws (sample jitter, a random
    background) come from `generator`, which lives on that device.

    With occ_state the render is occupancy-guided once the grids are ready
    (`occ_ready`, read on the host where the reference branches with
    lax.cond): the union probe CDF over the K stacked grids is built once a
    step outside the differentiated loss (it depends on the rays and grids
    only), then samples placed by inverse CDF; before that, stratified.
    occ_probe_mask: the hard mask takes each sample's probe-interval bit
    in place of a point query of the grids. use_kernels=False runs the
    plain version of every kernel."""
    ray_floor = 0.0 if occ_hard_mask else occ_ray_floor

    def step(params, opt_state, statics: ContainerStatics, rays, rgbs,
             generator: torch.Generator, occ_state: Optional[Dict] = None):
        dev = tree_leaves(params)[0].device
        rays = _to_device(rays, dev)
        rgbs = _to_device(rgbs, dev)
        occ_grid = occ_on = occ_cdf = None
        if occ_state is not None:
            occ_grid = (occ_state["occs"], occ_state["binary"],
                        statics.expert_aabbs)
            occ_on = bool(occ_ready(occ_state))
            if occ_on:
                _, near_s, far_s = _ray_validity(rays)
                occ_cdf = occupancy_probe_cdf(
                    *occ_grid, rays[:, 0:3].contiguous(),
                    rays[:, 3:6].contiguous(), near_s, far_s,
                    importance=occ_importance, ray_floor=ray_floor,
                    use_kernels=use_kernels)
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, _ = compute_mse_loss(
                container_field_fn(leaves, cfg, statics, active_expert,
                                   use_kernels=use_kernels),
                rays, rgbs, ray_samples=ray_samples, generator=generator,
                randomized=True, color_space=color_space,
                bg_policy=bg_policy, bg_fn=container_bg_fn(leaves, cfg),
                occ_grid=occ_grid, occ_on=occ_on, importance=occ_importance,
                occ_cdf=occ_cdf, occ_probe_mask=occ_probe_mask,
                occ_hard_mask=occ_hard_mask, occ_ray_floor=occ_ray_floor,
                use_kernels=use_kernels)
            flat = tree_leaves(leaves)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        by_id = {id(t): g for t, g in zip(flat, grads)}
        grads = tree_map(lambda t: torch.zeros_like(t) if by_id[id(t)] is None
                         else by_id[id(t)], leaves)
        base = tree_map(lambda t: t.detach(), leaves)
        updates, opt_state = optimizer.update(grads, opt_state, base)
        return apply_updates(base, updates), opt_state, loss.detach()

    return step


def runtime_adapt(
    *,
    params,
    opt_state,
    adapt_step,  # from make_adapt_step
    statics: ContainerStatics,
    data_loader: Iterable,  # yields {'rays', 'rgbs'} numpy batches
    steps: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> Dict:
    """steps=None -> one pass over the loader; else exactly `steps` updates,
    the loader restarted whenever it runs out -> {params, opt_state, loss
    (the last, a float), steps}. Without a generator, one on the params'
    device seeded 0."""
    if generator is None:
        generator = torch.Generator(tree_leaves(params)[0].device)
        generator.manual_seed(0)
    last_loss, count = 0.0, 0
    it = iter(data_loader)
    while steps is None or count < steps:
        try:
            batch = next(it)
        except StopIteration:
            if steps is None:
                break
            it = iter(data_loader)
            batch = next(it)
        params, opt_state, loss = adapt_step(
            params, opt_state, statics, batch["rays"], batch["rgbs"],
            generator)
        last_loss = float(loss)
        count += 1
    return {"params": params, "opt_state": opt_state, "loss": last_loss,
            "steps": count}



class ChunkRenderer:
    """One render program: (params, statics, rays (C, 8) tensor, *extra) ->
    (rgb (C,3), depth, acc[, wmax, entropy]) on `device` (or what an output
    mapping makes of them), run without autograd."""

    def __init__(self, fn, device: torch.device):
        self._fn = fn
        self.device = device

    def __call__(self, *args):
        with torch.no_grad():
            return self._fn(*args)


class TwoWaveOccRenderer:
    """Chunk renderer with exact empty-chunk skipping (hard-mask occupancy
    path). Callable like the one-shot program (`full`), plus the two-wave
    surface the dispatcher uses: `probe` runs the occupancy probe/CDF pass
    alone and reports which valid rays are alive; `render_from_cdf`
    finishes an alive chunk from that CDF (no second probe); `render_dead`
    gives the bit-exact background fill of a chunk with no alive ray
    without evaluating the field. `packable`: per-ray outputs do not depend
    on the chunk's other rays, so alive rays may be re-batched across
    chunks (not under bucketed routing). `pack_cost_ratio`: the probe's cost
    as a fraction of a chunk's field and mask cost, which a packed chunk
    pays again (the dispatcher's mode decision)."""

    def __init__(self, full, probe, render_from_cdf, render_dead, device,
                 packable=True, pack_cost_ratio=0.0):
        self.full = full
        self.probe = probe
        self.render_from_cdf = render_from_cdf
        self.render_dead = render_dead
        self.device = device
        self.packable = packable
        self.pack_cost_ratio = pack_cost_ratio

    def __call__(self, params, statics, rays):
        return self.full(params, statics, rays)

    def map_outputs(self, fn):
        """The same renderer with fn(rgb, depth, acc, *extra) applied on the
        device to every render program's outputs (e.g. packing them into one
        fetch); `extra` are per-call args threaded through the render
        calls, and the probe is shared. Cache the result."""
        full, rcdf, dead = self.full, self.render_from_cdf, self.render_dead
        dev = self.device
        return TwoWaveOccRenderer(
            full=ChunkRenderer(lambda p, s, r, *ex: fn(*full(p, s, r), *ex),
                               dev),
            probe=self.probe,
            render_from_cdf=ChunkRenderer(
                lambda p, s, r, c, *ex: fn(*rcdf(p, s, r, c), *ex), dev),
            render_dead=ChunkRenderer(
                lambda p, s, r, *ex: fn(*dead(p, s, r), *ex), dev),
            device=dev, packable=self.packable,
            pack_cost_ratio=self.pack_cost_ratio)


class EarlyStopOccRenderer:
    """Chunk renderer with early ray termination (occupancy path), the
    counterpart of nerfacc's early_stop_eps: a ray stops paying for samples
    once its transmittance is below eps. The render splits into programs
    and the dispatcher compacts between them on the host:

      partial          first seg samples of every ray -> a packed
                       (C, ncols+1) output (rows finalized as if terminated,
                       then a needs-more flag column) and a resume state;
      partial_from_cdf the same from a wave-1 probe CDF (hard mask);
      resume           the remaining samples of `cap` gathered rows of a
                       partial chunk -> packed (cap, ncols);
      render_dead      packed background program for occupancy-dead chunks
                       (hard mask only, else None);
      full             the one-shot unpacked program (never used by the
                       early-stop dispatch).

    Outputs are within 2*eps per channel of the one-shot render: the
    dropped tail radiance and the background-weight shift are each bounded
    by the carried transmittance (<= eps), and a terminated ray pays both.
    Not built for bucketed routing (capacity depends on the chunk's rays)."""

    def __init__(self, full, partial, partial_from_cdf, resume, render_dead,
                 probe, ncols, eps, device, pack_cost_ratio=0.0):
        self.full = full
        self.et_partial = partial
        self.et_partial_from_cdf = partial_from_cdf
        self.et_resume = resume
        self.render_dead = render_dead
        self.probe = probe
        self.ncols = ncols
        self.et_eps = eps
        self.device = device
        # early stop repacks per ray anyway; this gates only the exclusion
        # of occupancy-dead rays before the partial wave
        self.packable = probe is not None
        self.pack_cost_ratio = pack_cost_ratio

    def __call__(self, params, statics, rays):
        return self.full(params, statics, rays)


def _fog_stats(weights: torch.Tensor):
    """Per-ray (wmax, entropy) of the compositing weights (the haze
    signals of the video path), computed on the device."""
    wsum = torch.clamp(weights.sum(dim=1, keepdim=True), min=1e-12)
    p = weights / wsum
    entropy = -(p * torch.log(torch.clamp(p, min=1e-12))).sum(dim=1)
    return weights.amax(dim=1), entropy


def _pack_cost_ratio(cfg: ContainerConfig, ray_samples: int,
                     active_expert: Optional[int], hard_mask: bool,
                     union_probe: bool = False) -> float:
    """The reference's probe-to-field cost ratio that decides between chunk
    skipping and ray packing (runtime_adapt.py:614-632 over
    `analytic_render_gather_rows_per_ray`, utils/flops.py:157, at its
    defaults: 3 plane levels of packed corners, 128 probes; the union grid
    probes one row per probe point). Lines count 3 gathered rows a point,
    or none under `lines_matmul` (hat-stencil matmuls, either dtype,
    flops.py:192-194). It counts gather rows per ray; the port keeps it so
    that its dispatcher picks the reference's mode, not as a model of the
    H100."""
    g = 1 if active_expert is not None else cfg.num_experts
    probe_rows = 128.0 * (1 if union_probe else g)
    line_rows = 0 if cfg.expert.planes.lines_matmul else 3
    rows = float(ray_samples * 3 * (3 + line_rows) * g) + probe_rows
    if hard_mask:
        rows += ray_samples * g
    return probe_rows / max(rows - probe_rows, 1.0)


def _union_grid_for(occ: Dict, occ_importance: bool, res: int,
                    use_kernels: bool = True):
    """statics -> the union probe grid of `occ` at `res`, built once per
    statics object (the reference's id(statics) cache; the entry keeps the
    statics alive, so its id cannot be reused while cached); its point
    queries go through kernel 11q unless use_kernels=False."""
    cache: Dict = {}

    def grid_for(statics):
        key = id(statics)
        if key not in cache:
            cache.clear()
            with torch.no_grad():
                cache[key] = (statics, build_union_probe_grid(
                    occ, statics, res=res, importance=occ_importance,
                    use_kernels=use_kernels))
        return cache[key][1]

    return grid_for


def _union_probe_wrap(occ: Dict, occ_importance: bool, res: int,
                      use_kernels: bool, device):
    """The wave-1 probe over ONE resampled union grid. Only the probe
    switches grids: alive chunks sample from its CDF, while the one-shot
    `full` program (packing mode, direct calls) keeps exact per-expert
    probing."""
    grid_for = _union_grid_for(occ, occ_importance, res, use_kernels)

    def probe(statics, rays):
        return probe_rays_occ(statics, occ, rays, importance=occ_importance,
                              probe_fns=union_probe_fns(grid_for(statics)),
                              use_kernels=use_kernels)

    return ChunkRenderer(probe, device)


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
    fog_stats: bool = False,  # append per-ray (wmax, entropy)
    early_stop_eps: float = 0.0,  # > 0: early ray termination, outputs
    # within 2*eps per channel of the one-shot render
    early_stop_seg: int = 0,  # first-segment samples (0 = ray_samples // 4)
    device="cuda",
    use_kernels: bool = True,
):
    """Fixed-size ray-chunk renderer: (params, statics, rays (C, 8)) ->
    (rgb (C,3), depth (C,), acc (C,)[, wmax, entropy]), the kind the
    reference builds for the same arguments:

    - with occ_state, hard mask and a background that reads no field colors
      (white / black / none): a `TwoWaveOccRenderer`;
    - with occ_state otherwise: the one-shot program (soft mode: the grid
      steers placement and never zeroes sigma, so dead rays still composite
      the field and nothing is skipped);
    - early_stop_eps > 0 with occ_state: an `EarlyStopOccRenderer`, hard
      (with probe and dead programs) or soft, unless bucketed routing,
      ray_samples <= 8 or a 'last_sample' / 'random' background rule it out
      (then the renderer above, with the reference's message);
    - without occ_state: the stratified renderer.

    occ_probe_grid_res > 0 (full-MoE renderers only: active_expert None)
    probes ONE resampled union grid instead of every expert's every level:
    the two-wave and hard early-stop renderers' wave-1 probe, or the soft
    one-shot program's probe. The hard sigma mask and the `full` program of
    the two-wave renderer keep the exact per-expert union.

    fog_stats=True appends (wmax, entropy) of the compositing weights to
    every program's outputs (the dead program's are zeros). `occ_state` is
    moved to `device`; use_kernels=False renders through the plain versions
    of the kernels (the card's own reference)."""
    dev = resolve_device(device)
    if mesh is not None:
        raise NotImplementedError("mesh-sharded rendering is not ported")

    def _with_stats(rgb, depth, weights, acc):
        if fog_stats:
            return (rgb, depth, acc) + _fog_stats(weights)
        return rgb, depth, acc

    if occ_state is None:
        if float(early_stop_eps) > 0.0:
            print("[render] early_stop_eps ignored: early ray termination "
                  "exists on the occupancy path only (checkpoint has no "
                  "occ state / --use_occ off)")

        def render_fn(params, statics, rays):
            field = container_field_fn(params, cfg, statics, active_expert,
                                       use_kernels=use_kernels)
            rgb, depth, w, acc = render_rays_stratified(
                field, rays, ray_samples, randomized=False,
                bg_policy=bg_policy,
                bg_fn=container_bg_fn(params, cfg) if use_bg_fn else None,
                sigma_scale=sigma_scale, use_kernels=use_kernels)
            return _with_stats(rgb, depth, w, acc)

        return ChunkRenderer(render_fn, dev)

    occ = {k: v.to(dev) for k, v in occ_state.items()}
    common = dict(active_expert=active_expert, sigma_scale=sigma_scale,
                  use_kernels=use_kernels)
    # the probe-bit mask of the one-shot, partial and union programs (the
    # resume takes the partial's bits from its state)
    masks = dict(mask_from_probes=occ_probe_mask)
    union_probe = bool(occ_probe_grid_res) and active_expert is None
    if bool(occ_probe_grid_res) and not union_probe:
        print("[render] --occ_union_probe_res ignored: union-grid probing "
              "applies to the unsharded full-MoE path only "
              "(active_expert=None, no mesh)")

    def render_fn(params, statics, rays, cdf_state=None):
        rgb, depth, w, acc = render_rays_occ(
            params, cfg, statics, occ, rays, ray_samples, randomized=False,
            bg_policy=bg_policy, importance=occ_importance,
            hard_mask=occ_hard_mask, use_bg_fn=use_bg_fn,
            cdf_state=cdf_state, **masks, **common)
        return _with_stats(rgb, depth, w, acc)

    full = ChunkRenderer(render_fn, dev)
    # dead chunks reduce to the background only when the background reads
    # no field colors ('last_sample' does; 'random' needs a generator the
    # serving renderer never has) AND sigma is hard-masked (soft mode
    # composites the field on dead rays too)
    skippable_bg = occ_hard_mask and bg_policy in ("white", "black", "none")
    pack_ratio = _pack_cost_ratio(cfg, ray_samples, active_expert,
                                  occ_hard_mask, union_probe)
    probe = dead = None
    if skippable_bg:
        no_occ = dead_grid(occ)  # once per renderer, not per chunk

        def probe_fn(statics, rays):
            return probe_rays_occ(statics, occ, rays,
                                  active_expert=active_expert,
                                  importance=occ_importance,
                                  use_kernels=use_kernels)

        def dead_fn(params, statics, rays):
            rgb, depth, w, acc = render_rays_occ_dead(
                params, cfg, statics, rays, ray_samples, dead=no_occ,
                bg_policy=bg_policy, use_bg_fn=use_bg_fn,
                sigma_scale=sigma_scale, use_kernels=use_kernels)
            return _with_stats(rgb, depth, w, acc)

        probe = (_union_probe_wrap(occ, occ_importance,
                                   int(occ_probe_grid_res), use_kernels, dev)
                 if union_probe else ChunkRenderer(probe_fn, dev))
        dead = ChunkRenderer(dead_fn, dev)

    et_on = (float(early_stop_eps) > 0.0 and not cfg.bucketed
             and int(ray_samples) > 8
             and bg_policy not in ("last_sample", "random"))
    if float(early_stop_eps) > 0.0 and not et_on:
        print("[render] early_stop_eps ignored: needs an unsharded, "
              "non-bucketed renderer with > 8 samples and a background "
              "that reads no field colors")
    if et_on:
        seg = int(early_stop_seg) or max(int(ray_samples) // 4, 8)
        pack = _pack7 if fog_stats else _pack5

        def partial_fn(params, statics, rays, cdf_state=None):
            outs, et_alive, state = render_rays_occ_et_partial(
                params, cfg, statics, occ, rays, ray_samples,
                seg_samples=seg, bg_policy=bg_policy, use_bg_fn=use_bg_fn,
                importance=occ_importance, cdf_state=cdf_state,
                hard_mask=occ_hard_mask,
                early_stop_eps=float(early_stop_eps), fog=fog_stats,
                **masks, **common)
            flag = et_alive.to(outs[0].dtype)[:, None]
            return torch.cat([pack(*outs), flag], dim=1), state

        def resume_fn(params, statics, state, ids):
            return pack(*render_rays_occ_et_resume(
                params, cfg, statics, occ, state, ids,
                hard_mask=occ_hard_mask, **common))

        partial = ChunkRenderer(partial_fn, dev)
        return EarlyStopOccRenderer(
            full=full, partial=partial,
            partial_from_cdf=partial if probe is not None else None,
            resume=ChunkRenderer(resume_fn, dev),
            render_dead=(None if dead is None else ChunkRenderer(
                lambda p, s, r: pack(*dead(p, s, r)), dev)),
            probe=probe, ncols=7 if fog_stats else 5,
            eps=float(early_stop_eps), device=dev,
            pack_cost_ratio=pack_ratio)
    if skippable_bg:
        return TwoWaveOccRenderer(
            full=full, probe=probe, render_from_cdf=full, render_dead=dead,
            device=dev, packable=not cfg.bucketed,
            pack_cost_ratio=pack_ratio)
    if union_probe:
        # the one-shot program with the union grid steering placement
        grid_for = _union_grid_for(occ, occ_importance,
                                   int(occ_probe_grid_res), use_kernels)

        def render_union_fn(params, statics, rays):
            rgb, depth, w, acc = render_rays_occ(
                params, cfg, statics, occ, rays, ray_samples,
                randomized=False, bg_policy=bg_policy,
                importance=occ_importance, hard_mask=occ_hard_mask,
                use_bg_fn=use_bg_fn,
                probe_fns=union_probe_fns(grid_for(statics)), **masks,
                **common)
            return _with_stats(rgb, depth, w, acc)

        return ChunkRenderer(render_union_fn, dev)
    return full


def default_chunk_rays(ray_samples: int, budget_pts: int = 3_145_728) -> int:
    """The reference's render chunk: the largest multiple of 1024 rays with
    rays x samples <= budget_pts, within [4096, 65536]."""
    c = budget_pts // max(int(ray_samples), 1)
    return int(max(4096, min(65536, (c // 1024) * 1024)))


class CoherentExpertRenderer:
    """The coherent dispatch's programs: `full(params, statics, rays)`
    renders a routed chunk, `single(params, statics, rays, k)` a chunk
    through expert k alone, and `probe(statics, rays)` gives each ray's
    coherent expert id or -1 (kernel 10b)."""

    def __init__(self, full, single, probe, num_experts, device,
                 fog_stats=False):
        self.full = full
        self.single = single
        self.probe = probe
        self.num_experts = int(num_experts)
        self.device = device
        self.fog_stats = bool(fog_stats)

    def __call__(self, params, statics, rays):
        return self.full(params, statics, rays)


def make_coherent_renderer(
    cfg: ContainerConfig,
    *,
    ray_samples: int,
    bg_policy: str = "white",
    use_bg_fn: bool = True,
    fog_stats: bool = False,
    occ_state: Optional[Dict] = None,  # occupancy-guided coherent mode
    occ_importance: bool = False,
    occ_hard_mask: bool = True,
    occ_probe_mask: bool = False,
    sigma_scale: float = 1.0,
    occ_probe_grid_res: int = 0,  # every program probes ONE union grid
    device="cuda",
    use_kernels: bool = True,
) -> CoherentExpertRenderer:
    """Coherent-expert live renderer (`--render_coherent`): rays whose every
    sample routes to one expert alone render through that expert (1/K the
    field evaluations); the others through the full routed program. Exact
    by construction: for such rays the routed blend IS the single expert's
    field.

    Without occ_state the programs sample stratified. With it every program
    probes the union grids (or, with occ_probe_grid_res, the one resampled
    union grid shared by all three programs) for placement, so all see the
    same CDF, sample positions and hard mask, and only the field narrows to
    one expert (`field_expert`); the probe tests the routing at those
    positions. In hard mode a dead ray's sigma is masked to zero in every
    program, so the probe sends dead rays to expert 0.

    The single-expert program evaluates one expert's MLPs where the full
    program evaluates the K-batched ones; the matmuls may round differently
    on the card (a few float32 ulps through the MLPs)."""
    dev = resolve_device(device)

    def _stats(rgb, depth, weights, acc):
        if fog_stats:
            return (rgb, depth, acc) + _fog_stats(weights)
        return rgb, depth, acc

    if occ_state is not None:
        occ = {k: v.to(dev) for k, v in occ_state.items()}
        grid_for = (_union_grid_for(occ, occ_importance,
                                    int(occ_probe_grid_res), use_kernels)
                    if int(occ_probe_grid_res) > 0 else None)

        def pfns(statics):
            return None if grid_for is None else union_probe_fns(
                grid_for(statics))

        def render_k(params, statics, rays, k):
            return _stats(*render_rays_occ(
                params, cfg, statics, occ, rays, ray_samples,
                randomized=False, bg_policy=bg_policy,
                importance=occ_importance, hard_mask=occ_hard_mask,
                mask_from_probes=occ_probe_mask, use_bg_fn=use_bg_fn,
                sigma_scale=sigma_scale, field_expert=k,
                probe_fns=pfns(statics), use_kernels=use_kernels))

        def probe_fn(statics, rays):
            pts, _, alive = occ_sample_positions(
                occ, statics, rays, ray_samples, importance=occ_importance,
                hard_mask=occ_hard_mask, probe_fns=pfns(statics),
                use_kernels=use_kernels)
            kid = routing_coherent_expert(statics, cfg, pts,
                                          use_kernels=use_kernels)
            if occ_hard_mask:
                # dead rays are hard-masked to zero sigma in every program,
                # so any expert renders them identically: pack them with
                # expert 0 (soft mode composites the field on dead rays, so
                # there the routing test keeps deciding)
                kid = torch.where(alive, kid, torch.zeros_like(kid))
            return kid

        return CoherentExpertRenderer(
            full=ChunkRenderer(lambda p, s, r: render_k(p, s, r, None), dev),
            single=ChunkRenderer(render_k, dev),
            probe=ChunkRenderer(probe_fn, dev),
            num_experts=cfg.num_experts, device=dev, fog_stats=fog_stats)

    def render_strat(params, statics, rays, k):
        field = container_field_fn(params, cfg, statics, k,
                                   use_kernels=use_kernels)
        return _stats(*render_rays_stratified(
            field, rays, ray_samples, randomized=False, bg_policy=bg_policy,
            bg_fn=container_bg_fn(params, cfg) if use_bg_fn else None,
            sigma_scale=sigma_scale, use_kernels=use_kernels))

    def probe_strat(statics, rays):
        _, near_s, far_s = _ray_validity(rays)
        # exactly the render's sample positions (render_rays_stratified);
        # invalid rays composite the background under every program
        t_vals = stratified_t_vals(near_s, far_s, ray_samples, False)
        pts = t_to_points(rays[:, 0:3], rays[:, 3:6], t_vals)
        return routing_coherent_expert(statics, cfg, pts,
                                       use_kernels=use_kernels)

    return CoherentExpertRenderer(
        full=ChunkRenderer(lambda p, s, r: render_strat(p, s, r, None), dev),
        single=ChunkRenderer(render_strat, dev),
        probe=ChunkRenderer(probe_strat, dev),
        num_experts=cfg.num_experts, device=dev, fog_stats=fog_stats)


def coherent_dispatch(renderer: CoherentExpertRenderer, params,
                      statics: ContainerStatics,
                      rays: np.ndarray,  # (n, 8) float32, host
                      chunk_rays: int, stats: Optional[dict] = None):
    """Two-wave coherent-expert dispatch -> [(ids, device output), ...].

    Wave 1 probes every chunk's per-ray coherent expert (all chunks
    dispatched before the first fetch); wave 2 packs each expert's rays
    into dense chunks through the single-expert program and sends the
    boundary rays (-1) through the full program. A tail packs into the
    smallest fitting shape of a halving ladder (chunk_rays, chunk/2, ...
    down to 1024, at most 6 shapes). stats: mode, n_coherent, n_boundary,
    chunks_total and rays_padded (rows rendered beyond the n rays)."""
    n = rays.shape[0]
    if stats is None:
        stats = {}
    dev = renderer.device
    sizes = [chunk_rays]  # descending halving ladder of bucket shapes
    while sizes[-1] > 1024 and len(sizes) < 6:
        sizes.append(sizes[-1] // 2)

    def fit(m):
        return next((z for z in reversed(sizes) if z >= m), chunk_rays)

    spans = _spans(n, chunk_rays)
    probed = [(s, m, renderer.probe(statics, _chunk(rays[s:s + m],
                                                    chunk_rays, dev)))
              for s, m in spans]
    kid = np.empty(n, np.int32)
    for s, m, out in probed:
        kid[s:s + m] = _fetch(out)[:m]
    del probed

    pending = []

    def emit(ids_all, run):
        for s in range(0, len(ids_all), chunk_rays):
            ids = ids_all[s:s + chunk_rays]
            pending.append((ids, run(_chunk(rays[ids], fit(len(ids)), dev))))

    coherent = 0
    for k in range(renderer.num_experts):
        ids_k = np.flatnonzero(kid == k)
        coherent += len(ids_k)
        emit(ids_k, lambda c, k=k: renderer.single(params, statics, c, k))
    emit(np.flatnonzero(kid < 0),
         lambda c: renderer.full(params, statics, c))
    rays_padded = sum(fit(len(ids)) for ids, _ in pending) - n
    stats.update(mode="coherent", n_coherent=int(coherent),
                 n_boundary=int(n - coherent), chunks_total=len(pending),
                 rays_padded=int(max(rays_padded, 0)))
    return pending


def _pad_chunk(chunk: np.ndarray, chunk_rays: int) -> np.ndarray:
    pad = chunk_rays - chunk.shape[0]
    if pad:
        chunk = np.concatenate([chunk, np.zeros((pad, 8), np.float32)], 0)
    return chunk


def _pad_ids(ids: np.ndarray, cap: int) -> np.ndarray:
    out = np.zeros(cap, np.int64)
    out[: len(ids)] = ids
    return out


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array -> tensor on `dev`; to the card through pinned memory (a
    pageable upload would wait for the card)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        t = t.pin_memory().to(dev, non_blocking=True)
    return t


def _chunk(rays: np.ndarray, chunk_rays: int, dev: torch.device):
    """Host rays (m <= chunk_rays, 8) -> one zero-padded chunk on `dev`."""
    return _upload(_pad_chunk(rays, chunk_rays), dev)


def _fetch(out) -> np.ndarray:
    return out.cpu().numpy() if torch.is_tensor(out) else np.asarray(out)


def _pack5(rgb, depth, acc):
    return torch.cat([rgb, depth[:, None], acc[:, None]], dim=1)


def _pack7(rgb, depth, acc, wmax, entropy):
    return torch.cat([rgb, depth[:, None], acc[:, None], wmax[:, None],
                      entropy[:, None]], dim=1)


def _spans(n: int, chunk_rays: int):
    return [(s, min(chunk_rays, n - s)) for s in range(0, n, chunk_rays)]


def _early_stop_dispatch(r: EarlyStopOccRenderer, params, statics,
                         rays: np.ndarray, chunk_rays: int, stats: dict):
    """two_wave_dispatch's early-termination mode (EarlyStopOccRenderer).

    Wave 1 (hard-mask renderers only): probe the chunks, then pack the
    occupancy-alive rays into dense chunks or skip the dead chunks to the
    background program, as the two-wave renderer does. Wave A: the partial
    program over every live chunk, all dispatched before the first fetch.
    Wave B: fetch each chunk's packed partial output, keep the terminated
    rays' rows as final, and resume the rays still alive in cap-sized
    slices (cap = chunk/4, the compaction granularity)."""
    n = rays.shape[0]
    dev = r.device
    spans = _spans(n, chunk_rays)
    stats.update(chunks_total=len(spans), mode="early_stop",
                 chunks_skipped=0, n_resumed=0, n_terminated=0,
                 resume_calls=0)
    cap = max(chunk_rays // 4, 1024)

    # big frames: in segments, so that at most SEG resume states are live
    SEG = 16
    if len(spans) > SEG:
        pending = []
        totals = {"chunks_total": 0, "chunks_skipped": 0, "n_resumed": 0,
                  "n_terminated": 0, "resume_calls": 0}
        for s0 in range(0, n, SEG * chunk_rays):
            seg_stats: dict = {}
            for ids, out in _early_stop_dispatch(
                    r, params, statics, rays[s0:s0 + SEG * chunk_rays],
                    chunk_rays, seg_stats):
                pending.append((ids + s0, out))
            for k in totals:
                totals[k] += int(seg_stats.get(k, 0))
        stats.update(segments=-(-len(spans) // SEG), **totals)
        return pending

    pending = []
    partials = []  # (global ids (m,), packed partial output, resume state)
    if r.probe is not None:
        # wave 1: occupancy probe -> pack alive rays / skip dead chunks
        probed = []
        for s, m in spans:
            chunk = _chunk(rays[s:s + m], chunk_rays, dev)
            probed.append((s, m, chunk, r.probe(statics, chunk)))
        alive = np.zeros(n, bool)
        for s, m, _, (cdf_state, _) in probed:
            alive[s:s + m] = _fetch(cdf_state["alive_valid"])[:m]
        n_alive = int(alive.sum())
        alive_chunks = sum(1 for s, m in spans if alive[s:s + m].any())
        packed_chunks = -(-n_alive // chunk_rays) if n_alive else 0
        if packed_chunks * (1.0 + r.pack_cost_ratio) < alive_chunks:
            stats.update(mode="early_stop+packed", n_alive=n_alive,
                         alive_chunks=alive_chunks,
                         packed_chunks=packed_chunks)
            probed = None  # release the CDFs; packed partials re-probe
            idx_alive = np.flatnonzero(alive)
            for s in range(0, len(idx_alive), chunk_rays):
                gids = idx_alive[s:s + chunk_rays]
                packed, state = r.et_partial(
                    params, statics, _chunk(rays[gids], chunk_rays, dev))
                partials.append((gids, packed, state))
            idx_dead = np.flatnonzero(~alive)
            for s in range(0, len(idx_dead), chunk_rays):
                gids = idx_dead[s:s + chunk_rays]
                pending.append((gids, r.render_dead(
                    params, statics, _chunk(rays[gids], chunk_rays, dev))))
        else:
            skipped = 0
            for i in range(len(probed)):
                s, m, chunk, (cdf_state, _) = probed[i]
                probed[i] = None
                gids = np.arange(s, s + m)
                if alive[s:s + m].any():
                    packed, state = r.et_partial_from_cdf(
                        params, statics, chunk, cdf_state)
                    partials.append((gids, packed, state))
                else:
                    skipped += 1
                    pending.append((gids, r.render_dead(params, statics,
                                                        chunk)))
                del cdf_state
            stats.update(mode="early_stop+two_wave", chunks_skipped=skipped,
                         n_alive=n_alive, alive_chunks=alive_chunks)
    else:
        # soft mode: no occupancy-dead rays, every chunk goes partial
        for s, m in spans:
            packed, state = r.et_partial(
                params, statics, _chunk(rays[s:s + m], chunk_rays, dev))
            partials.append((np.arange(s, s + m), packed, state))

    # wave B: fetch the partial outputs (every partial is already
    # dispatched), split terminated / alive, resume the alive
    nc = r.ncols
    for i in range(len(partials)):
        gids, packed, state = partials[i]
        partials[i] = None
        h = _fetch(packed)
        m = len(gids)
        flags = h[:m, nc] > 0.5
        idx_term = np.flatnonzero(~flags)
        idx_alive = np.flatnonzero(flags)
        if len(idx_term):
            pending.append((gids[idx_term], h[idx_term, :nc]))
        for s in range(0, len(idx_alive), cap):
            sl = idx_alive[s:s + cap]
            ids = _upload(_pad_ids(sl, cap), dev)
            pending.append((gids[sl], r.et_resume(params, statics, state,
                                                  ids)))
            stats["resume_calls"] += 1
        stats["n_resumed"] += int(len(idx_alive))
        stats["n_terminated"] += int(len(idx_term))
        del state
    return pending


def two_wave_dispatch(chunk_renderer, params, statics: ContainerStatics,
                      rays: np.ndarray,  # (n, 8) float32, host
                      chunk_rays: int, *extra,
                      stats: Optional[dict] = None,
                      probe_cache: Optional[dict] = None):
    """Dispatch a host ray batch through fixed-size zero-padded chunks ->
    [(ids (m,), output), ...], every chunk dispatched before the caller's
    first fetch so the card runs ahead of the readbacks. `extra` per-call
    args go to the render programs (not the probe).

    With a two-wave renderer, wave 1 probes every chunk and fetches the
    per-ray alive bits; wave 2 then either packs the alive rays of the
    whole frame into dense chunks (when the renderer is packable and that
    saves field-eval chunks after the probe it pays again) or skips: alive
    chunks render from the wave-1 CDF, dead chunks from the background
    program (bit-exact). `probe_cache` (a caller-owned dict) keeps wave 1
    across calls on the SAME rays and grid; the caller invalidates it.
    Early-stop renderers take `_early_stop_dispatch`."""
    n = rays.shape[0]
    if stats is None:
        stats = {}
    dev = chunk_renderer.device
    if getattr(chunk_renderer, "et_resume", None) is not None:
        # probe_cache does not apply: resume states depend on params
        if extra:
            raise ValueError("early-stop renderers pack their outputs on the "
                             "device and do not thread extra per-call args")
        return _early_stop_dispatch(chunk_renderer, params, statics, rays,
                                    chunk_rays, stats)
    spans = _spans(n, chunk_rays)
    stats.update(chunks_total=len(spans), mode="plain", chunks_skipped=0)

    if getattr(chunk_renderer, "probe", None) is None:
        return [(np.arange(s, s + m), chunk_renderer(
                    params, statics, _chunk(rays[s:s + m], chunk_rays, dev),
                    *extra))
                for s, m in spans]

    # huge frames: in segments, so that at most SEG probe CDFs are live;
    # the mode is decided per segment
    SEG = 16
    if len(spans) > SEG:
        pending = []
        totals = {"chunks_total": 0, "chunks_skipped": 0, "n_alive": 0,
                  "alive_chunks": 0}
        modes = set()
        for s0 in range(0, n, SEG * chunk_rays):
            seg_stats: dict = {}
            for ids, out in two_wave_dispatch(
                    chunk_renderer, params, statics,
                    rays[s0:s0 + SEG * chunk_rays], chunk_rays, *extra,
                    stats=seg_stats):
                pending.append((ids + s0, out))
            modes.add(seg_stats.get("mode"))
            for k in totals:
                totals[k] += int(seg_stats.get(k, 0))
        stats.update(mode="+".join(sorted(m for m in modes if m)),
                     segments=-(-len(spans) // SEG), **totals)
        return pending

    # wave 1: probe every chunk, fetch the per-ray alive bits
    if probe_cache is not None and probe_cache.get("chunk_rays") == chunk_rays:
        probed, alive = probe_cache["probed"], probe_cache["alive"]
        stats.update(probe_cached=True)
    else:
        probed = []
        for s, m in spans:
            chunk = _chunk(rays[s:s + m], chunk_rays, dev)
            probed.append((s, m, chunk, chunk_renderer.probe(statics, chunk)))
        alive = np.zeros(n, bool)
        for s, m, _, (cdf_state, _) in probed:
            alive[s:s + m] = _fetch(cdf_state["alive_valid"])[:m]
        if probe_cache is not None:
            probe_cache.update(probed=probed, alive=alive,
                               chunk_rays=chunk_rays)

    alive_chunks = sum(1 for s, m in spans if alive[s:s + m].any())
    n_alive = int(alive.sum())
    packed_chunks = -(-n_alive // chunk_rays) if n_alive else 0

    pending = []
    ratio = getattr(chunk_renderer, "pack_cost_ratio", 0.0)
    if getattr(chunk_renderer, "packable", False) and (
            packed_chunks * (1.0 + ratio) < alive_chunks):
        # ray packing: field-eval chunks = ceil(alive / chunk)
        stats.update(mode="packed", packed_chunks=packed_chunks,
                     alive_chunks=alive_chunks, n_alive=n_alive)
        if probe_cache is None:
            probed = None  # release every chunk's probe CDF
        idx_alive = np.flatnonzero(alive)
        idx_dead = np.flatnonzero(~alive)
        for s in range(0, len(idx_alive), chunk_rays):
            ids = idx_alive[s:s + chunk_rays]
            pending.append((ids, chunk_renderer.full(
                params, statics, _chunk(rays[ids], chunk_rays, dev), *extra)))
        for s in range(0, len(idx_dead), chunk_rays):
            ids = idx_dead[s:s + chunk_rays]
            pending.append((ids, chunk_renderer.render_dead(
                params, statics, _chunk(rays[ids], chunk_rays, dev), *extra)))
        return pending

    # chunk skipping from the wave-1 CDFs
    skipped = 0
    for i in range(len(probed)):
        s, m, chunk, (cdf_state, _) = probed[i]
        if probe_cache is None:
            probed[i] = None  # free the CDF once its render is dispatched
        if alive[s:s + m].any():
            out = chunk_renderer.render_from_cdf(params, statics, chunk,
                                                 cdf_state, *extra)
        else:
            skipped += 1
            out = chunk_renderer.render_dead(params, statics, chunk, *extra)
        del cdf_state
        pending.append((np.arange(s, s + m), out))
    stats.update(mode="two_wave", chunks_skipped=skipped,
                 alive_chunks=alive_chunks, n_alive=n_alive)
    return pending


def render_rays_chunked(
    chunk_renderer,
    params,
    statics: ContainerStatics,
    rays: np.ndarray,  # (n, 8) float32, host
    chunk_rays: int,
    stats: Optional[dict] = None,
    fog_stats: bool = False,  # renderer built with fog_stats=True -> (n, 7)
) -> np.ndarray:
    """Render a host ray batch through fixed-size zero-padded chunks ->
    (n, 5) float32 [rgb, depth, acc] on the host (with fog_stats (n, 7)
    [..., wmax, entropy]): `two_wave_dispatch` with the outputs packed on
    the device into one fetch per chunk. `stats` receives the dispatch's
    mode and counts."""
    pack, ncols, attr = ((_pack7, 7, "_pack7_cache") if fog_stats
                         else (_pack5, 5, "_pack5_cache"))
    if isinstance(chunk_renderer, CoherentExpertRenderer):
        # coherent_dispatch with the outputs packed on the device
        if chunk_renderer.fog_stats != fog_stats:
            raise ValueError(
                f"coherent renderer built with fog_stats="
                f"{chunk_renderer.fog_stats} but the caller expects "
                f"fog_stats={fog_stats}: build it with the matching flag")
        packed = getattr(chunk_renderer, attr, None)
        if packed is None:
            base, dev = chunk_renderer, chunk_renderer.device
            packed = CoherentExpertRenderer(
                full=ChunkRenderer(
                    lambda p, s, c: pack(*base.full(p, s, c)), dev),
                single=ChunkRenderer(
                    lambda p, s, c, k: pack(*base.single(p, s, c, k)), dev),
                probe=base.probe, num_experts=base.num_experts, device=dev,
                fog_stats=base.fog_stats)
            setattr(chunk_renderer, attr, packed)
        out = np.zeros((rays.shape[0], ncols), np.float32)
        for ids, dev_out in coherent_dispatch(packed, params, statics, rays,
                                              chunk_rays, stats=stats):
            out[ids] = _fetch(dev_out)[:len(ids)]
        return out
    if getattr(chunk_renderer, "et_resume", None) is not None:
        if chunk_renderer.ncols != ncols:
            raise ValueError(
                f"early-stop renderer packs {chunk_renderer.ncols} output "
                f"columns but the caller expects {ncols}: build it with the "
                f"matching fog_stats flag")
        packed = chunk_renderer  # its programs pack on the device already
    elif getattr(chunk_renderer, "probe", None) is not None:
        packed = getattr(chunk_renderer, attr, None)
        if packed is None:
            packed = chunk_renderer.map_outputs(pack)
            setattr(chunk_renderer, attr, packed)
        packed.packable = chunk_renderer.packable  # may be toggled later
    else:
        base = chunk_renderer
        packed = ChunkRenderer(lambda p, s, c: pack(*base(p, s, c)),
                               base.device)
    out = np.zeros((rays.shape[0], ncols), np.float32)
    for ids, dev_out in two_wave_dispatch(packed, params, statics, rays,
                                          chunk_rays, stats=stats):
        rows = _fetch(dev_out)[:len(ids)]
        # the dispatchers give strictly increasing ids: a span as long as
        # the count is a contiguous range, copied as a slice (numpy's index
        # assignment is far slower on a whole chunk)
        if len(ids) and ids[-1] - ids[0] == len(ids) - 1:
            out[ids[0]:ids[-1] + 1] = rows
        else:
            out[ids] = rows
    return out


def render_image(
    chunk_renderer,
    params,
    statics: ContainerStatics,
    md,  # any object with H, W, intrinsics (fx, fy, cx, cy) and c2w (3, 4)
    *,
    scene_aabb: Optional[np.ndarray] = None,
    near: Optional[float] = None,
    far: Optional[float] = None,
    chunk_rays: int = 65536,
    stats: Optional[dict] = None,
):
    """Full-frame render -> (rgb (H,W,3) linear, depth (H,W), acc (H,W))
    as numpy. `stats` (not in the reference's signature) receives the
    dispatch's mode and counts."""
    H, W = md.H, md.W
    rays, _ = frame_rays(H, W, md.intrinsics, md.c2w, aabb=scene_aabb,
                         near=near, far=far)
    out = render_rays_chunked(chunk_renderer, params, statics, rays,
                              chunk_rays, stats=stats)
    return (out[:, 0:3].reshape(H, W, 3).copy(),
            out[:, 3].reshape(H, W).copy(),
            out[:, 4].reshape(H, W).copy())


def frame_chunk_rays_biased(c2w, intr, start, chunk_rays, H, W, *,
                            scene_box, near, far, near_override,
                            far_override, near_bias):
    """On-device frame ray generation plus the video path's near shift:
    t_near = max(near, 0) + bias, capped at far - 1e-4 (miss tags stay
    inf)."""
    rays = frame_chunk_rays(
        c2w, intr, start, chunk_rays, H, W, scene_box=scene_box, near=near,
        far=far, near_override=near_override, far_override=far_override)
    if float(near_bias) != 0.0:
        t_near = (torch.clamp(rays[:, 6], min=0.0)
                  + float(np.float32(near_bias)))
        rays = rays.clone()
        rays[:, 6] = torch.minimum(t_near, rays[:, 7] - 1e-4)
        rays, _ = clamp_rays_near_far(rays)
    return rays


def shape_frame_outputs(rays, rgb, depth, weights, acc, *extra, fog_stats,
                        invalid_black, map_outputs, out_u8):
    """Camera-renderer output shaping on the device: the fog signals,
    zeroed box-miss rays (invalid_black), then `map_outputs`, the uint8
    quantisation, or the stacked (C, 5[+2]) float planes."""
    outs = [rgb, depth, acc]
    if fog_stats:
        outs += list(_fog_stats(weights))
    if invalid_black:
        ok = torch.isfinite(rays[:, 6])
        outs = [torch.where(ok[:, None] if o.dim() == 2 else ok, o, 0.0)
                for o in outs]
    if map_outputs is not None:
        return map_outputs(*outs, *extra)
    if out_u8:
        return torch.clamp(outs[0] * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
    return torch.cat([o if o.dim() == 2 else o[:, None] for o in outs],
                     dim=1)


def make_live_camera_renderer(
    cfg: ContainerConfig,
    *,
    H: int,
    W: int,
    ray_samples: int,
    chunk_rays: int = 65536,
    scene_aabb: Optional[np.ndarray] = None,
    near: Optional[float] = None,
    far: Optional[float] = None,
    near_override: Optional[float] = None,
    far_override: Optional[float] = None,
    near_bias: float = 0.0,
    occ_state: Optional[Dict] = None,
    occ_importance: bool = False,
    occ_hard_mask: bool = True,
    occ_probe_mask: bool = False,
    occ_probe_grid_res: int = 0,  # union-grid probing (0 = exact per-expert)
    active_expert: Optional[int] = None,
    bg_policy: str = "white",
    use_bg_fn: bool = True,
    fog_stats: bool = False,
    invalid_black: bool = False,
    out_u8: bool = True,
    map_outputs=None,
    device="cuda",
    use_kernels: bool = True,
):
    """Serving-path frame renderer over the LIVE field: (params, statics,
    c2w (3, 4), intrinsics (4,), *extra) -> (H, W, 3) uint8, or with
    out_u8=False the stacked float planes (H*W, 5) [rgb, depth, acc]
    ((H*W, 7) with fog_stats' wmax and entropy), or with map_outputs its
    (H, W, k) result.

    Rays are generated on the device chunk by chunk
    (`frame_chunk_rays_biased`: the upload is the pose and intrinsics, not
    H*W*8 floats of host rays), each chunk is rendered and shaped on the
    device (`shape_frame_outputs`), and every chunk is dispatched before
    the one fetch of the frame. The one-program live modes: stratified
    without occ_state; soft occupancy (the grid steers placement, nothing
    is skipped); hard mask without dead-chunk skipping (the two-wave
    dispatcher stays on the host-ray path). occ_probe_grid_res > 0 probes
    ONE resampled union grid (built once per statics) instead of every
    expert's every level; the hard sigma mask stays exact per expert.

    `near_bias` shifts t_near on the device as the video path does
    (max(near, 0) + bias, capped at far - 1e-4; miss tags stay inf);
    `map_outputs(rgb, depth, acc[, wmax, entropy], *extra)` maps the
    outputs on the device; invalid_black zeroes box-miss pixels;
    occ_probe_mask masks the hard mode's sigma by the samples' probe bits
    in place of the point query."""
    dev = resolve_device(device)
    sb = None
    if scene_aabb is not None:
        sb = SceneBox(torch.as_tensor(np.asarray(scene_aabb, np.float32),
                                      device=dev))
    elif near is None or far is None:
        raise ValueError("provide scene_aabb or scalar near/far")
    occ = (None if occ_state is None
           else {k: v.to(dev) for k, v in occ_state.items()})
    grid_for = None
    if occ is not None and int(occ_probe_grid_res) > 0:
        if active_expert is not None:
            print("[render] --occ_union_probe_res ignored: union-grid "
                  "probing applies to the full-MoE path only "
                  "(active_expert set)")
        else:
            grid_for = _union_grid_for(occ, occ_importance,
                                       int(occ_probe_grid_res), use_kernels)

    def chunk_fn(params, statics, c2w, intr, start, union_grid, *extra):
        rays = frame_chunk_rays_biased(
            c2w, intr, start, chunk_rays, H, W, scene_box=sb, near=near,
            far=far, near_override=near_override, far_override=far_override,
            near_bias=near_bias)
        if occ is not None:
            rgb, depth, w, acc = render_rays_occ(
                params, cfg, statics, occ, rays, ray_samples,
                randomized=False, bg_policy=bg_policy,
                active_expert=active_expert, importance=occ_importance,
                hard_mask=occ_hard_mask, mask_from_probes=occ_probe_mask,
                use_bg_fn=use_bg_fn,
                probe_fns=(None if union_grid is None
                           else union_probe_fns(union_grid)),
                use_kernels=use_kernels)
        else:
            field = container_field_fn(params, cfg, statics, active_expert,
                                       use_kernels=use_kernels)
            rgb, depth, w, acc = render_rays_stratified(
                field, rays, ray_samples, randomized=False,
                bg_policy=bg_policy,
                bg_fn=container_bg_fn(params, cfg) if use_bg_fn else None,
                use_kernels=use_kernels)
        return shape_frame_outputs(
            rays, rgb, depth, w, acc, *extra, fog_stats=fog_stats,
            invalid_black=invalid_black, map_outputs=map_outputs,
            out_u8=out_u8)

    n_pix = H * W

    def render(params, statics, c2w, intrinsics, *extra):
        c2w_t = torch.from_numpy(
            np.array(np.asarray(c2w, np.float32)[:3, :4])).to(dev)
        intr_t = torch.from_numpy(
            np.array(np.asarray(intrinsics, np.float32)[:4])).to(dev)
        with torch.no_grad():
            grid = grid_for(statics) if grid_for is not None else None
            # every chunk dispatched before the first fetch
            pending = [chunk_fn(params, statics, c2w_t, intr_t, s, grid,
                                *extra)
                       for s in range(0, n_pix, chunk_rays)]
            out = torch.cat(pending, dim=0)[:n_pix].cpu().numpy()
        if map_outputs is not None or out_u8:
            return out.reshape(H, W, -1)
        return out  # (H*W, C) stacked planes; the caller reshapes

    return render


# --------------------------- evaluate ----------------------------------------
def _srgb_u8(img: torch.Tensor) -> np.ndarray:
    return (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8)


def runtime_evaluate(
    *,
    params,
    cfg: ContainerConfig,
    statics: ContainerStatics,
    optimizer: Optimizer,
    test_metadata: List[ImageMetadata],
    tto_steps: int,
    support_batch: int = 4096,
    ray_samples: int = 96,
    color_space: str = "linear",
    bg_policy: str = "random",
    near: Optional[float] = None,
    far: Optional[float] = None,
    global_aabb: Optional[np.ndarray] = None,
    out_dir: Optional[Path] = None,
    logger=None,
    seed: int = 0,
    lpips_weights_path: Optional[str] = None,
    chunk_rays: Optional[int] = None,  # None: default_chunk_rays
    occ_state: Optional[Dict] = None,
    occ_importance: bool = False,
    occ_probe_mask: bool = False,
    occ_hard_mask: bool = True,
    occ_probe_grid_res: int = 0,  # Phase-B union-grid probing (0 = exact)
    render_early_stop: float = 0.0,  # Phase-B early ray termination eps
    render_coherent: bool = False,  # Phase-B coherent-expert dispatch
    render_baked_res: int = 0,  # > 0: Phase-B renders a baked SH snapshot
    render_baked_sh: int = 3,  # SH levels (degree + 1) for the bake
    render_baked_occ: bool = False,  # bake only occ-alive cells
    render_baked_occ_dilate: int = 2,
    render_baked_sparse: int = 0,  # block-compact the baked table (exact)
    render_baked_cache: str = "",  # .npz snapshot cache: bake once, serve
    # on every later run of the SAME checkpoint/adaptation (fingerprinted)
    fim_cfg=None,  # not ported (ROADMAP Queue 1 item 7)
    mesh=None,  # not ported
) -> Dict[str, float]:
    """Adapt on the test images' support rays, then render and score them
    on the params' device -> {psnr, ssim, lpips (NaN without weights),
    duration (Phase A s), render_time (Phase B s), num_images, params}."""
    if fim_cfg is not None:
        raise NotImplementedError(
            "Fisher-weighted adaptation (--fim, make_fim_adapt_step) is not "
            "ported: ROADMAP Queue 1 item 7")
    if mesh is not None:
        raise NotImplementedError("mesh-sharded rendering is not ported")
    log = logger.log if logger is not None else print
    dev = tree_leaves(params)[0].device
    if chunk_rays is None:
        chunk_rays = default_chunk_rays(ray_samples)

    # ---- Phase A: adaptation ----
    log(f"[Phase 1] runtime adaptation, tto={tto_steps}")
    t0 = time.time()
    opt_state = optimizer.init(params)
    step = make_adapt_step(
        cfg, optimizer, ray_samples=ray_samples, color_space=color_space,
        bg_policy=bg_policy, occ_importance=occ_importance,
        occ_probe_mask=occ_probe_mask, occ_hard_mask=occ_hard_mask)

    def adapt_step(p, o, statics_, rays_, rgbs_, gen):
        return step(p, o, statics_, rays_, rgbs_, gen, occ_state)

    support_ds = RamRaysDataset(test_metadata, scene_aabb=global_aabb,
                                near_far_override=(near, far))
    log(f"  support rays: {len(support_ds):,} from {support_ds.num_images} "
        f"images")
    if tto_steps > 0 and len(support_ds) > 0:
        loader = EpochBatchSampler(support_ds, support_batch, seed=seed)
        gen = torch.Generator(dev)
        gen.manual_seed(seed)
        out = runtime_adapt(params=params, opt_state=opt_state,
                            adapt_step=adapt_step, statics=statics,
                            data_loader=loader, steps=tto_steps,
                            generator=gen)
        params = out["params"]
        log(f"  adapted {out['steps']} steps, last loss {out['loss']:.6f}")
    adapt_time = time.time() - t0

    # ---- Phase B: render + metrics ----
    log("[Phase 2] rendering test images")
    if render_baked_res > 0:
        # serving mode: resample the (adapted) field into a baked SH grid
        # once, then frames cost only trilinear grid lookups (models/baked).
        # Re-baked per TTO setting because adaptation changes the field.
        if float(render_early_stop) > 0.0:
            log("  [baked] NOTE: --render_early_stop is ignored with "
                "--render_baked (the baked render has no occ/ET path)")
        if render_coherent:
            log("  [baked] NOTE: --render_coherent is ignored with "
                "--render_baked (the snapshot has no expert routing)")
        from nerfsys_tpu_torch.models.baked import (
            BakedConfig,
            bake_field,
            load_baked,
            make_baked_chunk_renderer,
            occ_bake_fingerprint,
            params_fingerprint,
            save_baked,
        )

        # n_dirs scales with the basis count so the SH least-squares
        # projection stays overdetermined at any --render_baked_sh
        bcfg = BakedConfig(resolution=int(render_baked_res),
                           sh_levels=int(render_baked_sh),
                           n_dirs=max(32, 2 * int(render_baked_sh) ** 2),
                           sparse_block=int(render_baked_sparse))
        if render_baked_occ and occ_state is None:
            # bake_field only warns for a present-but-not-ready state; a
            # checkpoint with no grids at all would silently bake dense
            log("  [baked] WARNING: --render_baked_occ requested but the "
                "checkpoint has no occupancy state — baking dense")
        baked = None
        fp = params_fingerprint(params) if render_baked_cache else ""
        ok = occ_bake_fingerprint(
            occ_state if render_baked_occ else None,
            int(render_baked_occ_dilate)) if render_baked_cache else ""
        if render_baked_cache:
            baked = load_baked(render_baked_cache, bcfg, fingerprint=fp,
                               occ_key=ok, device=dev)
            if baked is not None:
                log(f"  [baked] loaded snapshot cache {render_baked_cache}")
        if baked is None:
            tb = time.time()
            baked = bake_field(
                params, cfg, statics, bcfg,
                occ_state=occ_state if render_baked_occ else None,
                occ_dilate=int(render_baked_occ_dilate), device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            log(f"  baked {bcfg.resolution}³ SH-{bcfg.sh_levels} grid "
                f"in {time.time() - tb:.1f}s")
            if render_baked_cache:
                save_baked(render_baked_cache, baked, bcfg, fingerprint=fp,
                           occ_key=ok)
                log(f"  [baked] saved snapshot cache {render_baked_cache}")
        renderer = make_baked_chunk_renderer(
            baked, bcfg, cfg, ray_samples=ray_samples, bg_policy="white",
            device=dev)
    elif render_coherent and float(render_early_stop) == 0:
        # coherent-expert live dispatch: exact, fastest on spatially
        # clustered frames (render_rays_chunked routes the bundle through
        # coherent_dispatch)
        if int(occ_probe_grid_res) > 0:
            log(f"  [render] coherent + union-probe grid "
                f"(res {int(occ_probe_grid_res)}): probe rows /K in every "
                "program")
        renderer = make_coherent_renderer(
            cfg, ray_samples=ray_samples, bg_policy="white",
            occ_state=occ_state, occ_importance=occ_importance,
            occ_hard_mask=occ_hard_mask, occ_probe_mask=occ_probe_mask,
            occ_probe_grid_res=occ_probe_grid_res, device=dev)
    else:
        if render_coherent:
            log("  [render] --render_coherent ignored: unsharded renders "
                "without --render_early_stop only")
        renderer = make_chunk_renderer(
            cfg, ray_samples=ray_samples, bg_policy="white",
            occ_state=occ_state, occ_importance=occ_importance,
            occ_probe_grid_res=occ_probe_grid_res,
            occ_hard_mask=occ_hard_mask,  # render how the checkpoint trained
            occ_probe_mask=occ_probe_mask,
            early_stop_eps=render_early_stop, device=dev)
    lpips_w = load_lpips_weights(lpips_weights_path)
    psnrs, ssims, lpipss = [], [], []
    if out_dir is not None:
        pred_dir = Path(out_dir) / f"pred{tto_steps}"
        gt_dir = Path(out_dir) / "gt"
        pred_dir.mkdir(parents=True, exist_ok=True)
        gt_dir.mkdir(parents=True, exist_ok=True)

    t1 = time.time()
    for i, md in enumerate(test_metadata):
        gt_srgb = md.load_image().astype(np.float32) / 255.0
        pred_lin, _, _ = render_image(
            renderer, params, statics, md, scene_aabb=global_aabb,
            near=near, far=far, chunk_rays=chunk_rays)
        pred_t = torch.from_numpy(pred_lin).to(dev)
        gt_t = torch.from_numpy(gt_srgb).to(dev)
        with torch.no_grad():
            pred_c, gt_c = color_space_transformer(pred_t, gt_t, color_space)
            p = float(psnr_from_mse(torch.mean((pred_c - gt_c) ** 2)))
            s = float(ssim(pred_c, gt_c))
            pred_srgb = linear_to_srgb(pred_t)
            if lpips_w is not None:
                lpipss.append(float(lpips(pred_srgb, gt_t, lpips_w)))
        psnrs.append(p)
        ssims.append(s)
        log(f"  [{i:03d}] psnr {p:.2f}  ssim {s:.4f}"
            + (f"  lpips {lpipss[-1]:.4f}" if lpips_w is not None else ""))

        if out_dir is not None:
            from PIL import Image as PILImage

            PILImage.fromarray(_srgb_u8(pred_srgb)).save(
                pred_dir / f"{i:06d}.png")
            PILImage.fromarray((gt_srgb * 255).astype(np.uint8)).save(
                gt_dir / f"{i:06d}.png")

    render_time = time.time() - t1
    result = {
        "psnr": float(np.mean(psnrs)) if psnrs else float("nan"),
        "ssim": float(np.mean(ssims)) if ssims else float("nan"),
        "lpips": float(np.mean(lpipss)) if lpipss else float("nan"),
        "duration": adapt_time,
        "render_time": render_time,
        "num_images": len(test_metadata),
        "params": params,
    }
    log(f"[RESULT tto={tto_steps}] psnr {result['psnr']:.3f}  "
        f"ssim {result['ssim']:.4f}  lpips {result['lpips']:.4f}  "
        f"adapt {adapt_time:.1f}s  render {render_time:.1f}s")
    return result
