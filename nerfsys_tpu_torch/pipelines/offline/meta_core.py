"""Meta-learning core: inner-loop task adaptation and the Reptile update.

Port of nerfsys_tpu/pipelines/offline/meta_core.py (`MetaConfig` :44,
`_expert_loss_fn` :103, `task_adapt` :174, `query_loss` :287,
`reptile_update` :309) for the first-order algorithms:

  - FoMAML: the inner SGD runs on a DETACHED copy of the expert; the adapted
    weights are reattached through the identity, base + (fast - base) with
    the difference detached, so the outer gradient of the expert is the
    query-loss gradient at the fast weights (the reference's
    `base + stop_gradient(f - base)`, same arithmetic).
  - Reptile: theta += lr * mean over valid tasks of (fast - theta).

Second-order MAML differentiates through the inner loop, which needs a
double backward through the encoder and compositor kernels; it raises
NotImplementedError. Inner adaptation touches ONLY the active expert; the
background model renders as a constant (detached) in the inner loop and is
trained by the outer query loss alone.

The reference's TPU scheduling knobs (expert_map, expert_unroll,
task_unroll) have no counterpart: experts and tasks run one after the
other, which is what its lax.map / lax.scan mean.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from nerfsys_tpu_torch.models.container import (
    ContainerConfig,
    _expert_apply_fn,
    background_color,
)
from nerfsys_tpu_torch.ops.losses import compute_mse_loss
from nerfsys_tpu_torch.ops.occupancy import occupancy_probe_cdf
from nerfsys_tpu_torch.utils.tree import tree_leaves, tree_map

Params = Dict
OccGrid = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MetaConfig:
    """Static hyperparameters of meta-training (the reference's semantic
    keys)."""

    algo: str = "fomaml"  # maml | fomaml | reptile
    inner_iter: int = 8
    inner_lr: float = 0.015
    reptile_lr: float = 1e-4  # outer lr of the reptile rule
    ray_samples: int = 96
    color_space: str = "srgb"
    bg_policy: str = "white"  # used when the container has no bg model
    sigma_scale: float = 1.0
    randomized: bool = True
    occ_importance: bool = False  # EMA values steer the probe pdf
    occ_probe_mask: bool = False  # hard mode only (not ported)
    occ_hard_mask: bool = True  # False: the soft mode (the ported one)
    occ_ray_floor: float = 0.25  # whole-ray pdf floor of the soft mode
    occ_probes: int = 128

    def __post_init__(self):
        if self.algo not in ("maml", "fomaml", "reptile"):
            raise ValueError(f"Unknown meta algo: {self.algo!r}")

    @property
    def first_order(self) -> bool:
        return self.algo in ("fomaml", "reptile")


def _expert_loss_fn(
    meta: MetaConfig,
    cfg: ContainerConfig,
    expert_params: Params,
    aabb: torch.Tensor,  # (2, 3)
    bg_params: Optional[Params],
    rays: torch.Tensor,
    rgbs: torch.Tensor,
    generator: Optional[torch.Generator],
    randomized: bool,
    occ_grid: Optional[OccGrid] = None,
    occ_on: Optional[bool] = None,
    occ_cdf=None,
    use_kernels: bool = True,
):
    """Single-expert render loss; with an occupancy grid the renderer goes
    stratified -> occupancy once the grid is ready."""
    apply_fn, _ = _expert_apply_fn(cfg)

    def field(pts, dirs):
        return apply_fn(expert_params, cfg.expert, aabb, pts, dirs,
                        use_kernels=use_kernels)

    bg_fn = None
    if cfg.use_bg_nerf and bg_params is not None:
        def bg_fn(dirs):
            return background_color({"bg": bg_params}, cfg, dirs)

    return compute_mse_loss(
        field, rays, rgbs, ray_samples=meta.ray_samples, generator=generator,
        randomized=randomized, color_space=meta.color_space,
        bg_policy=meta.bg_policy, bg_fn=bg_fn, sigma_scale=meta.sigma_scale,
        occ_grid=occ_grid, occ_on=occ_on, importance=meta.occ_importance,
        occ_cdf=occ_cdf, occ_probe_mask=meta.occ_probe_mask,
        occ_hard_mask=meta.occ_hard_mask, occ_ray_floor=meta.occ_ray_floor,
        n_probes=meta.occ_probes, use_kernels=use_kernels)


def _detach(tree):
    return None if tree is None else tree_map(lambda t: t.detach(), tree)


def task_adapt(
    meta: MetaConfig,
    cfg: ContainerConfig,
    expert_params: Params,  # one expert's tree (no K axis)
    aabb: torch.Tensor,  # (2, 3)
    bg_params: Optional[Params],
    support_rays: torch.Tensor,  # (S, 8)
    support_rgbs: torch.Tensor,  # (S, 3)
    generator: Optional[torch.Generator] = None,
    iterations: Optional[int] = None,
    inner_lr: Optional[float] = None,
    occ_grid: Optional[OccGrid] = None,  # this expert's K=1 grid slice
    occ_on: Optional[bool] = None,
    *,
    use_kernels: bool = True,
) -> Tuple[Params, torch.Tensor]:
    """Inner loop: `iterations` SGD steps on the support loss -> (fast
    params, inner losses (iterations,)). First order: the outer gradient
    reaches `expert_params` through the identity only."""
    iterations = meta.inner_iter if iterations is None else iterations
    lr = meta.inner_lr if inner_lr is None else inner_lr
    if iterations <= 0:
        # no adaptation (tto 0): a zero inner loss keeps metric shapes
        return expert_params, torch.zeros(
            (1,), device=support_rays.device)
    wants_outer = torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(expert_params))
    if not meta.first_order and wants_outer:
        raise NotImplementedError(
            "algo='maml' (second order) needs a double backward through the "
            "encoder and compositor kernels, which is not ported")
    bg_const = _detach(bg_params)

    occ_cdf = None
    if occ_grid is not None and (occ_on is None or occ_on):
        # support rays and grid are constant across the inner loop: probe
        # once per task, draw fresh samples every iteration
        o = support_rays[:, 0:3].contiguous()
        d = support_rays[:, 3:6].contiguous()
        near, far = support_rays[:, 6], support_rays[:, 7]
        valid = (torch.isfinite(near) & torch.isfinite(far) & (far > near)
                 & (far < 1e9))
        near_s = torch.where(valid, near, torch.zeros_like(near))
        far_s = torch.where(valid, far, torch.ones_like(far))
        occ_cdf = occupancy_probe_cdf(
            *occ_grid, o, d, near_s, far_s, meta.occ_probes,
            importance=meta.occ_importance,
            ray_floor=0.0 if meta.occ_hard_mask else meta.occ_ray_floor,
            use_kernels=use_kernels)

    fast = _detach(expert_params)
    losses = []
    with torch.enable_grad():
        for _ in range(iterations):
            p = tree_map(lambda t: t.detach().requires_grad_(True), fast)
            loss, _ = _expert_loss_fn(
                meta, cfg, p, aabb, bg_const, support_rays, support_rgbs,
                generator, meta.randomized, occ_grid, occ_on, occ_cdf,
                use_kernels)
            leaves = tree_leaves(p)
            grads = dict(zip(map(id, leaves), torch.autograd.grad(
                loss, leaves, allow_unused=True)))

            def sgd(w):
                g = grads[id(w)]
                return w.detach() if g is None else (w - lr * g).detach()

            fast = tree_map(sgd, p)
            losses.append(loss.detach())
    losses = torch.stack(losses)
    if not meta.first_order:
        return fast, losses  # values only (eval): no outer gradient asked
    return tree_map(lambda base, f: base + (f - base.detach()),
                    expert_params, fast), losses


def query_loss(
    meta: MetaConfig,
    cfg: ContainerConfig,
    fast_params: Params,
    aabb: torch.Tensor,
    bg_params: Optional[Params],
    query_rays: torch.Tensor,
    query_rgbs: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    occ_grid: Optional[OccGrid] = None,
    occ_on: Optional[bool] = None,
    *,
    use_kernels: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query-set loss at the adapted weights -> (loss, psnr); randomized
    when meta.randomized and a generator is given."""
    loss, aux = _expert_loss_fn(
        meta, cfg, fast_params, aabb, bg_params, query_rays, query_rgbs,
        generator, meta.randomized and generator is not None, occ_grid,
        occ_on, None, use_kernels)
    return loss, aux["psnr"]


def reptile_update(base_experts: Params, fast_experts: Params,
                   valid: torch.Tensor, lr: float) -> Params:
    """theta_k += lr * mean_b(W_kb - theta_k) over valid tasks; fast
    experts carry (K, B, ...), valid is (K, B)."""
    v = valid.to(torch.float32)
    denom = torch.clamp(v.sum(dim=1), min=1.0)  # (K,)

    def upd(theta, fast):
        w = v.reshape(*v.shape, *((1,) * (fast.dim() - 2)))
        # select-then-sum: NaNs of padded or failed tasks cannot leak
        diff = torch.where(w > 0, fast - theta[:, None],
                           torch.zeros((), dtype=fast.dtype,
                                       device=fast.device))
        delta = (diff * w).sum(dim=1)
        delta = delta / denom.reshape(-1, *((1,) * (delta.dim() - 1)))
        return theta + lr * delta

    return tree_map(upd, base_experts, fast_experts)
