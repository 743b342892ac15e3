"""Mixture-of-experts NeRF container: spatial routing + background model.

Port of nerfsys_tpu/models/container.py (`ContainerConfig`,
`ContainerStatics`, `init_container_params` :128, `_routing_dist` :158,
`routing_weights` :175, the dense `_eval_all_experts` :256,
`container_apply` :419, `container_apply_multidir` :447,
`background_color` :502, `container_field_fn`,
`container_bg_fn`, `_expert_apply_fn` :235, `param_group_labels` :545).
The K experts' parameters are stacked on a leading axis and evaluated as ONE batched call over that axis (batched matmuls, one
encoder launch), then blended with the dense (N, K) routing weights before
integration. Bucketed top-E dispatch is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from nerfsys_tpu_torch.models.ngp import (
    NGPConfig,
    _linear_init,
    init_ngp_params,
    ngp_apply,
    ngp_color,
    ngp_density,
    tree_to,
)
from nerfsys_tpu_torch.ops.encodings import sh_encode, sh_out_dim
from nerfsys_tpu_torch.utils.device import resolve_device
from nerfsys_tpu_torch.utils.tree import tree_map

Params = Dict


@dataclasses.dataclass(frozen=True)
class ContainerConfig:
    """Static hyperparameters of the MoE container."""

    num_experts: int
    nerf_variant: str = "instant"
    boundary_margin: float = 1.0  # > 1.0 -> soft routing
    cluster_2d: bool = True  # route on (y, z) only
    use_bg_nerf: bool = True
    bg_hidden: int = 32
    bg_encoding: str = "spherical"
    expert: NGPConfig = dataclasses.field(default_factory=NGPConfig)
    bucketed: bool = False

    def __post_init__(self):
        if self.nerf_variant != "instant":
            raise NotImplementedError(
                f"nerf_variant={self.nerf_variant!r}: only 'instant' is "
                f"ported")
        if self.bg_encoding != "spherical":
            raise NotImplementedError("only the spherical bg encoding is "
                                      "ported")

    @property
    def bg_enc_dim(self) -> int:
        return sh_out_dim(4)


@dataclasses.dataclass(frozen=True)
class ContainerStatics:
    """Non-learnable geometry: centroids (K, 3), expert boxes (K, 2, 3),
    global box (2, 3)."""

    centroids: torch.Tensor
    expert_aabbs: torch.Tensor
    global_aabb: torch.Tensor

    def to(self, device) -> "ContainerStatics":
        return ContainerStatics(self.centroids.to(device),
                                self.expert_aabbs.to(device),
                                self.global_aabb.to(device))


def init_container_params(cfg: ContainerConfig, seed: int = 0,
                          device="cuda") -> Params:
    """{'experts': K stacked experts, 'bg': {...}} drawn from a seeded
    torch.Generator (on the CPU, so the draw is device-independent)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    params: Params = {"experts": init_ngp_params(
        cfg.expert, gen, device="cpu", num_experts=cfg.num_experts)}
    if cfg.use_bg_nerf:
        params["bg"] = {"l0": _linear_init(gen, cfg.bg_enc_dim, cfg.bg_hidden),
                        "l1": _linear_init(gen, cfg.bg_hidden, 3)}
    return tree_to(params, dev)


def _routing_dist(statics: ContainerStatics, cfg: ContainerConfig,
                  pts: torch.Tensor) -> torch.Tensor:
    """(N, K) centroid distances in the routing subspace (YZ if
    cluster_2d)."""
    sl = slice(1, 3) if cfg.cluster_2d else slice(0, 3)
    x = pts[:, sl].to(torch.float32)
    c = statics.centroids[:, sl].to(torch.float32)
    return torch.sqrt(torch.clamp(
        (x**2).sum(-1)[:, None] - torch.matmul(2.0 * x, c.T)
        + (c**2).sum(-1)[None, :], min=0.0))


def routing_weights(statics: ContainerStatics, cfg: ContainerConfig,
                    pts: torch.Tensor) -> torch.Tensor:
    """Dense per-point expert weights (N, K): inverse distance over the
    experts within margin * min-distance (soft), else one-hot argmin."""
    dist = _routing_dist(statics, cfg, pts)
    if cfg.boundary_margin > 1.0:
        dist = torch.clamp(dist, min=1e-6)
        invd = 1.0 / dist
        mind = dist.amin(dim=1, keepdim=True)
        mask = dist <= cfg.boundary_margin * mind
        invd = invd * mask
        denom = torch.clamp(invd.sum(dim=1, keepdim=True), min=1e-6)
        return (invd / denom).to(pts.dtype)
    hard = torch.argmin(dist, dim=1)
    return torch.nn.functional.one_hot(hard, cfg.num_experts).to(pts.dtype)


def _expert_params(params: Params, k: int) -> Params:
    return tree_map(lambda t: t[k], params["experts"])


def _eval_all_experts(params: Params, cfg: ContainerConfig,
                      statics: ContainerStatics, pts: torch.Tensor,
                      dirs: torch.Tensor, *, use_kernels: bool = True):
    """All K experts at once -> (rgb (K, N, 3), sigma (K, N))."""
    return ngp_apply(params["experts"], cfg.expert, statics.expert_aabbs,
                     pts, dirs, use_kernels=use_kernels)


def container_apply(params: Params, cfg: ContainerConfig,
                    statics: ContainerStatics, pts: torch.Tensor,
                    dirs: torch.Tensor, active_expert: Optional[int] = None,
                    *, use_kernels: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed field evaluation -> (rgb (N,3), sigma (N,)): soft weights
    blend both sigma and rgb before integration."""
    if active_expert is not None:
        return ngp_apply(_expert_params(params, active_expert), cfg.expert,
                         statics.expert_aabbs[active_expert], pts, dirs,
                         use_kernels=use_kernels)
    if cfg.bucketed:
        raise NotImplementedError("bucketed expert dispatch is not ported")
    rgb_k, sigma_k = _eval_all_experts(params, cfg, statics, pts, dirs,
                                       use_kernels=use_kernels)
    w = routing_weights(statics, cfg, pts)  # (N, K)
    sigma = (w.T * sigma_k).sum(dim=0)
    rgb = (w.T[..., None] * rgb_k).sum(dim=0)
    return rgb, sigma


def container_apply_multidir(params: Params, cfg: ContainerConfig,
                             statics: ContainerStatics, pts: torch.Tensor,
                             dirs_m: torch.Tensor, *,
                             use_kernels: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed field at N points under M shared view directions -> (rgb
    (M, N, 3), sigma (N,)). The encoder, sigma trunk, geometry head and
    routing weights run once for all K experts; only the color head sweeps
    the M directions (one direction at a time, as the reference maps
    them)."""
    if cfg.bucketed:
        raise NotImplementedError("bucketed expert dispatch is not ported")
    sigma_k, geo_k = ngp_density(params["experts"], cfg.expert,
                                 statics.expert_aabbs, pts,
                                 return_feats=True, use_kernels=use_kernels)
    w = routing_weights(statics, cfg, pts)  # (N, K)
    sigma = (w.T * sigma_k).sum(dim=0)
    rgb = torch.stack([
        torch.einsum("nk,knc->nc", w,
                     ngp_color(params["experts"], cfg.expert, d, geo_k))
        for d in dirs_m])
    return rgb, sigma


def background_color(params: Params, cfg: ContainerConfig,
                     d: torch.Tensor) -> torch.Tensor:
    """Learned background RGB from view direction."""
    if not cfg.use_bg_nerf or "bg" not in params:
        raise RuntimeError("background_color called but use_bg_nerf=False")
    lead = d.shape[:-1]
    dn = d.reshape(-1, 3)
    dn = dn / torch.clamp(torch.linalg.norm(dn, dim=-1, keepdim=True),
                          min=1e-9)
    enc = sh_encode(dn, 4)
    bg = params["bg"]
    h = torch.relu(torch.matmul(enc, bg["l0"]["w"]) + bg["l0"]["b"])
    rgb = torch.sigmoid(torch.matmul(h, bg["l1"]["w"]) + bg["l1"]["b"])
    return rgb.reshape(*lead, 3)


def container_field_fn(params: Params, cfg: ContainerConfig,
                       statics: ContainerStatics,
                       active_expert: Optional[int] = None, *,
                       use_kernels: bool = True):
    """Bind into a FieldFn for the renderers."""

    def field(pts, dirs):
        return container_apply(params, cfg, statics, pts, dirs,
                               active_expert, use_kernels=use_kernels)

    return field


def container_bg_fn(params: Params, cfg: ContainerConfig):
    """The learned background for renderers, or None if disabled."""
    if not cfg.use_bg_nerf or "bg" not in params:
        return None

    def bg(dirs):
        return background_color(params, cfg, dirs)

    return bg


def _expert_apply_fn(cfg: ContainerConfig):
    """(apply, density) of one expert: 'instant' is the only variant
    ported (ContainerConfig refuses the others)."""
    return ngp_apply, ngp_density


def param_group_labels(params: Params) -> Params:
    """Label every leaf with its optimizer group, in the params' nesting:
    'encoding' (the hash table or the plane/line tables), 'sigma' (density
    trunk and heads), 'color' (color MLP), 'background' (the bg MLP)."""

    def label(tree, name):
        return tree_map(lambda _: name, tree)

    labels: Params = {"experts": {
        k: label(v, "encoding" if k in ("hash_table", "planes_enc") else
                 "color" if k == "color_mlp" else "sigma")
        for k, v in params["experts"].items()}}
    if "bg" in params:
        labels["bg"] = label(params["bg"], "background")
    return labels
