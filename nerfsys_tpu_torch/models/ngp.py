"""Instant-NGP-style radiance field expert.

Port of nerfsys_tpu/models/ngp.py (`NGPConfig` :54, `init_ngp_params`
:105, `world_to_unit` :148, `_mlp` :154, `encode_dir` :168, `ngp_density`
:175, `ngp_color` :206, `ngp_apply` :221) for both position encoders,
`xyz_encoding='hash'` (the reference's default: the multiresolution hash
grid, fp32 or packed bfloat16 pairs) and 'planes', with spherical-harmonics
directions.

    x (world) -> [0,1]^3 via the expert box -> hash grid or planes encoding
      -> sigma trunk: sigma_depth x [Linear(hidden) + ReLU]
      -> sigma head: Linear(1), trunc_exp; geo head: Linear(geo_feat_dim)
    [geo_feat, SH(d)] -> color_depth x [Linear + ReLU] -> Linear(3) -> sigmoid

Parameters are a plain dict of tensors with the reference's layout. They
may carry the K experts stacked on a leading axis (as the JAX pytree does);
then `aabb` is (K, 2, 3), shared points (N, 3) map to (K, N, 3) unit
coordinates and every output gains the leading K. The MLPs stay
`torch.matmul`, as the reference leaves them to XLA. With `use_bf16` (the
runner's --use_amp) they compute in bfloat16 as the reference's do
(:154-165, :192-212): input, weights and biases cast to bfloat16, the bias
added in bfloat16; the sigma and geo heads and the color MLP return
float32 before trunc_exp and the sigmoid. Params stay float32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from nerfsys_tpu_torch.ops.activations import trunc_exp
from nerfsys_tpu_torch.ops.encodings import (
    HashGridConfig,
    hash_encode,
    hash_grid_init,
    sh_encode,
    sh_out_dim,
)
from nerfsys_tpu_torch.ops.planes import (
    PlaneEncodingConfig,
    plane_encode,
    plane_encoding_init,
)
from nerfsys_tpu_torch.utils.device import resolve_device
from nerfsys_tpu_torch.utils.tree import tree_map

Params = Dict


@dataclasses.dataclass(frozen=True)
class NGPConfig:
    """Static architecture hyperparameters of one expert."""

    hidden: int = 64
    sigma_depth: int = 2
    color_hidden: int = 64
    color_depth: int = 3
    geo_feat_dim: int = 15
    use_sigmoid_rgb: bool = True
    dir_encoding: str = "spherical"
    sh_levels: int = 4
    xyz_encoding: str = "hash"  # 'hash' | 'planes'
    hash: HashGridConfig = dataclasses.field(default_factory=HashGridConfig)
    planes: PlaneEncodingConfig = dataclasses.field(
        default_factory=PlaneEncodingConfig)
    enc_eps: float = 1e-6
    # bfloat16 MLP compute (the reference's analogue of AMP autocast)
    use_bf16: bool = False

    def __post_init__(self):
        if self.xyz_encoding not in ("hash", "planes"):
            raise ValueError(f"xyz_encoding={self.xyz_encoding!r}: expected "
                             f"'hash' or 'planes'")
        if self.dir_encoding != "spherical":
            raise NotImplementedError(
                f"dir_encoding={self.dir_encoding!r}: only 'spherical' is "
                f"ported")

    @property
    def xyz_enc_dim(self) -> int:
        if self.xyz_encoding == "planes":
            return self.planes.out_dim
        return self.hash.out_dim

    @property
    def dir_enc_dim(self) -> int:
        return sh_out_dim(self.sh_levels)


def _linear_init(generator, in_dim: int, out_dim: int, lead=()):
    """torch.nn.Linear default init: U(-1/sqrt(in), 1/sqrt(in))."""
    bound = 1.0 / float(in_dim) ** 0.5
    w = (torch.rand(*lead, in_dim, out_dim, generator=generator) * 2 - 1)
    b = (torch.rand(*lead, out_dim, generator=generator) * 2 - 1)
    return {"w": w * bound, "b": b * bound}


def init_ngp_params(cfg: NGPConfig, generator: torch.Generator,
                    device="cuda", num_experts: int = 0) -> Params:
    """One expert's parameters, or K experts' stacked on a leading axis
    when num_experts > 0. Drawn on the CPU from `generator`, then moved."""
    dev = resolve_device(device)
    lead = (num_experts,) if num_experts else ()
    if cfg.xyz_encoding == "planes":
        params: Params = {"planes_enc": plane_encoding_init(
            cfg.planes, generator, device="cpu", num_experts=num_experts)}
    else:
        params = {"hash_table": hash_grid_init(
            cfg.hash, generator, device="cpu", num_experts=num_experts)}
    trunk, last = [], cfg.xyz_enc_dim
    for _ in range(max(cfg.sigma_depth, 0)):
        trunk.append(_linear_init(generator, last, cfg.hidden, lead))
        last = cfg.hidden
    params["sigma_trunk"] = trunk
    sigma_head = _linear_init(generator, last, 1, lead)
    sigma_head["b"] = torch.full_like(sigma_head["b"], -1.0)
    params["sigma_head"] = sigma_head
    params["geo_head"] = _linear_init(generator, last, cfg.geo_feat_dim, lead)
    color, last = [], cfg.geo_feat_dim + cfg.dir_enc_dim
    for _ in range(max(cfg.color_depth, 0)):
        color.append(_linear_init(generator, last, cfg.color_hidden, lead))
        last = cfg.color_hidden
    color.append(_linear_init(generator, last, 3, lead))
    params["color_mlp"] = color
    return tree_to(params, dev)


def tree_to(tree, device):
    """Move every tensor of a nested dict/list to `device`."""
    return tree_map(lambda t: t.to(device), tree)


def world_to_unit(x: torch.Tensor, aabb: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """World coords -> the expert's [eps, 1-eps]^3. With stacked boxes
    (K, 2, 3), shared points (N, 3) map to (K, N, 3), and per-expert points
    (K, C, 3) (the buckets of bucketed routing) each through their own
    expert's box."""
    if aabb.dim() == 3:
        lo, hi = aabb[:, None, 0, :], aabb[:, None, 1, :]
        x01 = ((x if x.dim() == 3 else x[None]) - lo) / (hi - lo)
    else:
        x01 = (x - aabb[0]) / (aabb[1] - aabb[0])
    return torch.clamp(x01, eps, 1.0 - eps)


def _linear(x: torch.Tensor, lyr, dtype=None) -> torch.Tensor:
    """x @ w + b; with `dtype`, w and b cast to it first."""
    w, b = lyr["w"], lyr["b"]
    if dtype is not None:
        w, b = w.to(dtype), b.to(dtype)
    return torch.matmul(x, w) + b.unsqueeze(-2)


def _mlp(x: torch.Tensor, layers, activate_last: bool = False, dtype=None):
    if dtype is not None:
        x = x.to(dtype)
    n = len(layers)
    for i, lyr in enumerate(layers):
        x = _linear(x, lyr, dtype)
        if activate_last or i < n - 1:
            x = torch.relu(x)
    return x


def encode_dir(d: torch.Tensor, cfg: NGPConfig) -> torch.Tensor:
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-9)
    return sh_encode(d, cfg.sh_levels)


def _flat_points(x: torch.Tensor, aabb: torch.Tensor):
    """Unstacked points of any leading shape -> (M, 3) plus the shape to
    restore; stacked boxes take (N, 3) as they are."""
    if aabb.dim() == 3:
        return x, None
    return x.reshape(-1, 3), x.shape[:-1]


def ngp_density(params: Params, cfg: NGPConfig, aabb: torch.Tensor,
                x: torch.Tensor, return_feats: bool = False, *,
                use_kernels: bool = True):
    """Density (and optionally geometry features). The encoder is the
    reference's three-way choice: planes; the packed hash encode when
    hash.packed with F == 2 and not Nearest; else the fp32 hash encode."""
    xf, lead = _flat_points(x, aabb)
    x01 = world_to_unit(xf, aabb, cfg.enc_eps)
    if cfg.xyz_encoding == "planes":
        h = plane_encode(params["planes_enc"], x01, cfg.planes,
                         use_kernels=use_kernels)
    else:
        hc = cfg.hash
        packed = (hc.packed and hc.features_per_level == 2
                  and hc.interpolation != "Nearest")
        h = hash_encode(params["hash_table"], x01, hc, packed=packed,
                        use_kernels=use_kernels)
    dt = torch.bfloat16 if cfg.use_bf16 else None
    h = _mlp(h, params["sigma_trunk"], activate_last=True, dtype=dt)
    # exp needs float32's range
    sigma_raw = _linear(h, params["sigma_head"], dt).float()
    sigma = trunc_exp(sigma_raw[..., 0])
    geo = None
    if return_feats:
        geo = _linear(h, params["geo_head"], dt).float()
    if lead is not None:
        sigma = sigma.reshape(lead)
        geo = None if geo is None else geo.reshape(*lead, -1)
    return (sigma, geo) if return_feats else sigma


def ngp_color(params: Params, cfg: NGPConfig, d: torch.Tensor,
              geo_feat: torch.Tensor) -> torch.Tensor:
    """View-dependent color from direction + geometry features; d may lack
    the leading K of stacked geo_feat (shared directions)."""
    d_enc = encode_dir(d, cfg)
    d_enc = d_enc.expand(*geo_feat.shape[:-1], d_enc.shape[-1])
    h = torch.cat([geo_feat, d_enc], dim=-1)
    rgb = _mlp(h, params["color_mlp"], activate_last=False,
               dtype=torch.bfloat16 if cfg.use_bf16 else None).float()
    if cfg.use_sigmoid_rgb:
        rgb = torch.sigmoid(rgb)
    return rgb


def ngp_apply(params: Params, cfg: NGPConfig, aabb: torch.Tensor,
              x: torch.Tensor, d: torch.Tensor, *,
              use_kernels: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full field evaluation -> (rgb (...,3), sigma (...,))."""
    sigma, geo = ngp_density(params, cfg, aabb, x, return_feats=True,
                             use_kernels=use_kernels)
    return ngp_color(params, cfg, d, geo), sigma
