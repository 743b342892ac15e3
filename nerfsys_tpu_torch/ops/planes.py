"""Factorized plane/line (TensoRF vector-matrix) position encoding, forward.

Port of nerfsys_tpu/ops/planes.py (`PlaneEncodingConfig` :46,
`plane_encoding_init` :128, `plane_encode` :621), forward only. For each
level R_l = base * growth^l and orientation (a, b | c) of _ORIENTATIONS, the
feature is the bilinear lerp of the (R^2, F) plane at (x_a, x_b)*(R-1) times
the linear lerp of the (R, F) line at x_c*(R-1), concatenated level-major
-> (..., 3 * L * F).

Tables may be one expert's, planes (3, R^2, F) with points (..., 3), or the
K experts' stacked on a leading axis, planes (K, 3, R^2, F) with points
(K, N, 3) (each expert encodes its own unit-cube coordinates).

Kernel 1 (`csrc/planes.cu`) computes this on the card;
`plane_encode_plain` is the same function in plain PyTorch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from nerfsys_tpu_torch import kernels
from nerfsys_tpu_torch.utils.device import resolve_device

# plane axes (a, b) and the complementary line axis c per orientation
_ORIENTATIONS = ((0, 1, 2), (0, 2, 1), (1, 2, 0))


@dataclasses.dataclass(frozen=True)
class PlaneEncodingConfig:
    """Static hyperparameters of the factorized plane/line encoder (the
    architecture keys of the reference config; its TPU execution knobs have
    no counterpart here)."""

    levels: int = 3
    base_res: int = 128
    growth: float = 2.0  # res_l = base_res * growth**l
    features: int = 8  # per orientation per level
    include_lines: bool = True
    init_scale: float = 0.1
    line_init: float = 1.0

    def level_resolutions(self) -> List[int]:
        return [max(2, int(round(self.base_res * self.growth**l)))
                for l in range(self.levels)]

    @property
    def out_dim(self) -> int:
        return 3 * self.levels * self.features


def plane_encoding_init(cfg: PlaneEncodingConfig, generator: torch.Generator,
                        device="cuda", num_experts: int = 0) -> Dict:
    """{'planes': [(3, R_l^2, F)...], 'lines': [(3, R_l, F)...]}; with
    num_experts > 0 every table gains a leading K axis. Values are drawn on
    the CPU from `generator`, then moved to `device`."""
    dev = resolve_device(device)
    lead = (num_experts,) if num_experts else ()
    F = cfg.features
    params: Dict = {"planes": [], "lines": []}
    for R in cfg.level_resolutions():
        params["planes"].append(
            (torch.randn(*lead, 3, R * R, F, generator=generator)
             * cfg.init_scale).to(dev))
        if cfg.include_lines:
            params["lines"].append(
                (torch.full((*lead, 3, R, F), cfg.line_init)
                 + torch.randn(*lead, 3, R, F, generator=generator)
                 * cfg.init_scale * 0.1).to(dev))
    if not cfg.include_lines:
        params.pop("lines")
    return params


def _as_stacked(params: Dict, x01: torch.Tensor):
    """(planes, lines, x (K, N, 3), stacked) with a K axis in every case."""
    planes = params["planes"]
    lines = params.get("lines")
    if planes[0].dim() == 4:
        if x01.dim() != 3 or x01.shape[0] != planes[0].shape[0]:
            raise ValueError(f"stacked tables need points (K, N, 3), got "
                             f"{tuple(x01.shape)}")
        return planes, lines, x01, True
    planes = [p[None] for p in planes]
    lines = None if lines is None else [t[None] for t in lines]
    return planes, lines, x01.reshape(1, -1, 3), False


def plane_encode_plain(params: Dict, x01: torch.Tensor,
                       cfg: PlaneEncodingConfig) -> torch.Tensor:
    """Plain PyTorch version of kernel 1 (same math, same float order)."""
    lead = x01.shape[:-1]
    planes, lines, x, stacked = _as_stacked(params, x01)
    x = torch.clamp(x.to(torch.float32), 0.0, 1.0)
    K = x.shape[0]
    kidx = torch.arange(K, device=x.device)[:, None]
    feats = []
    for l, R in enumerate(cfg.level_resolutions()):
        coords = x * (R - 1)
        hi = R - 1 - 1e-6
        for o, (a, b, c) in enumerate(_ORIENTATIONS):
            u, v = coords[..., a], coords[..., b]
            u0f = torch.floor(torch.clamp(u, 0.0, hi))
            v0f = torch.floor(torch.clamp(v, 0.0, hi))
            fu = (u - u0f)[..., None]
            fv = (v - v0f)[..., None]
            u0, v0 = u0f.long(), v0f.long()
            # neighbours clamped in bounds: at u0 = R-1 their weight is 0
            u1 = torch.clamp(u0 + 1, max=R - 1)
            v1 = torch.clamp(v0 + 1, max=R - 1)
            t = planes[l][:, o]  # (K, R*R, F)
            bv = (t[kidx, u0 * R + v0] * (1 - fu) * (1 - fv)
                  + t[kidx, u0 * R + v1] * (1 - fu) * fv
                  + t[kidx, u1 * R + v0] * fu * (1 - fv)
                  + t[kidx, u1 * R + v1] * fu * fv)
            if lines is not None:
                w = coords[..., c]
                w0f = torch.floor(torch.clamp(w, 0.0, hi))
                fw = (w - w0f)[..., None]
                w0 = w0f.long()
                w1 = torch.clamp(w0 + 1, max=R - 1)
                ln = lines[l][:, o]  # (K, R, F)
                bv = bv * (ln[kidx, w0] * (1 - fw) + ln[kidx, w1] * fw)
            feats.append(bv)
    out = torch.cat(feats, dim=-1)
    return out if stacked else out[0].reshape(*lead, cfg.out_dim)


def plane_encode_kernel(params: Dict, x01: torch.Tensor,
                        cfg: PlaneEncodingConfig) -> torch.Tensor:
    """Kernel 1's wrapper: the plain version for a CPU tensor; on a CUDA
    tensor it launches `plane_encode_fwd` or raises."""
    if x01.device.type == "cpu":
        return plane_encode_plain(params, x01, cfg)
    if x01.device.type != "cuda":
        raise ValueError(f"plane_encode: unsupported device {x01.device}")
    lead = x01.shape[:-1]
    planes, lines, x, stacked = _as_stacked(params, x01)
    res = cfg.level_resolutions()
    F = cfg.features
    if len(res) > kernels.PlaneLevels.MAX_LEVELS or len(planes) != len(res):
        raise ValueError("plane_encode: level count does not match tables")
    K, N = x.shape[0], x.shape[1]
    kernels.check_cuda_tensors("plane_encode", x01.device, x=x)
    lv = kernels.PlaneLevels()
    for l, R in enumerate(res):
        kernels.check_cuda_tensors("plane_encode", x01.device,
                                   plane=planes[l],
                                   line=None if lines is None else lines[l])
        if tuple(planes[l].shape) != (K, 3, R * R, F) or (
                lines is not None and tuple(lines[l].shape) != (K, 3, R, F)):
            raise ValueError(f"plane_encode: level {l} tables do not match "
                             f"R={R}, F={F}, K={K}")
        lv.planes[l] = planes[l].data_ptr()
        lv.lines[l] = 0 if lines is None else lines[l].data_ptr()
        lv.res[l] = R
        lv.clip_hi[l] = float(np.float32(R - 1 - 1e-6))
    lv.levels = len(res)
    lv.has_lines = int(lines is not None)
    out = torch.empty((K, N, cfg.out_dim), dtype=torch.float32,
                      device=x01.device)
    kernels.PLANES_FWD(x.data_ptr(), out.data_ptr(), lv, K, N, F,
                       kernels.stream_ptr(x))
    return out if stacked else out[0].reshape(*lead, cfg.out_dim)


def plane_encode(params: Dict, x01: torch.Tensor, cfg: PlaneEncodingConfig,
                 *, use_kernels: bool = True) -> torch.Tensor:
    """Encode points in [0,1]^3 -> (..., 3 * levels * features).

    use_kernels=False runs the plain version whatever the device (the card's
    own reference in comparisons); otherwise kernel 1's wrapper."""
    if use_kernels:
        return plane_encode_kernel(params, x01, cfg)
    return plane_encode_plain(params, x01, cfg)
