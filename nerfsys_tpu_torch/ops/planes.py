"""Factorized plane/line (TensoRF vector-matrix) position encoding.

Port of nerfsys_tpu/ops/planes.py (`PlaneEncodingConfig` :46,
`plane_encoding_init` :128, `plane_encode` :621 with its two custom VJPs,
`_plane_encode_mm_light_bwd` :565 and `_plane_encode_mm_bwd` :449). For each
level R_l = base * growth^l and orientation (a, b | c) of _ORIENTATIONS, the
feature is the bilinear lerp of the (R^2, F) plane at (x_a, x_b)*(R-1) times
the linear lerp of the (R, F) line at x_c*(R-1), concatenated level-major
-> (..., 3 * L * F).

Tables may be one expert's, planes (3, R^2, F) with points (..., 3), or the
K experts' stacked on a leading axis, planes (K, 3, R^2, F) with points
(K, N, 3) (each expert encodes its own unit-cube coordinates).

Kernel 1 (`csrc/planes.cu`) computes this on the card;
`plane_encode_plain` is the same function in plain PyTorch. Gradients go
through `PlaneEncode`, whose backward is `csrc/planes_bwd.cu` (light mode
when `pos_grad=False`, exact otherwise) or `plane_encode_bwd_plain`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

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
    # False: the light backward (table gradients from bfloat16-rounded plane
    # and line values, zero position gradients); True: the exact backward
    pos_grad: bool = True

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
    tensor it launches `plane_encode_fwd` or raises. Not differentiable:
    it raises under grad mode with inputs that require grad."""
    kernels.check_no_grad("plane_encode", x01, *_tables(params))
    if x01.device.type == "cpu":
        return plane_encode_plain(params, x01, cfg)
    if x01.device.type != "cuda":
        raise ValueError(f"plane_encode: unsupported device {x01.device}")
    lead = x01.shape[:-1]
    planes, lines, x, stacked = _as_stacked(params, x01)
    K, N = x.shape[0], x.shape[1]
    kernels.check_cuda_tensors("plane_encode", x01.device, x=x)
    lv = _level_table(planes, lines, cfg, K, x01.device, "plane_encode")
    out = torch.empty((K, N, cfg.out_dim), dtype=torch.float32,
                      device=x01.device)
    kernels.PLANES_FWD(x.data_ptr(), out.data_ptr(), lv, K, N, cfg.features,
                       kernels.stream_ptr(x))
    return out if stacked else out[0].reshape(*lead, cfg.out_dim)


def _tables(params: Dict) -> List[torch.Tensor]:
    return list(params["planes"]) + list(params.get("lines") or [])


def _level_table(planes, lines, cfg: PlaneEncodingConfig, K: int, device,
                 name: str) -> "kernels.PlaneLevels":
    """Check the stacked (K, ...) tables and fill the kernels' per-level
    pointer struct."""
    res = cfg.level_resolutions()
    F = cfg.features
    if len(res) > kernels.PlaneLevels.MAX_LEVELS or len(planes) != len(res):
        raise ValueError(f"{name}: level count does not match tables")
    lv = kernels.PlaneLevels()
    for l, R in enumerate(res):
        kernels.check_cuda_tensors(name, device, plane=planes[l],
                                   line=None if lines is None else lines[l])
        if tuple(planes[l].shape) != (K, 3, R * R, F) or (
                lines is not None and tuple(lines[l].shape) != (K, 3, R, F)):
            raise ValueError(f"{name}: level {l} tables do not match "
                             f"R={R}, F={F}, K={K}")
        lv.planes[l] = planes[l].data_ptr()
        lv.lines[l] = 0 if lines is None else lines[l].data_ptr()
        lv.res[l] = R
        lv.clip_hi[l] = float(np.float32(R - 1 - 1e-6))
    lv.levels = len(res)
    lv.has_lines = int(lines is not None)
    return lv


GradTables = Tuple[List[torch.Tensor], Optional[List[torch.Tensor]],
                   torch.Tensor]


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 (nearest even) and back, as the reference's light
    residuals are stored."""
    return t.to(torch.bfloat16).to(torch.float32)


def plane_encode_bwd_plain(params: Dict, x01: torch.Tensor, ct: torch.Tensor,
                           cfg: PlaneEncodingConfig) -> GradTables:
    """Plain PyTorch version of kernels 5 and 6: the VJP of plane_encode for
    the cotangent `ct` (..., out_dim) -> (grad planes, grad lines or None,
    grad x01), each shaped like its input.

    pos_grad=False (light): table gradients from the plane and line values
    rounded to bfloat16, grad x01 = 0. pos_grad=True (exact): float32 table
    gradients and the position gradient, masked by 0 <= x <= 1 (inclusive).
    The table gradient is a scatter-add (`index_add_`) of the 4 corner and 2
    node contributions per point."""
    planes, lines, x_raw, stacked = _as_stacked(params, x01)
    K, N = x_raw.shape[0], x_raw.shape[1]
    F = cfg.features
    ct = ct.reshape(K, N, cfg.out_dim).to(torch.float32)
    x = torch.clamp(x_raw.to(torch.float32), 0.0, 1.0)
    kidx = torch.arange(K, device=x.device)[:, None]
    gx = torch.zeros_like(x)
    g_planes, g_lines = [], []
    for l, R in enumerate(cfg.level_resolutions()):
        coords = x * (R - 1)
        hi = R - 1 - 1e-6
        gpl = torch.zeros((K * 3 * R * R, F), dtype=torch.float32,
                          device=x.device)
        gln = torch.zeros((K * 3 * R, F), dtype=torch.float32,
                          device=x.device)
        for o, (a, b, c) in enumerate(_ORIENTATIONS):
            u, v = coords[..., a], coords[..., b]
            u0f = torch.floor(torch.clamp(u, 0.0, hi))
            v0f = torch.floor(torch.clamp(v, 0.0, hi))
            fu = (u - u0f)[..., None]
            fv = (v - v0f)[..., None]
            au, av = 1 - fu, 1 - fv
            u0, v0 = u0f.long(), v0f.long()
            u1 = torch.clamp(u0 + 1, max=R - 1)
            v1 = torch.clamp(v0 + 1, max=R - 1)
            t = planes[l][:, o]  # (K, R*R, F)
            rows = (u0 * R + v0, u0 * R + v1, u1 * R + v0, u1 * R + v1)
            t00, t01, t10, t11 = (t[kidx, r] for r in rows)
            bv = t00 * au * av + t01 * au * fv + t10 * fu * av + t11 * fu * fv
            g = ct[..., (l * 3 + o) * F:(l * 3 + o + 1) * F]
            lval = None
            if lines is not None:
                w = coords[..., c]
                w0f = torch.floor(torch.clamp(w, 0.0, hi))
                fw = (w - w0f)[..., None]
                w0 = w0f.long()
                w1 = torch.clamp(w0 + 1, max=R - 1)
                ln = lines[l][:, o]  # (K, R, F)
                l0, l1 = ln[kidx, w0], ln[kidx, w1]
                lval = l0 * (1 - fw) + l1 * fw
                if cfg.pos_grad:
                    gp, gl = g * lval, g * bv
                else:
                    gp, gl = g * _bf16(lval), g * _bf16(bv)
                lbase = (kidx * 3 + o) * R
                gln.index_add_(0, (lbase + w0).reshape(-1),
                               ((1 - fw) * gl).reshape(-1, F))
                gln.index_add_(0, (lbase + w1).reshape(-1),
                               (fw * gl).reshape(-1, F))
            else:
                gp = g
            pbase = (kidx * 3 + o) * (R * R)
            for r, wgt in zip(rows, (au * (av * gp), au * (fv * gp),
                                     fu * (av * gp), fu * (fv * gp))):
                gpl.index_add_(0, (pbase + r).reshape(-1), wgt.reshape(-1, F))
            if cfg.pos_grad:
                lw = lval if lval is not None else 1.0
                db_dfu = (t10 - t00) * av + (t11 - t01) * fv
                db_dfv = (t01 - t00) * au + (t11 - t10) * fu
                gx[..., a] += (g * lw * db_dfu).sum(-1) * (R - 1)
                gx[..., b] += (g * lw * db_dfv).sum(-1) * (R - 1)
                if lval is not None:
                    gx[..., c] += (g * bv * (l1 - l0)).sum(-1) * (R - 1)
        g_planes.append(gpl.reshape(K, 3, R * R, F))
        g_lines.append(gln.reshape(K, 3, R, F))
    if cfg.pos_grad:
        gx = torch.where((x_raw >= 0.0) & (x_raw <= 1.0), gx,
                         torch.zeros((), dtype=gx.dtype, device=gx.device))
    return _unstack_grads(g_planes, g_lines if lines is not None else None,
                          gx, x01, stacked)


def _unstack_grads(g_planes, g_lines, gx, x01, stacked: bool) -> GradTables:
    if not stacked:
        g_planes = [t[0] for t in g_planes]
        g_lines = None if g_lines is None else [t[0] for t in g_lines]
    return g_planes, g_lines, gx.reshape(x01.shape)


def plane_encode_bwd_kernel(params: Dict, x01: torch.Tensor, ct: torch.Tensor,
                            cfg: PlaneEncodingConfig) -> GradTables:
    """Kernels 5/6's wrapper: the plain version for a CPU tensor; on a CUDA
    tensor it launches `plane_encode_bwd_light` (pos_grad=False) or
    `plane_encode_bwd` (pos_grad=True) or raises."""
    kernels.check_no_grad("plane_encode_bwd", x01, ct, *_tables(params))
    if x01.device.type == "cpu":
        return plane_encode_bwd_plain(params, x01, ct, cfg)
    if x01.device.type != "cuda":
        raise ValueError(f"plane_encode_bwd: unsupported device {x01.device}")
    planes, lines, x, stacked = _as_stacked(params, x01)
    K, N = x.shape[0], x.shape[1]
    ct = ct.reshape(K, N, cfg.out_dim)
    dev = x01.device
    kernels.check_cuda_tensors("plane_encode_bwd", dev, x=x, ct=ct)
    lv = _level_table(planes, lines, cfg, K, dev, "plane_encode_bwd")
    gr = kernels.PlaneGrads()
    g_planes = [torch.zeros_like(p) for p in planes]
    g_lines = None if lines is None else [torch.zeros_like(t) for t in lines]
    for l in range(len(g_planes)):
        gr.planes[l] = g_planes[l].data_ptr()
        gr.lines[l] = 0 if g_lines is None else g_lines[l].data_ptr()
    stream = kernels.stream_ptr(x)
    gx = torch.zeros_like(x)  # stays zero in light mode
    if cfg.pos_grad:
        kernels.PLANES_BWD(x.data_ptr(), ct.data_ptr(), lv, gr, gx.data_ptr(),
                           K, N, cfg.features, stream)
    else:
        kernels.PLANES_BWD_LIGHT(x.data_ptr(), ct.data_ptr(), lv, gr, K, N,
                                 cfg.features, stream)
    return _unstack_grads(g_planes, g_lines, gx, x01, stacked)


class PlaneEncode(torch.autograd.Function):
    """plane_encode with its reference VJP: forward kernel 1 (or the plain
    forward), backward kernels 5/6 (or `plane_encode_bwd_plain`). Inputs
    after the two static ones: x01, then the level tables, planes first,
    then lines; each gradient has its input's shape."""

    @staticmethod
    def forward(ctx, cfg, use_kernels, x01, *tables):
        params = _params_of(tables, cfg)
        fwd = plane_encode_kernel if use_kernels else plane_encode_plain
        out = fwd(params, x01, cfg)
        ctx.cfg, ctx.use_kernels = cfg, use_kernels
        ctx.save_for_backward(x01, *tables)
        return out

    @staticmethod
    def backward(ctx, ct):
        x01, *tables = ctx.saved_tensors
        params = _params_of(tables, ctx.cfg)
        bwd = (plane_encode_bwd_kernel if ctx.use_kernels
               else plane_encode_bwd_plain)
        g_planes, g_lines, gx = bwd(params, x01, ct.contiguous(), ctx.cfg)
        return (None, None, gx if ctx.needs_input_grad[2] else None,
                *g_planes, *(g_lines or ()))


def _params_of(tables, cfg: PlaneEncodingConfig) -> Dict:
    L = cfg.levels
    params: Dict = {"planes": list(tables[:L])}
    if len(tables) > L:
        params["lines"] = list(tables[L:])
    return params


def plane_encode(params: Dict, x01: torch.Tensor, cfg: PlaneEncodingConfig,
                 *, use_kernels: bool = True) -> torch.Tensor:
    """Encode points in [0,1]^3 -> (..., 3 * levels * features),
    differentiable in the tables (and in x01 when pos_grad).

    use_kernels=False runs the plain forward and backward whatever the
    device (the card's own reference in comparisons); otherwise the kernel
    wrappers, which run the plain versions for CPU tensors."""
    return PlaneEncode.apply(cfg, use_kernels, x01, *_tables(params))
