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
`plane_encode_plain` is the same function in plain PyTorch. Under the
reference's bfloat16 line matmuls (`lines_matmul` with
`lines_mm_dtype='bfloat16'`, `_linear_rows_mm` :224) the line lerp takes
bfloat16 weights and rows: kernel 1b, the same source's other
instantiation. Gradients go through `PlaneEncode`, whose backward is
`csrc/planes_bwd.cu` (light mode when `pos_grad=False`, kernel 5b under
bfloat16 line matmuls; exact otherwise) or `plane_encode_bwd_plain`.
Kernels 1, 5 and 6 take their launch geometry from `plane_fwd_plan` and
`plane_bwd_plan`, plain functions of the shapes. Under create_graph (the
MAML inner gradient) the backward is `PlaneEncodeBwd`, whose own backward
is kernel 5'' or 6'' (`csrc/planes_bwd2.cu`, the table gradients'
VJP; its plan `plane_bwd_plan(..., second=True)`, cached per shape) or
`plane_encode_bwd2_plain`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from nerfsys_tpu_torch import kernels
from nerfsys_tpu_torch.utils.device import (
    SMEM_BLOCK_BYTES,
    SMEM_SM_BYTES,
    aligned,
    num_sms,
    resolve_device,
)

# plane axes (a, b) and the complementary line axis c per orientation
_ORIENTATIONS = ((0, 1, 2), (0, 2, 1), (1, 2, 0))


@dataclasses.dataclass(frozen=True)
class PlaneEncodingConfig:
    """Static hyperparameters of the factorized plane/line encoder: the
    architecture keys of the reference config and its line matmuls; its
    other TPU execution knobs have no counterpart here."""

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
    # The reference's line lookups as hat-stencil matmuls. In float32 they
    # compute the gathers' function (kernel 1); in bfloat16 the two line
    # weights and the two line rows are rounded to bfloat16 and their exact
    # products summed in float32 (kernels 1b and 5b)
    lines_matmul: bool = False
    lines_mm_dtype: str = "float32"  # 'float32' | 'bfloat16'

    def __post_init__(self):
        if self.lines_mm_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"lines_mm_dtype={self.lines_mm_dtype!r}: "
                             f"expected 'float32' or 'bfloat16'")

    @property
    def lines_bf16(self) -> bool:
        """True when the line lookups round to bfloat16 (the reference reads
        lines_mm_dtype only under lines_matmul)."""
        return (self.lines_matmul and self.include_lines
                and self.lines_mm_dtype == "bfloat16")

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


def _line_value(ln: torch.Tensor, kidx, w0, w1, fw: torch.Tensor,
                lines_bf16: bool) -> torch.Tensor:
    """The line lerp l0 (1 - fw) + l1 fw; with lines_bf16 the reference's
    bfloat16 hat-stencil matmul: both weights and both rows rounded to
    bfloat16, their products exact in float32, one rounding in the sum."""
    l0, l1 = ln[kidx, w0], ln[kidx, w1]
    if lines_bf16:
        return _bf16(1 - fw) * _bf16(l0) + _bf16(fw) * _bf16(l1)
    return l0 * (1 - fw) + l1 * fw


def plane_encode_plain(params: Dict, x01: torch.Tensor,
                       cfg: PlaneEncodingConfig) -> torch.Tensor:
    """Plain PyTorch version of kernels 1 and 1b (same math, same float
    order)."""
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
                bv = bv * _line_value(lines[l][:, o], kidx, w0, w1, fw,
                                      cfg.lines_bf16)
            feats.append(bv)
    out = torch.cat(feats, dim=-1)
    return out if stacked else out[0].reshape(*lead, cfg.out_dim)


TILE, FWD_THREADS = 128, 384  # kernel 1's points per tile (4 rays of 32
# samples) and threads: 12 warps take a tile's 36 (level x orientation,
# 32-point) tasks at bench width in 3 rounds
BWD_TILE, BWD_THREADS = 64, 256  # kernels 5 and 6: 2 rays, 8 warps
# Kernels 5'' and 6'': the same tiles; at bench width (2 lanes a point) a
# tile is 36 (level x orientation, 16-point) tasks, which 9 warps take in 4
# whole rounds. No private line level: measured slower on an H100 even for
# the coarsest (PERF.md section 6).
BWD2_TILE_THREADS = 288
# Kernels 5 and 6's shared memory for private line gradients, by default. Float
# adds to shared memory are compare-and-swap loops on Hopper, so a private
# level pays only where many adds meet few rows: the coarsest level at
# bench width (12,288 bytes). Privatising all three levels (86,016 bytes)
# also leaves room for one block an SM, not two.
LINE_BUDGET = 16_384


@dataclasses.dataclass(frozen=True)
class PlaneLaunchPlan:
    """Launch geometry of kernel 1, 5 or 6 (csrc/planes.cu `PlanePlan`)."""

    tile: int  # consecutive points of one expert per tile (multiple of 32)
    threads: int  # per block (multiple of 32)
    blocks: int  # per expert: one per tile (kernel 1), persistent (5, 6)
    smem: int  # dynamic shared-memory bytes per block
    vec: bool  # 16-byte row access; False: the scalar variant
    # kernels 5 and 6, per level: float offset of its private line
    # gradients in shared memory, or -1 for the warp-aggregated global path
    line_ofs: Tuple[int, ...] = ()
    sms: int = 0  # kernels 5 and 6: the card's SMs, the persistent cap
    exact: bool = False  # kernel 6 (or 6''): the exact backward
    # kernels 5'' and 6'': smem holds the staged d ct and no position
    # partials (positions get no second derivative)
    second: bool = False

    @property
    def private_levels(self) -> List[int]:
        return [l for l, o in enumerate(self.line_ofs) if o >= 0]

    def as_struct(self) -> "kernels.PlanePlan":
        s = kernels.PlanePlan()
        s.tile, s.threads, s.blocks, s.smem = (self.tile, self.threads,
                                               self.blocks, self.smem)
        s.vec = int(self.vec)
        for l in range(kernels.PlaneLevels.MAX_LEVELS):
            s.line_ofs[l] = (self.line_ofs[l] if l < len(self.line_ofs)
                             else -1)
        s.sms = self.sms
        return s


def _check_shapes(res: Sequence[int], features: int) -> None:
    if not 0 < len(res) <= kernels.PlaneLevels.MAX_LEVELS:
        raise ValueError(f"plane kernels take 1 to "
                         f"{kernels.PlaneLevels.MAX_LEVELS} levels, got "
                         f"{len(res)}")
    if max(res) ** 2 * features >= 2**31:  # in-tile offsets are 32-bit
        raise ValueError(f"plane table too large for the kernels: R={max(res)}"
                         f", F={features}")


def plane_fwd_plan(n: int, res: Sequence[int], features: int,
                   vec_ok: bool = True) -> PlaneLaunchPlan:
    """Kernel 1's plan for N points per expert: one block per tile of
    TILE points (halved while the tile's points and (tile, 3*L*F) output
    exceed a block's shared memory); the 16-byte variant when F % 4 == 0
    and `vec_ok` (the tables are 16-byte aligned)."""
    _check_shapes(res, features)
    d = 3 * len(res) * features
    tile = TILE
    while tile > 32 and 4 * tile * (3 + d) > SMEM_BLOCK_BYTES:
        tile //= 2
    smem = 4 * tile * (3 + d)
    if smem > SMEM_BLOCK_BYTES:
        raise ValueError(f"plane_encode: a 32-point tile of {d} features "
                         f"exceeds {SMEM_BLOCK_BYTES} bytes of shared memory")
    return PlaneLaunchPlan(tile=tile, threads=FWD_THREADS,
                           blocks=max(1, -(-n // tile)), smem=smem,
                           vec=vec_ok and features % 4 == 0)


def plane_bwd_plan(n: int, k: int, res: Sequence[int], features: int,
                   has_lines: bool, num_sms: int, vec_ok: bool = True,
                   line_budget: Optional[int] = LINE_BUDGET,
                   exact: bool = False,
                   second: bool = False) -> PlaneLaunchPlan:
    """Kernel 5's plan (exact=False) or kernel 6's (exact=True) for K
    experts of N points each; with second=True, kernel 5''s or 6''s (the
    table gradients' VJP).

    Shared memory holds two (tile, 3*L*F) cotangent buffers and two
    (tile, 3) point buffers, in exact mode the (tile, 3*L, 3) position
    partials, and for kernels 5'' / 6'' the (tile, 3*L*F) staged d ct in
    their place (BWD_TILE points, halved while these exceed half a block's
    shared memory), then, for kernels 5 and 6, the private line
    gradients: levels are taken from the coarsest up while their 3*R*F
    floats fit in `line_budget` bytes (None: all that is left of the
    block's 227 KB); the others take the global path, as every level of
    5'' / 6'' does. Threads: BWD_THREADS, or BWD2_TILE_THREADS when
    second. Blocks per expert: as many as can be resident on `num_sms` SMs
    by shared memory and threads, at most one per tile (the entry point
    lowers it to what the occupancy calculator, registers included,
    allows)."""
    _check_shapes(res, features)
    d = 3 * len(res) * features
    threads = BWD2_TILE_THREADS if second else BWD_THREADS

    def buffers(tile):
        if second:
            return 8 * tile * (d + 3) + 4 * tile * d
        return 8 * tile * (d + 3) + (4 * tile * 9 * len(res) if exact else 0)

    tile = BWD_TILE
    while tile > 32 and buffers(tile) > SMEM_BLOCK_BYTES // 2:
        tile //= 2
    if buffers(tile) > SMEM_BLOCK_BYTES:
        raise ValueError(f"plane_encode_bwd: a 32-point tile of {d} features "
                         f"exceeds {SMEM_BLOCK_BYTES} bytes of shared memory")
    room = SMEM_BLOCK_BYTES - buffers(tile)
    if line_budget is not None:
        room = min(room, line_budget)
    line_ofs = [-1] * len(res)
    used = 0  # floats
    if has_lines and not second:
        for l in sorted(range(len(res)), key=lambda l: res[l]):
            size = 3 * res[l] * features
            if 4 * (used + size) <= room:
                line_ofs[l] = used
                used += size
    smem = buffers(tile) + 4 * used
    per_sm = max(1, min(SMEM_SM_BYTES // (smem + 1024), 2048 // threads))
    blocks = max(1, min(-(-n // tile), num_sms * per_sm // max(k, 1)))
    return PlaneLaunchPlan(tile=tile, threads=threads, blocks=blocks,
                           smem=smem, vec=vec_ok and features % 4 == 0,
                           line_ofs=tuple(line_ofs), sms=num_sms,
                           exact=exact, second=second)


@functools.lru_cache(maxsize=64)
def _bwd2_launch(n: int, k: int, res: Tuple[int, ...], features: int,
                 has_lines: bool, sms: int, vec: bool, exact: bool):
    """Kernel 5''s or 6''s default plan and its struct, per shape: a MAML
    step launches it 96 times and is host-bound."""
    plan = plane_bwd_plan(n, k, res, features, has_lines, sms, vec_ok=vec,
                          exact=exact, second=True)
    return plan, plan.as_struct()


def plane_encode_kernel(params: Dict, x01: torch.Tensor,
                        cfg: PlaneEncodingConfig) -> torch.Tensor:
    """Kernel 1's wrapper: the plain version for a CPU tensor; on a CUDA
    tensor it launches `plane_encode_fwd` (kernel 1b,
    `plane_encode_fwd_lines_bf16`, under bfloat16 line matmuls) or raises.
    Not differentiable: it raises under grad mode with inputs that require
    grad."""
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
    plan = plane_fwd_plan(N, cfg.level_resolutions(), cfg.features,
                          vec_ok=aligned(*planes, *(lines or ())))
    kern = (kernels.PLANES_FWD_LINES_BF16 if cfg.lines_bf16
            else kernels.PLANES_FWD)
    kern(x.data_ptr(), out.data_ptr(), lv, K, N, cfg.features,
         plan.as_struct(), kernels.stream_ptr(x))
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
    """Plain PyTorch version of kernels 5, 5b and 6: the VJP of plane_encode
    for the cotangent `ct` (..., out_dim) -> (grad planes, grad lines or
    None, grad x01), each shaped like its input.

    pos_grad=False (light): table gradients from the plane and line values
    rounded to bfloat16 (the line values as the forward formed them, so
    under bfloat16 line matmuls from bfloat16 operands: kernel 5b), grad
    x01 = 0. pos_grad=True (exact; line values regathered in float32
    whatever the forward's dtype, as the reference does): float32 table
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
                if cfg.pos_grad:  # the exact VJP regathers float32 lines
                    lval = l0 * (1 - fw) + l1 * fw
                    gp, gl = g * lval, g * bv
                else:  # the forward's line values, as residuals
                    lval = _line_value(ln, kidx, w0, w1, fw, cfg.lines_bf16)
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
    tensor it launches `plane_encode_bwd_light` (pos_grad=False; kernel 5b,
    `plane_encode_bwd_light_lines_bf16`, under bfloat16 line matmuls) or
    `plane_encode_bwd` (pos_grad=True, either line dtype) with
    `plane_bwd_plan`'s plan, or raises."""
    kernels.check_no_grad("plane_encode_bwd", x01, ct, *_tables(params))
    if x01.device.type == "cpu":
        return plane_encode_bwd_plain(params, x01, ct, cfg)
    return plane_encode_bwd_planned(params, x01, ct, cfg, plan=None)


def plane_encode_bwd_planned(params: Dict, x01: torch.Tensor,
                             ct: torch.Tensor, cfg: PlaneEncodingConfig,
                             plan: Optional[PlaneLaunchPlan]) -> GradTables:
    """The CUDA half of `plane_encode_bwd_kernel`; `plan` (None:
    `plane_bwd_plan`'s for cfg.pos_grad) sets the launch, so a caller can
    run either line-gradient variant at any shape."""
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
    vec_ok = aligned(ct, *planes, *(lines or ()), *g_planes, *(g_lines or ()))
    if plan is None:
        plan = plane_bwd_plan(N, K, cfg.level_resolutions(), cfg.features,
                              lines is not None, num_sms(dev), vec_ok=vec_ok,
                              exact=cfg.pos_grad)
    elif plan.vec and not vec_ok:
        raise ValueError("plane_encode_bwd: a 16-byte plan needs 16-byte "
                         "aligned tables and cotangent")
    if plan.exact != cfg.pos_grad:
        raise ValueError(f"plane_encode_bwd: an exact={plan.exact} plan for "
                         f"pos_grad={cfg.pos_grad}")
    stream = kernels.stream_ptr(x)
    if cfg.pos_grad:  # kernel 6 writes every point's gx once
        gx = torch.empty_like(x)
        kernels.PLANES_BWD(x.data_ptr(), ct.data_ptr(), lv, gr, gx.data_ptr(),
                           K, N, cfg.features, plan.as_struct(), stream)
    else:
        gx = torch.zeros_like(x)
        kern = (kernels.PLANES_BWD_LIGHT_LINES_BF16 if cfg.lines_bf16
                else kernels.PLANES_BWD_LIGHT)
        kern(x.data_ptr(), ct.data_ptr(), lv, gr, K, N, cfg.features,
             plan.as_struct(), stream)
    return _unstack_grads(g_planes, g_lines, gx, x01, stacked)


def plane_encode_bwd2_plain(params: Dict, x01: torch.Tensor, ct: torch.Tensor,
                            v_params: Dict, cfg: PlaneEncodingConfig,
                            sum_dtype: torch.dtype = torch.float32):
    """Plain PyTorch version of kernels 5'' (pos_grad=False) and 6''
    (pos_grad=True): the VJP of `plane_encode_bwd_plain`'s table gradients
    for their cotangents `v_params` ({'planes': [...], 'lines': [...]},
    shaped like the tables) -> (d ct shaped like ct, d planes, d lines or
    None). Positions get none.

    With lines, per point and (level, orientation) block, R the bf16
    rounding of the light mode (the identity in exact mode):
    d ct = bval(vP) R(lval(L)) + lval(vL) R(bval(P)); the plane corners
    take R(ct lval(vL)), the line nodes R(ct bval(vP)), scattered with the
    interpolation weights (`index_add_`). Without lines d ct = bval(vP),
    d P = 0. Kernel 1's arithmetic, in its order, for every value.
    `sum_dtype`: the dtype the table gradients are summed and returned in
    (float64: the exact sums of the same float32 shares)."""
    planes, lines, x_raw, stacked = _as_stacked(params, x01)
    vplanes, vlines, _, _ = _as_stacked(v_params, x01)
    K, N = x_raw.shape[0], x_raw.shape[1]
    F = cfg.features
    rnd = (lambda t: t) if cfg.pos_grad else _bf16
    ct = ct.reshape(K, N, cfg.out_dim).to(torch.float32)
    x = torch.clamp(x_raw.to(torch.float32), 0.0, 1.0)
    kidx = torch.arange(K, device=x.device)[:, None]
    d_ct = torch.empty_like(ct)
    d_planes, d_lines = [], []
    for l, R in enumerate(cfg.level_resolutions()):
        coords = x * (R - 1)
        hi = R - 1 - 1e-6
        dpl = torch.zeros((K * 3 * R * R, F), dtype=sum_dtype,
                          device=x.device)
        dln = torch.zeros((K * 3 * R, F), dtype=sum_dtype, device=x.device)
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
            rows = (u0 * R + v0, u0 * R + v1, u1 * R + v0, u1 * R + v1)

            def bilerp(t):
                t00, t01, t10, t11 = (t[kidx, r] for r in rows)
                return (t00 * au * av + t01 * au * fv + t10 * fu * av
                        + t11 * fu * fv)

            blk = slice((l * 3 + o) * F, (l * 3 + o + 1) * F)
            bv_v = bilerp(vplanes[l][:, o])
            if lines is None:
                d_ct[..., blk] = bv_v
                continue
            bv = bilerp(planes[l][:, o])
            w = coords[..., c]
            w0f = torch.floor(torch.clamp(w, 0.0, hi))
            fw = (w - w0f)[..., None]
            w0 = w0f.long()
            w1 = torch.clamp(w0 + 1, max=R - 1)
            ln, vln = lines[l][:, o], vlines[l][:, o]
            lval = ln[kidx, w0] * (1 - fw) + ln[kidx, w1] * fw
            lval_v = vln[kidx, w0] * (1 - fw) + vln[kidx, w1] * fw
            d_ct[..., blk] = bv_v * rnd(lval) + lval_v * rnd(bv)
            g = ct[..., blk]
            sp, sl = rnd(g * lval_v), rnd(g * bv_v)
            lbase = (kidx * 3 + o) * R
            dln.index_add_(0, (lbase + w0).reshape(-1),
                           ((1 - fw) * sl).reshape(-1, F).to(sum_dtype))
            dln.index_add_(0, (lbase + w1).reshape(-1),
                           (fw * sl).reshape(-1, F).to(sum_dtype))
            pbase = (kidx * 3 + o) * (R * R)
            for r, wgt in zip(rows, (au * (av * sp), au * (fv * sp),
                                     fu * (av * sp), fu * (fv * sp))):
                dpl.index_add_(0, (pbase + r).reshape(-1),
                               wgt.reshape(-1, F).to(sum_dtype))
        d_planes.append(dpl.reshape(K, 3, R * R, F))
        d_lines.append(dln.reshape(K, 3, R, F))
    if not stacked:
        d_planes = [t[0] for t in d_planes]
        d_lines = [t[0] for t in d_lines]
    return (d_ct.reshape(*x01.shape[:-1], cfg.out_dim), d_planes,
            d_lines if lines is not None else None)


def plane_encode_bwd2_kernel(params: Dict, x01: torch.Tensor,
                             ct: torch.Tensor, v_params: Dict,
                             cfg: PlaneEncodingConfig):
    """Kernels 5'' / 6'' wrapper: the plain version for a CPU tensor; on a
    CUDA tensor it launches `plane_encode_bwd2_light` (pos_grad=False:
    bf16 rounding) or `plane_encode_bwd2` (pos_grad=True) with
    `plane_bwd_plan(..., second=True)`'s plan, cached per shape, or
    raises. Returns what `plane_encode_bwd2_plain` returns."""
    kernels.check_no_grad("plane_encode_bwd2", x01, ct, *_tables(params),
                          *_tables(v_params))
    if x01.device.type == "cpu":
        return plane_encode_bwd2_plain(params, x01, ct, v_params, cfg)
    if x01.device.type != "cuda":
        raise ValueError(f"plane_encode_bwd2: unsupported device "
                         f"{x01.device}")
    planes, lines, x, stacked = _as_stacked(params, x01)
    vplanes, vlines, _, _ = _as_stacked(v_params, x01)
    if (lines is None) != (vlines is None):
        raise ValueError("plane_encode_bwd2: the cotangents must match the "
                         "tables (lines or none)")
    K, N = x.shape[0], x.shape[1]
    ct = ct.reshape(K, N, cfg.out_dim).contiguous()
    dev = x01.device
    kernels.check_cuda_tensors("plane_encode_bwd2", dev, x=x, ct=ct)
    lv = _level_table(planes, lines, cfg, K, dev, "plane_encode_bwd2")
    vv = _level_table(vplanes, vlines, cfg, K, dev, "plane_encode_bwd2")
    gr = kernels.PlaneGrads()
    d_planes = [torch.zeros_like(p) for p in planes]
    d_lines = None if lines is None else [torch.zeros_like(t) for t in lines]
    for l in range(len(d_planes)):
        gr.planes[l] = d_planes[l].data_ptr()
        gr.lines[l] = 0 if d_lines is None else d_lines[l].data_ptr()
    d_ct = torch.empty_like(ct)
    vec = cfg.features % 4 == 0 and aligned(
        ct, d_ct, *planes, *(lines or ()), *vplanes, *(vlines or ()),
        *d_planes, *(d_lines or ()))
    _, struct = _bwd2_launch(N, K, tuple(cfg.level_resolutions()),
                             cfg.features, lines is not None, num_sms(dev),
                             vec, cfg.pos_grad)
    kern = kernels.PLANES_BWD2 if cfg.pos_grad else kernels.PLANES_BWD2_LIGHT
    kern(x.data_ptr(), ct.data_ptr(), lv, vv, gr, d_ct.data_ptr(), K, N,
         cfg.features, struct, kernels.stream_ptr(x))
    if not stacked:
        d_planes = [t[0] for t in d_planes]
        d_lines = None if d_lines is None else [t[0] for t in d_lines]
    return d_ct.reshape(*x01.shape[:-1], cfg.out_dim), d_planes, d_lines


class PlaneEncodeBwd(torch.autograd.Function):
    """The table gradients of `PlaneEncode` as a differentiable function of
    the cotangent ct and the tables: forward kernel 5 or 6 (or
    `plane_encode_bwd_plain`), backward kernel 5'' or 6'' (or
    `plane_encode_bwd2_plain`). Inputs after the two static ones: x01, ct,
    then the tables, planes first; outputs: the table gradients in that
    order. `PlaneEncode.backward` calls it under create_graph (MAML's inner
    gradient); x01 gets no derivative and a third one raises."""

    @staticmethod
    def forward(ctx, cfg, use_kernels, x01, ct, *tables):
        if cfg.lines_bf16:
            raise NotImplementedError(
                "plane_encode: the second derivative under bfloat16 line "
                "matmuls (kernel 5''b) is not ported (ROADMAP Queue 2 item "
                "1, with MAML under these options, Queue 1 item 3)")
        ctx.set_materialize_grads(False)
        params = _params_of(tables, cfg)
        bwd = (plane_encode_bwd_kernel if use_kernels
               else plane_encode_bwd_plain)
        g_planes, g_lines, _ = bwd(params, x01, ct, cfg)
        ctx.cfg, ctx.use_kernels = cfg, use_kernels
        ctx.save_for_backward(x01, ct, *tables)
        return (*g_planes, *(g_lines or ()))

    @staticmethod
    @once_differentiable
    def backward(ctx, *v):
        x01, ct, *tables = ctx.saved_tensors
        if all(t is None for t in v):
            return (None,) * (4 + len(tables))
        v = [torch.zeros_like(t) if g is None else g.contiguous()
             for g, t in zip(v, tables)]
        bwd2 = (plane_encode_bwd2_kernel if ctx.use_kernels
                else plane_encode_bwd2_plain)
        d_ct, d_planes, d_lines = bwd2(
            _params_of(tables, ctx.cfg), x01, ct, _params_of(v, ctx.cfg),
            ctx.cfg)
        if not ctx.needs_input_grad[3]:
            d_ct = None
        return (None, None, None, d_ct, *d_planes, *(d_lines or ()))


class PlaneEncode(torch.autograd.Function):
    """plane_encode with its reference VJP: forward kernel 1 (or the plain
    forward), backward kernels 5/6 (or `plane_encode_bwd_plain`). Inputs
    after the two static ones: x01, then the level tables, planes first,
    then lines; each gradient has its input's shape. Under create_graph
    the backward is `PlaneEncodeBwd`, differentiable again (kernels 5'' /
    6''); otherwise it launches kernel 5 or 6 itself."""

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
        if torch.is_grad_enabled():  # create_graph: kernels 5'' / 6''
            if ctx.needs_input_grad[2]:
                raise NotImplementedError(
                    "plane_encode: a second derivative with positions that "
                    "require grad is not ported (on every MAML path the "
                    "points are ray geometry)")
            return (None, None, None, *PlaneEncodeBwd.apply(
                ctx.cfg, ctx.use_kernels, x01, ct.contiguous(), *tables))
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
