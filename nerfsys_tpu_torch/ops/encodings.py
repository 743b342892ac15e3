"""Input encodings: spherical harmonics and the multiresolution hash grid.

Port of nerfsys_tpu/ops/encodings.py: `sh_encode`, `sh_out_dim` and
`num_sh_bases` (:48-106), real SH up to degree 4 in the Nerfstudio
coefficient convention; and the Instant-NGP hash grid (:133-528):
`HashGridConfig` :135, `hash_grid_init` :205, `_hash3` :218,
`_grid_index3` :228, `tcnn_param_layout` :243, `hash_grid_encode` :256
(Nearest), `hash_grid_encode_fused` :345 with `_encode_indices_weights`
:406, `pack_table_pairs` / `_unpack_pairs` :457-470 and
`hash_grid_encode_packed` with its VJP :491-528.

Per level l with scale s_l (the float32 numbers of
`HashGridConfig.level_scales`), a point x in [0,1]^3 reads the 8 corners
of its cell at x * s_l (+ 0.5 in the tcnn layout), each a row of the
level's slab of 2^T rows: the prime-XOR hash of the corner's lattice
coordinates masked to 2^T - 1 (the tcnn layout stores coarse levels
densely, x + y*res + z*res^2). The output is the weighted corner sum,
(..., L * F) level-major with the features fastest. The reference's
`_corner_sum_matrix` (an MXU matmul over lane-aligned (N, L*8) tensors) is
ported as the direct sum over the corners, in `_CORNERS` order.

Tables may be one expert's, (L * 2^T, F) with points (..., 3), or the K
experts' stacked, (K, L * 2^T, F) with points (K, N, 3). Kernel row 7
(`csrc/hash_grid.cu`) computes the fp32 forward (`hash_encode_fwd`), the
packed bfloat16-pair forward (`hash_encode_fwd_packed`) and the table
gradient (`hash_encode_bwd`); `hash_encode_plain`,
`hash_encode_packed_plain` and `hash_encode_bwd_plain` are the same
functions in plain PyTorch. The plain versions loop over levels (all
levels' indices at once take gigabytes at a full serve chunk) and hash in
int64 masked to 2^T - 1, which gives the reference's uint32 wraparound
bits: the lattice coordinates stay below 2^13 and the primes below 2^32.
Gradients go through `HashEncode` to the table only: positions are ray
geometry here, and the reference's packed VJP returns zeros for them.
Under create_graph (the MAML inner gradient) the table gradient is
`HashEncodeBwd`, whose own VJP is the fp32 encode (kernel 7a) of the
table cotangent.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Tuple

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

MAX_SH_DEGREE = 4


def num_sh_bases(degree: int) -> int:
    if degree > MAX_SH_DEGREE:
        raise ValueError(f"SH degree {degree} > {MAX_SH_DEGREE}")
    return (degree + 1) ** 2


def sh_out_dim(levels: int = 4) -> int:
    return levels**2


def sh_encode(directions: torch.Tensor, levels: int = 4) -> torch.Tensor:
    """Real SH components up to degree = levels - 1.

    directions: (..., 3), normalised internally. Returns (..., levels**2).
    """
    degree = levels - 1
    if not 0 <= degree <= MAX_SH_DEGREE:
        raise ValueError(f"SH levels {levels} out of range")
    d = directions
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-9)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z

    comps = [torch.full_like(x, 0.28209479177387814)]  # l=0
    if degree > 0:
        comps += [
            0.4886025119029199 * y,
            0.4886025119029199 * z,
            0.4886025119029199 * x,
        ]
    if degree > 1:
        comps += [
            1.0925484305920792 * x * y,
            1.0925484305920792 * y * z,
            0.9461746957575601 * zz - 0.31539156525251999,
            1.0925484305920792 * x * z,
            0.5462742152960396 * (xx - yy),
        ]
    if degree > 2:
        comps += [
            0.5900435899266435 * y * (3 * xx - yy),
            2.890611442640554 * x * y * z,
            0.4570457994644658 * y * (5 * zz - 1),
            0.3731763325901154 * z * (5 * zz - 3),
            0.4570457994644658 * x * (5 * zz - 1),
            1.445305721320277 * z * (xx - yy),
            0.5900435899266435 * x * (xx - 3 * yy),
        ]
    if degree > 3:
        comps += [
            2.5033429417967046 * x * y * (xx - yy),
            1.7701307697799304 * y * z * (3 * xx - yy),
            0.9461746957575601 * x * y * (7 * zz - 1),
            0.6690465435572892 * y * z * (7 * zz - 3),
            0.10578554691520431 * (35 * zz * zz - 30 * zz + 3),
            0.6690465435572892 * x * z * (7 * zz - 3),
            0.47308734787878004 * (xx - yy) * (7 * zz - 1),
            1.7701307697799304 * x * z * (xx - 3 * yy),
            0.6258357354491761 * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    return torch.stack(comps, dim=-1)


# =============================== hash grid ==================================
_HASH_PRIMES = (1, 2654435761, 805459861)
# 8 trilinear corner offsets (dx, dy, dz), corner-major (dx slowest)
_CORNERS = tuple((dx, dy, dz) for dx in (0, 1) for dy in (0, 1)
                 for dz in (0, 1))
INTERPOLATIONS = ("Linear", "Smoothstep", "Nearest")  # kernel mode 0, 1, 2


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    """Static hyperparameters of an Instant-NGP multiresolution hash grid
    (the reference's fields; `packed` reads the table as bfloat16 pairs,
    F must be 2; `tcnn_layout` is tiny-cuda-nn's GridEncoding layout)."""

    levels: int = 16
    min_res: int = 16
    max_res: int = 4096
    log2_hashmap_size: int = 19
    features_per_level: int = 2
    hash_init_scale: float = 1e-3
    interpolation: str = "Linear"  # Nearest | Linear | Smoothstep
    packed: bool = False
    tcnn_layout: bool = False

    def __post_init__(self):
        if self.mode not in INTERPOLATIONS:
            raise ValueError(f"interpolation={self.interpolation!r}: expected "
                             f"one of {INTERPOLATIONS}")

    @property
    def mode(self) -> str:
        return self.interpolation or "Linear"

    @property
    def table_size(self) -> int:
        return 2**self.log2_hashmap_size

    @property
    def out_dim(self) -> int:
        return self.levels * self.features_per_level

    @property
    def growth_factor(self) -> float:
        if self.levels <= 1:
            return 1.0
        return math.exp(
            (math.log(self.max_res) - math.log(self.min_res)) / (self.levels - 1)
        )

    def level_scales(self) -> np.ndarray:
        """float32 per-level scales, with the reference's numpy
        expressions: floor(min_res * growth^l), or in the tcnn layout
        min_res * exp2(l * log2(growth)) - 1. The kernels and the plain
        versions both take these numbers."""
        ls = np.arange(self.levels, dtype=np.float32)
        if self.tcnn_layout:
            g = np.float32(math.log2(self.growth_factor))
            return (np.exp2(ls * g, dtype=np.float32)
                    * np.float32(self.min_res) - np.float32(1.0))
        return np.floor(
            self.min_res * (self.growth_factor**ls)
        ).astype(np.float32)

    def level_resolutions(self) -> np.ndarray:
        """Integer per-level vertex-lattice resolutions."""
        if self.tcnn_layout:
            return (np.ceil(self.level_scales()) + 1).astype(np.int32)
        ls = np.arange(self.levels, dtype=np.float32)
        return np.floor(self.min_res * (self.growth_factor**ls)).astype(np.int32)

    def level_dense_mask(self) -> np.ndarray:
        """(L,) bool: the levels stored densely (tcnn layout only), those
        whose whole lattice fits the slab (res^3 <= 2^T)."""
        if not self.tcnn_layout:
            return np.zeros(self.levels, bool)
        res = self.level_resolutions().astype(np.int64)
        return (res**3) <= np.int64(self.table_size)


def hash_grid_init(cfg: HashGridConfig, generator: torch.Generator,
                   device="cuda", num_experts: int = 0) -> torch.Tensor:
    """Hash table, uniform(-1, 1) * hash_init_scale, (L * 2^T, F) with one
    slab per level (level-major); num_experts > 0 adds a leading K. Drawn
    on the CPU from `generator`, then moved to `device`."""
    dev = resolve_device(device)
    lead = (num_experts,) if num_experts else ()
    total = cfg.table_size * cfg.levels
    table = torch.rand(*lead, total, cfg.features_per_level,
                       generator=generator)
    return ((table * 2.0 - 1.0) * cfg.hash_init_scale).to(dev)


def _hash3(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor,
           log2_size: int) -> torch.Tensor:
    """Prime-XOR spatial hash of int64 lattice coordinates, masked to
    2^log2_size - 1 (the low bits of the reference's uint32 arithmetic)."""
    h = (ix * _HASH_PRIMES[0]) ^ (iy * _HASH_PRIMES[1]) ^ (iz * _HASH_PRIMES[2])
    return h & (2**log2_size - 1)


def _grid_index3(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor,
                 cfg: HashGridConfig, level: int) -> torch.Tensor:
    """Slab-relative row of lattice corners at `level`: hashed, or in the
    tcnn layout linear (x fastest) at the dense levels."""
    if cfg.tcnn_layout and cfg.level_dense_mask()[level]:
        res = int(cfg.level_resolutions()[level])
        return ix + iy * res + iz * res * res
    return _hash3(ix, iy, iz, cfg.log2_hashmap_size)


def tcnn_param_layout(cfg: HashGridConfig):
    """Per-level (rows_used, padded_size, offset) of a tcnn GridEncoding
    param blob, in entries: next_multiple(min(res^3, 2^T), 8), accumulated
    level-major. Requires the tcnn layout."""
    if not cfg.tcnn_layout:
        raise ValueError("tcnn_param_layout needs tcnn_layout resolutions")
    res = cfg.level_resolutions().astype(np.int64)
    rows = np.minimum(res**3, np.int64(cfg.table_size))
    padded = -(-rows // 8) * 8
    offsets = np.concatenate([[0], np.cumsum(padded)[:-1]])
    return rows, padded, offsets


Corner = Tuple[torch.Tensor, Optional[torch.Tensor]]


def level_corners(x: torch.Tensor, cfg: HashGridConfig,
                  level: int) -> List[Corner]:
    """(slab-relative row int64, weight float32) of each corner `level`
    reads for points x (..., 3): the 8 corners in `_CORNERS` order, the
    weight (wx * wy) * wz; Nearest: one row (round half to even), weight
    None (1). The float operations are the reference's, one rounding
    each."""
    scale = float(cfg.level_scales()[level])
    s = x.to(torch.float32) * scale
    if cfg.mode == "Nearest":
        if cfg.tcnn_layout:
            raise NotImplementedError(
                "Nearest interpolation is not supported with tcnn_layout")
        c = torch.round(s).long()
        return [(_hash3(c[..., 0], c[..., 1], c[..., 2],
                        cfg.log2_hashmap_size), None)]
    if cfg.tcnn_layout:
        s = s + 0.5
    fl = torch.floor(s)
    fr = s - fl
    if cfg.mode == "Smoothstep":
        fr = fr * fr * (3.0 - 2.0 * fr)
    lo = fl.long()
    hi = lo + 1
    if cfg.tcnn_layout:
        res = int(cfg.level_resolutions()[level])
        lo, hi = lo.clamp(0, res - 1), hi.clamp(0, res - 1)
    cells, weights = (lo, hi), (1.0 - fr, fr)
    out = []
    for dx, dy, dz in _CORNERS:
        row = _grid_index3(cells[dx][..., 0], cells[dy][..., 1],
                           cells[dz][..., 2], cfg, level)
        out.append((row, weights[dx][..., 0] * weights[dy][..., 1]
                    * weights[dz][..., 2]))
    return out


def encode_indices_weights(x01: torch.Tensor, cfg: HashGridConfig):
    """The reference's `_encode_indices_weights`: absolute table rows
    (N, L * 8) int64 and weights (N, L * 8) float32, level-major with the
    corners fastest (Linear and Smoothstep)."""
    if cfg.mode == "Nearest":
        raise ValueError("encode_indices_weights: Linear or Smoothstep only")
    x = x01.reshape(-1, 3)
    idx, w = [], []
    for level in range(cfg.levels):
        corners = level_corners(x, cfg, level)
        idx.append(torch.stack([r for r, _ in corners], -1)
                   + level * cfg.table_size)
        w.append(torch.stack([c for _, c in corners], -1))
    return torch.cat(idx, -1), torch.cat(w, -1)


def _as_stacked(table: torch.Tensor, x01: torch.Tensor, cfg: HashGridConfig):
    """(table (K, L*2^T, F), x (K, N, 3), lead shape or None if stacked)."""
    rows = cfg.levels * cfg.table_size
    F = cfg.features_per_level
    if tuple(table.shape[-2:]) != (rows, F):
        raise ValueError(f"hash table {tuple(table.shape)} does not match "
                         f"L*2^T={rows}, F={F}")
    if table.dim() == 3:
        if x01.dim() != 3 or x01.shape[0] != table.shape[0]:
            raise ValueError(f"stacked tables need points (K, N, 3), got "
                             f"{tuple(x01.shape)}")
        return table, x01, None
    return table[None], x01.reshape(1, -1, 3), x01.shape[:-1]


def _unstack(out: torch.Tensor, lead, cfg: HashGridConfig) -> torch.Tensor:
    return out if lead is None else out[0].reshape(*lead, cfg.out_dim)


def _level_rows(K: int, cfg: HashGridConfig, level: int, device):
    """(K, 1) int64 row offsets of each expert's slab `level` in the
    flattened (K * L * 2^T, F) table."""
    k = torch.arange(K, device=device, dtype=torch.int64)[:, None]
    return (k * cfg.levels + level) * cfg.table_size


def hash_encode_plain(table: torch.Tensor, x01: torch.Tensor,
                      cfg: HashGridConfig) -> torch.Tensor:
    """Plain PyTorch version of kernel 7a: the fp32 encode (Linear,
    Smoothstep, Nearest; floor and tcnn layouts), the corners summed in
    `_CORNERS` order, one rounding per operation."""
    tab, x, lead = _as_stacked(table, x01, cfg)
    K, N = x.shape[0], x.shape[1]
    F = cfg.features_per_level
    flat = tab.reshape(-1, F)
    dtype = torch.promote_types(tab.dtype, torch.float32)  # float64 tests
    out = torch.empty((K, N, cfg.out_dim), dtype=dtype, device=x.device)
    for level in range(cfg.levels):
        base = _level_rows(K, cfg, level, x.device)
        acc = torch.zeros((K, N, F), dtype=dtype, device=x.device)
        for row, w in level_corners(x, cfg, level):
            v = flat[(base + row).reshape(-1)].reshape(K, N, F)
            acc = acc + (v if w is None else w[..., None] * v)
        out[..., level * F:(level + 1) * F] = acc
    return _unstack(out, lead, cfg)


def pack_table_pairs(table: torch.Tensor) -> torch.Tensor:
    """(T, 2) float table -> (T,) int64 holding the reference's uint32 of
    two bfloat16 bit patterns (hi = f0, lo = f1)."""
    bits = table.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    return (bits[..., 0] << 16) | bits[..., 1]


def _bf16_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^16) -> the bfloat16 with those bits."""
    signed = torch.where(bits >= 0x8000, bits - 0x10000, bits)
    return signed.to(torch.int16).view(torch.bfloat16)


def unpack_pairs(g: torch.Tensor):
    """Packed pairs (int64 of uint32 values) -> (f0, f1) bfloat16."""
    return _bf16_of_bits((g >> 16) & 0xFFFF), _bf16_of_bits(g & 0xFFFF)


def _check_packed(cfg: HashGridConfig) -> None:
    if cfg.features_per_level != 2 or cfg.mode == "Nearest":
        raise ValueError("the packed hash encode needs features_per_level "
                         "== 2 and Linear or Smoothstep interpolation")


def hash_encode_packed_plain(table: torch.Tensor, x01: torch.Tensor,
                             cfg: HashGridConfig) -> torch.Tensor:
    """Plain PyTorch version of kernel 7b, the reference's packed forward:
    each corner's two features read as bfloat16 from the packed table, the
    weight rounded to bfloat16, the product rounded to bfloat16 (a
    bfloat16 multiply), the corners summed in float32."""
    _check_packed(cfg)
    tab, x, lead = _as_stacked(table, x01, cfg)
    K, N = x.shape[0], x.shape[1]
    packed = pack_table_pairs(tab.reshape(-1, 2))
    out = torch.empty((K, N, cfg.out_dim), dtype=torch.float32,
                      device=x.device)
    for level in range(cfg.levels):
        base = _level_rows(K, cfg, level, x.device)
        a0 = torch.zeros((K, N), dtype=torch.float32, device=x.device)
        a1 = torch.zeros_like(a0)
        for row, w in level_corners(x, cfg, level):
            f0, f1 = unpack_pairs(packed[(base + row).reshape(-1)]
                                  .reshape(K, N))
            wb = w.to(torch.bfloat16)
            a0 = a0 + (wb * f0).to(torch.float32)
            a1 = a1 + (wb * f1).to(torch.float32)
        out[..., 2 * level] = a0
        out[..., 2 * level + 1] = a1
    return _unstack(out, lead, cfg)


def hash_encode_bwd_plain(x01: torch.Tensor, dout: torch.Tensor,
                          cfg: HashGridConfig,
                          table_shape: torch.Size) -> torch.Tensor:
    """Plain PyTorch version of kernel 7c: the table gradient of the encode
    for the cotangent `dout` (..., L * F), table-shaped. Each corner adds
    w * dout (the float32 w, for the packed forward too; Nearest adds dout)
    with `index_add_`."""
    F = cfg.features_per_level
    x = x01 if len(table_shape) == 3 else x01.reshape(1, -1, 3)
    K, N = x.shape[0], x.shape[1]
    g = dout.reshape(K, N, cfg.out_dim).to(torch.float32)
    dtable = torch.zeros((K * cfg.levels * cfg.table_size, F),
                         dtype=torch.float32, device=x.device)
    for level in range(cfg.levels):
        base = _level_rows(K, cfg, level, x.device)
        g_l = g[..., level * F:(level + 1) * F]
        for row, w in level_corners(x, cfg, level):
            share = g_l if w is None else w[..., None] * g_l
            dtable.index_add_(0, (base + row).reshape(-1),
                              share.reshape(-1, F))
    return dtable.reshape(table_shape)


@functools.lru_cache(maxsize=64)
def _level_table(cfg: HashGridConfig) -> "kernels.HashLevels":
    """The kernels' per-level struct: the same float32 scales, integer
    resolutions and dense flags the plain versions use (built once per
    config: the numpy level helpers cost tens of microseconds a launch)."""
    if not 1 <= cfg.levels <= kernels.HashLevels.MAX_LEVELS:
        raise ValueError(f"hash kernels take 1-{kernels.HashLevels.MAX_LEVELS}"
                         f" levels, not {cfg.levels}")
    if not 1 <= cfg.log2_hashmap_size <= 30:
        raise ValueError("hash kernels take log2_hashmap_size 1-30")
    if cfg.features_per_level not in kernels.HASH_FEATURES:
        raise ValueError(f"hash kernels take features_per_level in "
                         f"{kernels.HASH_FEATURES}")
    if cfg.tcnn_layout and cfg.mode == "Nearest":
        raise NotImplementedError(
            "Nearest interpolation is not supported with tcnn_layout")
    lv = kernels.HashLevels()
    for level, (s, r, d) in enumerate(zip(cfg.level_scales(),
                                          cfg.level_resolutions(),
                                          cfg.level_dense_mask())):
        lv.scale[level] = float(s)
        lv.res[level] = int(r)
        lv.dense[level] = int(d)
    lv.levels = cfg.levels
    lv.log2_size = cfg.log2_hashmap_size
    lv.tcnn = int(cfg.tcnn_layout)
    lv.mode = INTERPOLATIONS.index(cfg.mode)
    return lv


def _device_of(name: str, x01: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain)."""
    if x01.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x01.device}")
    return x01.device.type == "cuda"


# Launch plans of kernels 7a / 7b and 7c (csrc/hash_grid.cu `HashPlan`).
LANE_MAPS = ("samples", "rays")  # kernel lane_map 0, 1
HASH_FWD_TILE, HASH_FWD_THREADS = 256, 512  # 7a: 8 rays of 32 samples
HASH_FWD_SMEM = 49_152  # 7a's tile is halved while its staging exceeds it
# 7a's shape thresholds in tiles of 256 points per SM (see `_fwd_shape`)
HASH_FWD_ONE_GROUP, HASH_FWD_SMALL_TILES = 3, 24
HASH_BWD_TILE, HASH_BWD_THREADS = 64, 256  # 7c: 2 rays of 32 samples
HASH_BWD_LEVELS = 2  # 7c's levels per block: 2 slabs (16 MiB) in the L2


@dataclasses.dataclass(frozen=True)
class HashLaunchPlan:
    """Launch geometry of kernel 7a, 7b or 7c (csrc/hash_grid.cu
    `HashPlan`)."""

    tile: int  # consecutive points of one expert per tile: 32 x 2^j <= 1024
    threads: int  # per block (multiple of 32)
    blocks: int  # per expert: one per tile (7a), persistent (7c)
    smem: int  # dynamic shared-memory bytes per block
    lane_map: str  # "rays": lanes across the tile's runs of 32; "samples"
    vec: bool  # 16-byte output stores (7a) / cotangent copies (7c)
    level_group: int = 0  # levels per block; grid y takes the groups

    def as_struct(self) -> "kernels.HashPlan":
        return kernels.HashPlan(
            self.tile, self.threads, self.blocks, self.smem,
            LANE_MAPS.index(self.lane_map), int(self.vec), self.level_group)


def _check_lane_map(lane_map: str) -> None:
    if lane_map not in LANE_MAPS:
        raise ValueError(f"lane_map={lane_map!r}: expected one of "
                         f"{LANE_MAPS}")


def _level_group(cfg: HashGridConfig, level_group: Optional[int]) -> int:
    lg = cfg.levels if level_group is None else level_group
    if not 1 <= lg <= cfg.levels or cfg.levels % lg:
        raise ValueError(f"hash encode: level_group={lg} does not divide "
                         f"{cfg.levels} levels")
    return lg


def _fwd_shape(n: int, k: int, levels: int, num_sms: int):
    """7a's (tile, levels per block) by the work per SM, in tiles of 256
    points: up to HASH_FWD_ONE_GROUP, tiles of 256 in one group of all
    levels; up to HASH_FWD_SMALL_TILES, tiles of 128 in groups of 4
    levels; beyond, tiles of 512 in groups of 4. The thresholds fit what
    was fastest on an H100 at the runner's width (L=16, F=2) at the three
    shapes the paths use: a query set (64,000 points, 1.9 tiles an SM),
    an inner step (128,000, 3.8) and a serve chunk (4 x 2,097,152, 248)."""
    per_sm = k * -(-n // 256) / num_sms
    four = 4 if levels % 4 == 0 else levels
    if per_sm <= HASH_FWD_ONE_GROUP:
        return 256, levels
    return (128 if per_sm <= HASH_FWD_SMALL_TILES else 512), four


def hash_fwd_plan(n: int, cfg: HashGridConfig, k: int = 1,
                  num_sms: int = 132, lane_map: str = "rays",
                  level_group: Optional[int] = None,
                  vec_ok: bool = True) -> HashLaunchPlan:
    """Kernel 7a's (and 7b's) plan for K experts of N points each: one
    block per tile of consecutive points of one expert and level group
    (`level_group` levels, a divisor of L), with at most one warp per
    (level, run of 32) task; tile and group chosen by `_fwd_shape` unless
    a group is given (then tiles of HASH_FWD_TILE), the tile halved while
    its points and staged (tile, level_group * F) output exceed
    HASH_FWD_SMEM; 16-byte stores when a group's span is whole float4s and
    `vec_ok` (the output is 16-byte aligned)."""
    _check_lane_map(lane_map)
    L, F = cfg.levels, cfg.features_per_level
    if level_group is None:
        tile, level_group = _fwd_shape(n, k, L, num_sms)
    else:
        tile = HASH_FWD_TILE
    lg = _level_group(cfg, level_group)

    def smem(t):  # points, output rows of lg*F + 1 floats, run shifts
        return 4 * (3 * t + t * (lg * F + 1) + 32)

    while tile > 32 and smem(tile) > HASH_FWD_SMEM:
        tile //= 2
    if smem(tile) > SMEM_BLOCK_BYTES:
        raise ValueError(f"hash_encode: a 32-point tile of {lg * F} "
                         f"features exceeds {SMEM_BLOCK_BYTES} bytes of "
                         f"shared memory")
    return HashLaunchPlan(
        tile=tile, threads=min(HASH_FWD_THREADS, tile * lg),
        blocks=max(1, -(-n // tile)), smem=smem(tile), lane_map=lane_map,
        vec=vec_ok and (lg * F) % 4 == 0, level_group=lg)


def hash_bwd_plan(n: int, k: int, cfg: HashGridConfig, num_sms: int,
                  lane_map: str = "samples",
                  level_group: Optional[int] = HASH_BWD_LEVELS,
                  vec_ok: bool = True) -> HashLaunchPlan:
    """Kernel 7c's plan for K experts of N points each.

    Levels go in groups of `level_group` (None: all; a group that does not
    divide L falls back to all). Shared memory holds two (tile,
    level_group * F) cotangent buffers and two (tile, 3) point buffers
    (HASH_BWD_TILE points, halved while they exceed half a block's shared
    memory). With one level group the blocks are persistent: per expert as
    many as can be resident on `num_sms` SMs by shared memory and threads,
    at most one per tile (the entry point lowers it to what the occupancy
    calculator, registers included, allows). With several, each block
    takes one tile of one group (one warp per (level, run of 32) task), and
    the groups run one after the other, so that the slabs they add into
    stay in the L2."""
    _check_lane_map(lane_map)
    L, F = cfg.levels, cfg.features_per_level
    if level_group is not None and L % level_group:
        level_group = None
    lg = _level_group(cfg, level_group)
    d = lg * F
    tile = HASH_BWD_TILE
    while tile > 32 and 8 * tile * (d + 3) > SMEM_BLOCK_BYTES // 2:
        tile //= 2
    smem = 8 * tile * (d + 3)
    if smem > SMEM_BLOCK_BYTES:
        raise ValueError(f"hash_encode_bwd: a 32-point tile of {d} features "
                         f"exceeds {SMEM_BLOCK_BYTES} bytes of shared memory")
    tiles = -(-n // tile)
    threads = min(HASH_BWD_THREADS, tile * lg)
    per_sm = max(1, min(SMEM_SM_BYTES // (smem + 1024), 2048 // threads))
    blocks = tiles if lg < L else max(1, min(tiles,
                                             num_sms * per_sm // max(k, 1)))
    return HashLaunchPlan(
        tile=tile, threads=threads, blocks=blocks, smem=smem,
        lane_map=lane_map, vec=vec_ok and d % 4 == 0, level_group=lg)


@functools.lru_cache(maxsize=256)
def _fwd_struct(n: int, k: int, cfg: HashGridConfig, num_sms: int,
                vec_ok: bool) -> "kernels.HashPlan":
    """`hash_fwd_plan`'s default plan as the kernel's struct, per shape."""
    return hash_fwd_plan(n, cfg, k, num_sms, vec_ok=vec_ok).as_struct()


@functools.lru_cache(maxsize=256)
def _bwd_struct(n: int, k: int, cfg: HashGridConfig, num_sms: int,
                vec_ok: bool) -> "kernels.HashPlan":
    """`hash_bwd_plan`'s default plan as the kernel's struct, per shape."""
    return hash_bwd_plan(n, k, cfg, num_sms, vec_ok=vec_ok).as_struct()


def hash_encode_kernel(table: torch.Tensor, x01: torch.Tensor,
                       cfg: HashGridConfig,
                       packed: bool = False) -> torch.Tensor:
    """Kernels 7a / 7b's wrapper: the plain version for a CPU tensor; on a
    CUDA tensor it launches `hash_encode_fwd` or, when `packed`,
    `hash_encode_fwd_packed` (both with `hash_fwd_plan`'s plan), or raises.
    Not differentiable: it raises under grad mode with inputs that require
    grad."""
    kernels.check_no_grad("hash_encode", x01, table)
    if packed:
        _check_packed(cfg)
    if not _device_of("hash_encode", x01):
        return (hash_encode_packed_plain if packed else hash_encode_plain)(
            table, x01, cfg)
    return hash_encode_planned(table, x01, cfg, packed=packed)


def hash_encode_planned(table: torch.Tensor, x01: torch.Tensor,
                        cfg: HashGridConfig, packed: bool = False,
                        plan: Optional[HashLaunchPlan] = None
                        ) -> torch.Tensor:
    """The CUDA half of `hash_encode_kernel`; `plan` (None:
    `hash_fwd_plan`'s) sets 7a's or 7b's launch, so a caller can run either
    lane map, tile or level grouping at any shape."""
    if x01.device.type != "cuda":
        raise ValueError(f"hash_encode: unsupported device {x01.device}")
    tab, x, lead = _as_stacked(table, x01, cfg)
    K, N = x.shape[0], x.shape[1]
    kernels.check_cuda_tensors("hash_encode", x01.device, x=x, hash_table=tab)
    if not aligned(tab):
        raise ValueError("hash_encode: the table must start on a 16-byte "
                         "boundary (the kernel reads rows as vectors)")
    lv = _level_table(cfg)
    out = torch.empty((K, N, cfg.out_dim), dtype=torch.float32,
                      device=x01.device)
    st = (_fwd_struct(N, K, cfg, num_sms(x.device), aligned(out))
          if plan is None else plan.as_struct())
    stream = kernels.stream_ptr(x)
    if packed:
        kernels.HASH_FWD_PACKED(x.data_ptr(), tab.data_ptr(), out.data_ptr(),
                                lv, K, N, st, stream)
    else:
        kernels.HASH_FWD(x.data_ptr(), tab.data_ptr(), out.data_ptr(), lv, K,
                         N, cfg.features_per_level, st, stream)
    return _unstack(out, lead, cfg)


def hash_encode_bwd_kernel(x01: torch.Tensor, dout: torch.Tensor,
                           cfg: HashGridConfig,
                           table_shape: torch.Size) -> torch.Tensor:
    """Kernel 7c's wrapper: the plain version for a CPU tensor; on a CUDA
    tensor it launches `hash_encode_bwd` (with `hash_bwd_plan`'s plan, into
    a zeroed table-shaped buffer) or raises."""
    kernels.check_no_grad("hash_encode_bwd", x01, dout)
    if not _device_of("hash_encode_bwd", x01):
        return hash_encode_bwd_plain(x01, dout, cfg, table_shape)
    return hash_encode_bwd_planned(x01, dout, cfg, table_shape)


def hash_encode_bwd_planned(x01: torch.Tensor, dout: torch.Tensor,
                            cfg: HashGridConfig, table_shape: torch.Size,
                            plan: Optional[HashLaunchPlan] = None
                            ) -> torch.Tensor:
    """The CUDA half of `hash_encode_bwd_kernel`; `plan` (None:
    `hash_bwd_plan`'s) sets 7c's launch, so a caller can run either lane
    map or level grouping at any shape."""
    if x01.device.type != "cuda":
        raise ValueError(f"hash_encode_bwd: unsupported device {x01.device}")
    if tuple(table_shape[-2:]) != (cfg.levels * cfg.table_size,
                                   cfg.features_per_level):
        raise ValueError("hash_encode_bwd: table shape does not match cfg")
    stacked = len(table_shape) == 3
    x = x01 if stacked else x01.reshape(1, -1, 3)
    K, N = x.shape[0], x.shape[1]
    g = dout.reshape(K, N, cfg.out_dim)
    kernels.check_cuda_tensors("hash_encode_bwd", x01.device, x=x, dout=g)
    lv = _level_table(cfg)
    dtable = torch.zeros(table_shape, dtype=torch.float32, device=x.device)
    st = (_bwd_struct(N, K, cfg, num_sms(x.device), aligned(g))
          if plan is None else plan.as_struct())
    kernels.HASH_BWD(x.data_ptr(), g.data_ptr(), dtable.data_ptr(), lv, K, N,
                     cfg.features_per_level, st, kernels.stream_ptr(x))
    return dtable


class HashEncodeBwd(torch.autograd.Function):
    """Kernel 7c's table gradient as a differentiable function of the
    cotangent: forward kernel 7c (or `hash_encode_bwd_plain`), backward
    row 7c'': 7c is linear in its cotangent and its corner rows and
    weights depend on x01 alone, so its VJP is the fp32 encode, kernel 7a
    (or `hash_encode_plain`), of the incoming table cotangent. That holds
    for the packed forward too: its VJP gathers in float32 (the
    reference's `_packed_bwd` transposed), so 7a and not 7b. The table
    gets no second-order term and x01 none. `HashEncode.backward` calls it
    under create_graph (MAML's inner gradient)."""

    @staticmethod
    def forward(ctx, cfg, use_kernels, table_shape, x01, dout):
        bwd = hash_encode_bwd_kernel if use_kernels else \
            hash_encode_bwd_plain
        ctx.cfg, ctx.use_kernels = cfg, use_kernels
        ctx.save_for_backward(x01)
        return bwd(x01, dout, cfg, table_shape)

    @staticmethod
    @once_differentiable
    def backward(ctx, v):
        (x01,) = ctx.saved_tensors
        if v is None or not ctx.needs_input_grad[4]:
            return None, None, None, None, None
        v = v.contiguous()
        if not aligned(v):  # kernel 7a reads rows as vectors
            v = v.clone()
        fwd = hash_encode_kernel if ctx.use_kernels else hash_encode_plain
        return None, None, None, None, fwd(v, x01, ctx.cfg)


class HashEncode(torch.autograd.Function):
    """The hash encode with the reference's VJP to the table: forward
    kernel 7a or 7b (or their plain versions), backward kernel 7c (or
    `hash_encode_bwd_plain`). Inputs after the three static ones: x01,
    then the table; x01 gets no gradient. Under create_graph the backward
    is `HashEncodeBwd`, differentiable again (row 7c'', kernel 7a on the
    table cotangent); otherwise it launches 7c itself."""

    @staticmethod
    def forward(ctx, cfg, packed, use_kernels, x01, table):
        if use_kernels:
            out = hash_encode_kernel(table, x01, cfg, packed)
        elif packed:
            out = hash_encode_packed_plain(table, x01, cfg)
        else:
            out = hash_encode_plain(table, x01, cfg)
        ctx.cfg, ctx.use_kernels, ctx.table_shape = cfg, use_kernels, \
            table.shape
        ctx.save_for_backward(x01)
        return out

    @staticmethod
    def backward(ctx, dout):
        (x01,) = ctx.saved_tensors
        if torch.is_grad_enabled():
            return (None, None, None, None, HashEncodeBwd.apply(
                ctx.cfg, ctx.use_kernels, ctx.table_shape, x01,
                dout.contiguous()))
        bwd = hash_encode_bwd_kernel if ctx.use_kernels else \
            hash_encode_bwd_plain
        return (None, None, None, None,
                bwd(x01, dout.contiguous(), ctx.cfg, ctx.table_shape))


def hash_encode(table: torch.Tensor, x01: torch.Tensor, cfg: HashGridConfig,
                *, packed: bool = False,
                use_kernels: bool = True) -> torch.Tensor:
    """Encode points in [0,1]^3 -> (..., L * F), differentiable in the
    table. packed=True is the reference's `hash_grid_encode_packed` (F = 2,
    Linear or Smoothstep). Raises when x01 requires grad: the encode has no
    position gradient. use_kernels=False runs the plain forward and
    backward whatever the device (the card's own reference)."""
    if torch.is_grad_enabled() and x01.requires_grad:
        raise RuntimeError("hash_encode: positions get no gradient; detach "
                           "x01 (it is ray geometry on every path)")
    return HashEncode.apply(cfg, packed, use_kernels, x01, table)
