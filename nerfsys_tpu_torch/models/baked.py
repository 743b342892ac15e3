"""Baked snapshot serving: the routed MoE field resampled once into a
corner-packed spherical-harmonics grid, then rendered by trilinear lookups
and the compositor (no encoder, no MLPs, no routing per frame).

Port of nerfsys_tpu/models/baked.py (`BakedConfig` :52, `_fibonacci_sphere`
:143, `sh_projection_matrix` :154, `_compact_np` / `compact_baked`
:170-225, `_pack_sparse_from_vals` :228, `_np_dilate3` :301, `bake_field`
:349, `params_fingerprint` :521, `occ_bake_fingerprint` :550, `save_baked`
/ `load_baked` :573-644, `baked_trilerp` :647, `baked_query` :746,
`render_rays_baked` :758, `make_baked_camera_renderer` :806,
`make_baked_chunk_renderer` :899).

Table layout (the reference's): row ((x*R)+y)*R+z holds `pack` corner
blocks of the cell's forward 2x2x2 neighbourhood (neighbours clamped at
R-1), each block `padded_channels` wide with the first `channels` = sigma +
3 x SH coefficients used, blocks in (dx, dy, dz) lexicographic order. A
block-sparse table keeps only alive sparse_block³ blocks (slot 0 is the
shared all-zero block) behind an int32 index whose rows pack the slots of a
4³ super-block. The tables are built with torch on the bake's device; they
are bit-identical to the reference's numpy packers.

Kernel 8 (`csrc/baked.cu`) is the trilinear lookup on the card, with its
launch geometry from `baked_plan`; `baked_trilerp_plain` is the same
function in plain PyTorch. The reference's
`device_put_chunked` (a transport workaround) has no counterpart: tables
move with `.to(device)`.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nerfsys_tpu_torch import kernels
from nerfsys_tpu_torch.models.container import (
    ContainerConfig,
    ContainerStatics,
    container_apply_multidir,
    container_bg_fn,
)
from nerfsys_tpu_torch.models.ngp import tree_to
from nerfsys_tpu_torch.models.occupancy import occ_ready, union_binary_fn
from nerfsys_tpu_torch.ops.encodings import sh_encode
from nerfsys_tpu_torch.ops.scene_box import SceneBox
from nerfsys_tpu_torch.ops.volrend import (
    background_rgb,
    stratified_t_vals,
    t_to_points,
    volume_render,
)
from nerfsys_tpu_torch.pipelines.online.runtime_adapt import (
    ChunkRenderer,
    _fog_stats,
    frame_chunk_rays_biased,
    shape_frame_outputs,
)
from nerfsys_tpu_torch.utils.device import aligned, resolve_device

_TABLE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class BakedConfig:
    """The reference's fields, names and defaults (a snapshot's metadata
    compares them across packages)."""

    resolution: int = 256  # cells per axis over the global aabb
    sh_levels: int = 3  # SH degree + 1 (3 -> 9 bases)
    n_dirs: int = 32  # directions sampled per cell for the SH projection
    chunk_cells: int = 131072  # field-evaluation chunk during baking
    dtype: str = "bfloat16"  # table dtype: "bfloat16" or "float32"
    corner_pack: int = 0  # corners per row: 2, 4, 8, or 0 = auto
    auto_pack_budget_gb: float = 5.0  # auto mode's table-size ceiling
    sparse_block: int = 0  # 0 = dense table; else the block edge

    def __post_init__(self):
        if int(self.n_dirs) < self.n_bases:
            raise ValueError(
                f"BakedConfig: n_dirs={self.n_dirs} < n_bases="
                f"{self.n_bases} (sh_levels={self.sh_levels}) makes the SH "
                f"least-squares projection singular")
        if int(self.corner_pack) not in (0, 2, 4, 8):
            raise ValueError(f"BakedConfig: corner_pack={self.corner_pack} "
                             f"must be 0 (auto), 2, 4 or 8")
        if int(self.sparse_block) < 0 or int(self.sparse_block) == 1:
            raise ValueError(f"BakedConfig: sparse_block={self.sparse_block}"
                             f" must be 0 (dense) or a block edge >= 2")
        if self.sparse_block and self.resolution % self.sparse_block:
            raise ValueError(
                f"BakedConfig: sparse_block={self.sparse_block} must divide "
                f"resolution={self.resolution}")
        if self.dtype not in _TABLE_DTYPES:
            raise ValueError(f"BakedConfig: dtype={self.dtype!r} must be one "
                             f"of {sorted(_TABLE_DTYPES)}")

    @property
    def n_bases(self) -> int:
        return int(self.sh_levels) ** 2

    @property
    def channels(self) -> int:
        return 1 + 3 * self.n_bases  # sigma + SH coefs per color channel

    @property
    def padded_channels(self) -> int:
        """Per-corner block width: a multiple of 8, at least 32."""
        return max(32, -(-self.channels // 8) * 8)

    @property
    def table_dtype(self) -> torch.dtype:
        return _TABLE_DTYPES[self.dtype]

    def resolved_pack(self, resolution: Optional[int] = None) -> int:
        """corner_pack with auto (0) resolved against the table budget."""
        pack = int(self.corner_pack)
        if pack:
            return pack
        R = int(self.resolution if resolution is None else resolution)
        itemsize = torch.finfo(self.table_dtype).bits // 8
        for pack in (8, 4):
            gb = R**3 * pack * self.padded_channels * itemsize / 1e9
            if gb <= float(self.auto_pack_budget_gb):
                return pack
        return 2

    @property
    def row_width(self) -> int:
        return self.resolved_pack() * self.padded_channels


def _fibonacci_sphere(n: int) -> np.ndarray:
    """(n, 3) roughly uniform unit directions (deterministic)."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5.0**0.5) * i
    return np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
         np.cos(phi)], axis=-1,
    ).astype(np.float32)


def sh_projection_matrix(levels: int, dirs: np.ndarray) -> np.ndarray:
    """(B, M) least-squares projector, coefs = P @ rgb_at_dirs, with P =
    (YᵀY)⁻¹Yᵀ for the (M, B) SH design matrix Y (float32 solve)."""
    Y = sh_encode(torch.from_numpy(np.asarray(dirs, np.float32)),
                  levels=levels).numpy()
    return np.linalg.solve(Y.T @ Y, Y.T).astype(np.float32)


_SUPER = 4  # blocks per super-block axis in the index rows (4³ = 64 slots)


def _deltas(pack: int):
    """Corner offsets of the packed blocks, (dx, dy, dz) lexicographic."""
    return [(dx, dy, dz)
            for dx in range(2 if pack == 8 else 1)
            for dy in range(2 if pack >= 4 else 1)
            for dz in range(2)]


def _block_index(alive: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """alive (Rb, Rb, Rb) bool -> (alive block ids ascending, index (Rbs³,
    64) int32 of slots 1..n, 0 for dead blocks and the padding past Rb)."""
    Rb = alive.shape[0]
    ids = torch.nonzero(alive.reshape(-1)).squeeze(1)
    slots = torch.zeros(Rb**3, dtype=torch.int32, device=alive.device)
    slots[ids] = torch.arange(1, ids.numel() + 1, dtype=torch.int32,
                              device=alive.device)
    S = _SUPER
    Rbs = -(-Rb // S)
    padded = torch.zeros((Rbs * S,) * 3, dtype=torch.int32,
                         device=alive.device)
    padded[:Rb, :Rb, :Rb] = slots.reshape(Rb, Rb, Rb)
    index = (padded.reshape(Rbs, S, Rbs, S, Rbs, S)
             .permute(0, 2, 4, 1, 3, 5).reshape(Rbs**3, S**3).contiguous())
    return ids, index


def _block_coords(ids: torch.Tensor, Rb: int):
    return ids // (Rb * Rb), (ids // Rb) % Rb, ids % Rb


_FILL_BLOCKS = 4096  # blocks filled per step by the sparse packers


def compact_table(table: torch.Tensor, R: int, block: int):
    """Block-compact a dense (R³, W) table -> (compacted table, block
    index): blocks of block³ x-major rows that are all zero collapse onto
    the zero block at slot 0, alive blocks keep their rows at slots 1..n.
    Exact for any table (port of `_compact_np`)."""
    B, Rb = int(block), R // int(block)
    W = table.shape[1]
    t6 = table.reshape(Rb, B, Rb, B, Rb, B, W)
    alive = torch.stack([(t6[bx] != 0).any(dim=5).any(dim=4).any(dim=2)
                         .any(dim=0) for bx in range(Rb)])
    ids, index = _block_index(alive)
    t7 = t6.permute(0, 2, 4, 1, 3, 5, 6)  # (Rb, Rb, Rb, B, B, B, W) view
    comp = torch.zeros(((ids.numel() + 1) * B**3, W), dtype=table.dtype,
                       device=table.device)
    for s in range(0, ids.numel(), _FILL_BLOCKS):
        bx, by, bz = _block_coords(ids[s:s + _FILL_BLOCKS], Rb)
        comp[(s + 1) * B**3:(s + 1 + bx.numel()) * B**3] = (
            t7[bx, by, bz].reshape(-1, W))
    return comp, index


def compact_baked(baked: Dict, bcfg: BakedConfig) -> Dict:
    """Dense baked dict -> block-sparse baked dict (exact); bcfg must be
    the sparse config used at render time."""
    if not bcfg.sparse_block:
        raise ValueError("compact_baked: bcfg.sparse_block is 0 (dense)")
    if "block_index" in baked:
        return baked
    comp, index = compact_table(baked["table"], int(bcfg.resolution),
                                int(bcfg.sparse_block))
    return dict(baked, table=comp, block_index=index)


def pack_dense(vals_t: torch.Tensor, R: int, Cp: int,
               pack: int) -> torch.Tensor:
    """(R³, C) values in the table dtype -> the dense (R³, pack·Cp) table
    (neighbours clamped at R-1, blocks zero-padded to Cp)."""
    C = vals_t.shape[-1]
    g = vals_t.reshape(R, R, R, C)
    clamped = torch.clamp(torch.arange(1, R + 1, device=g.device), max=R - 1)
    table = torch.zeros((R, R, R, pack * Cp), dtype=vals_t.dtype,
                        device=vals_t.device)
    for bi, (dx, dy, dz) in enumerate(_deltas(pack)):
        b = g
        if dz:
            b = b.index_select(2, clamped)
        if dy:
            b = b.index_select(1, clamped)
        if dx:
            b = b.index_select(0, clamped)
        table[..., bi * Cp:bi * Cp + C] = b
    return table.reshape(R**3, pack * Cp)


def pack_sparse(vals_t: torch.Tensor, R: int, block: int, Cp: int,
                pack: int):
    """Corner-pack and block-compact without building the dense table ->
    (compacted table, block index), bit-identical to `pack_dense` followed
    by `compact_table` (port of `_pack_sparse_from_vals`). A packed row is
    nonzero iff one of its corner cells is, so block aliveness comes from
    the per-cell nonzero mask dilated forward along the packed axes. vals_t
    must already be in the table dtype, so that aliveness sees the zeros
    of the cast."""
    B, Rb = int(block), R // int(block)
    C = vals_t.shape[-1]
    W = pack * Cp
    dev = vals_t.device
    rnz = (vals_t.reshape(R, R, R, C) != 0).any(dim=-1)
    fwd = torch.clamp(torch.arange(1, R + 1, device=dev), max=R - 1)
    for ax in ([0, 1, 2] if pack == 8 else [1, 2] if pack == 4 else [2]):
        rnz = rnz | rnz.index_select(ax, fwd)
    alive = rnz.reshape(Rb, B, Rb, B, Rb, B).any(dim=5).any(dim=3).any(dim=1)
    ids, index = _block_index(alive)

    comp = torch.zeros(((ids.numel() + 1) * B**3, W), dtype=vals_t.dtype,
                       device=dev)
    local = torch.arange(B, device=dev)
    for s in range(0, ids.numel(), _FILL_BLOCKS):
        bx, by, bz = _block_coords(ids[s:s + _FILL_BLOCKS], Rb)
        nb = bx.numel()
        X = (bx * B)[:, None, None, None] + local[None, :, None, None]
        Y = (by * B)[:, None, None, None] + local[None, None, :, None]
        Z = (bz * B)[:, None, None, None] + local[None, None, None, :]
        rows = comp[(s + 1) * B**3:(s + 1 + nb) * B**3].view(nb, B, B, B, W)
        for bi, (dx, dy, dz) in enumerate(_deltas(pack)):
            flat = ((torch.clamp(X + dx, max=R - 1) * R
                     + torch.clamp(Y + dy, max=R - 1)) * R
                    + torch.clamp(Z + dz, max=R - 1))
            rows[..., bi * Cp:bi * Cp + C] = vals_t[flat]
    return comp, index


def _dilate3(mask: torch.Tensor) -> torch.Tensor:
    """One 3³ max-pool pass over an (R, R, R) bool mask, zero outside (the
    box filter done one axis at a time)."""
    out = mask
    for ax in range(3):
        n = out.shape[ax]
        grown = out.clone()
        grown.narrow(ax, 1, n - 1).logical_or_(out.narrow(ax, 0, n - 1))
        grown.narrow(ax, 0, n - 1).logical_or_(out.narrow(ax, 1, n - 1))
        out = grown
    return out


def cell_centers(R: int, lo: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """(R³, 3) cell centres of the bake grid, x-major like the rows."""
    idx = torch.arange(R, dtype=torch.float32, device=lo.device) + 0.5
    gx, gy, gz = torch.meshgrid(idx, idx, idx, indexing="ij")
    return lo[None, :] + torch.stack([gx, gy, gz], dim=-1).reshape(
        -1, 3) * h[None, :]


def bake_alive_mask(occ_state: Dict, statics: ContainerStatics,
                    centers: torch.Tensor, R: int,
                    occ_dilate: int = 2, *,
                    use_kernels: bool = True) -> Optional[torch.Tensor]:
    """(R, R, R) bool: cells whose centre is occupied under any expert's
    grid (kernel 11q unless use_kernels=False), dilated `occ_dilate` passes
    in bake-grid space; None when the occupancy state is not ready (the
    bake then evaluates every cell)."""
    if not bool(occ_ready(occ_state)):
        print("[bake] occ_state not ready (warmup incomplete) - baking dense")
        return None
    query = union_binary_fn(occ_state, statics, use_kernels=use_kernels)
    step = 1 << 20
    alive = torch.cat([query(centers[i:i + step])
                       for i in range(0, centers.shape[0], step)])
    alive = alive.reshape(R, R, R)
    for _ in range(max(int(occ_dilate), 0)):
        alive = _dilate3(alive)
    return alive


def bake_field(params, cfg: ContainerConfig, statics: ContainerStatics,
               bcfg: BakedConfig = BakedConfig(), *, aabb=None,
               occ_state: Optional[Dict] = None, occ_dilate: int = 2,
               device="cuda", use_kernels: bool = True) -> Dict:
    """Resample the routed container field into a baked grid on `device`
    -> {"table", "aabb", "corner_pack"[, "block_index"]}.

    Each evaluated cell's radiance over `n_dirs` Fibonacci directions is
    projected onto the SH basis by least squares (rgb clipped to [0, 1],
    sigma to >= 0 first). With a ready `occ_state`, only cells alive under
    the union grid (dilated `occ_dilate` times) are evaluated; the rest
    stay zero. The values are cast to the table dtype before anything tests
    them for zero, then packed dense or block-sparse. use_kernels=False
    evaluates the field through the plain versions on any device (the
    card's reference for the bake)."""
    dev = resolve_device(device)
    params = tree_to(params, dev)
    statics = statics.to(dev)
    R = int(bcfg.resolution)
    box = (statics.global_aabb if aabb is None else torch.as_tensor(
        np.asarray(aabb, np.float32), device=dev))
    lo, hi = box[0], box[1]
    h = (hi - lo) / R

    dirs = _fibonacci_sphere(bcfg.n_dirs)
    proj = torch.from_numpy(sh_projection_matrix(bcfg.sh_levels, dirs)).to(dev)
    dirs_t = torch.from_numpy(dirs).to(dev)
    centers = cell_centers(R, lo, h)

    cells = None
    if occ_state is not None:
        occ = {k: v.to(dev) for k, v in occ_state.items()}
        alive = bake_alive_mask(occ, statics, centers, R, occ_dilate,
                                use_kernels=use_kernels)
        if alive is not None:
            cells = torch.nonzero(alive.reshape(-1)).squeeze(1)
            print(f"[bake] occ skip: {cells.numel()}/{R**3} cells alive "
                  f"({100.0 * cells.numel() / R**3:.1f}%, "
                  f"dilate={occ_dilate})")

    def eval_cells(pts):  # (c, 3) -> (c, C)
        rgb_m, sigma = container_apply_multidir(
            params, cfg, statics, pts, dirs_t, use_kernels=use_kernels)
        rgb_m = torch.clamp(rgb_m, 0.0, 1.0)
        sigma = torch.clamp(sigma, min=0.0)
        coefs = torch.einsum("bm,mcr->cbr", proj, rgb_m)  # (c, B, 3)
        return torch.cat([sigma[:, None], coefs.reshape(pts.shape[0], -1)],
                         dim=1)

    vals = torch.zeros((R**3, bcfg.channels), dtype=torch.float32,
                       device=dev)
    n_eval = R**3 if cells is None else cells.numel()
    step = max(1, min(int(bcfg.chunk_cells), n_eval))
    with torch.no_grad():
        for i in range(0, n_eval, step):
            sel = slice(i, i + step) if cells is None else cells[i:i + step]
            vals[sel] = eval_cells(centers[sel])

    pack = bcfg.resolved_pack(R)
    Cp = bcfg.padded_channels
    vals_t = vals.to(bcfg.table_dtype)
    del vals
    out = {"aabb": torch.stack([lo, hi]).to(torch.float32),
           "corner_pack": pack}
    if not bcfg.sparse_block:
        out["table"] = pack_dense(vals_t, R, Cp, pack)
        return out
    B = int(bcfg.sparse_block)
    comp, index = pack_sparse(vals_t, R, B, Cp, pack)
    nb, total = comp.shape[0] // B**3 - 1, (R // B)**3
    print(f"[bake] sparse pack: {nb}/{total} blocks alive "
          f"({100.0 * nb / total:.1f}%), table "
          f"{comp.numel() * comp.element_size() / 1e9:.2f} GB (dense "
          f"{R**3 * pack * Cp * comp.element_size() / 1e9:.2f})")
    out["table"], out["block_index"] = comp, index
    return out


# ------------------------------------------------------------ snapshots

def _leaves_with_path(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    else:
        yield path, tree


def params_fingerprint(params) -> str:
    """Deterministic fingerprint of a params tree: per leaf its path,
    shape, dtype, float64 sums and strided byte samples (the reference's
    algorithm over the port's tree; it is not equal to the reference's
    fingerprint of the same weights, whose paths are spelled otherwise)."""
    h = hashlib.sha256()
    for path, leaf in sorted(_leaves_with_path(params), key=lambda kv: kv[0]):
        a = np.asarray(leaf.detach().cpu() if torch.is_tensor(leaf) else leaf)
        h.update(path.encode())
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        if a.size:
            af = a.astype(np.float64)
            h.update(np.float64(np.abs(af).sum()).tobytes())
            h.update(np.float64(af.sum()).tobytes())
            raw = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
            h.update(raw[:4096].tobytes())
            if raw.size > 4096:
                h.update(raw[::max(1, raw.size // 1024)].tobytes())
    return h.hexdigest()[:16]


def occ_bake_fingerprint(occ_state: Optional[Dict], occ_dilate: int) -> str:
    """Digest of the occupancy-bake inputs ('' without occupancy): the
    dilate count and the binary grids' bytes (equal to the reference's for
    the same grids)."""
    if occ_state is None:
        return ""
    h = hashlib.sha256()
    h.update(str(int(occ_dilate)).encode())
    h.update(np.asarray(occ_state["binary"].cpu()).tobytes())
    return "occ:" + h.hexdigest()[:16]


def _norm_npz_path(path) -> str:
    p = str(path)
    return p if p.endswith(".npz") else p + ".npz"


def save_baked(path, baked: Dict, bcfg: BakedConfig, *,
               fingerprint: str = "", occ_key: str = "") -> None:
    """Write a snapshot in the reference's .npz format: the arrays (bf16
    stored as uint16) and a JSON `__meta__` with the BakedConfig fields,
    the pack, the dtypes, the params fingerprint and the occupancy key."""
    arrays, dtypes = {}, {}
    for k in ("table", "aabb", "block_index"):
        if k not in baked:
            continue
        t = baked[k].detach().cpu()
        if t.dtype == torch.bfloat16:
            dtypes[k] = "bfloat16"
            arrays[k] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            a = t.numpy()
            dtypes[k] = str(a.dtype)
            arrays[k] = a
    meta = {"bcfg": dataclasses.asdict(bcfg),
            "corner_pack": int(baked["corner_pack"]),
            "dtypes": dtypes,
            "fingerprint": fingerprint,
            "occ_key": occ_key}
    np.savez(_norm_npz_path(path), __meta__=json.dumps(meta), **arrays)


def load_baked(path, bcfg: BakedConfig, *, fingerprint: str = "",
               occ_key: str = "", device="cuda") -> Optional[Dict]:
    """Load a snapshot written by `save_baked` (of either package) onto
    `device`, or None, with the reason printed, when the file is absent or
    was baked under another BakedConfig, params fingerprint or occupancy
    key."""
    dev = resolve_device(device)
    path = _norm_npz_path(path)
    if not os.path.exists(path):
        return None
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["__meta__"]))
    want = dataclasses.asdict(bcfg)
    if meta["bcfg"] != want:
        print(f"[baked] cache {path} ignored: BakedConfig mismatch (cached "
              f"{meta['bcfg']} != requested {want})")
        return None
    if fingerprint and meta.get("fingerprint") \
            and meta["fingerprint"] != fingerprint:
        print(f"[baked] cache {path} ignored: params fingerprint mismatch")
        return None
    if meta.get("occ_key", "") != occ_key:
        print(f"[baked] cache {path} ignored: occ-bake input mismatch "
              f"(cached {meta.get('occ_key', '')!r} != requested "
              f"{occ_key!r})")
        return None

    def arr(k):
        a = z[k]
        if meta.get("dtypes", {}).get(k) == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        return t.to(dev)

    out = {"table": arr("table"), "aabb": arr("aabb"),
           "corner_pack": int(meta["corner_pack"])}
    if "block_index" in z:
        out["block_index"] = arr("block_index")
    return out


# --------------------------------------------------------------- lookup

def _clip_hi(R: int) -> float:
    """The reference's clip bound R - 1.000001, rounded to float32 (equal
    to R - 1 for R >= 64)."""
    return float(np.float32(R - 1.000001))


def table_rows(R: int, block_index: Optional[torch.Tensor] = None,
               block: int = 0):
    """(jx, jy, jz) int64 cell indices -> their table rows: x-major in a
    dense table; in a sparse one the slot read from the block index (dead
    blocks read the zero block at slot 0)."""
    if block_index is None:
        return lambda jx, jy, jz: (jx * R + jy) * R + jz
    B, S = int(block), _SUPER
    Rbs = -(-(R // B) // S)

    def row_of(jx, jy, jz):
        bx, by, bz = jx // B, jy // B, jz // B
        sid = ((bx // S) * Rbs + (by // S)) * Rbs + (bz // S)
        sub = ((bx % S) * S + (by % S)) * S + (bz % S)
        slot = block_index[sid, sub].long()
        return slot * B**3 + ((jx % B) * B + (jy % B)) * B + (jz % B)

    return row_of


def lookup_cells(aabb: torch.Tensor, pts: torch.Tensor, R: int, pack: int):
    """Cell selection of a lookup at pts (N, 3) -> (w (N, 3) lerp weights,
    xs, ys, iz): the lookup reads the rows of cells (x, y, iz) for x in xs
    and y in ys. xs is [ix] for pack 8, else [ix, ix+1 clamped at R-1]; ys
    is [iy] for packs 8 and 4, else [iy, iy+1 clamped]."""
    lo, hi = aabb[0], aabb[1]
    h = (hi - lo) / R
    g = (pts - lo) / h - 0.5
    g = torch.clamp(g, 0.0, _clip_hi(R))
    f = torch.floor(g)
    ix, iy, iz = f[:, 0].long(), f[:, 1].long(), f[:, 2].long()
    xs = [ix] if pack == 8 else [ix, torch.clamp(ix + 1, max=R - 1)]
    ys = [iy] if pack >= 4 else [iy, torch.clamp(iy + 1, max=R - 1)]
    return g - f, xs, ys, iz


def baked_trilerp_plain(table: torch.Tensor, aabb: torch.Tensor,
                        pts: torch.Tensor, R: int, C: int, Cp: int,
                        pack: int, block_index: Optional[torch.Tensor] = None,
                        block: int = 0) -> torch.Tensor:
    """Plain PyTorch version of kernel 8: the trilinear payload (N, C) at
    pts (N, 3), op by op as the reference computes it (`baked_trilerp`),
    with the sparse slot read by direct indexing. Each corner block is
    sliced to its C used channels before the lerps (the padding is never
    part of the result)."""
    row_of = table_rows(R, block_index, block)
    w, xs, ys, iz = lookup_cells(aabb, pts, R, pack)
    wx, wy, wz = w[:, 0:1], w[:, 1:2], w[:, 2:3]

    def blocks(jx, jy, jz):
        r = table[row_of(jx, jy, jz)]
        return [r[:, i * Cp:i * Cp + C].to(torch.float32)
                for i in range(pack)]

    if pack == 8:
        b = blocks(xs[0], ys[0], iz)
        x0 = ((b[0] * (1 - wz) + b[1] * wz) * (1 - wy)
              + (b[2] * (1 - wz) + b[3] * wz) * wy)
        x1 = ((b[4] * (1 - wz) + b[5] * wz) * (1 - wy)
              + (b[6] * (1 - wz) + b[7] * wz) * wy)
        return x0 * (1 - wx) + x1 * wx
    if pack == 4:

        def row4(jx):
            r = blocks(jx, ys[0], iz)
            z0 = r[0] * (1 - wz) + r[1] * wz
            z1 = r[2] * (1 - wz) + r[3] * wz
            return z0 * (1 - wy) + z1 * wy

        return row4(xs[0]) * (1 - wx) + row4(xs[1]) * wx
    (ix, ix1), (iy, iy1) = xs, ys

    def row2(jx, jy):
        r = blocks(jx, jy, iz)
        return r[0] * (1.0 - wz) + r[1] * wz

    return (row2(ix, iy) * (1 - wx) * (1 - wy)
            + row2(ix1, iy) * wx * (1 - wy)
            + row2(ix, iy1) * (1 - wx) * wy
            + row2(ix1, iy1) * wx * wy)


@dataclasses.dataclass(frozen=True)
class BakedLaunchPlan:
    """Launch geometry of kernel 8 (csrc/baked.cu `BakedPlan`): a team of
    `lanes` lanes reads each table row, one 16-byte piece a lane per set;
    a warp takes 32 consecutive points, 32 / lanes teams of it at once."""

    lanes: int  # a team's lanes: pack x pieces padded to 2^qbits / sets
    sets: int  # pieces each lane loads per row (rows wider than 32 pieces)
    qbits: int  # log2 of a corner block's pieces, padded to a power of two
    pieces: int  # a corner block's 16-byte pieces: Cp x itemsize / 16
    warps: int  # per block
    blocks: int  # ceil(N / (32 warps))
    smem: int  # the warps' staged outputs: 32 x C floats each

    @property
    def teams(self) -> int:
        return 32 // self.lanes

    @functools.cached_property
    def struct(self) -> "kernels.BakedPlan":
        return kernels.BakedPlan(self.lanes, self.sets, self.qbits,
                                 self.pieces, self.warps, self.blocks,
                                 self.smem)


# Warps per block: 8, fewer where their staged outputs (32 x C floats a
# warp) would exceed the 48 KB a block has without opting in
BAKED_WARPS = 8
BAKED_SMEM = 48 * 1024


@functools.lru_cache(maxsize=64)
def baked_plan(n: int, pack: int, c: int, cp: int,
               itemsize: int) -> BakedLaunchPlan:
    """Kernel 8's plan for N points of a table of `pack` corner blocks of
    Cp channels (C used) of `itemsize` bytes (2: bf16, 4: f32). A block is
    Cp x itemsize / 16 pieces, padded to a power of two; a row's padded
    pieces spread over a team of at most 32 lanes, the rest over sets."""
    if pack not in (2, 4, 8) or itemsize not in (2, 4):
        raise ValueError(f"baked_trilerp: pack {pack}, itemsize {itemsize}")
    ch = 16 // itemsize
    if cp % ch or not 0 < c <= cp:
        raise ValueError(f"baked_trilerp: Cp={cp} must be a multiple of {ch} "
                         f"and hold C={c}")
    pieces = cp // ch
    qbits = (pieces - 1).bit_length()
    width = pack << qbits
    lanes = min(32, width)
    sets = width // lanes
    if sets > 4:
        raise ValueError(f"baked_trilerp: rows of {pack} x {cp} channels are "
                         f"wider than the kernel's 4 pieces a lane")
    warps = min(BAKED_WARPS, BAKED_SMEM // (32 * 4 * c))
    if warps < 1:
        raise ValueError(f"baked_trilerp: C={c} outputs a point exceed the "
                         f"staging buffer")
    return BakedLaunchPlan(lanes=lanes, sets=sets, qbits=qbits,
                           pieces=pieces, warps=warps,
                           blocks=max(1, -(-n // (32 * warps))),
                           smem=32 * 4 * c * warps)


def baked_trilerp_kernel(table: torch.Tensor, aabb: torch.Tensor,
                         pts: torch.Tensor, R: int, C: int, Cp: int,
                         pack: int, block_index: Optional[torch.Tensor] = None,
                         block: int = 0) -> torch.Tensor:
    """Kernel 8's wrapper: the plain version for a CPU tensor; on a CUDA
    tensor it launches `baked_trilerp` or raises."""
    kernels.check_no_grad("baked_trilerp", pts, table)
    if pts.device.type == "cpu":
        return baked_trilerp_plain(table, aabb, pts, R, C, Cp, pack,
                                   block_index, block)
    if pts.device.type != "cuda":
        raise ValueError(f"baked_trilerp: unsupported device {pts.device}")
    dev = pts.device
    if pts.dim() != 2 or pts.shape[1] != 3:
        raise ValueError("baked_trilerp: pts must be (N, 3)")
    if pack not in (2, 4, 8) or table.dim() != 2 \
            or table.shape[1] != pack * Cp or tuple(aabb.shape) != (2, 3):
        raise ValueError("baked_trilerp: table must be (rows, pack*Cp) with "
                         "pack in 2/4/8, aabb (2, 3)")
    if block_index is not None:
        Rbs = -(-(R // block) // _SUPER)
        if tuple(block_index.shape) != (Rbs**3, _SUPER**3):
            raise ValueError(f"baked_trilerp: block_index must be "
                             f"({Rbs**3}, {_SUPER**3})")
    kernels.check_cuda_tensors("baked_trilerp", dev, pts=pts, table=table,
                               aabb=aabb, block_index=block_index)
    if not aligned(table) or table.shape[0] >= 2**31:
        raise ValueError("baked_trilerp: the table must be 16-byte aligned "
                         "with fewer than 2^31 rows")
    N = pts.shape[0]
    plan = baked_plan(N, pack, C, Cp, table.element_size())
    out = torch.empty((N, C), dtype=torch.float32, device=dev)
    kernels.BAKED_TRILERP(
        pts.data_ptr(), table.data_ptr(), int(table.dtype == torch.bfloat16),
        aabb.data_ptr(),
        None if block_index is None else block_index.data_ptr(),
        out.data_ptr(), N, R, C, Cp, pack, int(block), plan.struct,
        kernels.stream_ptr(pts))
    return out


def baked_trilerp(baked: Dict, bcfg: BakedConfig, pts: torch.Tensor, *,
                  use_kernels: bool = True) -> torch.Tensor:
    """Trilinear payload (N, C) at pts (N, 3); the pack follows from the
    table's row width. use_kernels=False runs the plain version on any
    device."""
    Cp = bcfg.padded_channels
    table = baked["table"]
    pack = int(table.shape[1]) // Cp
    sparse = "block_index" in baked
    if sparse != bool(bcfg.sparse_block):
        raise ValueError(
            f"baked_trilerp: baked dict sparsity does not match "
            f"bcfg.sparse_block={bcfg.sparse_block}; bake and render must "
            f"share the BakedConfig")
    fn = baked_trilerp_kernel if use_kernels else baked_trilerp_plain
    return fn(table, baked["aabb"], pts, int(bcfg.resolution), bcfg.channels,
              Cp, pack, baked.get("block_index"), int(bcfg.sparse_block))


def baked_query(baked: Dict, bcfg: BakedConfig, pts: torch.Tensor,
                dirs: torch.Tensor):
    """Trilinear (rgb (N, 3), sigma (N,)) at pts viewed along dirs."""
    B = bcfg.n_bases
    val = baked_trilerp(baked, bcfg, pts)
    sigma = torch.clamp(val[:, 0], min=0.0)
    sh = sh_encode(dirs, levels=int(bcfg.sh_levels))  # (N, B)
    rgb = torch.einsum("nb,nbc->nc", sh, val[:, 1:].reshape(-1, B, 3))
    return torch.clamp(rgb, 0.0, 1.0), sigma


def render_rays_baked(baked: Dict, bcfg: BakedConfig, rays: torch.Tensor,
                      n_samples: int,
                      generator: Optional[torch.Generator] = None, *,
                      randomized: bool = False, bg_policy: str = "white",
                      bg_fn=None, use_kernels: bool = True):
    """Stratified render over the baked grid -> (rgb, depth, weights, acc),
    with render_rays_stratified's validity and background rules. The SH
    basis is evaluated once per ray; compositing is kernel 4."""
    o, d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6], rays[:, 7]
    n_rays = o.shape[0]
    valid = (torch.isfinite(near) & torch.isfinite(far) & (far > near)
             & (far < 1e9))
    near_s = torch.where(valid, near, torch.zeros_like(near))
    far_s = torch.where(valid, far, torch.ones_like(far))

    t_vals = stratified_t_vals(near_s, far_s, n_samples, randomized,
                               generator)
    pts = t_to_points(o, d, t_vals)
    B = bcfg.n_bases
    val = baked_trilerp(baked, bcfg, pts.reshape(-1, 3).contiguous(),
                        use_kernels=use_kernels)
    val = val.reshape(n_rays, n_samples, -1)
    sigma = torch.where(valid[:, None], torch.clamp(val[..., 0], min=0.0),
                        torch.zeros((), device=val.device))
    sh = sh_encode(d, levels=int(bcfg.sh_levels))  # (n_rays, B)
    rgb = torch.einsum("nb,nsbc->nsc", sh,
                       val[..., 1:].reshape(n_rays, n_samples, B, 3))
    rgb = torch.clamp(rgb, 0.0, 1.0)

    if bg_fn is not None:
        bg = bg_fn(d)
    else:
        bg = background_rgb(bg_policy, n_rays, generator=generator,
                            last_sample_rgb=rgb[:, -1, :], dtype=rgb.dtype,
                            device=rgb.device)
    rgb_sigma = torch.cat([rgb, sigma[..., None]], dim=-1)
    return volume_render(rgb_sigma, t_vals,
                         bg_rgb=None if bg is None else bg.contiguous(),
                         use_kernels=use_kernels)


def _baked_to(baked: Dict, dev: torch.device) -> Dict:
    return {k: v.to(dev) if torch.is_tensor(v) else v
            for k, v in baked.items()}


def make_baked_camera_renderer(
    baked: Dict,
    bcfg: BakedConfig,
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
    bg_policy: str = "white",
    use_bg_fn: bool = True,
    fog_stats: bool = False,
    out_u8: bool = True,
    invalid_black: bool = False,
    map_outputs=None,
    device="cuda",
    use_kernels: bool = True,
):
    """Serving-path frame renderer over the snapshot: (params, statics, c2w
    (3, 4), intrinsics (4,), *extra) -> (H, W, 3) uint8, or with
    out_u8=False f32 rgb (H, W, 3), depth and acc (H, W); with map_outputs
    its (H, W, k) result. Rays are generated on the device chunk by chunk;
    every chunk is dispatched before the one fetch of the frame. params is
    read only for the learned background."""
    dev = resolve_device(device)
    sb = None
    if scene_aabb is not None:
        sb = SceneBox(torch.as_tensor(np.asarray(scene_aabb, np.float32),
                                      device=dev))
    elif near is None or far is None:
        raise ValueError("provide scene_aabb or scalar near/far")
    baked_dev = _baked_to(baked, dev)
    n_pix = H * W

    def chunk_fn(params, statics, c2w, intr, start, *extra):
        rays = frame_chunk_rays_biased(
            c2w, intr, start, chunk_rays, H, W, scene_box=sb, near=near,
            far=far, near_override=near_override, far_override=far_override,
            near_bias=near_bias)
        bg_fn = container_bg_fn(params, cfg) if use_bg_fn else None
        rgb, depth, weights, acc = render_rays_baked(
            baked_dev, bcfg, rays, ray_samples, bg_policy=bg_policy,
            bg_fn=bg_fn, use_kernels=use_kernels)
        return shape_frame_outputs(
            rays, rgb, depth, weights, acc, *extra, fog_stats=fog_stats,
            invalid_black=invalid_black, map_outputs=map_outputs,
            out_u8=out_u8)

    def render(params, statics, c2w, intrinsics, *extra):
        c2w_t = torch.from_numpy(
            np.array(np.asarray(c2w, np.float32)[:3, :4])).to(dev)
        intr_t = torch.from_numpy(
            np.array(np.asarray(intrinsics, np.float32)[:4])).to(dev)
        with torch.no_grad():
            pending = [chunk_fn(params, statics, c2w_t, intr_t, s, *extra)
                       for s in range(0, n_pix, chunk_rays)]
            out = torch.cat(pending, dim=0)[:n_pix].cpu().numpy()
        if map_outputs is not None or out_u8:
            return out.reshape(H, W, -1)
        return (out[:, 0:3].reshape(H, W, 3).copy(),
                out[:, 3].reshape(H, W).copy(),
                out[:, 4].reshape(H, W).copy())

    return render


def make_baked_chunk_renderer(
    baked: Dict,
    bcfg: BakedConfig,
    cfg: ContainerConfig,
    *,
    ray_samples: int,
    bg_policy: str = "white",
    use_bg_fn: bool = True,
    fog_stats: bool = False,
    map_outputs=None,
    mesh=None,
    device="cuda",
    use_kernels: bool = True,
) -> ChunkRenderer:
    """Chunk renderer over the snapshot, a drop-in for `render_image` /
    `render_rays_chunked`: (params, statics, rays (C, 8), *extra) -> (rgb,
    depth, acc), plus the per-ray (wmax, entropy) with fog_stats, or
    map_outputs(rgb, depth, acc, *extra). params is read only for the
    learned background."""
    if mesh is not None:
        raise NotImplementedError("mesh-sharded rendering is not ported")
    dev = resolve_device(device)
    baked_dev = _baked_to(baked, dev)

    def render_fn(params, statics, rays, *extra):
        bg_fn = container_bg_fn(params, cfg) if use_bg_fn else None
        rgb, depth, weights, acc = render_rays_baked(
            baked_dev, bcfg, rays, ray_samples, bg_policy=bg_policy,
            bg_fn=bg_fn, use_kernels=use_kernels)
        if fog_stats:
            return (rgb, depth, acc) + _fog_stats(weights)
        if map_outputs is not None:
            return map_outputs(rgb, depth, acc, *extra)
        return rgb, depth, acc

    return ChunkRenderer(render_fn, dev)
