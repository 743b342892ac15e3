"""Build and load the port's hand-written CUDA kernels (route: nvcc + ctypes).

Every kernel source in `nerfsys_tpu_torch/csrc/` is compiled on first use by
`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`
into its own shared library under `nerfsys_tpu_torch/_build/` (listed in
.gitignore) and loaded with `ctypes`. The C entry points take raw device
pointers (`tensor.data_ptr()`), sizes and PyTorch's current stream; each
returns `cudaGetLastError()` after its launch, and `Kernel.__call__` raises
when that is not 0. Nothing here imports or builds anything at import time.

`build_all()` starts one `nvcc` per source, all at once, and waits for them:
a cold build costs the slowest single file, not the sum.

Each `Kernel` keeps a plain integer launch counter (`launches`), raised by
one exactly where its kernel is launched; `reset_launches()` zeroes them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# library stem -> (source file, extra nvcc flags). The probe, the sampler
# and the point query compile with --fmad=false so that no multiply-add is
# contracted: their cell selection, interval counts and lerps then round
# exactly like the plain PyTorch versions, which run one elementwise op per
# kernel. The
# encoder backward does too: its light mode rounds the recomputed plane and
# line values to bfloat16, and a value one float32 ulp away can round to
# the neighbouring bfloat16. So does the baked lookup, whose cell selection
# and lerp tree then match the plain version bit for bit. So does the hash
# grid: a contracted x * scale + 0.5 or corner weight can move a point into
# the neighbouring cell, at a hashed level an unrelated row. So do the
# bucket dispatch and the coherent-expert test: their routing distances
# must round as the plain versions' do, or a near tie picks another expert.
# So does the plane encoder's forward: its features feed the MLP's ReLUs,
# and a feature one ulp off flips a unit whose pre-activation lies within
# rounding of zero, which moves that point's whole gradient (contracted,
# a FoMAML step on a real scene missed the plain step's gradients by
# 5.1e-3 of a leaf's max on an H100, chip_smoke's trainer check). So
# does trunc_exp (row 12), whose values must equal the plain version's bit
# for bit, though none of its products meets an add.
SOURCES: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "planes": ("planes.cu", ("--fmad=false",)),
    "occ_probe": ("occ_probe.cu", ("--fmad=false",)),
    "occ_sample": ("occ_sample.cu", ("--fmad=false",)),
    "volrend": ("volrend.cu", ()),
    "volrend_bwd": ("volrend_bwd.cu", ()),
    "volrend_bwd2": ("volrend_bwd2.cu", ()),
    "planes_bwd": ("planes_bwd.cu", ("--fmad=false",)),
    "planes_bwd2": ("planes_bwd2.cu", ("--fmad=false",)),
    "baked": ("baked.cu", ("--fmad=false",)),
    "composite_seg": ("composite_seg.cu", ()),
    "hash_grid": ("hash_grid.cu", ("--fmad=false",)),
    "bucket": ("bucket.cu", ("--fmad=false",)),
    "coherent": ("coherent.cu", ("--fmad=false",)),
    "occ_query": ("occ_query.cu", ("--fmad=false",)),
    "activations": ("activations.cu", ("--fmad=false",)),
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}  # stem -> nvcc's stderr (ptxas register use)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                           "build the port's kernels")
    return path


def _lib_path(stem: str) -> Path:
    src, extra = SOURCES[stem]
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / src]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS + extra).encode())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def _start_build(stem: str) -> Tuple[subprocess.Popen, Path, Path]:
    src, extra = SOURCES[stem]
    out = _lib_path(stem)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp), str(CSRC / src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, out


def _finish_build(stem: str, proc, tmp: Path, out: Path) -> None:
    stdout, stderr = proc.communicate()
    build_log[stem] = (stdout or "") + (stderr or "")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {SOURCES[stem][0]} "
                           f"(rc {proc.returncode}):\n{build_log[stem]}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def build_all(stems: Sequence[str] = tuple(SOURCES)) -> float:
    """Compile every missing library in parallel; returns wall seconds."""
    t0 = time.perf_counter()
    jobs = [(s, *_start_build(s)) for s in stems if not _lib_path(s).exists()]
    errors = []
    for stem, proc, tmp, out in jobs:
        try:
            _finish_build(stem, proc, tmp, out)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def library(stem: str) -> ctypes.CDLL:
    """The loaded shared library for `stem`, building it first if needed."""
    lib = _libs.get(stem)
    if lib is None:
        path = _lib_path(stem)
        if not path.exists():
            _finish_build(stem, *_start_build(stem))
        lib = ctypes.CDLL(str(path))
        lib.nerfsys_cuda_error_string.argtypes = [_I]
        lib.nerfsys_cuda_error_string.restype = ctypes.c_char_p
        _libs[stem] = lib
    return lib


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


class Kernel:
    """One C entry point of one library, with its launch counter."""

    def __init__(self, name: str, stem: str, symbol: str, argtypes,
                 replaces: str):
        self.name = name
        self.stem = stem
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces  # file:line of the JAX op it ports
        self.launches = 0
        self._fn = None

    @property
    def source(self) -> str:
        return f"nerfsys_tpu_torch/csrc/{SOURCES[self.stem][0]}"

    def __call__(self, *args) -> None:
        if self._fn is None:
            lib = library(self.stem)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = _I
            self._fn = fn
        self.launches += 1
        rc = self._fn(*args)
        if rc != 0:
            msg = library(self.stem).nerfsys_cuda_error_string(rc)
            raise RuntimeError(f"kernel {self.name}: CUDA error {rc} "
                               f"({msg.decode() if msg else '?'})")


class PlaneLevels(ctypes.Structure):
    """Per-level table pointers and resolutions (csrc/planes.cu PlaneLevels)."""
    MAX_LEVELS = 8
    _fields_ = [
        ("planes", _P * 8),
        ("lines", _P * 8),
        ("res", _I * 8),
        ("clip_hi", _F * 8),
        ("levels", _I),
        ("has_lines", _I),
    ]


class PlanePlan(ctypes.Structure):
    """A launch plan of kernels 1, 5, 6, 5'' and 6'' (csrc/planes.cu
    PlanePlan; filled from ops/planes.py `PlaneLaunchPlan`)."""
    _fields_ = [
        ("tile", _I),
        ("threads", _I),
        ("blocks", _I),
        ("smem", _I),
        ("vec", _I),
        ("line_ofs", _I * 8),
        ("sms", _I),
    ]


class PlaneGrads(ctypes.Structure):
    """Per-level gradient table pointers (csrc/planes_bwd.cu PlaneGrads)."""
    _fields_ = [
        ("planes", _P * 8),
        ("lines", _P * 8),
    ]


PLANES_FWD = Kernel(
    "plane_encode_fwd", "planes", "plane_encode_fwd",
    # x, out, levels (by value), K, N, F, plan (by value), stream
    [_P, _P, PlaneLevels, _I, _I, _I, PlanePlan, _P],
    replaces="nerfsys_tpu/ops/planes.py:269 (_plane_encode_parts)",
)
PLANES_FWD_LINES_BF16 = Kernel(  # kernel 1b
    "plane_encode_fwd_lines_bf16", "planes", "plane_encode_fwd_lines_bf16",
    # the same arguments as plane_encode_fwd
    [_P, _P, PlaneLevels, _I, _I, _I, PlanePlan, _P],
    replaces="nerfsys_tpu/ops/planes.py:224-266 (_linear_rows_mm with "
             "lines_mm_dtype='bfloat16', from _plane_encode_parts :288)",
)


class ProbePlan(ctypes.Structure):
    """A launch plan of kernel 2 (csrc/occ_probe.cu ProbePlan; filled from
    ops/occupancy.py `ProbeLaunchPlan`)."""
    _fields_ = [
        ("lane_map", _I),  # 0 "probes", 1 "rays"
        ("rays", _I),
        ("threads", _I),
        ("blocks", _I),
        ("stride", _I),
        ("smem", _I),
        ("group", _I),
        ("chunks", _I),
    ]


OCC_PROBE_CDF = Kernel(
    "occupancy_probe_cdf", "occ_probe", "occupancy_probe_cdf",
    # o, d, near, far, mids, occs, binary, level table, cdf, alive, occ,
    # N, P, K, L, R, importance, c_imp, c_uni, c_keep, c_floor,
    # plan (by value), stream
    [_P] * 11 + [_I] * 6 + [_F] * 4 + [ProbePlan, _P],
    replaces="nerfsys_tpu/ops/occupancy.py:394 (occupancy_probe_cdf)",
)


class SamplePlan(ctypes.Structure):
    """A launch plan of kernel 3 (csrc/occ_sample.cu SamplePlan; filled
    from ops/occupancy.py `SampleLaunchPlan`)."""
    _fields_ = [
        ("warps", _I),
        ("threads", _I),
        ("blocks", _I),
        ("stride", _I),
        ("smem", _I),
        ("top", _I),
    ]


OCC_SAMPLE = Kernel(
    "sample_tvals_from_cdf", "occ_sample", "sample_tvals_from_cdf",
    # cdf, near, far, u, edges, probe bits (nullable), t_vals, mask
    # (nullable with the bits), branch counts (nullable), N, P, S,
    # u_per_ray, plan (by value), stream
    [_P] * 9 + [_I] * 4 + [SamplePlan, _P],
    replaces="nerfsys_tpu/ops/occupancy.py:468 (sample_tvals_from_cdf, "
             "with_mask)",
)


class VolrendPlan(ctypes.Structure):
    """A launch plan of kernel 4 and its VJP (csrc/volrend_common.cuh
    VolrendPlan; filled from ops/volrend.py `VolrendLaunchPlan`)."""
    _fields_ = [
        ("lanes", _I),
        ("pieces", _I),
        ("threads", _I),
        ("blocks", _I),
        ("smem", _I),
    ]


class RayLanePlan(ctypes.Structure):
    """A launch plan of rows 8 and 10b (csrc/volrend_common.cuh
    RayLanePlan; filled from ops/volrend.py `RayLaneLaunchPlan`)."""
    _fields_ = [
        ("lanes", _I),
        ("pieces", _I),
        ("groups", _I),
        ("threads", _I),
        ("blocks", _I),
    ]


VOLREND_FWD = Kernel(
    "volume_render_fwd", "volrend", "volume_render_fwd",
    # rgb_sigma, t_vals, bg (nullable), rgb, depth, weights, acc,
    # N, S, scale_on, sigma_scale, plan (by value), stream
    [_P] * 7 + [_I] * 3 + [_F, VolrendPlan, _P],
    replaces="nerfsys_tpu/ops/volrend.py:57,81 (render_weights, "
             "volume_render)",
)
VOLREND_BWD = Kernel(
    "volume_render_bwd", "volrend_bwd", "volume_render_bwd",
    # rgb_sigma, t_vals, bg, g_rgb, g_depth, g_weights, g_acc (the last
    # five nullable), g_rgb_sigma, g_bg (nullable), N, S, scale_on,
    # sigma_scale, plan (by value), stream
    [_P] * 9 + [_I] * 3 + [_F, VolrendPlan, _P],
    replaces="nerfsys_tpu/ops/volrend.py:81 (volume_render, its VJP)",
)
VOLREND_BWD2 = Kernel(
    "volume_render_bwd2", "volrend_bwd2", "volume_render_bwd2",
    # rgb_sigma, t_vals, bg, g_rgb, g_depth, g_weights, g_acc (the last
    # five nullable), v_rgb_sigma, v_bg (nullable), d_rgb_sigma, d_bg,
    # d_g_rgb, d_g_depth, d_g_weights, d_g_acc (the last five nullable),
    # N, S, scale_on, sigma_scale, plan (by value), stream
    [_P] * 15 + [_I] * 3 + [_F, VolrendPlan, _P],
    replaces="nerfsys_tpu/ops/volrend.py:57,81 (autodiff of volume_render's "
             "VJP: the second derivative MAML takes)",
)
PLANES_BWD_LIGHT = Kernel(
    "plane_encode_bwd_light", "planes_bwd", "plane_encode_bwd_light",
    # x, ct, levels, grads (by value), K, N, F, plan (by value), stream
    [_P, _P, PlaneLevels, PlaneGrads, _I, _I, _I, PlanePlan, _P],
    replaces="nerfsys_tpu/ops/planes.py:565 (_plane_encode_mm_light_bwd)",
)
PLANES_BWD_LIGHT_LINES_BF16 = Kernel(  # kernel 5b
    "plane_encode_bwd_light_lines_bf16", "planes_bwd",
    "plane_encode_bwd_light_lines_bf16",
    # the same arguments as plane_encode_bwd_light
    [_P, _P, PlaneLevels, PlaneGrads, _I, _I, _I, PlanePlan, _P],
    replaces="nerfsys_tpu/ops/planes.py:565 (_plane_encode_mm_light_bwd on "
             "the residuals of the bfloat16 line matmuls, :547-560)",
)
PLANES_BWD = Kernel(
    "plane_encode_bwd", "planes_bwd", "plane_encode_bwd",
    # x, ct, levels, grads (by value), gx, K, N, F, plan (by value), stream
    [_P, _P, PlaneLevels, PlaneGrads, _P, _I, _I, _I, PlanePlan, _P],
    replaces="nerfsys_tpu/ops/planes.py:449 (_plane_encode_mm_bwd)",
)

PLANES_BWD2_LIGHT = Kernel(
    "plane_encode_bwd2_light", "planes_bwd2", "plane_encode_bwd2_light",
    # x, ct, tables, their cotangents (both by value), d tables (by value),
    # d ct, K, N, F, plan (by value), stream
    [_P, _P, PlaneLevels, PlaneLevels, PlaneGrads, _P, _I, _I, _I,
     PlanePlan, _P],
    replaces="nerfsys_tpu/ops/planes.py:565 (autodiff of "
             "_plane_encode_mm_light_bwd with its bf16 residuals :542: the "
             "second derivative MAML takes)",
)
PLANES_BWD2_LIGHT_LINES_BF16 = Kernel(  # kernel 5''b
    "plane_encode_bwd2_light_lines_bf16", "planes_bwd2",
    "plane_encode_bwd2_light_lines_bf16",
    # the same arguments as plane_encode_bwd2_light
    [_P, _P, PlaneLevels, PlaneLevels, PlaneGrads, _P, _I, _I, _I,
     PlanePlan, _P],
    replaces="nerfsys_tpu/ops/planes.py:565 (autodiff of "
             "_plane_encode_mm_light_bwd through the bfloat16 line matmuls "
             "_linear_rows_mm :224-266 that form its residuals :542-561: "
             "the second derivative MAML takes under bfloat16 line matmuls)",
)
PLANES_BWD2 = Kernel(
    "plane_encode_bwd2", "planes_bwd2", "plane_encode_bwd2",
    # the same arguments as plane_encode_bwd2_light
    [_P, _P, PlaneLevels, PlaneLevels, PlaneGrads, _P, _I, _I, _I,
     PlanePlan, _P],
    replaces="nerfsys_tpu/ops/planes.py:449 (autodiff of "
             "_plane_encode_mm_bwd: the second derivative MAML takes)",
)


class BakedPlan(ctypes.Structure):
    """A launch plan of kernel 8 (csrc/baked.cu BakedPlan; filled from
    models/baked.py `BakedLaunchPlan`)."""
    _fields_ = [
        ("lanes", _I),
        ("sets", _I),
        ("qbits", _I),
        ("pieces", _I),
        ("warps", _I),
        ("blocks", _I),
        ("smem", _I),
    ]


BAKED_TRILERP = Kernel(
    "baked_trilerp", "baked", "baked_trilerp",
    # pts, table, table_bf16, aabb, block_index (nullable), out,
    # N, R, C, Cp, pack, Bs, plan (by value), stream
    [_P, _P, _I, _P, _P, _P] + [_I] * 6 + [BakedPlan, _P],
    replaces="nerfsys_tpu/models/baked.py:647 (baked_trilerp)",
)

COMPOSITE_SEG = Kernel(
    "composite_segment", "composite_seg", "composite_segment_fwd",
    # carry rgb, depth, acc, trans, wmax, wlogw (the last two nullable),
    # rgb, sigma, t, dt, out rgb, depth, acc, trans, wmax, wlogw (nullable),
    # N, s, t_stride, d_stride, fog, plan (by value), stream
    [_P] * 16 + [_I] * 5 + [RayLanePlan, _P],
    replaces="nerfsys_tpu/ops/volrend.py:153 (composite_segment)",
)


class HashLevels(ctypes.Structure):
    """Per-level scales, resolutions and dense flags of the hash grid, and
    its layout (csrc/hash_grid.cu HashLevels)."""
    MAX_LEVELS = 32
    _fields_ = [
        ("scale", _F * 32),
        ("res", _I * 32),
        ("dense", _I * 32),
        ("levels", _I),
        ("log2_size", _I),
        ("tcnn", _I),
        ("mode", _I),  # 0 Linear, 1 Smoothstep, 2 Nearest
    ]


class HashPlan(ctypes.Structure):
    """A launch plan of kernels 7a, 7b and 7c (csrc/hash_grid.cu HashPlan;
    filled from ops/encodings.py `HashLaunchPlan`)."""
    _fields_ = [
        ("tile", _I),
        ("threads", _I),
        ("blocks", _I),
        ("smem", _I),
        ("lane_map", _I),  # 0 "samples", 1 "rays"
        ("vec", _I),
        ("level_group", _I),
    ]


HASH_FEATURES = (1, 2, 4, 8)  # features per level the hash kernels take

HASH_FWD = Kernel(
    "hash_encode_fwd", "hash_grid", "hash_encode_fwd",
    # x, table, out, levels (by value), K, N, F, plan (by value), stream
    [_P, _P, _P, HashLevels, _I, _I, _I, HashPlan, _P],
    replaces="nerfsys_tpu/ops/encodings.py:345 (hash_grid_encode_fused with "
             "_encode_indices_weights :406; hash_grid_encode :256 for "
             "Nearest)",
)
HASH_FWD_PACKED = Kernel(
    "hash_encode_fwd_packed", "hash_grid", "hash_encode_fwd_packed",
    # x, table, out, levels (by value), K, N, plan (by value), stream
    [_P, _P, _P, HashLevels, _I, _I, HashPlan, _P],
    replaces="nerfsys_tpu/ops/encodings.py:491 (hash_grid_encode_packed, "
             "_packed_fwd :506)",
)
HASH_BWD = Kernel(
    "hash_encode_bwd", "hash_grid", "hash_encode_bwd",
    # x, dout, dtable, levels (by value), K, N, F, plan (by value), stream
    [_P, _P, _P, HashLevels, _I, _I, _I, HashPlan, _P],
    replaces="nerfsys_tpu/ops/encodings.py:511 (_packed_bwd, and the "
             "row_gather transpose of hash_grid_encode_fused :345)",
)


class DispatchPlan(ctypes.Structure):
    """A launch plan of kernel 10a-i (csrc/bucket.cu DispatchPlan; filled
    from models/container.py `DispatchLaunchPlan`)."""
    _fields_ = [
        ("tile", _I),
        ("tiles", _I),
        ("fill_blocks", _I),
        ("fill_threads", _I),
    ]


BUCKET_DISPATCH = Kernel(
    "bucket_dispatch", "bucket", "bucket_dispatch",
    # pts, dirs (nullable), centroids, idx, w, dest, counts, bucket_rows,
    # rows, status scratch, N, K, E, C, cluster_2d, margin, plan (by
    # value), stream
    [_P] * 10 + [_I] * 5 + [_F, DispatchPlan, _P],
    replaces="nerfsys_tpu/models/container.py:279 (_bucketed_eval: top-E "
             "routing, the counting sort into buckets, the row gather "
             ":301-350)",
)
BUCKET_COMBINE_FWD = Kernel(
    "bucket_combine_fwd", "bucket", "bucket_combine_fwd",
    # w, dest, sigma_b, rgb_b (nullable), sigma, rgb (nullable), N, E,
    # n_slots, stream
    [_P] * 6 + [_I] * 3 + [_P],
    replaces="nerfsys_tpu/models/container.py:363 (_bucketed_eval's "
             "reshape-sum blend)",
)


class CombinePlan(ctypes.Structure):
    """A launch plan of kernel 10a-iii (csrc/bucket.cu CombinePlan; filled
    from models/container.py `CombineLaunchPlan`)."""
    _fields_ = [
        ("tile", _I),
        ("tiles", _I),
        ("fill_blocks", _I),
    ]


BUCKET_COMBINE_BWD = Kernel(
    "bucket_combine_bwd", "bucket", "bucket_combine_bwd",
    # w, dest, counts, g_sigma, g_rgb (nullable), g_sigma_b, g_rgb_b
    # (nullable), N, K, E, C, plan (by value), stream
    [_P] * 7 + [_I] * 4 + [CombinePlan, _P],
    replaces="nerfsys_tpu/models/container.py:363 (the blend's VJP)",
)
COHERENT_EXPERT = Kernel(
    "coherent_expert", "coherent", "coherent_expert",
    # pts (N, S, 3), centroids, out, N, S, K, cluster_2d, margin, plan (by
    # value), stream
    [_P] * 3 + [_I] * 4 + [_F, RayLanePlan, _P],
    replaces="nerfsys_tpu/models/container.py:198 (routing_coherent_expert)",
)

OCC_QUERY = Kernel(
    "occupancy_query", "occ_query", "occupancy_query",
    # pts, occs (nullable), binary (nullable), level table, bits out
    # (nullable), values out (nullable), M, K, L, R, stream
    [_P] * 6 + [_L] + [_I] * 3 + [_P],
    replaces="nerfsys_tpu/ops/occupancy.py:159,179,196 (query_binary, "
             "query_values, query_pair: one row_gather a point, "
             "ops/gather.py:40; unioned as models/occupancy.py:47-118)",
)

TRUNC_EXP_FWD = Kernel(
    "trunc_exp_fwd", "activations", "trunc_exp_fwd",
    # x, y, n, m, vec, cover, blocks, stream
    [_P, _P, _L, _F, _I, _I, _I, _P],
    replaces="nerfsys_tpu/ops/activations.py:32 (trunc_exp, its forward "
             "_trunc_exp_fwd :37)",
)
TRUNC_EXP_BWD = Kernel(
    "trunc_exp_bwd", "activations", "trunc_exp_bwd",
    # g, y, gx, n, vec, blocks, stream
    [_P, _P, _P, _L, _I, _I, _P],
    replaces="nerfsys_tpu/ops/activations.py:43 (_trunc_exp_bwd)",
)
TRUNC_EXP_BWD2 = Kernel(
    "trunc_exp_bwd2", "activations", "trunc_exp_bwd2",
    # v, g, x, d g, d x, n, m, vec, blocks, stream
    [_P] * 5 + [_L, _F, _I, _I, _P],
    replaces="nerfsys_tpu/ops/activations.py:32-47 (autodiff of "
             "_trunc_exp_bwd through the residual exp(clip(x)): the second "
             "derivative MAML takes)",
)

KERNELS = (PLANES_FWD, OCC_PROBE_CDF, OCC_SAMPLE, VOLREND_FWD, VOLREND_BWD,
           PLANES_BWD_LIGHT, PLANES_BWD, BAKED_TRILERP, COMPOSITE_SEG,
           HASH_FWD, HASH_FWD_PACKED, HASH_BWD, BUCKET_DISPATCH,
           BUCKET_COMBINE_FWD, BUCKET_COMBINE_BWD, COHERENT_EXPERT,
           OCC_QUERY, VOLREND_BWD2, PLANES_BWD2_LIGHT, PLANES_BWD2,
           TRUNC_EXP_FWD, TRUNC_EXP_BWD, TRUNC_EXP_BWD2,
           PLANES_FWD_LINES_BF16, PLANES_BWD_LIGHT_LINES_BF16,
           PLANES_BWD2_LIGHT_LINES_BF16)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> Dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def check_no_grad(name: str, *tensors) -> None:
    """Raise when a kernel wrapper is reached with grad mode on and an input
    that requires grad: its output would carry no grad_fn, so a loss built
    on it would drop those gradients silently. Differentiable callers go
    through the op's autograd Function, whose forward runs without grad."""
    if not torch.is_grad_enabled():
        return
    if any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel wrapper has no backward; call the op's "
            f"differentiable entry point (or run under torch.no_grad())")


# inputs the kernels read in another dtype than float32, by keyword
_DTYPES = {
    "binary": (torch.bool,),
    "occ": (torch.bool,),
    "table": (torch.float32, torch.bfloat16),
    "block_index": (torch.int32,),
    "dest": (torch.int32,),
    "counts": (torch.int32,),
    "branch_counts": (torch.int32,),
}


def check_cuda_tensors(name: str, device: torch.device, **tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on `device`
    with a dtype the kernel reads (float32, or those of `_DTYPES` for the
    keywords named there)."""
    for key, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        want = _DTYPES.get(key, (torch.float32,))
        if t.dtype not in want:
            raise TypeError(f"{name}: {key} has dtype {t.dtype}, expected "
                            f"one of {want}")
