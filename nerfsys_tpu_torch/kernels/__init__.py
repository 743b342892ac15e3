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

# library stem -> (source file, extra nvcc flags). The probe and sampler
# compile with --fmad=false so that no multiply-add is contracted: their
# cell selection, interval counts and lerps then round exactly like the
# plain PyTorch versions, which run one elementwise op per kernel. The
# encoder backward does too: its light mode rounds the recomputed plane and
# line values to bfloat16, and a value one float32 ulp away can round to
# the neighbouring bfloat16.
SOURCES: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "planes": ("planes.cu", ()),
    "occ_probe": ("occ_probe.cu", ("--fmad=false",)),
    "occ_sample": ("occ_sample.cu", ("--fmad=false",)),
    "volrend": ("volrend.cu", ()),
    "volrend_bwd": ("volrend_bwd.cu", ()),
    "planes_bwd": ("planes_bwd.cu", ("--fmad=false",)),
}

_P = ctypes.c_void_p
_I = ctypes.c_int
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


class PlaneGrads(ctypes.Structure):
    """Per-level gradient table pointers (csrc/planes_bwd.cu PlaneGrads)."""
    _fields_ = [
        ("planes", _P * 8),
        ("lines", _P * 8),
    ]


PLANES_FWD = Kernel(
    "plane_encode_fwd", "planes", "plane_encode_fwd",
    # x, out, levels (by value), K, N, F, stream
    [_P, _P, PlaneLevels, _I, _I, _I, _P],
    replaces="nerfsys_tpu/ops/planes.py:269 (_plane_encode_parts)",
)
OCC_PROBE_CDF = Kernel(
    "occupancy_probe_cdf", "occ_probe", "occupancy_probe_cdf",
    # o, d, near, far, mids, occs, binary, level_aabbs, cdf, alive, occ,
    # N, P, K, L, R, importance, c_imp, c_uni, c_keep, c_floor, stream
    [_P] * 11 + [_I] * 6 + [_F] * 4 + [_P],
    replaces="nerfsys_tpu/ops/occupancy.py:394 (occupancy_probe_cdf)",
)
OCC_SAMPLE = Kernel(
    "sample_tvals_from_cdf", "occ_sample", "sample_tvals_from_cdf",
    # cdf, near, far, u, edges, t_vals, N, P, S, u_per_ray, stream
    [_P] * 6 + [_I] * 4 + [_P],
    replaces="nerfsys_tpu/ops/occupancy.py:468 (sample_tvals_from_cdf)",
)
VOLREND_FWD = Kernel(
    "volume_render_fwd", "volrend", "volume_render_fwd",
    # rgb_sigma, t_vals, bg (nullable), rgb, depth, weights, acc,
    # N, S, scale_on, sigma_scale, stream
    [_P] * 7 + [_I] * 3 + [_F, _P],
    replaces="nerfsys_tpu/ops/volrend.py:57,81 (render_weights, "
             "volume_render)",
)

VOLREND_BWD = Kernel(
    "volume_render_bwd", "volrend_bwd", "volume_render_bwd",
    # rgb_sigma, t_vals, bg, g_rgb, g_depth, g_weights, g_acc (the last
    # five nullable), g_rgb_sigma, g_bg (nullable), N, S, scale_on,
    # sigma_scale, stream
    [_P] * 9 + [_I] * 3 + [_F, _P],
    replaces="nerfsys_tpu/ops/volrend.py:81 (volume_render, its VJP)",
)
PLANES_BWD_LIGHT = Kernel(
    "plane_encode_bwd_light", "planes_bwd", "plane_encode_bwd_light",
    # x, ct, levels, grads (by value), K, N, F, stream
    [_P, _P, PlaneLevels, PlaneGrads, _I, _I, _I, _P],
    replaces="nerfsys_tpu/ops/planes.py:565 (_plane_encode_mm_light_bwd)",
)
PLANES_BWD = Kernel(
    "plane_encode_bwd", "planes_bwd", "plane_encode_bwd",
    # x, ct, levels, grads (by value), gx, K, N, F, stream
    [_P, _P, PlaneLevels, PlaneGrads, _P, _I, _I, _I, _P],
    replaces="nerfsys_tpu/ops/planes.py:449 (_plane_encode_mm_bwd)",
)

KERNELS = (PLANES_FWD, OCC_PROBE_CDF, OCC_SAMPLE, VOLREND_FWD, VOLREND_BWD,
           PLANES_BWD_LIGHT, PLANES_BWD)


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


def check_cuda_tensors(name: str, device: torch.device, **tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on `device`
    with the dtype the kernel reads (float32, or bool/uint8 where named)."""
    for key, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        want = (torch.bool,) if key in ("binary",) else (torch.float32,)
        if t.dtype not in want:
            raise TypeError(f"{name}: {key} has dtype {t.dtype}, expected "
                            f"{want[0]}")
