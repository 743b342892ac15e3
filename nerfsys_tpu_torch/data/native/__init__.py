"""Native (C++) host data-loader kernels, built with g++ at first use and
loaded through ctypes.

The port's own copy of nerfsys_tpu/data/native (`get_lib`,
`native_available`, `compute_rays_native`, `compact_rays_native`,
`route_rays_native`, `dda_route_native`; the same signatures, argtypes and
return shapes) over its own copy of `ray_kernels.cpp`. The callers send
three host loops through it: `data.ram_rays.frame_rays` and
`process_single_image` (per-image ray precompute and compaction), and
`data.task_dataset.route_rays_to_cells` / `route_rays_exact(policy="dda")`.
Each call runs on `n_threads` C++ threads (0: the hardware concurrency)
and releases the GIL while it runs (ctypes' `CDLL`).

Two decided differences from the JAX package's loader:
- the library is named by a hash of the source and the flags
  (`_build/libray_kernels-<hash>.so` in the package, as `kernels` names
  its nvcc builds), not compared by mtime; it is compiled to a temporary
  file in the same directory and moved onto its name with `os.replace`,
  so processes that build at once each load a whole library;
- a failed build raises RuntimeError with g++'s output. There is no
  silent numpy fallback: the numpy paths are the plain versions, reached
  only through the callers' `native=False`.

Nothing is built or loaded at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_HERE = Path(__file__).resolve().parent
SRC = _HERE / "ray_kernels.cpp"
BUILD_DIR = _HERE.parent.parent / "_build"
CXX = "g++"
# The JAX package's flags exactly: -std=c++17 (not gnu++17) keeps GCC at
# -ffp-contract=off, which the DDA's bit-for-bit contract with the numpy
# router needs. Never add -march=native or -ffast-math.
CXX_FLAGS: Tuple[str, ...] = ("-O3", "-std=c++17", "-fPIC", "-shared",
                              "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_f32p_t = ctypes.POINTER(ctypes.c_float)
_u8p_t = ctypes.POINTER(ctypes.c_uint8)
_i64p_t = ctypes.POINTER(ctypes.c_longlong)


def lib_path() -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join((CXX,) + CXX_FLAGS).encode())
    return Path(BUILD_DIR) / f"libray_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists -> its path. g++ writes a
    temporary file in the same directory, then `os.replace` moves it onto
    the final name (atomic: a concurrent loader never sees half a file).
    RuntimeError, with g++'s output, when the compiler is missing or
    fails."""
    out = lib_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"{CXX} not found: a C++17 compiler is required "
                           f"to build {SRC.name}")
    fd, tmp = tempfile.mkstemp(prefix=out.stem + ".", suffix=".tmp",
                               dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed for {SRC.name} (rc "
                               f"{proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.nerfsys_compute_rays.restype = ctypes.c_longlong
    lib.nerfsys_compute_rays.argtypes = [
        ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, _f32p_t, _f32p_t, ctypes.c_float, ctypes.c_float,
        _f32p_t, _u8p_t, ctypes.c_int,
    ]
    lib.nerfsys_compact_rays.restype = ctypes.c_longlong
    lib.nerfsys_compact_rays.argtypes = [
        _f32p_t, _u8p_t, _u8p_t, _u8p_t, ctypes.c_longlong, _f32p_t, _f32p_t,
    ]
    lib.nerfsys_route_rays.restype = None
    lib.nerfsys_route_rays.argtypes = [
        _f32p_t, ctypes.c_longlong, _f32p_t,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _f32p_t, ctypes.c_int, _i64p_t, ctypes.c_int,
    ]
    lib.nerfsys_dda_route.restype = None
    lib.nerfsys_dda_route.argtypes = [
        _f32p_t, ctypes.c_longlong, _f32p_t,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _i64p_t, ctypes.c_int,
    ]
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded shared library, built first if needed (raises when the
    build fails)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            _lib = _load(build())
        return _lib


def native_available() -> bool:
    """True once the library builds and loads. Kept for name parity with
    the reference's loader, whose callers took their numpy paths when it
    returned False; here it never returns False: a failed build raises."""
    return get_lib() is not None


def _f32p(a: Optional[np.ndarray]):
    if a is None:
        return _f32p_t()
    return a.ctypes.data_as(_f32p_t)


def _u8p(a: Optional[np.ndarray]):
    if a is None:
        return _u8p_t()
    return a.ctypes.data_as(_u8p_t)


def _rays(rays: np.ndarray) -> np.ndarray:
    rays = np.ascontiguousarray(rays, np.float32)
    if rays.ndim != 2 or rays.shape[1] != 8:
        raise ValueError(f"rays must be (N, 8), got {rays.shape}")
    return rays


def _box6(aabb) -> np.ndarray:
    box = np.ascontiguousarray(aabb, np.float32).reshape(-1)
    if box.shape != (6,):
        raise ValueError(f"aabb must hold 6 values (2, 3), got "
                         f"{np.shape(aabb)}")
    return box


def _cells(cells) -> Tuple[int, int, int]:
    c = tuple(int(v) for v in cells)
    if len(c) != 3 or min(c) < 1:
        raise ValueError(f"cells must be 3 positive ints, got {cells}")
    return c


def compute_rays_native(
    H: int,
    W: int,
    intrinsics,  # (fx, fy, cx, cy)
    c2w: np.ndarray,  # (3, 4) (a (4, 4) pose: its top 3 rows)
    aabb: Optional[np.ndarray] = None,  # (2, 3)
    near: Optional[float] = None,
    far: Optional[float] = None,
    center_pixels: bool = True,
    n_threads: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (rays (H*W, 8) float32, valid (H*W,) bool).

    The semantics of np_ray_directions + np_get_rays + np_clamp_rays
    (invalid rays carry near/far = +inf)."""
    lib = get_lib()
    fx, fy, cx, cy = [float(v) for v in intrinsics[:4]]
    pose = np.ascontiguousarray(np.asarray(c2w, np.float32)[:3, :4])
    if pose.shape != (3, 4):
        raise ValueError(f"c2w must be (3, 4) or (4, 4), got {np.shape(c2w)}")
    box = _box6(aabb) if aabb is not None else None
    H, W = int(H), int(W)
    rays = np.empty((H * W, 8), np.float32)
    valid = np.empty((H * W,), np.uint8)
    lib.nerfsys_compute_rays(
        H, W, fx, fy, cx, cy, 1 if center_pixels else 0,
        _f32p(pose), _f32p(box),
        -1.0 if near is None else float(near),
        -1.0 if far is None else float(far),
        _f32p(rays), _u8p(valid), int(n_threads),
    )
    return rays, valid.astype(bool)


def compact_rays_native(
    rays: np.ndarray,  # (N, 8) float32
    valid: np.ndarray,  # (N,) bool/uint8
    keep: Optional[np.ndarray],  # (N,) bool/uint8 or None
    rgb_u8: np.ndarray,  # (N, 3) uint8
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (rays (M, 8), rgb (M, 3) float in [0,1]): the rows passing
    valid & keep."""
    lib = get_lib()
    rays = _rays(rays)
    n = rays.shape[0]
    valid8 = np.ascontiguousarray(valid, np.uint8).reshape(-1)
    keep8 = (np.ascontiguousarray(keep, np.uint8).reshape(-1)
             if keep is not None else None)
    rgb_u8 = np.ascontiguousarray(rgb_u8, np.uint8)
    if valid8.shape != (n,) or (keep8 is not None and keep8.shape != (n,)) \
            or rgb_u8.shape != (n, 3):
        raise ValueError(f"compact: {n} rays, valid {valid8.shape}, keep "
                         f"{None if keep8 is None else keep8.shape}, rgb "
                         f"{rgb_u8.shape}")
    out_rays = np.empty((n, 8), np.float32)
    out_rgb = np.empty((n, 3), np.float32)
    m = lib.nerfsys_compact_rays(
        _f32p(rays), _u8p(valid8), _u8p(keep8), _u8p(rgb_u8), n,
        _f32p(out_rays), _f32p(out_rgb),
    )
    return out_rays[:m].copy(), out_rgb[:m].copy()


def route_rays_native(
    rays: np.ndarray,  # (N, 8) float32
    aabb: np.ndarray,  # (2, 3)
    cells: Tuple[int, int, int],
    ts: np.ndarray,  # (P,) sample fractions
    n_threads: int = 0,
) -> np.ndarray:
    """Max-overlap micro-cell per ray by a majority vote over the sample
    fractions ts, (N,) int64 with -1 = miss."""
    lib = get_lib()
    rays = _rays(rays)
    box = _box6(aabb)
    c = _cells(cells)
    ts = np.ascontiguousarray(ts, np.float32).reshape(-1)
    out = np.empty((rays.shape[0],), np.int64)
    lib.nerfsys_route_rays(
        _f32p(rays), rays.shape[0], _f32p(box), c[0], c[1], c[2],
        _f32p(ts), ts.shape[0], out.ctypes.data_as(_i64p_t), int(n_threads),
    )
    return out


def dda_route_native(
    rays: np.ndarray,  # (N, 8) float32
    aabb: np.ndarray,  # (2, 3) region box
    cells: Tuple[int, int, int],
    max_steps: int = 64,
    n_threads: int = 0,
) -> np.ndarray:
    """Exact DDA max-overlap cell per ray, with the weak-overlap filter;
    (N,) int64, -1 = miss / filtered. Bit for bit the numpy router
    (task_dataset._dda_route_numpy)."""
    lib = get_lib()
    rays = _rays(rays)
    box = _box6(aabb)
    c = _cells(cells)
    out = np.empty((rays.shape[0],), np.int64)
    lib.nerfsys_dda_route(
        _f32p(rays), rays.shape[0], _f32p(box), c[0], c[1], c[2],
        int(max_steps), out.ctypes.data_as(_i64p_t), int(n_threads),
    )
    return out
