"""Per-image metadata with lazy pixel and mask loading (host-side numpy).

The port's own copy of nerfsys_tpu/data/image_metadata.py (`load_pt` :21,
`_nearest_resize_bool` :41, `ImageMetadata` :51). It reads the prepared
dataset's format: metadata `.pt` dicts {H, W, c2w (3, 4), intrinsics [fx,
fy, cx, cy], distortion}, JPEG or PNG rgbs, and optional per-expert boolean
pixel masks stored as plain or zip-compressed `.pt` files.

torch only deserializes the `.pt` containers here: every array becomes
numpy at once.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional
from zipfile import ZipFile

import numpy as np
import torch


def load_pt(path) -> dict:
    """Deserialize a .pt file (a path or an open file) to numpy-backed
    python objects."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    return _to_numpy(obj)


def _to_numpy(obj):
    if isinstance(obj, torch.Tensor):
        return obj.numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def _nearest_resize_bool(mask: np.ndarray, H: int, W: int) -> np.ndarray:
    """Nearest-neighbour resize of a 2D boolean mask."""
    h, w = mask.shape
    if (h, w) == (H, W):
        return mask
    ri = (np.arange(H) * (h / H)).astype(np.int64).clip(0, h - 1)
    ci = (np.arange(W) * (w / W)).astype(np.int64).clip(0, w - 1)
    return mask[ri][:, ci]


class ImageMetadata:
    """One camera/image: pose, scaled intrinsics, lazy pixels and mask."""

    def __init__(self, image_path: Path, c2w: np.ndarray, W: int, H: int,
                 intrinsics: np.ndarray, image_index: int,
                 is_val: bool = False, mask_dir: Optional[Path] = None):
        self.image_path = Path(image_path)
        self.c2w = np.asarray(c2w, dtype=np.float32)  # (3, 4) world DRB
        self.W = int(W)
        self.H = int(H)
        # (4,) [fx, fy, cx, cy], already downscaled
        self.intrinsics = np.asarray(intrinsics, dtype=np.float32)
        self.image_index = int(image_index)
        self.is_val = bool(is_val)
        self.mask_path = (Path(mask_dir) / f"{self.image_path.stem}.pt"
                          if mask_dir is not None else None)

    def __repr__(self):
        return (f"ImageMetadata(path={self.image_path.name}, "
                f"idx={self.image_index}, W={self.W}, H={self.H}, "
                f"val={self.is_val})")

    def load_image(self) -> np.ndarray:
        """(H, W, 3) uint8 RGB, LANCZOS-resized to the scaled resolution."""
        from PIL import Image as PILImage

        img = PILImage.open(self.image_path).convert("RGB")
        if img.size != (self.W, self.H):
            img = img.resize((self.W, self.H), PILImage.LANCZOS)
        return np.asarray(img, dtype=np.uint8)

    def load_mask(self) -> Optional[np.ndarray]:
        """(H, W) bool keep-mask from a plain or zipped .pt, or None."""
        if self.mask_path is None or not self.mask_path.exists():
            return None
        try:
            m = load_pt(self.mask_path)
        except Exception:
            with ZipFile(self.mask_path, "r") as zf:
                inner = zf.namelist()[0]
                with zf.open(inner) as f:
                    m = load_pt(f)
        m = np.asarray(m)
        if m.ndim == 1:
            if m.size != self.H * self.W:
                return None
            m = m.reshape(self.H, self.W)
        if m.ndim != 2:
            return None
        return _nearest_resize_bool(m.astype(bool), self.H, self.W)
