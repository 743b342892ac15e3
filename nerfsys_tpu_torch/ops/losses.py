"""Image-quality score of rendered frames.

Port of `psnr_from_mse` from nerfsys_tpu/ops/losses.py (:25).
"""
from __future__ import annotations

import torch


def psnr_from_mse(m: torch.Tensor) -> torch.Tensor:
    """PSNR = -10 log10(mse + 1e-24)."""
    return -10.0 * torch.log10(m + 1e-24)
