"""sRGB <-> linear conversions.

Port of `linear_to_srgb` from nerfsys_tpu/ops/color_space.py (:17). The
renderer predicts linear RGB; served frames are saved in sRGB.
"""
from __future__ import annotations

import torch


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(
        x <= 0.0031308,
        12.92 * x,
        1.055 * torch.pow(torch.clamp(x, min=1e-12), 1.0 / 2.4) - 0.055,
    )

