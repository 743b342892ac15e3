"""sRGB <-> linear conversions and loss-space alignment.

Port of nerfsys_tpu/ops/color_space.py (`linear_to_srgb` :17,
`srgb_to_linear` :26, `color_space_transformer` :34). The renderer predicts
linear RGB; 8-bit ground truth is sRGB. The transformer converts exactly ONE
side so loss and metrics are computed in one space. Clips pass gradients by
JAX's rule (half at a bound, see ops/activations.clip).
"""
from __future__ import annotations

from typing import Tuple

import torch

from nerfsys_tpu_torch.ops.activations import clip


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    x = clip(x, 0.0, 1.0)
    return torch.where(
        x <= 0.0031308,
        12.92 * x,
        1.055 * torch.pow(torch.maximum(x, x.new_tensor(1e-12)), 1.0 / 2.4)
        - 0.055,
    )


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    return torch.where(
        x <= 0.04045,
        x / 12.92,
        torch.pow(torch.maximum((x + 0.055) / 1.055, x.new_tensor(1e-12)),
                  2.4),
    )


def color_space_transformer(pred_linear: torch.Tensor, gt_srgb: torch.Tensor,
                            color_space: str
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bring (prediction, GT) into the requested common color space:
    'linear', 'srgb' or 'identity' (the reference's semantics)."""
    cs = str(color_space).lower()
    pred32 = pred_linear.to(torch.float32)
    gt32 = clip(gt_srgb.to(torch.float32), 0.0, 1.0)
    if cs == "linear":
        pred = clip(pred32, 0.0, 1.0)
        gt = clip(srgb_to_linear(gt32), 0.0, 1.0)
    elif cs == "srgb":
        pred = clip(linear_to_srgb(pred32), 0.0, 1.0)
        gt = gt32
    elif cs == "identity":
        pred, gt = pred32, gt32
    else:
        raise ValueError(f"Invalid color_space={color_space!r}; use "
                         f"'linear'|'srgb'|'identity'")
    return pred.to(pred_linear.dtype), gt.to(pred_linear.dtype)
