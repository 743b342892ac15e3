"""Spherical-harmonics direction encoding.

Port of `sh_encode`, `sh_out_dim` and `num_sh_bases` from
nerfsys_tpu/ops/encodings.py (:48-106): real SH up to degree 4 in the
Nerfstudio coefficient convention, with the reference's coefficients.
"""
from __future__ import annotations

import torch

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
