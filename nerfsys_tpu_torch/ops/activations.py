"""Numerically hardened activations for NeRF density heads.

Port of nerfsys_tpu/ops/activations.py, and `clip`, the port's
`jnp.clip`. `trunc_exp` is an exp whose input
AND gradient are taken at the clamped input, so a runaway logit never gives
inf in either pass. The clamp bound is dtype-aware (log of the dtype max,
shaved so exp() rounding cannot overflow), with the reference's table.
"""
from __future__ import annotations

import torch

_EXP_MAX = {
    torch.float16: 11.089866488,
    torch.bfloat16: 88.7,
    torch.float32: 88.7,
    torch.float64: 709.782712893,
}


def _exp_clamp(x: torch.Tensor) -> torch.Tensor:
    m = _EXP_MAX.get(x.dtype, _EXP_MAX[torch.float32])
    return torch.clamp(x, -m, m)


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.exp(_exp_clamp(x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip with JAX's gradient: 1 inside, 1/2 at a bound (where
    jnp.maximum / jnp.minimum tie), 0 outside. torch.clamp would pass all
    of it at a bound; torch.maximum / torch.minimum pass half, as JAX."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))
