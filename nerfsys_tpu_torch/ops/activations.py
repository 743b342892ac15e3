"""Numerically hardened activations for NeRF density heads.

Port of nerfsys_tpu/ops/activations.py, and `clip`, the port's
`jnp.clip`. `trunc_exp` is an exp whose input
AND gradient are taken at the clamped input, so a runaway logit never gives
inf in either pass. The clamp bound is dtype-aware (log of the dtype max,
shaved so exp() rounding cannot overflow), with the reference's table.

Row 12 of the kernel table: on a CUDA tensor `trunc_exp` runs the
hand-written kernels of `csrc/activations.cu` (forward, backward, and the
backward's own VJP, which MAML's inner gradient takes), each bit-equal to
its plain version here; on a CPU tensor it runs `_TruncExp`, the plain
version.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from nerfsys_tpu_torch import kernels
from nerfsys_tpu_torch.utils.device import aligned, num_sms

_EXP_MAX = {
    torch.float16: 11.089866488,
    torch.bfloat16: 88.7,
    torch.float32: 88.7,
    torch.float64: 709.782712893,
}


ACT_THREADS = 256  # threads a block of csrc/activations.cu's kernels
ACT_VECS = 2  # 16-byte vectors a thread of the forward's exact-cover grid


def act_launch(n: int, sms: int, cover: bool = False) -> Tuple[bool, int]:
    """(exact cover, blocks) of row 12's launch for n > 0 points on `sms`
    SMs, which the wrapper passes to the entry point: the grid-stride loop
    on blocks of a 16-byte vector a thread, at most 8 an SM (one trip a
    thread up to 1,081,344 points on 132 SMs: a bench step's calls); with
    `cover` (the forward) and above that size, the exact-cover grid of
    ACT_VECS vectors a thread (a frame's calls)."""
    cap = 8 * (sms if sms > 0 else 132)
    want = -(-n // (4 * ACT_THREADS))  # blocks at a vector a thread
    if not cover or want <= cap:
        return False, max(1, min(want, cap))
    return True, -(-n // (4 * ACT_VECS * ACT_THREADS))


def _exp_clamp(x: torch.Tensor) -> torch.Tensor:
    m = _EXP_MAX.get(x.dtype, _EXP_MAX[torch.float32])
    return torch.clamp(x, -m, m)


class _TruncExp(torch.autograd.Function):
    """The plain version (CPU tensors). Backward g * y with y the saved
    output. Under create_graph (MAML's inner gradient) y is recomputed from
    x through `clip`, so that its derivative is the reference's: the
    residual exp(clip(x)) has slope y inside the clamp, y / 2 at it and 0
    beyond (the saved output's own graph would give y everywhere)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.exp(_exp_clamp(x))
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        if torch.is_grad_enabled():
            m = _EXP_MAX.get(x.dtype, _EXP_MAX[torch.float32])
            y = torch.exp(clip(x, -m, m))
        return g * y


def trunc_exp_fwd_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of `trunc_exp_fwd`: exp(clamp(x, -m, m))."""
    return torch.exp(_exp_clamp(x))


def trunc_exp_bwd_plain(g: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain version of `trunc_exp_bwd`: g * y."""
    return g * y


def trunc_exp_bwd2_plain(v: torch.Tensor, g: torch.Tensor,
                         x: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Plain version of `trunc_exp_bwd2`: the VJP of g * exp(clip(x)) for
    the cotangent v -> (d g, d x) = (v y, s (v g) y), with y =
    exp(clamp(x)) and s the slope of `clip` (1 inside, 1/2 at a bound, an
    exact 0 beyond), in autograd's order: what `_TruncExp`'s backward
    gives under create_graph."""
    m = _EXP_MAX[torch.float32]
    y = trunc_exp_fwd_plain(x)
    t = (v * g) * y
    t = torch.where((x == m) | (x == -m), t / 2, t)
    return v * y, t.masked_fill((x > m) | (x < -m), 0.0)


def _launch_args(name: str, *tensors: torch.Tensor):
    """Check the kernels' float32 CUDA inputs of one shape; returns (n,
    vec, sms, stream)."""
    x = tensors[0]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 only on the card (--use_amp "
                            f"returns the sigma head to float32 before "
                            f"trunc_exp), got {t.dtype}")
        if t.device != x.device or t.shape != x.shape:
            raise ValueError(f"{name}: inputs differ in device or shape")
    return (x.numel(), int(aligned(*tensors)), num_sms(x.device),
            kernels.stream_ptr(x))


def _cuda_or_raise(name: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type == "cuda"


def trunc_exp_fwd_kernel(x: torch.Tensor) -> torch.Tensor:
    """Row 12's forward: the plain version for a CPU tensor; on a CUDA
    tensor it launches `trunc_exp_fwd` or raises."""
    if not _cuda_or_raise("trunc_exp", x):
        return trunc_exp_fwd_plain(x)
    x = x.contiguous()
    y = torch.empty_like(x)
    n, vec, sms, stream = _launch_args("trunc_exp", x, y)
    if n == 0:
        return y
    cover, blocks = act_launch(n, sms, cover=True)
    kernels.TRUNC_EXP_FWD(x.data_ptr(), y.data_ptr(), n,
                          _EXP_MAX[torch.float32], vec, int(cover), blocks,
                          stream)
    return y


def trunc_exp_bwd_kernel(g: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Row 12's backward g * y: the plain version for CPU tensors; on CUDA
    tensors it launches `trunc_exp_bwd` or raises."""
    if not _cuda_or_raise("trunc_exp_bwd", g):
        return trunc_exp_bwd_plain(g, y)
    g, y = g.contiguous(), y.contiguous()
    gx = torch.empty_like(g)
    n, vec, sms, stream = _launch_args("trunc_exp_bwd", g, y, gx)
    if n == 0:
        return gx
    kernels.TRUNC_EXP_BWD(g.data_ptr(), y.data_ptr(), gx.data_ptr(), n, vec,
                          act_launch(n, sms)[1], stream)
    return gx


def trunc_exp_bwd2_kernel(v: torch.Tensor, g: torch.Tensor,
                          x: torch.Tensor) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Row 12's second derivative (d g, d x): the plain version for CPU
    tensors; on CUDA tensors it launches `trunc_exp_bwd2` (which
    recomputes y from x) or raises."""
    if not _cuda_or_raise("trunc_exp_bwd2", v):
        return trunc_exp_bwd2_plain(v, g, x)
    v, g, x = (t.contiguous() for t in (v, g, x))
    dg, dx = torch.empty_like(v), torch.empty_like(v)
    n, vec, sms, stream = _launch_args("trunc_exp_bwd2", v, g, x, dg, dx)
    if n == 0:
        return dg, dx
    kernels.TRUNC_EXP_BWD2(v.data_ptr(), g.data_ptr(), x.data_ptr(),
                           dg.data_ptr(), dx.data_ptr(), n,
                           _EXP_MAX[torch.float32], vec,
                           act_launch(n, sms)[1], stream)
    return dg, dx


class _TruncExpKernel(torch.autograd.Function):
    """trunc_exp on the card: forward `trunc_exp_fwd`, backward
    `trunc_exp_bwd` on the saved y; under create_graph the backward is
    `_TruncExpBwd`, whose own backward is `trunc_exp_bwd2`."""

    @staticmethod
    def forward(ctx, x):
        y = trunc_exp_fwd_kernel(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        if torch.is_grad_enabled():
            return _TruncExpBwd.apply(x, y.detach(), g)
        return trunc_exp_bwd_kernel(g, y)


class _TruncExpBwd(torch.autograd.Function):
    """g * exp(clip(x)) as a function of x and g (y = exp(clamp(x)) is the
    same value, passed in for the forward): forward `trunc_exp_bwd`,
    backward `trunc_exp_bwd2`, which recomputes y from x and carries the
    clip's slope into d x."""

    @staticmethod
    def forward(ctx, x, y, g):
        ctx.save_for_backward(x, g)
        return trunc_exp_bwd_kernel(g, y)

    @staticmethod
    @once_differentiable
    def backward(ctx, v):
        x, g = ctx.saved_tensors
        dg, dx = trunc_exp_bwd2_kernel(v, g, x)
        return dx, None, dg


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp(clamp(x)) with the reference's gradients: `_TruncExp` (the plain
    version) for a CPU tensor, row 12's kernels for a CUDA tensor (float32
    only), raising on any other device."""
    if _cuda_or_raise("trunc_exp", x):
        return _TruncExpKernel.apply(x)
    return _TruncExp.apply(x)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip with JAX's gradient: 1 inside, 1/2 at a bound (where
    jnp.maximum / jnp.minimum tie), 0 outside. torch.clamp would pass all
    of it at a bound; torch.maximum / torch.minimum pass half, as JAX."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))
