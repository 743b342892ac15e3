"""Dense volume rendering: stratified sampling and compositing.

Port of nerfsys_tpu/ops/volrend.py (`stratified_t_vals` :26, `t_to_points`
:51, `render_weights` :57, `volume_render` :81, `background_rgb` :216,
`render_rays_stratified` :252). Every ray carries exactly S samples laid out
(N, S); empty space is masked by zero sigma.

Kernel 4 (`csrc/volrend.cu`) is the compositor forward on the card;
`volume_render_plain` is the same function in plain PyTorch. Gradients go
through `VolumeRender`, whose backward is kernel 4's VJP
(`csrc/volrend_bwd.cu`) or autograd through the plain version. Every clip follows JAX's gradient
rule at a tie (`jnp.clip` and `jnp.maximum` pass half the gradient where
the operands are equal, `torch.clamp` all of it), so the plain version
clips with `torch.maximum` / `torch.minimum`, which pass half too.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from nerfsys_tpu_torch import kernels
from nerfsys_tpu_torch.ops.activations import clip
from nerfsys_tpu_torch.ops.occupancy import linspace01
from nerfsys_tpu_torch.utils.device import resolve_device

Render = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def stratified_t_vals(near: torch.Tensor, far: torch.Tensor,
                      ray_samples: int, randomized: bool = False,
                      generator: Optional[torch.Generator] = None):
    """S samples per ray uniformly in [near, far], with optional stratified
    jitter -> t_vals (N, S)."""
    t_lin = linspace01(ray_samples, near.device).to(near.dtype)[None, :]
    t_vals = near[:, None] * (1.0 - t_lin) + far[:, None] * t_lin
    if randomized:
        if generator is None:
            raise ValueError("randomized sampling requires a generator")
        mids = 0.5 * (t_vals[:, :-1] + t_vals[:, 1:])
        low = torch.cat([t_vals[:, :1], mids], dim=1)
        high = torch.cat([mids, t_vals[:, -1:]], dim=1)
        u = torch.rand(t_vals.shape, generator=generator,
                       device=t_vals.device, dtype=t_vals.dtype)
        t_vals = low + (high - low) * u
    return t_vals


def t_to_points(rays_o, rays_d, t_vals) -> torch.Tensor:
    """(N,3),(N,3),(N,S) -> sample positions (N,S,3)."""
    return rays_o[:, None, :] + rays_d[:, None, :] * t_vals[..., None]


def render_weights(sigma: torch.Tensor, t_vals: torch.Tensor):
    """(weights, alpha, trans), each (N, S): dists >= 1e-4 with the last
    interval repeated, alpha in [0, 1-1e-7], T = exclusive cumprod of
    (1 - alpha + 1e-10)."""
    d = torch.clamp(t_vals[:, 1:] - t_vals[:, :-1], min=1e-4)
    dists = torch.cat([d, d[:, -1:]], dim=1)
    alpha = clip(1.0 - torch.exp(-sigma * dists), 0.0, 1.0 - 1e-7)
    one_m = 1.0 - alpha + 1e-10
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[:, :1]), one_m], dim=1), dim=1
    )[:, :-1]
    return alpha * trans, alpha, trans


def volume_render_plain(rgb_sigma: torch.Tensor, t_vals: torch.Tensor,
                        bg_rgb: Optional[torch.Tensor] = None, *,
                        sigma_scale: float = 1.0) -> Render:
    """Plain PyTorch version of kernel 4 -> (rgb (N,3), depth (N,),
    weights (N,S), acc (N,))."""
    rgb = clip(rgb_sigma[..., :3], 0.0, 1.0)
    sigma = torch.maximum(rgb_sigma[..., 3], rgb_sigma.new_zeros(()))
    if sigma_scale != 1.0:
        sigma = sigma * float(sigma_scale)
    weights, _, _ = render_weights(sigma, t_vals)
    rgb_map = (weights[..., None] * rgb).sum(dim=1)
    depth_map = (weights * t_vals).sum(dim=1)
    acc_map = weights.sum(dim=1)
    if bg_rgb is not None:
        rgb_map = rgb_map + (1.0 - acc_map[..., None]) * bg_rgb.to(
            rgb_map.dtype)
    return rgb_map, depth_map, weights, acc_map


def volume_render_kernel(rgb_sigma: torch.Tensor, t_vals: torch.Tensor,
                         bg_rgb: Optional[torch.Tensor] = None, *,
                         sigma_scale: float = 1.0) -> Render:
    """Kernel 4's wrapper: the plain version for CPU tensors; on CUDA
    tensors it launches `volume_render_fwd` or raises. Not differentiable:
    it raises under grad mode with inputs that require grad."""
    kernels.check_no_grad("volume_render", rgb_sigma, t_vals, bg_rgb)
    if rgb_sigma.device.type == "cpu":
        return volume_render_plain(rgb_sigma, t_vals, bg_rgb,
                                   sigma_scale=sigma_scale)
    if rgb_sigma.device.type != "cuda":
        raise ValueError(f"volume_render: unsupported device "
                         f"{rgb_sigma.device}")
    dev = rgb_sigma.device
    N, S = _check_shapes("volume_render", rgb_sigma, t_vals, bg_rgb)
    kernels.check_cuda_tensors("volume_render", dev, rgb_sigma=rgb_sigma,
                               t_vals=t_vals, bg_rgb=bg_rgb)
    rgb = torch.empty((N, 3), dtype=torch.float32, device=dev)
    depth = torch.empty((N,), dtype=torch.float32, device=dev)
    weights = torch.empty((N, S), dtype=torch.float32, device=dev)
    acc = torch.empty((N,), dtype=torch.float32, device=dev)
    kernels.VOLREND_FWD(
        rgb_sigma.data_ptr(), t_vals.data_ptr(),
        None if bg_rgb is None else bg_rgb.data_ptr(), rgb.data_ptr(),
        depth.data_ptr(), weights.data_ptr(), acc.data_ptr(), N, S,
        int(sigma_scale != 1.0), float(sigma_scale),
        kernels.stream_ptr(rgb_sigma))
    return rgb, depth, weights, acc


def _check_shapes(name, rgb_sigma, t_vals, bg_rgb):
    N, S = t_vals.shape
    if tuple(rgb_sigma.shape) != (N, S, 4) or S < 2:
        raise ValueError(f"{name}: rgb_sigma must be (N, S, 4), S >= 2")
    if bg_rgb is not None and tuple(bg_rgb.shape) != (N, 3):
        raise ValueError(f"{name}: bg_rgb must be (N, 3)")
    return N, S


Grads = Tuple[Optional[torch.Tensor], ...]


def volume_render_bwd_plain(rgb_sigma: torch.Tensor, t_vals: torch.Tensor,
                            bg_rgb: Optional[torch.Tensor], grads: Grads, *,
                            sigma_scale: float = 1.0):
    """Plain PyTorch version of kernel 4's VJP: autograd through
    `volume_render_plain` for the upstream (d rgb, d depth, d weights,
    d acc), any of them None -> (d rgb_sigma, d bg or None)."""
    with torch.enable_grad():
        rs = rgb_sigma.detach().requires_grad_(True)
        bg = None if bg_rgb is None else bg_rgb.detach().requires_grad_(True)
        outs = volume_render_plain(rs, t_vals, bg, sigma_scale=sigma_scale)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        inputs = [rs] if bg is None else [rs, bg]
        if not pairs:
            return torch.zeros_like(rs), (None if bg is None
                                          else torch.zeros_like(bg))
        got = torch.autograd.grad([o for o, _ in pairs],
                                  inputs, [g for _, g in pairs])
    return got[0], (None if bg is None else got[1])


def volume_render_bwd_kernel(rgb_sigma: torch.Tensor, t_vals: torch.Tensor,
                             bg_rgb: Optional[torch.Tensor], grads: Grads, *,
                             sigma_scale: float = 1.0):
    """Kernel 4's VJP wrapper: the plain version for CPU tensors; on CUDA
    tensors it launches `volume_render_bwd` or raises."""
    kernels.check_no_grad("volume_render_bwd", rgb_sigma, t_vals, bg_rgb,
                          *grads)
    if rgb_sigma.device.type == "cpu":
        return volume_render_bwd_plain(rgb_sigma, t_vals, bg_rgb, grads,
                                       sigma_scale=sigma_scale)
    if rgb_sigma.device.type != "cuda":
        raise ValueError(f"volume_render_bwd: unsupported device "
                         f"{rgb_sigma.device}")
    dev = rgb_sigma.device
    N, S = _check_shapes("volume_render_bwd", rgb_sigma, t_vals, bg_rgb)
    g_rgb, g_depth, g_w, g_acc = (None if g is None else g.contiguous()
                                  for g in grads)
    for g, shape in ((g_rgb, (N, 3)), (g_depth, (N,)), (g_w, (N, S)),
                     (g_acc, (N,))):
        if g is not None and tuple(g.shape) != shape:
            raise ValueError("volume_render_bwd: upstream gradient shapes do "
                             "not match the outputs")
    kernels.check_cuda_tensors("volume_render_bwd", dev, rgb_sigma=rgb_sigma,
                               t_vals=t_vals, bg_rgb=bg_rgb, g_rgb=g_rgb,
                               g_depth=g_depth, g_weights=g_w, g_acc=g_acc)
    g_rs = torch.empty_like(rgb_sigma)
    g_bg = None if bg_rgb is None else torch.empty_like(bg_rgb)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    kernels.VOLREND_BWD(
        rgb_sigma.data_ptr(), t_vals.data_ptr(), ptr(bg_rgb), ptr(g_rgb),
        ptr(g_depth), ptr(g_w), ptr(g_acc), g_rs.data_ptr(), ptr(g_bg), N, S,
        int(sigma_scale != 1.0), float(sigma_scale),
        kernels.stream_ptr(rgb_sigma))
    return g_rs, g_bg


class VolumeRender(torch.autograd.Function):
    """volume_render with its VJP: forward kernel 4, backward its VJP
    kernel (the plain versions for CPU tensors). Gradients reach rgb_sigma
    and bg_rgb; t_vals gets none. Unused outputs send no gradient (None
    counts as zero)."""

    @staticmethod
    def forward(ctx, rgb_sigma, t_vals, bg_rgb, sigma_scale):
        ctx.set_materialize_grads(False)
        ctx.sigma_scale = sigma_scale
        ctx.save_for_backward(rgb_sigma, t_vals, bg_rgb)
        return volume_render_kernel(rgb_sigma, t_vals, bg_rgb,
                                    sigma_scale=sigma_scale)

    @staticmethod
    def backward(ctx, *grads):
        rgb_sigma, t_vals, bg_rgb = ctx.saved_tensors
        g_rs, g_bg = volume_render_bwd_kernel(
            rgb_sigma, t_vals, bg_rgb, grads, sigma_scale=ctx.sigma_scale)
        return g_rs, None, g_bg, None


def volume_render(rgb_sigma: torch.Tensor, t_vals: torch.Tensor,
                  bg_rgb: Optional[torch.Tensor] = None, *,
                  sigma_scale: float = 1.0,
                  use_kernels: bool = True) -> Render:
    """Standard NeRF compositing over dense (N, S) samples of rgb in [0, 1]
    and sigma >= 0 (clipped), differentiable in rgb_sigma and bg_rgb.
    use_kernels=False runs the plain version (autograd) on any device;
    otherwise `VolumeRender`, kernel 4 and its VJP."""
    if use_kernels:
        return VolumeRender.apply(rgb_sigma, t_vals, bg_rgb,
                                  float(sigma_scale))
    return volume_render_plain(rgb_sigma, t_vals, bg_rgb,
                               sigma_scale=sigma_scale)


def background_rgb(policy: str, n_rays: int,
                   generator: Optional[torch.Generator] = None,
                   last_sample_rgb: Optional[torch.Tensor] = None,
                   dtype=torch.float32, device=None):
    """Constant background policies: 'white', 'black', 'random',
    'last_sample', 'none' -> (N, 3) or None. The device defaults to that of
    `last_sample_rgb`, else to the card."""
    if device is None:
        device = (last_sample_rgb.device if last_sample_rgb is not None
                  else "cuda")
    device = resolve_device(device)
    p = str(policy).lower()
    if p == "white":
        return torch.ones((n_rays, 3), dtype=dtype, device=device)
    if p == "black":
        return torch.zeros((n_rays, 3), dtype=dtype, device=device)
    if p == "random":
        if generator is None:
            raise ValueError("random background requires a generator")
        return torch.rand((n_rays, 3), generator=generator, device=device,
                          dtype=dtype)
    if p == "last_sample":
        if last_sample_rgb is None:
            raise ValueError("last_sample background requires sample colors")
        return last_sample_rgb
    if p == "none":
        return None
    raise ValueError(f"Unknown background policy: {policy!r}")


FieldFn = Callable[[torch.Tensor, torch.Tensor],
                   Tuple[torch.Tensor, torch.Tensor]]


def render_rays_stratified(
    field_fn: FieldFn,
    rays: torch.Tensor,  # (N, 8) packed
    ray_samples: int,
    generator: Optional[torch.Generator] = None,
    *,
    randomized: bool = False,
    bg_policy: str = "white",
    bg_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    sigma_scale: float = 1.0,
    use_kernels: bool = True,
) -> Render:
    """Dense stratified renderer; invalid rays (inf or >= 1e9 bounds)
    render to the background with zero weights."""
    o, d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6], rays[:, 7]
    n_rays = o.shape[0]
    valid = (torch.isfinite(near) & torch.isfinite(far) & (far > near)
             & (far < 1e9))
    near_s = torch.where(valid, near, torch.zeros_like(near))
    far_s = torch.where(valid, far, torch.ones_like(far))

    t_vals = stratified_t_vals(near_s, far_s, ray_samples, randomized,
                               generator)
    pts = t_to_points(o, d, t_vals)
    dirs = d[:, None, :].expand(pts.shape)
    rgb, sigma = field_fn(pts.reshape(-1, 3), dirs.reshape(-1, 3))
    rgb = rgb.reshape(n_rays, ray_samples, 3)
    sigma = sigma.reshape(n_rays, ray_samples)
    sigma = torch.where(valid[:, None], sigma, torch.zeros_like(sigma))

    if bg_fn is not None:
        bg = bg_fn(d)
    else:
        bg = background_rgb(bg_policy, n_rays, generator=generator,
                            last_sample_rgb=rgb[:, -1, :], dtype=rgb.dtype,
                            device=rgb.device)
    rgb_sigma = torch.cat([rgb, sigma[..., None]], dim=-1)
    return volume_render(rgb_sigma, t_vals,
                         bg_rgb=None if bg is None else bg.contiguous(),
                         sigma_scale=sigma_scale, use_kernels=use_kernels)
