"""Dense volume rendering: stratified sampling and compositing.

Port of nerfsys_tpu/ops/volrend.py (`stratified_t_vals` :26, `t_to_points`
:51, `render_weights` :57, `volume_render` :81, `composite_init` :134,
`composite_segment` :153, `composite_finalize` :183, `full_dists` :207,
`background_rgb` :216, `render_rays_stratified` :252). Every ray carries
exactly S samples laid out (N, S); empty space is masked by zero sigma.

Kernel row 8 (`csrc/composite_seg.cu`) composites one segment of samples
into a carried state for the early-stop renderer;
`composite_segment_plain` is the same function in plain PyTorch. It takes
kernel 4's lane map, planned by `ray_lane_plan` (s >= 1), as the
coherent-expert test (row 10b, models/container.py) does.

Kernel 4 (`csrc/volrend.cu`) is the compositor forward on the card;
`volume_render_plain` is the same function in plain PyTorch. Gradients go
through `VolumeRender`, whose backward is kernel 4's VJP
(`csrc/volrend_bwd.cu`) or autograd through the plain version; under
create_graph (the MAML inner gradient) that VJP is `VolumeRenderBwd`,
differentiable again through kernel 4'' (`csrc/volrend_bwd2.cu`) or
`volume_render_bwd2_plain`. The kernels put a ray's samples on lanes of a
warp and take their launch plan from `volrend_plan`. Every clip
follows JAX's gradient
rule at a tie (`jnp.clip` and `jnp.maximum` pass half the gradient where
the operands are equal, `torch.clamp` all of it), so the plain version
clips with `torch.maximum` / `torch.minimum`, which pass half too.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from nerfsys_tpu_torch import kernels
from nerfsys_tpu_torch.ops.activations import clip
from nerfsys_tpu_torch.ops.occupancy import linspace01
from nerfsys_tpu_torch.utils.device import aligned, resolve_device

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
    tensors it launches `volume_render_fwd` (with `volrend_plan`'s plan) or
    raises. Not differentiable: it raises under grad mode with inputs that
    require grad."""
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
    if not aligned(rgb_sigma):
        raise ValueError("volume_render: rgb_sigma must start on a 16-byte "
                         "boundary (the kernel reads samples as vectors)")
    rgb = torch.empty((N, 3), dtype=torch.float32, device=dev)
    depth = torch.empty((N,), dtype=torch.float32, device=dev)
    weights = torch.empty((N, S), dtype=torch.float32, device=dev)
    acc = torch.empty((N,), dtype=torch.float32, device=dev)
    kernels.VOLREND_FWD(
        rgb_sigma.data_ptr(), t_vals.data_ptr(),
        None if bg_rgb is None else bg_rgb.data_ptr(), rgb.data_ptr(),
        depth.data_ptr(), weights.data_ptr(), acc.data_ptr(), N, S,
        int(sigma_scale != 1.0), float(sigma_scale),
        _plan_struct(N, S, False), kernels.stream_ptr(rgb_sigma))
    return rgb, depth, weights, acc


def _check_shapes(name, rgb_sigma, t_vals, bg_rgb):
    N, S = t_vals.shape
    if tuple(rgb_sigma.shape) != (N, S, 4) or S < 2:
        raise ValueError(f"{name}: rgb_sigma must be (N, S, 4), S >= 2")
    if bg_rgb is not None and tuple(bg_rgb.shape) != (N, 3):
        raise ValueError(f"{name}: bg_rgb must be (N, 3)")
    return N, S


Grads = Tuple[Optional[torch.Tensor], ...]

VOLREND_THREADS = 256  # 8 warps a block
VOLREND_BWD_SMEM = 48 * 1024  # piece carries within what needs no opt-in


@dataclasses.dataclass(frozen=True)
class VolrendLaunchPlan:
    """Launch geometry of kernel 4 and its VJP (csrc/volrend_common.cuh
    `VolrendPlan`)."""

    lanes: int  # lanes a ray: the power of 2 at or above S, at most 32
    pieces: int  # pieces of `lanes` samples a ray: ceil(S / lanes)
    threads: int  # per block
    blocks: int
    smem: int  # the VJP's T at each piece's start, a float per piece and
    # warp (the forward carries T in a register)

    @property
    def rays_per_warp(self) -> int:
        return 32 // self.lanes

    def as_struct(self) -> "kernels.VolrendPlan":
        return kernels.VolrendPlan(self.lanes, self.pieces, self.threads,
                                   self.blocks, self.smem)


def ray_lanes(s: int) -> int:
    """Lanes a ray of S samples takes: the power of 2 at or above S, at
    most 32."""
    return min(32, 1 << (s - 1).bit_length())


def volrend_plan(n: int, s: int, *, backward: bool) -> VolrendLaunchPlan:
    """Kernel 4's (backward=False) or its VJP's plan for N rays of S
    samples: a ray's samples on `lanes` consecutive lanes, so a warp takes
    32 / lanes rays (S <= 16) or one ray in ceil(S / 32) pieces (S > 32);
    8 warps a block, for the VJP fewer when the pieces' carries would pass
    48 KB of shared memory."""
    name = "volume_render_bwd" if backward else "volume_render"
    if s < 2:
        raise ValueError(f"{name}: S={s}, expected S >= 2")
    lanes = ray_lanes(s)
    pieces = -(-s // lanes)
    warps = VOLREND_THREADS // 32
    smem = 0
    if backward and pieces > 1:
        warps = min(warps, VOLREND_BWD_SMEM // (4 * pieces))
        if warps < 1:
            raise ValueError(f"{name}: S={s} samples need more than "
                             f"{VOLREND_BWD_SMEM} bytes of shared memory a "
                             f"warp")
        smem = 4 * warps * pieces
    rays_per_block = warps * (32 // lanes)
    return VolrendLaunchPlan(lanes=lanes, pieces=pieces, threads=32 * warps,
                             blocks=max(1, -(-n // rays_per_block)),
                             smem=smem)


@functools.lru_cache(maxsize=256)
def _plan_struct(n: int, s: int, backward: bool) -> "kernels.VolrendPlan":
    """`volrend_plan` as the kernels' struct, per shape and direction."""
    return volrend_plan(n, s, backward=backward).as_struct()


@dataclasses.dataclass(frozen=True)
class RayLaneLaunchPlan:
    """Launch geometry of rows 8 and 10b (csrc/volrend_common.cuh
    `RayLanePlan`): a ray's samples on `lanes` lanes in `pieces`, and
    `groups` groups of 32 / lanes rays a warp at once."""

    lanes: int
    pieces: int
    groups: int  # the kernel's compile-time constant, checked by its entry
    threads: int
    blocks: int  # enough for N rays in one pass

    @property
    def rays_per_warp(self) -> int:
        return self.groups * (32 // self.lanes)

    def as_struct(self) -> "kernels.RayLanePlan":
        return kernels.RayLanePlan(self.lanes, self.pieces, self.groups,
                                   self.threads, self.blocks)


def ray_lane_plan(n: int, s: int, groups: int,
                  max_lanes: int = 32) -> RayLaneLaunchPlan:
    """Row 8's or 10b's plan for N rays of s >= 1 samples: kernel 4's lane
    map with at most `max_lanes` lanes a ray (a power of 2: the power of 2
    at or above s, capped; a ray longer than its lanes takes pieces),
    `groups` groups of 32 / lanes rays a warp, 8 warps a block, blocks for
    one pass."""
    if s < 1 or groups < 1 or max_lanes not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"ray_lane_plan: s={s}, groups={groups}, max_lanes="
                         f"{max_lanes}; expected s, groups >= 1 and "
                         f"max_lanes a power of 2 up to 32")
    lanes = min(max_lanes, ray_lanes(s))
    warps = VOLREND_THREADS // 32
    return RayLaneLaunchPlan(
        lanes=lanes, pieces=-(-s // lanes), groups=groups,
        threads=32 * warps,
        blocks=max(1, -(-n // (warps * groups * (32 // lanes)))))


@functools.lru_cache(maxsize=256)
def ray_lane_struct(n: int, s: int, groups: int,
                    max_lanes: int = 32) -> "kernels.RayLanePlan":
    """`ray_lane_plan` as the kernels' struct, per shape."""
    return ray_lane_plan(n, s, groups, max_lanes).as_struct()


def volume_render_bwd_plain(rgb_sigma: torch.Tensor, t_vals: torch.Tensor,
                            bg_rgb: Optional[torch.Tensor], grads: Grads, *,
                            sigma_scale: float = 1.0,
                            create_graph: bool = False):
    """Plain PyTorch version of kernel 4's VJP: autograd through
    `volume_render_plain` for the upstream (d rgb, d depth, d weights,
    d acc), any of them None -> (d rgb_sigma, d bg or None).

    create_graph=True differentiates the inputs as given (rgb_sigma, bg_rgb
    and the upstream must be the tensors to differentiate in, rgb_sigma
    requiring grad) and keeps the graph of the result: the plain path of
    kernel 4'' (`volume_render_bwd2_plain`)."""
    with torch.enable_grad():
        if create_graph:
            rs, bg = rgb_sigma, bg_rgb
        else:
            rs = rgb_sigma.detach().requires_grad_(True)
            bg = (None if bg_rgb is None
                  else bg_rgb.detach().requires_grad_(True))
        outs = volume_render_plain(rs, t_vals, bg, sigma_scale=sigma_scale)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        inputs = [rs] if bg is None or not bg.requires_grad else [rs, bg]
        if not pairs:
            return torch.zeros_like(rs), (None if bg is None
                                          else torch.zeros_like(bg))
        got = torch.autograd.grad([o for o, _ in pairs],
                                  inputs, [g for _, g in pairs],
                                  allow_unused=True,  # bg: depth alone
                                  create_graph=create_graph)
        got = [torch.zeros_like(x) if g is None else g
               for g, x in zip(got, inputs)]
    if bg is None:
        return got[0], None
    return got[0], got[1] if len(got) > 1 else torch.zeros_like(bg)


def volume_render_bwd_kernel(rgb_sigma: torch.Tensor, t_vals: torch.Tensor,
                             bg_rgb: Optional[torch.Tensor], grads: Grads, *,
                             sigma_scale: float = 1.0):
    """Kernel 4's VJP wrapper: the plain version for CPU tensors; on CUDA
    tensors it launches `volume_render_bwd` (with `volrend_plan`'s plan)
    or raises."""
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
    if not aligned(rgb_sigma):
        raise ValueError("volume_render_bwd: rgb_sigma must start on a "
                         "16-byte boundary (the kernel reads samples as "
                         "vectors)")
    g_rs = torch.empty_like(rgb_sigma)
    g_bg = None if bg_rgb is None else torch.empty_like(bg_rgb)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    kernels.VOLREND_BWD(
        rgb_sigma.data_ptr(), t_vals.data_ptr(), ptr(bg_rgb), ptr(g_rgb),
        ptr(g_depth), ptr(g_w), ptr(g_acc), g_rs.data_ptr(), ptr(g_bg), N, S,
        int(sigma_scale != 1.0), float(sigma_scale), _plan_struct(N, S, True),
        kernels.stream_ptr(rgb_sigma))
    return g_rs, g_bg


Upstream = Tuple[Optional[torch.Tensor], ...]


def volume_render_bwd2_plain(rgb_sigma: torch.Tensor, t_vals: torch.Tensor,
                             bg_rgb: Optional[torch.Tensor], grads: Upstream,
                             v_rs: Optional[torch.Tensor],
                             v_bg: Optional[torch.Tensor], *,
                             sigma_scale: float = 1.0):
    """Plain PyTorch version of kernel 4'': the VJP of kernel 4's VJP.
    For the upstream u = grads (d rgb, d depth, d weights, d acc; any
    None) and the cotangents v = (v_rs, v_bg) of its outputs (None counts
    as zero) -> (d rgb_sigma, d bg or None, d u: a tuple with a tensor
    where u has one). d u is the compositor's JVP at rgb_sigma in the
    direction v; d (rgb_sigma, bg) is u^T H v. Autograd through
    `volume_render_bwd_plain(..., create_graph=True)`."""
    with torch.enable_grad():
        rs = rgb_sigma.detach().requires_grad_(True)
        bg = None if bg_rgb is None else bg_rgb.detach().requires_grad_(True)
        us = [None if g is None else g.detach().requires_grad_(True)
              for g in grads]
        g_rs, g_bg = volume_render_bwd_plain(rs, t_vals, bg, us,
                                             sigma_scale=sigma_scale,
                                             create_graph=True)
        pairs = [(o, v) for o, v in ((g_rs, v_rs), (g_bg, v_bg))
                 if o is not None and v is not None and o.requires_grad]
        inputs = [rs] + ([] if bg is None else [bg]) + [
            u for u in us if u is not None]
        got = [None] * len(inputs)
        if pairs:
            got = list(torch.autograd.grad(
                [o for o, _ in pairs], inputs, [v for _, v in pairs],
                allow_unused=True))
        got = [torch.zeros_like(x) if g is None else g
               for g, x in zip(got, inputs)]
    d_rs, rest = got[0], got[1:]
    d_bg = None
    if bg is not None:
        d_bg, rest = rest[0], rest[1:]
    it = iter(rest)
    return d_rs, d_bg, tuple(None if u is None else next(it) for u in us)


def volume_render_bwd2_kernel(rgb_sigma: torch.Tensor, t_vals: torch.Tensor,
                              bg_rgb: Optional[torch.Tensor],
                              grads: Upstream, v_rs: Optional[torch.Tensor],
                              v_bg: Optional[torch.Tensor], *,
                              sigma_scale: float = 1.0):
    """Kernel 4'' wrapper: the plain version for CPU tensors; on CUDA
    tensors it launches `volume_render_bwd2` (with kernel 4' plan) or
    raises. Returns what `volume_render_bwd2_plain` returns."""
    kernels.check_no_grad("volume_render_bwd2", rgb_sigma, t_vals, bg_rgb,
                          *grads, v_rs, v_bg)
    if rgb_sigma.device.type == "cpu":
        return volume_render_bwd2_plain(rgb_sigma, t_vals, bg_rgb, grads,
                                        v_rs, v_bg, sigma_scale=sigma_scale)
    if rgb_sigma.device.type != "cuda":
        raise ValueError(f"volume_render_bwd2: unsupported device "
                         f"{rgb_sigma.device}")
    dev = rgb_sigma.device
    N, S = _check_shapes("volume_render_bwd2", rgb_sigma, t_vals, bg_rgb)
    g_rgb, g_depth, g_w, g_acc = (None if g is None else g.contiguous()
                                  for g in grads)
    for g, shape in ((g_rgb, (N, 3)), (g_depth, (N,)), (g_w, (N, S)),
                     (g_acc, (N,))):
        if g is not None and tuple(g.shape) != shape:
            raise ValueError("volume_render_bwd2: upstream gradient shapes "
                             "do not match the outputs")
    v_rs = (torch.zeros_like(rgb_sigma) if v_rs is None
            else v_rs.contiguous())
    if not aligned(v_rs):  # autograd's cotangent: a fresh copy is aligned
        v_rs = v_rs.clone()
    v_bg = None if bg_rgb is None or v_bg is None else v_bg.contiguous()
    if tuple(v_rs.shape) != (N, S, 4) or (
            v_bg is not None and tuple(v_bg.shape) != (N, 3)):
        raise ValueError("volume_render_bwd2: the cotangents must be shaped "
                         "like rgb_sigma and bg_rgb")
    kernels.check_cuda_tensors("volume_render_bwd2", dev,
                               rgb_sigma=rgb_sigma, t_vals=t_vals,
                               bg_rgb=bg_rgb, g_rgb=g_rgb, g_depth=g_depth,
                               g_weights=g_w, g_acc=g_acc, v_rs=v_rs,
                               v_bg=v_bg)
    if not aligned(rgb_sigma):
        raise ValueError("volume_render_bwd2: rgb_sigma must start on a "
                         "16-byte boundary (the kernel reads samples as "
                         "vectors)")
    d_rs = torch.empty_like(rgb_sigma)
    d_bg = None if bg_rgb is None else torch.empty_like(bg_rgb)
    d_u = tuple(None if g is None else torch.empty_like(g)
                for g in (g_rgb, g_depth, g_w, g_acc))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    kernels.VOLREND_BWD2(
        rgb_sigma.data_ptr(), t_vals.data_ptr(), ptr(bg_rgb), ptr(g_rgb),
        ptr(g_depth), ptr(g_w), ptr(g_acc), v_rs.data_ptr(), ptr(v_bg),
        d_rs.data_ptr(), ptr(d_bg), *(ptr(t) for t in d_u), N, S,
        int(sigma_scale != 1.0), float(sigma_scale),
        _plan_struct(N, S, True), kernels.stream_ptr(rgb_sigma))
    return d_rs, d_bg, d_u


class VolumeRenderBwd(torch.autograd.Function):
    """Kernel 4's VJP as a differentiable function of (rgb_sigma, bg_rgb)
    and the upstream: forward kernel 4', backward kernel 4'' (the plain
    versions for CPU tensors). `VolumeRender.backward` calls it under
    create_graph, where MAML takes its inner gradient; a third derivative
    raises."""

    @staticmethod
    def forward(ctx, rgb_sigma, t_vals, bg_rgb, sigma_scale, *grads):
        ctx.set_materialize_grads(False)
        ctx.sigma_scale = sigma_scale
        ctx.save_for_backward(rgb_sigma, t_vals, bg_rgb, *grads)
        return volume_render_bwd_kernel(rgb_sigma, t_vals, bg_rgb, grads,
                                        sigma_scale=sigma_scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, v_rs, v_bg):
        rgb_sigma, t_vals, bg_rgb, *grads = ctx.saved_tensors
        if v_rs is None and v_bg is None:
            return (None,) * (4 + len(grads))
        d_rs, d_bg, d_u = volume_render_bwd2_kernel(
            rgb_sigma, t_vals, bg_rgb, grads, v_rs, v_bg,
            sigma_scale=ctx.sigma_scale)
        return (d_rs, None, d_bg, None, *d_u)


class VolumeRender(torch.autograd.Function):
    """volume_render with its VJP: forward kernel 4, backward its VJP
    kernel (the plain versions for CPU tensors). Gradients reach rgb_sigma
    and bg_rgb; t_vals gets none. Unused outputs send no gradient (None
    counts as zero). Under create_graph the backward is `VolumeRenderBwd`,
    so that the VJP can be differentiated again (kernel 4''); otherwise it
    launches kernel 4' itself."""

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
        if torch.is_grad_enabled():
            g_rs, g_bg = VolumeRenderBwd.apply(rgb_sigma, t_vals, bg_rgb,
                                               ctx.sigma_scale, *grads)
        else:
            g_rs, g_bg = volume_render_bwd_kernel(
                rgb_sigma, t_vals, bg_rgb, grads,
                sigma_scale=ctx.sigma_scale)
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


# --------------------------- segmented compositing --------------------------
# The early-stop renderer composites a ray's samples in segments with a
# carried transmittance (models/occupancy.py render_rays_occ_et_*): the
# weights of a segment's samples are alpha * exclusive-cumprod-in-segment *
# T_carry, the one-shot products in the same left-to-right order.

Carry = Dict[str, torch.Tensor]
_CARRY_KEYS = ("rgb", "depth", "acc", "trans")
_FOG_KEYS = ("wmax", "wlogw")


def composite_init(n_rays: int, dtype=torch.float32, fog: bool = False,
                   device="cuda") -> Carry:
    """Fresh per-ray carry. fog=True also carries the haze statistics
    (wmax and sum w log w: the weight entropy decomposes over segments as
    -(sum w log w)/W + log W with W = sum w)."""
    dev = resolve_device(device)
    carry = {
        "rgb": torch.zeros((n_rays, 3), dtype=dtype, device=dev),
        "depth": torch.zeros((n_rays,), dtype=dtype, device=dev),
        "acc": torch.zeros((n_rays,), dtype=dtype, device=dev),
        "trans": torch.ones((n_rays,), dtype=dtype, device=dev),
    }
    if fog:
        carry["wmax"] = torch.zeros((n_rays,), dtype=dtype, device=dev)
        carry["wlogw"] = torch.zeros((n_rays,), dtype=dtype, device=dev)
    return carry


def composite_segment_plain(carry: Carry, rgb: torch.Tensor,
                            sigma: torch.Tensor, t_seg: torch.Tensor,
                            dists_seg: torch.Tensor) -> Carry:
    """Plain PyTorch version of kernel row 8: composite one segment of
    rgb (N, s, 3) in [0, 1] and sigma (N, s) >= 0 (masked and scaled by the
    caller) at t_seg, dists_seg (N, s) into the carry -> a new carry.
    dists_seg are slices of `full_dists` over the whole sample set, so the
    boundary interval spans the segments."""
    alpha = clip(1.0 - torch.exp(-sigma * dists_seg), 0.0, 1.0 - 1e-7)
    one_m = 1.0 - alpha + 1e-10
    trans_local = torch.cumprod(
        torch.cat([torch.ones_like(alpha[:, :1]), one_m], dim=1), dim=1
    )[:, :-1]
    w = alpha * trans_local * carry["trans"][:, None]
    out = {
        "rgb": carry["rgb"] + (w[..., None] * rgb).sum(dim=1),
        "depth": carry["depth"] + (w * t_seg).sum(dim=1),
        "acc": carry["acc"] + w.sum(dim=1),
        "trans": carry["trans"] * torch.prod(one_m, dim=1),
    }
    if "wmax" in carry:
        out["wmax"] = torch.maximum(carry["wmax"], w.amax(dim=1))
        out["wlogw"] = carry["wlogw"] + (
            w * torch.log(torch.clamp(w, min=1e-12))).sum(dim=1)
    return out


def composite_segment(carry: Carry, rgb: torch.Tensor, sigma: torch.Tensor,
                      t_seg: torch.Tensor, dists_seg: torch.Tensor) -> Carry:
    """Kernel row 8's wrapper: the plain version for CPU tensors; on CUDA
    tensors it launches `composite_segment_fwd` (with `ray_lane_plan`'s
    plan, one ray group a warp) or raises. t_seg and
    dists_seg may be column slices of (N, S) tensors (unit column stride):
    the kernel reads them through their row stride. No backward: it raises
    under grad mode with inputs that require grad."""
    kernels.check_no_grad("composite_segment", rgb, sigma, t_seg, dists_seg,
                          *carry.values())
    if rgb.device.type == "cpu":
        return composite_segment_plain(carry, rgb, sigma, t_seg, dists_seg)
    if rgb.device.type != "cuda":
        raise ValueError(f"composite_segment: unsupported device "
                         f"{rgb.device}")
    dev = rgb.device
    N, s = sigma.shape
    fog = "wmax" in carry
    if tuple(rgb.shape) != (N, s, 3) or s < 1:
        raise ValueError("composite_segment: rgb must be (N, s, 3), sigma "
                         "(N, s), s >= 1")
    strides = []
    for name, t in (("t_seg", t_seg), ("dists_seg", dists_seg)):
        if (tuple(t.shape) != (N, s) or t.device != dev
                or t.dtype != torch.float32
                or (N > 0 and s > 1 and t.stride(1) != 1)
                or (N > 1 and t.stride(0) < s)):
            raise ValueError(f"composite_segment: {name} must be a float32 "
                             f"(N, s) tensor on {dev} with unit column "
                             f"stride")
        strides.append(t.stride(0) if N > 1 else s)
    keys = _CARRY_KEYS + (_FOG_KEYS if fog else ())
    for key in keys:
        shape = (N, 3) if key == "rgb" else (N,)
        if tuple(carry[key].shape) != shape:
            raise ValueError(f"composite_segment: carry[{key!r}] must be "
                             f"{shape}")
    kernels.check_cuda_tensors("composite_segment", dev, rgb=rgb,
                               sigma=sigma,
                               **{f"carry_{k}": carry[k] for k in keys})
    out = {k: torch.empty_like(carry[k]) for k in keys}
    ptr = lambda key, d: d[key].data_ptr() if fog else None  # noqa: E731
    kernels.COMPOSITE_SEG(
        carry["rgb"].data_ptr(), carry["depth"].data_ptr(),
        carry["acc"].data_ptr(), carry["trans"].data_ptr(),
        ptr("wmax", carry), ptr("wlogw", carry), rgb.data_ptr(),
        sigma.data_ptr(), t_seg.data_ptr(), dists_seg.data_ptr(),
        out["rgb"].data_ptr(), out["depth"].data_ptr(),
        out["acc"].data_ptr(), out["trans"].data_ptr(), ptr("wmax", out),
        ptr("wlogw", out), N, s, strides[0], strides[1], int(fog),
        ray_lane_struct(N, s, 1), kernels.stream_ptr(rgb))
    return out


def composite_finalize(carry: Carry, bg_rgb: Optional[torch.Tensor]):
    """(rgb_map, depth_map, acc_map[, wmax, entropy]) from a carry, with
    volume_render's background blend. For a ray terminated early the
    dropped tail radiance and the background-weight shift are each bounded
    by its carried transmittance (the early-stop eps)."""
    rgb_map = carry["rgb"]
    if bg_rgb is not None:
        rgb_map = rgb_map + (1.0 - carry["acc"][..., None]) * bg_rgb.to(
            rgb_map.dtype)
    if "wmax" not in carry:
        return rgb_map, carry["depth"], carry["acc"]
    # entropy of p = w / W: -(sum w log w) / W + log W; a ray with
    # (near-)zero weight has no distribution and reports 0, like _fog_stats
    wsum = torch.clamp(carry["acc"], min=1e-12)
    entropy = -carry["wlogw"] / wsum + torch.log(wsum)
    entropy = torch.where(carry["acc"] > 1e-9, entropy,
                          torch.zeros_like(entropy))
    return rgb_map, carry["depth"], carry["acc"], carry["wmax"], entropy


def full_dists(t_vals: torch.Tensor) -> torch.Tensor:
    """The (N, S) step sizes volume_render derives from t_vals (consecutive
    diffs clamped >= 1e-4, the last repeated), once over the whole sample
    set, so that segment slices see the true boundary intervals."""
    d = torch.clamp(t_vals[:, 1:] - t_vals[:, :-1], min=1e-4)
    return torch.cat([d, d[:, -1:]], dim=1)


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
