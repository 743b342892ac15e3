"""Adversarial inputs of the compositor forward (kernel 4, its module
`nerfsys_tpu_torch.ops.volrend`) against JAX, the kernel's lane algorithm
walked in numpy, and the launch plan it shares with its VJP.

The same numpy inputs go through nerfsys_tpu.ops.volrend.volume_render
(jit disabled) and through the port's `volume_render_plain` and
`volume_render_kernel` on CPU tensors (where the wrapper runs the plain
version). The inputs are `test_torch_volrend_edges._inputs`, the ones
chip_smoke.py holds kernel 4 to on the card: alpha at its 1 - 1e-7 clip
(sigma * dt >= 17), sigma exactly 0 and 1e-9, rgb exactly 0 and 1,
zero-length intervals (dt at its 1e-4 floor, the last one included),
S = 2, 8, 31, 33, 64 and 97, no background, sigma_scale 25, and ray
counts that leave a tail past whole warps. Tolerances: 1e-6 for the plain
version against JAX (the same operations; sums in other orders); 1e-5 for
the lane walk (a product tree for T instead of the sequential cumprod,
butterfly sums), the card's tolerance. rgb, weights and acc are compared
absolutely (all in [0, 1]), depth relative to its max.

The plan is `volrend_plan(n, s, backward=False)`: the VJP's lanes and
pieces (so both directions form T in one order), no shared memory (the
forward carries T between pieces in a register), 8 warps a block.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsys_tpu.ops import volrend as JV
from nerfsys_tpu_torch.ops import volrend as TV
from test_torch_volrend_edges import _inputs, _seg_shift
from test_torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse)

JAX_TOL = 1e-6  # the same operations, sums in other orders
WALK_TOL = 1e-5  # a product tree for T, butterfly sums (the card's)

CASES = ([("clip", 32, True, 1.0), ("zero", 32, True, 1.0),
          ("rgb01", 32, True, 1.0), ("dtfloor", 32, True, 1.0)]
         + [("rand", s, True, 1.0) for s in (2, 8, 31, 33, 64, 97)]
         + [("rand", 32, False, 1.0), ("rand", 32, True, 25.0),
            ("clip", 97, True, 25.0), ("dtfloor", 33, True, 1.0),
            ("zero", 8, False, 25.0), ("clip", 3, True, 1.0)])
IDS = [f"{k}-S{s}{'' if bg else '-nobg'}-x{scale:g}"
       for k, s, bg, scale in CASES]
N = 37  # a tail past whole warps at every S <= 16


def _case(kind, s, with_bg, seed, n=N):
    rs, t, bg, _ = _inputs(kind, n, s, seed)
    return rs, t, (bg if with_bg else None)


def _torch(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _errs(got, want):
    """(rgb, weights, acc) absolute, depth relative to its max."""
    got = [np.asarray(g, np.float64) for g in got]
    want = [np.asarray(w, np.float64) for w in want]
    depth = np.abs(got[1] - want[1]).max() / max(np.abs(want[1]).max(), 1e-30)
    return (float(np.abs(got[0] - want[0]).max()),
            float(np.abs(got[2] - want[2]).max()),
            float(np.abs(got[3] - want[3]).max()), float(depth))


@pytest.mark.parametrize("kind,s,with_bg,scale", CASES, ids=IDS)
def test_forward_edges_match_jax(kind, s, with_bg, scale):
    """The plain version and the wrapper on CPU tensors against JAX."""
    rs, t, bg = _case(kind, s, with_bg, seed=s)
    with jax.disable_jit():
        want = JV.volume_render(jnp.asarray(rs), jnp.asarray(t),
                                None if bg is None else jnp.asarray(bg),
                                sigma_scale=scale)
    want = [np.asarray(w) for w in want]
    for fn in (TV.volume_render_plain, TV.volume_render_kernel):
        got = fn(_torch(rs), _torch(t), _torch(bg), sigma_scale=scale)
        assert [tuple(g.shape) for g in got] == [(N, 3), (N,), (N, s), (N,)]
        assert all(bool(torch.isfinite(g).all()) for g in got)
        assert max(_errs([g.numpy() for g in got], want)) <= JAX_TOL


# ---------------------------------------------------------------------------
# the kernel's lanes, walked in numpy


def _lane_forward(rs, t, bg, scale):
    """Kernel 4 as its lanes compute it (csrc/volrend.cu), in float32
    numpy: each ray's samples on `lanes` lanes, pieces of `lanes` with the
    transmittance carried, an inclusive product scan (Kogge-Stone, the
    VJP's) for T within a piece, a butterfly segment sum for rgb, depth
    and acc, the background blend by the segment's first lane."""
    n, S = t.shape
    plan = TV.volrend_plan(n, S, backward=False)
    W, P = plan.lanes, plan.pieces
    f32 = np.float32
    hi = f32(1.0) - f32(1e-7)
    lane = np.arange(W)
    weights = np.zeros((n, S), f32)
    sums = np.zeros((5, n, W), f32)  # r, g, b, depth, acc per lane
    T = np.ones(n, f32)
    for p in range(P):
        s = p * W + lane
        on = s < S
        sc = np.minimum(s, S - 1)
        v = np.where(on[None, :, None], rs[:, sc], f32(0))
        tt = np.where(on, t[:, sc], f32(0))
        nxt = np.where(sc < S - 1, t[:, np.minimum(sc + 1, S - 1)] - t[:, sc],
                       t[:, sc] - t[:, np.maximum(sc - 1, 0)])
        dt = np.maximum(nxt, f32(1e-4))
        sigma = np.maximum(v[..., 3], f32(0))
        if scale != 1.0:
            sigma = sigma * f32(scale)
        e = np.exp(-sigma * dt).astype(f32)
        alpha = np.where(on, np.minimum(np.maximum(f32(1) - e, f32(0)), hi),
                         f32(0))
        m = np.where(on, f32(1) - alpha + f32(1e-10), f32(1))
        incl = m.copy()
        d = 1
        while d < W:
            incl = np.where(lane >= d, incl * _seg_shift(incl, d, 1, True),
                            incl)
            d *= 2
        ex = _seg_shift(incl, 1, 1, True)
        w = alpha * (T[:, None] * ex)
        weights[:, s[on]] = w[:, on]
        r = np.minimum(np.maximum(v[..., :3], f32(0)), f32(1))
        for c in range(3):
            sums[c] = sums[c] + w * r[..., c]
        sums[3] = sums[3] + w * tt
        sums[4] = sums[4] + w
        T = T * incl[:, W - 1]
    d = W // 2
    while d >= 1:
        sums = sums + sums[:, :, lane ^ d]
        d //= 2
    rgb = np.stack([sums[c][:, 0] for c in range(3)], -1)
    acc = sums[4][:, 0]
    if bg is not None:
        rgb = rgb + (f32(1) - acc)[:, None] * bg
    return rgb, sums[3][:, 0], weights, acc


@pytest.mark.parametrize("kind,s,with_bg,scale", CASES, ids=IDS)
def test_lane_walk_matches_plain(kind, s, with_bg, scale):
    """The kernel's lane algorithm at its plan, against the plain
    version."""
    rs, t, bg = _case(kind, s, with_bg, seed=s + 200)
    want = TV.volume_render_plain(_torch(rs), _torch(t), _torch(bg),
                                  sigma_scale=scale)
    got = _lane_forward(rs, t, bg, scale)
    assert all(np.isfinite(g).all() for g in got)
    assert max(_errs(got, [w.numpy() for w in want])) <= WALK_TOL


def test_lane_walk_transmittance_is_the_vjps():
    """At the clip (alpha = 1 - 1e-7, T falling to ~1e-7 a sample) the
    walk's weights stay within 1e-5 of the sequential cumprod's and never
    go negative: the product tree rounds, it does not cancel."""
    rs, t, bg = _case("clip", 97, True, seed=5)
    want = TV.volume_render_plain(_torch(rs), _torch(t), _torch(bg))
    got = _lane_forward(rs, t, bg, 1.0)
    assert (got[2] >= 0).all()
    assert np.abs(got[2] - want[2].numpy()).max() <= WALK_TOL


# ---------------------------------------------------------------------------
# launch plans


@pytest.mark.parametrize("s", [2, 3, 4, 5, 8, 9, 16, 17, 31, 32, 33, 64, 65,
                               97, 128, 1000, 100_000])
def test_forward_plan_shares_the_vjps_lanes(s):
    """The forward's lanes and pieces are the VJP's (one order for T); it
    keeps 8 warps a block and no shared memory at any S."""
    fwd = TV.volrend_plan(4000, s, backward=False)
    bwd = TV.volrend_plan(4000, s, backward=True)
    assert (fwd.lanes, fwd.pieces) == (bwd.lanes, bwd.pieces)
    assert fwd.lanes == min(32, 1 << (s - 1).bit_length())
    assert fwd.threads == 256 and fwd.smem == 0
    assert fwd.blocks == -(-4000 // (8 * fwd.rays_per_warp))


@pytest.mark.parametrize("n,s", [(0, 2), (1, 2), (37, 3), (100, 8),
                                 (33, 17), (9, 32), (9, 33), (5, 97),
                                 (300, 16), (65_536 + 13, 32)])
def test_forward_plan_visits_every_sample_once(n, s):
    """Blocks, warps, lanes and pieces cover each (ray, sample) once, and
    each ray's first lane (the one that writes its outputs) once."""
    plan = TV.volrend_plan(n, s, backward=False)
    W, warps = plan.lanes, plan.threads // 32
    blk, w, lane = np.meshgrid(np.arange(plan.blocks), np.arange(warps),
                               np.arange(32), indexing="ij")
    ray = ((blk * warps + w) * plan.rays_per_warp + lane // W).ravel()
    sl = (lane % W).ravel()
    seen = np.zeros((n, s), np.int64)
    for p in range(plan.pieces):
        smp = p * W + sl
        on = (ray < n) & (smp < s)
        np.add.at(seen, (ray[on], smp[on]), 1)
    assert (seen == 1).all()
    leaders = ray[(sl == 0) & (ray < n)]
    assert np.array_equal(np.sort(leaders), np.arange(n))


def test_plan_structs_cached_per_direction():
    """The struct is cached per (N, S, direction), in the kernels' field
    order; the directions differ only in the VJP's carries."""
    f = TV._plan_struct(4000, 97, False)
    b = TV._plan_struct(4000, 97, True)
    assert f is TV._plan_struct(4000, 97, False) and f is not b
    assert [k for k, _ in type(f)._fields_] == [
        "lanes", "pieces", "threads", "blocks", "smem"]
    assert (f.lanes, f.pieces, f.threads, f.smem) == (32, 4, 256, 0)
    assert (b.lanes, b.pieces, b.smem) == (32, 4, 4 * 8 * 4)
    with pytest.raises(ValueError, match="S >= 2"):
        TV.volrend_plan(10, 1, backward=False)


def test_wrapper_refuses_grad_inputs():
    """The forward wrapper has no backward: under grad mode with an input
    that requires grad it raises (VolumeRender is the differentiable
    path)."""
    rs, t, bg = _case("rand", 8, True, seed=1)
    x = _torch(rs).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        TV.volume_render_kernel(x, _torch(t), _torch(bg))
