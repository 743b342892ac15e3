"""Adversarial inputs of the compositor's VJP (kernel 4's VJP, its module
`nerfsys_tpu_torch.ops.volrend`) against JAX, the kernel's lane algorithm
walked in numpy, and its launch plans.

The same numpy inputs and cotangents go through `jax.vjp` of
nerfsys_tpu.ops.volrend.volume_render (jit disabled) and through the port's
`volume_render_bwd_plain` and `volume_render_bwd_kernel` on CPU tensors
(where the wrapper runs the plain version). The inputs are the ones
chip_smoke.py holds the kernel to on the card: alpha at its 1 - 1e-7 clip
(sigma * dt >= 17), sigma exactly 0 and 1e-9 (alpha = 0 ties), rgb exactly
0 and 1, zero-length intervals (dt at its 1e-4 floor, the last one
included), S = 2, 8, 31, 33, 64 and 97, each upstream gradient alone and
all four, no background, sigma_scale 25. Tolerances, relative to each
gradient's max: 1e-6 for the plain version against JAX (the same
operations; the cumprod VJPs sum in other orders); 1e-5 for the lane walk
(scans in a tree order instead of the sequential products), the card's
tolerance. The background's gradient G (1 - acc) is held relative to
max |G|: where acc rounds to 1, either side's 1 - sum(w) is an ulp of 1.

The plans are plain functions of (N, S): the tests check that a ray's
samples fill one segment of a warp (several rays a warp for S <= 16,
pieces of 32 with a carry for S > 32), that blocks, warps, lanes and
pieces visit every (ray, sample) exactly once, and that the shared memory
of the piece carries stays within the 48 KB a block has without opting in.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsys_tpu.ops import volrend as JV
from nerfsys_tpu_torch.ops import volrend as TV
from test_torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse)

N = 24
JAX_TOL = 1e-6  # of each gradient's max: the same operations, other orders
WALK_TOL = 1e-5  # of each gradient's max: tree-order scans (the card's)
ALL4 = (True, True, True, True)


def _inputs(kind, n, s, seed):
    """rgb_sigma (n, s, 4), t (n, s), bg (n, 3) and the upstream (rgb,
    depth, weights, acc) gradients, float32 numpy (chip_smoke's kinds)."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.1, 2.5, (n, s)), axis=1).astype(np.float32)
    rgb = rng.uniform(-0.2, 1.2, (n, s, 3)).astype(np.float32)
    sigma = rng.exponential(1.0, (n, s)).astype(np.float32)
    if kind == "clip":  # alpha at 1 - 1e-7: sigma * dt >= 17
        sigma[0::2, ::3] = 17.0 / 1e-4
        sigma[1::2, s // 2] = 17.0 / 1e-4
    elif kind == "zero":  # ties at max(sigma, 0) and at alpha's lower clip
        sigma[0::2] = 0.0
        sigma[1::2, ::2] = 0.0
        sigma[3::4, 1::2] = 1e-9
    elif kind == "rgb01":  # ties at the rgb clip bounds
        rgb[0::2] = 0.0
        rgb[1::2] = 1.0
        rgb[0::4, ::2, 1] = 1.0
    elif kind == "dtfloor":  # zero-length intervals, the last one too
        t[:, 1::2] = t[:, 0:s - 1:2][:, :t[:, 1::2].shape[1]]
        t[:, -1] = t[:, -2]
    rgb_sigma = np.concatenate([rgb, sigma[..., None]], axis=-1)
    ups = (rng.normal(size=(n, 3)), 0.2 * rng.normal(size=(n,)),
           rng.normal(size=(n, s)), rng.normal(size=(n,)))
    return (rgb_sigma, t, rng.uniform(size=(n, 3)).astype(np.float32),
            [u.astype(np.float32) for u in ups])


CASES = ([("clip", 32, ALL4, True, 1.0), ("zero", 32, ALL4, True, 1.0),
          ("rgb01", 32, ALL4, True, 1.0), ("dtfloor", 32, ALL4, True, 1.0)]
         + [("rand", s, ALL4, True, 1.0) for s in (2, 8, 31, 33, 64, 97)]
         + [("rand", 32, tuple(j == i for j in range(4)), True, 1.0)
            for i in range(4)]
         + [("rand", 32, ALL4, False, 1.0), ("rand", 32, ALL4, True, 25.0),
            ("clip", 97, ALL4, True, 25.0), ("dtfloor", 33, ALL4, True, 1.0),
            ("zero", 8, ALL4, False, 25.0)])
IDS = [f"{k}-S{s}-{''.join('1' if u else '0' for u in used)}"
       f"{'' if bg else '-nobg'}-x{scale:g}"
       for k, s, used, bg, scale in CASES]


def _case(kind, s, used, with_bg, seed):
    rs, t, bg, ups = _inputs(kind, N, s, seed)
    return rs, t, (bg if with_bg else None), [
        u if on else None for u, on in zip(ups, used)]


def _jax_vjp(rs, t, bg, grads, scale):
    """jax.vjp of volume_render; a None upstream gradient is zeros."""
    with jax.disable_jit():
        def f(r, b):
            return JV.volume_render(r, jnp.asarray(t), b, sigma_scale=scale)

        b0 = jnp.asarray(bg if bg is not None else np.zeros((N, 3),
                                                            np.float32))
        outs, vjp = jax.vjp(f, jnp.asarray(rs), b0)
        ct = tuple(jnp.zeros_like(o) if g is None else jnp.asarray(g)
                   for g, o in zip(grads, outs))
        g_rs, g_bg = vjp(ct)
    return np.asarray(g_rs), np.asarray(g_bg)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _bg_err(got, want, grads):
    """|d bg| error over max |G| (1 if G is absent: then both are 0)."""
    scale = float(np.abs(grads[0]).max()) if grads[0] is not None else 1.0
    return float(np.abs(np.asarray(got, np.float64) - want).max() / scale)


def _torch(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("kind,s,used,with_bg,scale", CASES, ids=IDS)
def test_vjp_edges_match_jax(kind, s, used, with_bg, scale):
    """The plain version and the wrapper on CPU tensors against jax.vjp."""
    rs, t, bg, grads = _case(kind, s, used, with_bg, seed=s)
    want, want_bg = _jax_vjp(rs, t, bg, grads, scale)
    assert np.abs(want).max() > 0
    for fn in (TV.volume_render_bwd_plain, TV.volume_render_bwd_kernel):
        got, got_bg = fn(_torch(rs), _torch(t), _torch(bg),
                         tuple(_torch(g) for g in grads), sigma_scale=scale)
        assert got.shape == (N, s, 4) and torch.isfinite(got).all()
        assert _rel(got.numpy(), want) <= JAX_TOL
        if with_bg:
            assert _bg_err(got_bg.numpy(), want_bg, grads) <= JAX_TOL
        else:
            assert got_bg is None


def test_vjp_ties_carry_half_gradients():
    """sigma exactly 0 passes half the gradient at max(sigma, 0) (JAX's tie
    rule): exactly half of what sigma = 1e-30 gets (no tie at the max, the
    same alpha = 0 tie at alpha's clip), neither 0 nor all of it."""
    rs, t, bg, grads = _case("zero", 32, ALL4, True, seed=1)
    got, _ = TV.volume_render_bwd_plain(_torch(rs), _torch(t), _torch(bg),
                                        tuple(_torch(g) for g in grads))
    full = rs.copy()
    full[..., 3] = np.where(rs[..., 3] == 0.0, 1e-30, rs[..., 3])
    ref, _ = TV.volume_render_bwd_plain(_torch(full), _torch(t), _torch(bg),
                                        tuple(_torch(g) for g in grads))
    zero = rs[..., 3] == 0.0
    g, r = got[..., 3].numpy()[zero], ref[..., 3].numpy()[zero]
    assert (r != 0).all()
    np.testing.assert_allclose(g, 0.5 * r, rtol=1e-6)


# ---------------------------------------------------------------------------
# the kernel's lanes, walked in numpy


def _seg_shift(v, d, fill, up):
    """Lane l takes lane l - d (up) or l + d of its segment, `fill` past
    the edge (where the kernel's predicate keeps the own value)."""
    out = np.full_like(v, fill)
    if up:
        out[:, d:] = v[:, :-d]
    else:
        out[:, :-d] = v[:, d:]
    return out


def _clip_grad(x, lo, hi):
    """d clip(x, lo, hi) / dx under JAX's tie rule (half at a bound)."""
    m = np.maximum(x, lo)
    return (np.where(x > lo, 1, np.where(x == lo, 0.5, 0))
            * np.where(m < hi, 1, np.where(m == hi, 0.5, 0))).astype(
                np.float32)


def _lane_vjp(rs, t, bg, grads, scale):
    """Kernel 4's VJP as its lanes compute it (csrc/volrend_bwd.cu), in
    float32 numpy: each ray's samples on `lanes` lanes, pieces of `lanes`
    with a carry, an inclusive product scan (Kogge-Stone) for T, the
    division-free suffix scan of the affine maps x -> g alpha + m x, the
    segment sum for acc."""
    n, S = t.shape
    plan = TV.volrend_plan(n, S, backward=True)
    W, P = plan.lanes, plan.pieces
    f32 = np.float32
    hi = f32(1.0) - f32(1e-7)
    lane = np.arange(W)
    G = grads[0] if grads[0] is not None else np.zeros((n, 3), f32)
    gd = grads[1] if grads[1] is not None else np.zeros(n, f32)
    ga = grads[3] if grads[3] is not None else np.zeros(n, f32)
    b = bg if bg is not None else np.zeros((n, 3), f32)
    out = np.zeros((n, S, 4), f32)

    def load(p):
        s = p * W + lane
        on = s < S
        sc = np.minimum(s, S - 1)
        v = np.where(on[None, :, None], rs[:, sc], f32(0))
        tt = t[:, sc]
        nxt = np.where(sc < S - 1, t[:, np.minimum(sc + 1, S - 1)] - tt,
                       tt - t[:, np.maximum(sc - 1, 0)])
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
        return s, on, v, tt, dt, e, alpha, m, incl

    starts, T = [], np.ones(n, f32)
    for p in range(P):
        incl = load(p)[-1]
        starts.append(T)
        T = T * incl[:, W - 1]
    A, acc = np.zeros(n, f32), np.zeros((n, W), f32)
    for p in range(P - 1, -1, -1):
        s, on, v, tt, dt, e, alpha, m, incl = load(p)
        ex = _seg_shift(incl, 1, 1, True)
        Ts = starts[p][:, None] * ex if P > 1 else ex
        w = alpha * Ts
        acc = acc + w
        r = np.minimum(np.maximum(v[..., :3], f32(0)), f32(1))
        g = ((G[:, None, 0] * (r[..., 0] - b[:, None, 0])
              + G[:, None, 1] * (r[..., 1] - b[:, None, 1])
              + G[:, None, 2] * (r[..., 2] - b[:, None, 2]))
             + gd[:, None] * tt + ga[:, None])
        if grads[2] is not None:
            g = g + grads[2][:, np.minimum(s, S - 1)]
        g = np.where(on, g, f32(0))
        mm, bb = m.copy(), g * alpha
        d = 1
        while d < W:
            m2, b2 = _seg_shift(mm, d, 1, False), _seg_shift(bb, d, 0, False)
            bb, mm = bb + mm * b2, mm * m2
            d *= 2
        mn, bn = _seg_shift(mm, 1, 1, False), _seg_shift(bb, 1, 0, False)
        d_alpha = Ts * (g - (bn + mn * A[:, None]))
        A = bb[:, 0] + mm[:, 0] * A
        d_sigma = d_alpha * _clip_grad(f32(1) - e, f32(0), hi) * (e * dt)
        if scale != 1.0:
            d_sigma = d_sigma * f32(scale)
        grad = np.stack([w * G[:, None, c] * _clip_grad(v[..., c], f32(0),
                                                         f32(1))
                         for c in range(3)]
                        + [d_sigma * _clip_grad(v[..., 3], f32(0), np.inf)],
                        -1).astype(f32)
        out[:, s[on]] = grad[:, on]
    d = W // 2
    while d >= 1:
        acc = acc + acc[:, lane ^ d]
        d //= 2
    return out, (G * (f32(1) - acc[:, :1])) if bg is not None else None


@pytest.mark.parametrize("kind,s,used,with_bg,scale", CASES, ids=IDS)
def test_lane_walk_matches_plain(kind, s, used, with_bg, scale):
    """The kernel's lane algorithm at its plan, against the plain version."""
    rs, t, bg, grads = _case(kind, s, used, with_bg, seed=s + 100)
    want, want_bg = TV.volume_render_bwd_plain(
        _torch(rs), _torch(t), _torch(bg), tuple(_torch(g) for g in grads),
        sigma_scale=scale)
    got, got_bg = _lane_vjp(rs, t, bg, grads, scale)
    assert np.isfinite(got).all()
    assert _rel(got, want.numpy()) <= WALK_TOL
    if with_bg:
        assert _bg_err(got_bg, want_bg.numpy(), grads) <= WALK_TOL


# ---------------------------------------------------------------------------
# launch plans


@pytest.mark.parametrize("s", [2, 3, 4, 5, 8, 9, 16, 17, 31, 32, 33, 64, 65,
                               97, 128, 1000])
def test_plan_lanes_and_pieces(s):
    """A ray's samples fill one segment: the power of 2 at or above S up to
    32 lanes (so 32 / lanes rays a warp), then pieces of 32."""
    plan = TV.volrend_plan(4000, s, backward=True)
    assert plan.lanes == min(32, 1 << (s - 1).bit_length())
    assert plan.lanes * plan.rays_per_warp == 32
    assert (plan.pieces - 1) * plan.lanes < s <= plan.pieces * plan.lanes
    assert plan.pieces == 1 or plan.lanes == 32
    assert plan.rays_per_warp == (32 // plan.lanes if s <= 16 else 1)
    assert plan.threads == 256
    assert plan.smem == (4 * 8 * plan.pieces if plan.pieces > 1 else 0)
    assert plan.blocks == -(-4000 // (8 * plan.rays_per_warp))


@pytest.mark.parametrize("n,s", [(1, 2), (37, 3), (100, 8), (33, 17),
                                 (9, 32), (9, 33), (5, 97), (300, 16)])
def test_plan_visits_every_sample_once(n, s):
    """Blocks, warps, lanes and pieces cover each (ray, sample) once."""
    plan = TV.volrend_plan(n, s, backward=True)
    seen = np.zeros((n, s), np.int64)
    W, warps = plan.lanes, plan.threads // 32
    for blk in range(plan.blocks):
        for w in range(warps):
            for lane in range(32):
                ray = (blk * warps + w) * plan.rays_per_warp + lane // W
                for p in range(plan.pieces):
                    smp = p * W + lane % W
                    if ray < n and smp < s:
                        seen[ray, smp] += 1
    assert (seen == 1).all()


def test_plan_limits_and_struct():
    """Long rays take fewer warps a block to keep the carries within 48 KB;
    beyond one warp's worth the plan refuses, as it does S < 2; the struct
    carries the fields in the kernel's order and is cached per shape."""
    big = TV.volrend_plan(10, 100_000, backward=True)
    assert big.pieces == 3125 and big.threads == 96
    assert big.smem == 4 * 3 * 3125 <= 48 * 1024
    with pytest.raises(ValueError, match="shared memory"):
        TV.volrend_plan(10, 32 * 12_289, backward=True)
    with pytest.raises(ValueError, match="S >= 2"):
        TV.volrend_plan(10, 1, backward=True)
    st = TV._plan_struct(4000, 32, True)
    assert st is TV._plan_struct(4000, 32, True)
    assert [f for f, _ in type(st)._fields_] == [
        "lanes", "pieces", "threads", "blocks", "smem"]
    assert (st.lanes, st.pieces, st.threads, st.blocks, st.smem) == (
        32, 1, 256, 500, 0)


def test_plain_vjp_without_a_background_gradient_path():
    """A background with only the depth gradient upstream (rgb unused):
    the background's gradient is zeros, as JAX's."""
    rs, t, bg, grads = _case("rand", 8, (False, True, False, False), True,
                             seed=3)
    _, g_bg = TV.volume_render_bwd_plain(_torch(rs), _torch(t), _torch(bg),
                                         tuple(_torch(g) for g in grads))
    assert g_bg is not None and not g_bg.any()
