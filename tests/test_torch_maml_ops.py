"""Port parity of the compositor's double backward, which second-order
MAML takes through its inner loop: kernel 4'' (`VolumeRenderBwd`, the VJP
of kernel 4's VJP) against the JAX package's autodiff of its own VJP
(the encoders' and trunc_exp's are in tests/test_torch_maml_encoders.py).

For the upstream u and the cotangents v of the VJP's outputs, both sides
take the gradient of <v, VJP(u)> in (rgb_sigma, bg, u) (JAX: `jax.grad`
of the contraction through `jax.vjp`, jit disabled; the port:
`torch.autograd.grad(..., create_graph=True)` through `volume_render`,
and `volume_render_bwd2_plain` and its wrapper directly), from the same
numpy inputs: the adversarial cases tests/test_torch_volrend_edges.py
holds kernel 4' to (alpha at its clip, sigma exactly 0, rgb exactly 0
and 1, dt at its floor, S = 2 to 97, each upstream alone and all four,
no background, sigma_scale 25). Tolerance 1e-5 of each output's max
(measured <= 1e-6). The JVP's acc' = sum w' (and d bg = -G acc')
cancels to rounding noise on opaque rays, so it is held relative to the
max over rays of sum |w'| (times max |G|) instead.

Kernel 4'' is also walked as its lanes compute it on its plan
(tests/test_torch_volrend_bwd2_scan.py's scans in their tree order, the
card's tolerance 1e-5), on the same cases. The plain
compositor has a float64 `torch.autograd.gradgradcheck`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsys_tpu.ops import volrend as JV
from nerfsys_tpu_torch.ops import volrend as TV
from test_torch_volrend_bwd2_scan import lane_bwd2
from test_torch_volrend_edges import CASES, IDS, N, _inputs

TOL = 1e-5  # of each output's max
WALK_TOL = 1e-5  # the lane walk: tree-order scans (the card's tolerance)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    if scale == 0:
        return float(np.abs(got).max())
    return float(np.abs(got - want).max() / scale)


def _t(x, grad=False):
    if x is None:
        return None
    return torch.tensor(np.ascontiguousarray(x), requires_grad=grad)


# ------------------------------- compositor ----------------------------------
def _comp_case(kind, s, used, with_bg, seed):
    rs, t, bg, ups = _inputs(kind, N, s, seed)
    rng = np.random.default_rng(seed + 7)
    v_rs = rng.normal(size=rs.shape).astype(np.float32)
    v_bg = rng.normal(size=(N, 3)).astype(np.float32) if with_bg else None
    return (rs, t, bg if with_bg else None,
            [u if on else None for u, on in zip(ups, used)], v_rs, v_bg)


def _jax_bwd2(rs, t, bg, grads, v_rs, v_bg, scale):
    """jax.grad of <v, vjp(u)> in (rgb_sigma, bg, u); a None upstream is
    zeros (and gets no derivative), a missing background no term."""
    shapes = ((N, 3), (N,), t.shape, (N,))

    def psi(r, b, us):
        def f(rr, bb):
            return JV.volume_render(rr, jnp.asarray(t), bb,
                                    sigma_scale=scale)

        outs, vjp = jax.vjp(f, r, b)
        ct = tuple(jnp.zeros(sh, jnp.float32) if u is None else u
                   for u, sh in zip(us, shapes))
        g_rs, g_bg = vjp(ct)
        out = jnp.sum(g_rs * v_rs)
        if v_bg is not None:
            out = out + jnp.sum(g_bg * v_bg)
        return out

    b0 = jnp.asarray(bg if bg is not None else np.zeros((N, 3), np.float32))
    us = [None if g is None else jnp.asarray(g) for g in grads]
    with jax.disable_jit():
        if bg is None:
            d_rs, d_us = jax.grad(lambda r, u: psi(r, None, u),
                                  argnums=(0, 1))(jnp.asarray(rs), us)
            d_bg = None
        else:
            d_rs, d_bg, d_us = jax.grad(psi, argnums=(0, 1, 2))(
                jnp.asarray(rs), b0, us)
    return (np.asarray(d_rs), None if d_bg is None else np.asarray(d_bg),
            [None if u is None else np.asarray(u) for u in d_us])


def _through_function(rs, t, bg, grads, v_rs, v_bg, scale):
    """The port's autograd: the gradient of <v, VJP(u)> through
    `volume_render` (VolumeRender, then VolumeRenderBwd under
    create_graph)."""
    r = _t(rs, grad=True)
    b = _t(bg, grad=True)
    us = [_t(g, grad=True) for g in grads]
    outs = TV.volume_render(r, _t(t), b, sigma_scale=scale)
    pairs = [(o, u) for o, u in zip(outs, us) if u is not None]
    ins = [r] + ([] if b is None else [b])
    g = torch.autograd.grad([o for o, _ in pairs], ins,
                            [u for _, u in pairs], create_graph=True,
                            allow_unused=True)
    psi = (g[0] * _t(v_rs)).sum()
    if b is not None and v_bg is not None and g[1] is not None:
        psi = psi + (g[1] * _t(v_bg)).sum()
    wrt = ins + [u for u in us if u is not None]
    d = torch.autograd.grad(psi, wrt, allow_unused=True)
    d = [torch.zeros_like(w) if x is None else x for x, w in zip(d, wrt)]
    d_rs, rest = d[0], d[1:]
    d_bg = None
    if b is not None:
        d_bg, rest = rest[0], rest[1:]
    it = iter(rest)
    return d_rs, d_bg, [None if u is None else next(it) for u in us]


def _wdot_scale(rs, t, v_rs, scale):
    """max over rays of sum_s |w'_s| (JAX's JVP of the weights in the
    direction v_rs): the scale of acc' = sum_s w'_s, which cancels to
    rounding noise on opaque rays (acc at 1 whatever the tangent), and so
    of d acc and d bg = -G acc'."""
    with jax.disable_jit():
        _, wd = jax.jvp(lambda r: JV.volume_render(
            r, jnp.asarray(t), None, sigma_scale=scale)[2],
            (jnp.asarray(rs),), (jnp.asarray(v_rs),))
    return float(np.abs(np.asarray(wd, np.float64)).sum(1).max())


def _comp_errs(got, want, grads, acc_scale):
    """(name, error over its scale): d rgb_sigma, d bg, each d u over the
    max of its own want, except acc' over `acc_scale` and d bg over
    max |G| acc_scale."""
    d_rs, d_bg, d_u = got
    out = [("rgb_sigma", _rel(d_rs, want[0]))]
    if want[1] is not None:
        g_max = float(np.abs(grads[0]).max()) if grads[0] is not None else 1
        out.append(("bg", float(np.abs(np.asarray(d_bg, np.float64)
                                       - want[1]).max())
                    / max(g_max * acc_scale, 1e-30)))
    for i, (a, b) in enumerate(zip(d_u, want[2])):
        assert (a is None) == (b is None)
        if b is None:
            continue
        err = (float(np.abs(np.asarray(a, np.float64) - b).max())
               / max(acc_scale, 1e-30) if i == 3 else _rel(a, b))
        out.append((("rgb", "depth", "weights", "acc")[i], err))
    return out


@pytest.mark.parametrize("kind,s,used,with_bg,scale", CASES, ids=IDS)
def test_compositor_bwd2_matches_jax(kind, s, used, with_bg, scale):
    rs, t, bg, grads, v_rs, v_bg = _comp_case(kind, s, used, with_bg, s)
    want = _jax_bwd2(rs, t, bg, grads, v_rs, v_bg, scale)
    acc_scale = _wdot_scale(rs, t, v_rs, scale)
    plain = TV.volume_render_bwd2_plain(
        _t(rs), _t(t), _t(bg), tuple(_t(g) for g in grads), _t(v_rs),
        _t(v_bg), sigma_scale=scale)
    kern = TV.volume_render_bwd2_kernel(
        _t(rs), _t(t), _t(bg), tuple(_t(g) for g in grads), _t(v_rs),
        _t(v_bg), sigma_scale=scale)
    func = _through_function(rs, t, bg, grads, v_rs, v_bg, scale)
    assert np.abs(want[0]).max() > 0
    for d_rs, d_bg, d_u in (plain, kern, func):
        assert torch.isfinite(d_rs).all()
        assert (d_bg is None) == (not with_bg)
        got = (d_rs.detach().numpy(),
               None if d_bg is None else d_bg.detach().numpy(),
               [None if u is None else u.detach().numpy() for u in d_u])
        errs = _comp_errs(got, want, grads, acc_scale)
        assert all(e <= TOL for _, e in errs), errs


def _lane_bwd2(rs, t, bg, grads, v_rs, v_bg, scale):
    """Kernel 4'' as its lanes compute it (csrc/volrend_bwd2.cu) on its
    plan, kernel 4''s `volrend_plan`: the forward pair as one scan, Q and
    P as two (tests/test_torch_volrend_bwd2_scan.py), in float32 torch."""
    n, S = t.shape
    plan = TV.volrend_plan(n, S, backward=True)
    got = lane_bwd2(_t(rs), _t(t), _t(bg), tuple(_t(g) for g in grads),
                    _t(v_rs), _t(v_bg), scale, plan.lanes, plan.pieces)
    return (got[0].numpy(), None if got[1] is None else got[1].numpy(),
            [None if u is None else u.numpy() for u in got[2]])


@pytest.mark.parametrize("kind,s,used,with_bg,scale", CASES, ids=IDS)
def test_compositor_bwd2_lane_walk_matches_plain(kind, s, used, with_bg,
                                                 scale):
    """Kernel 4'''s lane algorithm at its plan, against the plain version."""
    rs, t, bg, grads, v_rs, v_bg = _comp_case(kind, s, used, with_bg,
                                              s + 100)
    want = TV.volume_render_bwd2_plain(
        _t(rs), _t(t), _t(bg), tuple(_t(g) for g in grads), _t(v_rs),
        _t(v_bg), sigma_scale=scale)
    got = _lane_bwd2(rs, t, bg, grads, v_rs, v_bg, scale)
    assert np.isfinite(got[0]).all()
    want = (want[0].numpy(), None if want[1] is None else want[1].numpy(),
            [None if u is None else u.numpy() for u in want[2]])
    errs = _comp_errs(got, want, grads, _wdot_scale(rs, t, v_rs, scale))
    assert all(e <= WALK_TOL for _, e in errs), errs


def test_compositor_gradgradcheck():
    """The plain compositor in float64, away from every clip tie."""
    rng = np.random.default_rng(0)
    n, s = 3, 5
    t = np.sort(rng.uniform(0.5, 2.0, (n, s)), axis=1)
    rs = np.concatenate([rng.uniform(0.1, 0.9, (n, s, 3)),
                         rng.uniform(0.2, 2.0, (n, s, 1))], -1)
    r = torch.tensor(rs, requires_grad=True)
    b = torch.tensor(rng.uniform(size=(n, 3)), requires_grad=True)
    tt = torch.tensor(t)

    def f(r, b):
        return TV.volume_render_plain(r, tt, b, sigma_scale=1.5)

    assert torch.autograd.gradgradcheck(f, (r, b))


def test_compositor_first_order_takes_no_bwd2(monkeypatch):
    """Without create_graph VolumeRender's backward launches kernel 4' and
    never builds the differentiable VJP (FoMAML, Reptile and the adapt
    step pay nothing); a third derivative raises."""
    rs, t, bg, grads, v_rs, v_bg = _comp_case("rand", 8, (True,) * 4, True,
                                              0)
    calls = []

    def spy(*a, **k):
        calls.append(1)
        raise AssertionError("VolumeRenderBwd reached without create_graph")

    r = _t(rs, grad=True)
    with monkeypatch.context() as mp:
        mp.setattr(TV.VolumeRenderBwd, "apply", spy)
        TV.volume_render(r, _t(t), _t(bg))[0].sum().backward()
    assert not calls and r.grad is not None
    g, = torch.autograd.grad(TV.volume_render(r, _t(t), _t(bg))[0].sum(), r,
                             create_graph=True)
    h, = torch.autograd.grad((g * _t(v_rs)).sum(), r, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(h.sum(), r)


def test_compositor_bwd2_wrapper_refuses_grad():
    rs, t, bg, grads, v_rs, v_bg = _comp_case("rand", 8, (True,) * 4, True,
                                              0)
    with pytest.raises(RuntimeError, match="no backward"):
        TV.volume_render_bwd2_kernel(_t(rs, grad=True), _t(t), _t(bg),
                                     tuple(_t(g) for g in grads), _t(v_rs),
                                     _t(v_bg))
