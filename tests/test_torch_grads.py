"""Port parity of the backward kernels' modules against JAX's VJPs.

The same numpy inputs and cotangents go through `jax.vjp` of the JAX
functions (eagerly, jit disabled) and through the port's autograd Functions
on CPU tensors, where the kernel wrappers run their plain versions:

  - the compositor (`VolumeRender`, the module of kernel 4's VJP) against
    `jax.vjp(volume_render)`, with ties at every clip bound: sigma = 0,
    sigma * dt below ~3e-8 (alpha exactly 0) and rgb at 0 and 1. Target
    1e-6 absolute (gradients of size O(1); the cumprod's reverse sums run in
    another order than XLA's);
  - the plane encoder (`PlaneEncode`, kernels 5/6's module) against
    `jax.vjp(plane_encode)` with matmul_bwd=True, both modes to 1e-5 of
    each gradient's max (light mode measured <= 3.4e-7: the bfloat16
    residuals round alike on both sides). The light tables differ from the
    exact ones by 1.0e-3 to 3.7e-3 of their max (the bf16 rounding), so a
    light backward that skipped the rounding would fail.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsys_tpu.ops import planes as JP
from nerfsys_tpu.ops import volrend as JV
from nerfsys_tpu_torch import kernels
from nerfsys_tpu_torch.ops import activations as TA
from nerfsys_tpu_torch.ops import color_space as TC
from nerfsys_tpu_torch.ops import planes as TP
from nerfsys_tpu_torch.ops import volrend as TV


def _ties(seed=0, n=48, s=8):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.5, 4.5, size=(n, s)), axis=1).astype(np.float32)
    t[0, 3] = t[0, 2]  # a zero-length interval (clamped to 1e-4)
    rgb = rng.uniform(-0.2, 1.2, size=(n, s, 3)).astype(np.float32)
    rgb[3, :, :] = 0.0  # rgb exactly at the lower bound
    rgb[4, :, :] = 1.0  # and at the upper bound
    rgb[5, ::2, 1] = 0.0
    sigma = rng.exponential(1.0, size=(n, s)).astype(np.float32)
    sigma[1] = -1.0  # negative: clipped to 0
    sigma[2, 4] = 1e4  # opaque: alpha at 1 - 1e-7
    sigma[6] = 0.0  # exactly 0: a tie at max(sigma, 0) and at alpha's clip
    sigma[7] = 1e-9  # sigma * dt < 3e-8: alpha rounds to exactly 0
    sigma[8, 1:5] = 0.0
    rgb_sigma = np.concatenate([rgb, sigma[..., None]], -1)
    bg = rng.uniform(size=(n, 3)).astype(np.float32)
    cts = (rng.normal(size=(n, 3)).astype(np.float32),
           rng.normal(size=(n,)).astype(np.float32) * 0.2,
           rng.normal(size=(n, s)).astype(np.float32),
           rng.normal(size=(n,)).astype(np.float32))
    return rgb_sigma, t, bg, cts


def _jax_volume_vjp(rgb_sigma, t, bg, cts, scale, used):
    with jax.disable_jit():
        def f(rs, b):
            return JV.volume_render(rs, jnp.asarray(t), b, sigma_scale=scale)

        outs, vjp = jax.vjp(f, jnp.asarray(rgb_sigma), jnp.asarray(bg))
        ct = tuple(jnp.asarray(c) if u else jnp.zeros_like(o)
                   for c, o, u in zip(cts, outs, used))
        return [np.asarray(g) for g in vjp(ct)]


@pytest.mark.parametrize("scale,used", [
    (1.0, (True, False, False, False)),  # the training path: rgb only
    (1.0, (True, True, True, True)),
    (2.5, (True, True, False, True)),
])
def test_compositor_vjp_matches_jax(scale, used):
    rgb_sigma, t, bg, cts = _ties()
    want = _jax_volume_vjp(rgb_sigma, t, bg, cts, scale, used)
    rs = torch.tensor(rgb_sigma, requires_grad=True)
    b = torch.tensor(bg, requires_grad=True)
    outs = TV.volume_render(rs, torch.tensor(t), b, sigma_scale=scale)
    assert outs[0].grad_fn is not None
    torch.autograd.backward([o for o, u in zip(outs, used) if u],
                            [torch.tensor(c) for c, u in zip(cts, used) if u])
    np.testing.assert_allclose(rs.grad.numpy(), want[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(b.grad.numpy(), want[1], rtol=0, atol=1e-6)
    # the tie rows really carry half gradients (not 0, not the full one)
    g = rs.grad.numpy()
    assert np.all(g[6, :, 3] != 0) and np.all(g[7, :, 3] != 0)


def test_compositor_plain_and_function_agree_without_bg():
    rgb_sigma, t, _, cts = _ties(seed=3)
    grads = []
    for use_kernels in (True, False):
        rs = torch.tensor(rgb_sigma, requires_grad=True)
        rgb, depth, _, acc = TV.volume_render(rs, torch.tensor(t),
                                              use_kernels=use_kernels)
        (rgb * torch.tensor(cts[0])).sum().backward()
        grads.append(rs.grad.numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=0, atol=1e-7)


def test_clip_takes_jax_tie_rule():
    """jnp.clip passes 1/2 of the gradient at a bound; torch.clamp all of
    it. The port's clip and the plain compositor follow JAX."""
    x = np.array([-0.5, 0.0, 0.5, 1.0, 1.5], np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.clip(v, 0.0, 1.0).sum())(
        jnp.asarray(x)))
    np.testing.assert_array_equal(want, [0.0, 0.5, 1.0, 0.5, 0.0])
    xt = torch.tensor(x, requires_grad=True)
    TA.clip(xt, 0.0, 1.0).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    xc = torch.tensor(x, requires_grad=True)
    torch.clamp(xc, 0.0, 1.0).sum().backward()
    assert xc.grad[1] == 1.0  # why the port does not use clamp
    # srgb alignment at pred = 0 and 1
    p = torch.tensor([0.0, 1.0, 0.5], requires_grad=True)
    pred, _ = TC.color_space_transformer(p, torch.zeros(3), "srgb")
    pred.sum().backward()
    from nerfsys_tpu.ops import color_space as JC

    jg = jax.grad(lambda v: JC.color_space_transformer(
        v, jnp.zeros(3), "srgb")[0].sum())(jnp.asarray([0.0, 1.0, 0.5]))
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=0)


def _planes(levels=2, base=8, F=4, seed=0, pos_grad=False):
    jcfg = JP.PlaneEncodingConfig(levels=levels, base_res=base, growth=2.0,
                                  features=F, matmul_bwd=True,
                                  pos_grad=pos_grad, bwd_chunk=256)
    tcfg = TP.PlaneEncodingConfig(levels=levels, base_res=base, growth=2.0,
                                  features=F, pos_grad=pos_grad)
    params = jax.tree_util.tree_map(
        np.asarray, JP.plane_encoding_init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    # planes of size O(1), so that bf16 rounding is not below the noise
    params["planes"] = [rng.normal(size=p.shape).astype(np.float32)
                        for p in params["planes"]]
    return jcfg, tcfg, params


def _x(n, seed=0):
    x = np.random.default_rng(seed).uniform(size=(n, 3)).astype(np.float32)
    x[0] = 0.0  # on the bounds: the position mask is inclusive there
    x[1] = 1.0
    x[2] = [1.0, 0.5, 0.0]
    x[3] = [1.2, -0.3, 0.5]  # outside: zero position gradient per axis
    return x


def _jax_plane_vjp(jcfg, params, x, ct):
    with jax.disable_jit():
        out, vjp = jax.vjp(lambda p, xx: JP.plane_encode(p, xx, jcfg),
                           jax.tree_util.tree_map(jnp.asarray, params),
                           jnp.asarray(x))
        gp, gx = vjp(jnp.asarray(ct))
    return (jax.tree_util.tree_map(np.asarray, gp), np.asarray(gx),
            np.asarray(out))


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("pos_grad,tol", [(True, 1e-5), (False, 1e-5)])
@pytest.mark.parametrize("base,F", [(8, 4), (16, 2)])
def test_plane_backward_matches_jax(pos_grad, tol, base, F):
    jcfg, tcfg, params = _planes(base=base, F=F, pos_grad=pos_grad)
    x = _x(300)
    ct = np.random.default_rng(1).normal(
        size=(300, tcfg.out_dim)).astype(np.float32)
    gp, gx, out = _jax_plane_vjp(jcfg, params, x, ct)
    if not pos_grad:  # JAX's exact tables: what skipping the rounding gives
        jexact, _, _ = _planes(base=base, F=F, pos_grad=True)
        gp_exact, _, _ = _jax_plane_vjp(jexact, params, x, ct)
    tables = {k: [torch.tensor(v, requires_grad=True) for v in vs]
              for k, vs in params.items()}
    xt = torch.tensor(x, requires_grad=True)
    y = TP.plane_encode(tables, xt, tcfg)
    np.testing.assert_allclose(y.detach().numpy(), out, rtol=0, atol=1e-6)
    y.backward(torch.tensor(ct))
    for key in ("planes", "lines"):
        for l in range(jcfg.levels):
            assert _rel(tables[key][l].grad.numpy(), gp[key][l]) <= tol
            if not pos_grad:  # the check can tell light from exact
                assert _rel(tables[key][l].grad.numpy(),
                            gp_exact[key][l]) > 10 * tol
    if pos_grad:
        assert _rel(xt.grad.numpy(), gx) <= 1e-5
        assert np.all(xt.grad.numpy()[3, :2] == 0)  # outside [0, 1]
        assert np.all(xt.grad.numpy()[1] != 0)  # at 1.0: inclusive mask
    else:
        assert np.all(xt.grad.numpy() == 0) and np.all(gx == 0)


@pytest.mark.parametrize("pos_grad", [False, True])
def test_plane_backward_stacked_matches_per_expert(pos_grad):
    """Gradients of stacked (K, ...) tables equal each expert's own."""
    jcfg, tcfg, p0 = _planes(seed=0, pos_grad=pos_grad)
    _, _, p1 = _planes(seed=1, pos_grad=pos_grad)
    x = np.stack([_x(120, seed=2), _x(120, seed=3)])
    ct = np.random.default_rng(4).normal(
        size=(2, 120, tcfg.out_dim)).astype(np.float32)
    stacked = {k: [torch.tensor(np.stack([p0[k][l], p1[k][l]]),
                                requires_grad=True)
                   for l in range(jcfg.levels)] for k in p0}
    TP.plane_encode(stacked, torch.tensor(x), tcfg).backward(
        torch.tensor(ct))
    for e, params in enumerate((p0, p1)):
        gp, _, _ = _jax_plane_vjp(jcfg, params, x[e], ct[e])
        for key in ("planes", "lines"):
            for l in range(jcfg.levels):
                got = stacked[key][l].grad[e].numpy()
                assert _rel(got, gp[key][l]) <= 1e-5


def test_plane_backward_plain_path_matches_kernel_wrapper():
    """use_kernels=False (the plain forward and backward on any device)
    gives the same gradients as the kernel wrappers' CPU path."""
    _, tcfg, params = _planes()
    x = torch.tensor(_x(64))
    ct = torch.randn(64, tcfg.out_dim, generator=torch.Generator()
                     .manual_seed(0))
    grads = []
    for use_kernels in (True, False):
        tab = {k: [torch.tensor(v, requires_grad=True) for v in vs]
               for k, vs in params.items()}
        TP.plane_encode(tab, x, tcfg, use_kernels=use_kernels).backward(ct)
        grads.append([t.grad for vs in tab.values() for t in vs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_kernel_wrappers_refuse_grad_without_backward():
    """A wrapper reached under grad mode with inputs that need grad would
    return outputs without grad_fn (gradients dropped): it raises."""
    _, tcfg, params = _planes()
    tab = {k: [torch.tensor(v, requires_grad=True) for v in vs]
           for k, vs in params.items()}
    x = torch.tensor(_x(8))
    with pytest.raises(RuntimeError, match="no backward"):
        TP.plane_encode_kernel(tab, x, tcfg)
    with torch.no_grad():
        TP.plane_encode_kernel(tab, x, tcfg)
    rgb_sigma, t, bg, _ = _ties(n=16)
    rs = torch.tensor(rgb_sigma, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        TV.volume_render_kernel(rs, torch.tensor(t), torch.tensor(bg))
    with pytest.raises(RuntimeError, match="no backward"):
        kernels.check_no_grad("x", torch.zeros(1, requires_grad=True))
    # through the ops, gradients reach every input that needs them
    out = TP.plane_encode(tab, x, tcfg)
    rgb = TV.volume_render(rs, torch.tensor(t), torch.tensor(bg))[0]
    (out.sum() + rgb.sum()).backward()
    assert all(t.grad is not None for vs in tab.values() for t in vs)
    assert rs.grad is not None


def test_helpers_default_to_the_card():
    """background_rgb and get_ray_directions take their device from their
    inputs or default to the card (and so raise without one)."""
    from nerfsys_tpu_torch.ops import rays as TR

    last = torch.rand(4, 3)
    assert TV.background_rgb("white", 4, last_sample_rgb=last).device == \
        last.device
    assert TR.get_ray_directions(3, 2, 2.0, 2.0, 1.0, 1.5,
                                 device="cpu").shape == (3, 2, 3)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TV.background_rgb("white", 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.get_ray_directions(3, 2, 2.0, 2.0, 1.0, 1.5)


@pytest.mark.parametrize("space", ["linear", "srgb", "identity"])
def test_color_space_transformer_value_and_grad_match_jax(space):
    from nerfsys_tpu.ops import color_space as JC
    from nerfsys_tpu.ops import losses as JL
    from nerfsys_tpu_torch.ops import losses as TL

    rng = np.random.default_rng(5)
    pred = rng.uniform(-0.1, 1.1, size=(64, 3)).astype(np.float32)
    pred[:3] = [0.0, 1.0, 0.0031308]  # bounds and the sRGB knee
    gt = rng.uniform(-0.05, 1.05, size=(64, 3)).astype(np.float32)
    gt[3] = [0.0, 1.0, 0.04045]

    def jloss(p):
        a, b = JC.color_space_transformer(p, jnp.asarray(gt), space)
        return JL.mse(a, b)

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(pred))
    p = torch.tensor(pred, requires_grad=True)
    a, b = TC.color_space_transformer(p, torch.tensor(gt), space)
    got = TL.mse(a, b)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(b.numpy(), np.asarray(
        JC.color_space_transformer(jnp.asarray(pred), jnp.asarray(gt),
                                   space)[1]), rtol=1e-6, atol=0)
    assert float(TL.psnr(a, b).detach()) == pytest.approx(
        float(JL.psnr(*JC.color_space_transformer(
            jnp.asarray(pred), jnp.asarray(gt), space))), rel=1e-6)
    with pytest.raises(ValueError):
        TC.color_space_transformer(p, torch.tensor(gt), "xyz")
