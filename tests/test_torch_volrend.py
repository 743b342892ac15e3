"""Port parity: compositing (kernel 4's module) and the leaf ops around it.

The same numpy inputs go through the JAX functions (eager, on the CPU) and
their port counterparts on CPU tensors, where kernel 4's wrapper runs its
plain version. Tolerances: 1e-6 absolute for values in [0, 1]; 1e-5 for
depth (t up to ~5) and for the cumprod/sum paths (XLA and PyTorch sum 8-32
terms in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsys_tpu.ops import activations as JA
from nerfsys_tpu.ops import color_space as JC
from nerfsys_tpu.ops import encodings as JE
from nerfsys_tpu.ops import losses as JL
from nerfsys_tpu.ops import volrend as JV
from nerfsys_tpu_torch.ops import activations as TA
from nerfsys_tpu_torch.ops import color_space as TC
from nerfsys_tpu_torch.ops import encodings as TE
from nerfsys_tpu_torch.ops import losses as TL
from nerfsys_tpu_torch.ops import volrend as TV
from test_torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse)


def _samples(seed=0, n=64, s=8):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.5, 4.5, size=(n, s)), axis=1).astype(np.float32)
    t[0, 3] = t[0, 2]  # a zero-length interval (clamped to 1e-4)
    rgb = rng.uniform(-0.2, 1.2, size=(n, s, 3)).astype(np.float32)
    sigma = rng.exponential(2.0, size=(n, s)).astype(np.float32)
    sigma[1] = -1.0  # negative density: clamped to 0
    sigma[2, 4] = 1e4  # opaque sample
    rgb_sigma = np.concatenate([rgb, sigma[..., None]], -1)
    bg = rng.uniform(size=(n, 3)).astype(np.float32)
    return rgb_sigma, t, bg


@pytest.mark.parametrize("with_bg,scale", [(True, 1.0), (False, 1.0),
                                           (True, 3.0)])
def test_volume_render_matches_jax(with_bg, scale):
    rgb_sigma, t, bg = _samples()
    want = JV.volume_render(jnp.asarray(rgb_sigma), jnp.asarray(t),
                            jnp.asarray(bg) if with_bg else None,
                            sigma_scale=scale)
    got = TV.volume_render(torch.tensor(rgb_sigma), torch.tensor(t),
                           torch.tensor(bg) if with_bg else None,
                           sigma_scale=scale)
    for g, w, tol in zip(got, want, (1e-6, 1e-5, 1e-6, 1e-6)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=tol)


def test_render_weights_and_stratified_t_vals_match_jax():
    rgb_sigma, t, _ = _samples(seed=1)
    sigma = np.maximum(rgb_sigma[..., 3], 0.0)
    for g, w in zip(TV.render_weights(torch.tensor(sigma), torch.tensor(t)),
                    JV.render_weights(jnp.asarray(sigma), jnp.asarray(t))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    near = np.linspace(0.1, 1.0, 16).astype(np.float32)
    far = near + 3.0
    np.testing.assert_array_equal(
        TV.stratified_t_vals(torch.tensor(near), torch.tensor(far),
                             24).numpy(),
        np.asarray(JV.stratified_t_vals(None, jnp.asarray(near),
                                        jnp.asarray(far), 24,
                                        randomized=False)))
    gen = torch.Generator().manual_seed(0)
    tj = TV.stratified_t_vals(torch.tensor(near), torch.tensor(far), 24,
                              randomized=True, generator=gen)
    assert (tj >= torch.tensor(near)[:, None]).all()
    assert (tj <= torch.tensor(far)[:, None]).all()


def test_background_policies():
    assert TV.background_rgb("white", 4, device="cpu").sum() == 12
    assert TV.background_rgb("none", 4, device="cpu") is None
    with pytest.raises(ValueError):
        TV.background_rgb("random", 4, device="cpu")
    with pytest.raises(ValueError):
        TV.background_rgb("sky", 4, device="cpu")
    # the device follows the sample colors when they are given
    last = torch.rand(4, 3)
    assert TV.background_rgb("black", 4, last_sample_rgb=last).device == \
        last.device


def test_sh_encode_matches_jax():
    d = np.random.default_rng(0).normal(size=(200, 3)).astype(np.float32)
    for levels in (1, 2, 3, 4, 5):
        np.testing.assert_allclose(
            TE.sh_encode(torch.tensor(d), levels).numpy(),
            np.asarray(JE.sh_encode(jnp.asarray(d), levels)), rtol=0,
            atol=1e-6)
    assert TE.sh_out_dim(4) == JE.sh_out_dim(4) == 16
    assert TE.num_sh_bases(3) == JE.num_sh_bases(3) == 16


def test_trunc_exp_value_and_gradient():
    x = np.array([-200.0, -3.0, 0.0, 2.5, 88.0, 500.0], np.float32)
    want = np.asarray(JA.trunc_exp(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(lambda v: JA.trunc_exp(v).sum())(
        jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    y = TA.trunc_exp(xt)
    y.sum().backward()
    # atol 1e-30: XLA on the CPU flushes the subnormal exp(-88.7) to zero
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=1e-6,
                               atol=1e-30)
    np.testing.assert_allclose(xt.grad.numpy(), want_g, rtol=1e-6,
                               atol=1e-30)
    assert np.isfinite(y.detach().numpy()).all()


def test_color_space_and_psnr_match_jax():
    x = np.linspace(-0.1, 1.1, 301).astype(np.float32)
    np.testing.assert_allclose(TC.linear_to_srgb(torch.tensor(x)).numpy(),
                               np.asarray(JC.linear_to_srgb(jnp.asarray(x))),
                               rtol=0, atol=1e-6)
    for m in (1e-3, 0.05, 0.0):
        assert float(TL.psnr_from_mse(torch.tensor(m))) == pytest.approx(
            float(JL.psnr_from_mse(jnp.asarray(m, jnp.float32))), rel=1e-6)
