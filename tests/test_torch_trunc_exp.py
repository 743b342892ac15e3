"""Row 12, trunc_exp: the port's plain version against the JAX package's
`trunc_exp` (value, first and second derivative) at and beyond the clamp
and on NaN, +-inf and -0.0, and the plain versions of the three kernels
(`trunc_exp_fwd`, `trunc_exp_bwd`, `trunc_exp_bwd2`) bit for bit against
autograd through `_TruncExp`, which they replace on the card. The kernels
themselves run on the card (chip_smoke's `edge trunc_exp` lines); here
the wrappers' routing and refusals."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsys_tpu.ops import activations as JA
from nerfsys_tpu_torch import kernels
from nerfsys_tpu_torch.ops import activations as TA
from test_torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse)

M = np.float32(88.7)
X = np.array([-np.inf, -1e30, -100.0, np.nextafter(-M, np.float32(-200)),
              -M, np.nextafter(-M, np.float32(0)), -20.0, -1.0, -0.0, 0.0,
              3.0, 50.0, np.nextafter(M, np.float32(0)), M,
              np.nextafter(M, np.float32(200)), 100.0, 1e30, np.inf,
              np.nan], np.float32)
BEYOND = (X > M) | (X < -M)
AT = (X == M) | (X == -M)


def _draws(seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.5, 2.0, X.size).astype(np.float32)
    v = rng.uniform(-2.0, 2.0, X.size).astype(np.float32)
    return c, v


def _same(got, want):
    """Bit-equal float32 arrays (NaN equal to NaN)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), (
        got, want)


def _jax_close(got, want, zero_for_nan=None):
    """Against eager JAX: XLA on the CPU flushes subnormals (exp(-88.7) is
    3.0e-39) to 0, so values under 1e-30 only have to be under 1e-30.
    `zero_for_nan`: where JAX gives NaN and the port an exact +0 (the
    second derivative beyond the clamp, where JAX multiplies the clip's
    zero slope into a product that overflowed to inf and autograd masks
    it)."""
    got, want = np.asarray(got), np.asarray(want)
    if zero_for_nan is not None:
        swap = zero_for_nan & np.isnan(want)
        assert np.all(got[swap] == 0.0) and not np.any(np.signbit(got[swap]))
        want = np.where(swap, np.float32(0.0), want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    tiny = ok & (np.abs(want) < 1e-30)
    assert np.all(np.abs(got[tiny]) < 1e-30)
    big = ok & ~tiny
    np.testing.assert_allclose(got[big], want[big], rtol=1e-6)


def test_plain_value_and_derivatives_match_jax():
    c, v = _draws()
    with jax.disable_jit():
        xj = jnp.asarray(X)
        y_j = JA.trunc_exp(xj)
        g_j = jax.grad(lambda z: jnp.sum(JA.trunc_exp(z) * c))(xj)
        h_j = jax.grad(lambda z: jnp.sum(jax.grad(
            lambda w: jnp.sum(JA.trunc_exp(w) * c))(z) * v))(xj)
    x = torch.tensor(X, requires_grad=True)
    y = TA.trunc_exp(x)
    g, = torch.autograd.grad((y * torch.tensor(c)).sum(), x,
                             create_graph=True)
    h, = torch.autograd.grad((g * torch.tensor(v)).sum(), x)
    for got, want in ((y, y_j), (g, g_j)):
        _jax_close(got.detach().numpy(), want)
    # above the clamp: (v c) exp(m) overflows where |v c| > 1.02
    overflow = (X > M) & (np.abs(v * c) * np.exp(np.float64(M)) > 3.4e38)
    assert overflow.any() and np.all(np.isnan(np.asarray(h_j)[overflow]))
    _jax_close(h.numpy(), h_j, zero_for_nan=BEYOND)
    h = h.numpy()
    assert np.all(h[BEYOND] == 0.0) and np.all(~np.signbit(h[BEYOND]))
    inside = ~BEYOND & ~AT & ~np.isnan(X)
    assert np.all(h[AT] != 0.0) and np.all(h[inside][X[inside] > -50] != 0.0)
    assert np.isnan(h[-1]) and np.isnan(g.detach().numpy()[-1])


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_plain_versions_are_autograd_bit_for_bit(seed):
    """The three kernels' plain versions equal autograd through _TruncExp:
    forward, backward without create_graph, and the second derivative's
    (d g, d x) for a cotangent v of the inner gradient."""
    c, v = _draws(seed)
    x = torch.tensor(X, requires_grad=True)
    y = TA._TruncExp.apply(x)
    _same(TA.trunc_exp_fwd_plain(x.detach()), y.detach())
    gt = torch.tensor(c, requires_grad=True)
    gx, = torch.autograd.grad(y, x, gt, retain_graph=True)
    _same(TA.trunc_exp_bwd_plain(gt.detach(), y.detach()), gx)
    gx2, = torch.autograd.grad(y, x, gt, create_graph=True)
    vt = torch.tensor(v)
    dx, dg = torch.autograd.grad(gx2, (x, gt), vt)
    p_dg, p_dx = TA.trunc_exp_bwd2_plain(vt, gt.detach(), x.detach())
    _same(p_dg, dg)
    _same(p_dx, dx)


def test_cpu_routes_to_the_plain_version_and_launches_nothing():
    kernels.reset_launches()
    x = torch.tensor(X)
    _same(TA.trunc_exp(x), TA.trunc_exp_fwd_plain(x))
    _same(TA.trunc_exp_fwd_kernel(x), TA.trunc_exp_fwd_plain(x))
    _same(TA.trunc_exp_bwd_kernel(x, x), x * x)
    for a, b in zip(TA.trunc_exp_bwd2_kernel(x, x, x),
                    TA.trunc_exp_bwd2_plain(x, x, x)):
        _same(a, b)
    assert all(kernels.launches()[k] == 0 for k in
               ("trunc_exp_fwd", "trunc_exp_bwd", "trunc_exp_bwd2"))


def test_wrappers_refuse_other_devices_and_dtypes():
    meta = torch.empty(8, device="meta")
    for call in (lambda: TA.trunc_exp(meta),
                 lambda: TA.trunc_exp_fwd_kernel(meta),
                 lambda: TA.trunc_exp_bwd_kernel(meta, meta),
                 lambda: TA.trunc_exp_bwd2_kernel(meta, meta, meta)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    # the launch checks: float32 of one shape on one device
    with pytest.raises(TypeError, match="float32"):
        TA._launch_args("trunc_exp", torch.zeros(8, dtype=torch.float64))
    with pytest.raises(TypeError, match="float32"):
        TA._launch_args("trunc_exp_bwd", torch.zeros(8),
                        torch.zeros(8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="shape"):
        TA._launch_args("trunc_exp_bwd", torch.zeros(8), torch.zeros(4))
