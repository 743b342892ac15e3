"""Port parity: the plane/line encoder (kernel 1's module) against JAX.

The same numpy inputs go through nerfsys_tpu.ops.planes and
nerfsys_tpu_torch.ops.planes on the CPU, where the port's kernel wrapper
runs its plain version. Both compute in float32 with the same operation
order, so the tolerance is 1e-6 absolute on features of size O(0.3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsys_tpu.ops import planes as J
from nerfsys_tpu_torch.ops import planes as T
from test_torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse)

ATOL = 1e-6


def _setup(base=8, F=4, levels=2, seed=0):
    jcfg = J.PlaneEncodingConfig(levels=levels, base_res=base, growth=2.0,
                                 features=F, matmul_bwd=True, pos_grad=False)
    tcfg = T.PlaneEncodingConfig(levels=levels, base_res=base, growth=2.0,
                                 features=F)
    params = jax.tree_util.tree_map(
        np.asarray, J.plane_encoding_init(jax.random.PRNGKey(seed), jcfg))
    tparams = {k: [torch.tensor(v) for v in vs] for k, vs in params.items()}
    return jcfg, tcfg, params, tparams


def _points(n, seed=0):
    x = np.random.default_rng(seed).uniform(size=(n, 3)).astype(np.float32)
    x[:4] = 1.0  # the far corner: u0 = R-1 where the clip rounds up
    x[4:7] = 0.0
    x[7, 0] = 1.0
    x[8] = [1.0, 0.5, 0.0]
    x[9] = [1.2, -0.3, 0.5]  # outside [0,1]: clipped
    return x


@pytest.mark.parametrize("base,F", [(8, 4), (16, 2)])
def test_plane_encode_matches_jax_and_reference(base, F):
    jcfg, tcfg, params, tparams = _setup(base, F)
    x = _points(256)
    want = np.asarray(J.plane_encode(params, jnp.asarray(x), jcfg))
    got = T.plane_encode(tparams, torch.tensor(x), tcfg).numpy()
    assert got.shape == (256, tcfg.out_dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # float64 numpy reference of the same math (R < 128: in bounds there)
    ref = J.plane_encode_ref(params, x, jcfg)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_plane_encode_clamp_edge_base_128():
    """float32(R-1-1e-6) == R-1 for R >= 128: x = 1.0 selects u0 = R-1.
    The port clamps the zero-weight neighbours in bounds; JAX reads
    wrapped packed rows with weight 0. Same result."""
    assert np.float32(127 - 1e-6) == 127.0
    jcfg, tcfg, params, tparams = _setup(base=128, F=2, levels=1)
    x = _points(64, seed=3)
    want = np.asarray(J.plane_encode(params, jnp.asarray(x), jcfg))
    got = T.plane_encode(tparams, torch.tensor(x), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.isfinite(got).all()


def test_stacked_experts_match_per_expert_and_batch_shape():
    jcfg, tcfg, _, _ = _setup()
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    per = [jax.tree_util.tree_map(np.asarray,
                                  J.plane_encoding_init(k, jcfg))
           for k in keys]
    stacked = {key: [torch.tensor(np.stack([p[key][l] for p in per]))
                     for l in range(jcfg.levels)] for key in per[0]}
    x = np.stack([_points(100, seed=s) for s in (0, 1)])
    got = T.plane_encode(stacked, torch.tensor(x), tcfg).numpy()
    assert got.shape == (2, 100, tcfg.out_dim)
    for k in range(2):
        want = np.asarray(J.plane_encode(per[k], jnp.asarray(x[k]), jcfg))
        np.testing.assert_allclose(got[k], want, rtol=0, atol=ATOL)
    # unstacked points keep their leading shape
    single = {key: [t[0] for t in v] for key, v in stacked.items()}
    out = T.plane_encode(single, torch.tensor(x[0]).reshape(10, 10, 3), tcfg)
    assert out.shape == (10, 10, tcfg.out_dim)


def test_wrapper_uses_plain_only_on_cpu():
    _, tcfg, _, tparams = _setup()
    x = torch.tensor(_points(32))
    np.testing.assert_array_equal(
        T.plane_encode_kernel(tparams, x, tcfg).numpy(),
        T.plane_encode_plain(tparams, x, tcfg).numpy())
    meta = {k: [t.to("meta") for t in v] for k, v in tparams.items()}
    with pytest.raises(ValueError):
        T.plane_encode_kernel(meta, x.to("meta"), tcfg)
