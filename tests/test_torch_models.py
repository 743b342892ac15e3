"""Port parity: the expert field and the MoE container through interop.

Container params in the reference layout (K=2 experts, planes L=2, base 8,
F=4, hidden 16) are drawn with numpy from a seed, handed to JAX as arrays
and carried into the port by nerfsys_tpu_torch.utils.interop. Both sides
then evaluate the same numpy points. The MLPs are float32 matmuls
summed in another order by XLA and PyTorch (and XLA may fuse a multiply
and an add into one rounding inside jit), so the tolerance is 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsys_tpu.models import container as JCo
from nerfsys_tpu.models import ngp as JN
from nerfsys_tpu.ops.planes import PlaneEncodingConfig
from nerfsys_tpu_torch.models import container as TCo
from nerfsys_tpu_torch.models import ngp as TN
from nerfsys_tpu_torch.utils import interop

ATOL = 1e-5


def _np_params(rng, cfg):
    """Container params in the reference layout, drawn with numpy: the K
    experts stacked on a leading axis, per-level plane and line lists."""
    K, e = cfg.num_experts, cfg.expert

    def lin(i, o, lead=(K,)):
        s = 1.0 / np.sqrt(i)
        return {"w": (rng.uniform(-s, s, (*lead, i, o))).astype(np.float32),
                "b": (rng.uniform(-s, s, (*lead, o))).astype(np.float32)}

    res = e.planes.level_resolutions()
    F = e.planes.features
    experts = {
        "planes_enc": {
            "planes": [rng.normal(0, 0.1, (K, 3, R * R, F)).astype(np.float32)
                       for R in res],
            "lines": [rng.normal(1, 0.01, (K, 3, R, F)).astype(np.float32)
                      for R in res]},
        "sigma_trunk": [lin(e.planes.out_dim, e.hidden), lin(e.hidden,
                                                               e.hidden)],
        "sigma_head": lin(e.hidden, 1),
        "geo_head": lin(e.hidden, e.geo_feat_dim),
        "color_mlp": [lin(e.geo_feat_dim + 16, e.color_hidden),
                      lin(e.color_hidden, e.color_hidden),
                      lin(e.color_hidden, 3)],
    }
    return {"experts": experts,
            "bg": {"l0": lin(16, cfg.bg_hidden, ()),
                   "l1": lin(cfg.bg_hidden, 3, ())}}


def _setup(K=2, margin=1.1, seed=0):
    expert = JN.NGPConfig(
        hidden=16, sigma_depth=2, color_hidden=16, color_depth=2,
        geo_feat_dim=7, xyz_encoding="planes",
        planes=PlaneEncodingConfig(levels=2, base_res=8, growth=2.0,
                                   features=4, matmul_bwd=True,
                                   pos_grad=False))
    cfg = JCo.ContainerConfig(num_experts=K, expert=expert,
                              boundary_margin=margin, bg_hidden=8)
    cents = np.array([[0.0, -1.0, 0.0], [0.0, 1.0, 0.3]], np.float32)
    boxes = np.stack([np.stack([c - 1.2, c + 1.2]) for c in cents])
    gbox = np.array([[-2.5] * 3, [2.5] * 3], np.float32)
    st = JCo.ContainerStatics(jnp.asarray(cents), jnp.asarray(boxes),
                              jnp.asarray(gbox))
    np_params = _np_params(np.random.default_rng(seed), cfg)
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    tcfg = interop.container_config_from_jax(cfg)
    tparams = interop.container_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), "cpu")
    tst = interop.statics_from_jax(JCo.ContainerStatics(cents, boxes, gbox),
                                   "cpu")
    return cfg, st, params, np_params, tcfg, tst, tparams


def _pts(n=500, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-2.4, 2.4, size=(n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def test_ngp_apply_per_expert_matches_jax():
    cfg, st, params, np_params, tcfg, tst, tparams = _setup()
    x, d = _pts()
    for k in range(2):
        jp = jax.tree_util.tree_map(lambda a: a[k], params["experts"])
        want = jax.jit(JN.ngp_apply, static_argnums=1)(
            jp, cfg.expert, st.expert_aabbs[k], jnp.asarray(x),
            jnp.asarray(d))
        tp = interop.tree_to_torch(
            jax.tree_util.tree_map(lambda a: a[k], np_params["experts"]),
            "cpu")
        got = TN.ngp_apply(tp, tcfg.expert, tst.expert_aabbs[k],
                           torch.tensor(x), torch.tensor(d))
        _close(got[0], want[0])
        _close(got[1], want[1])
    # leading batch shape is kept
    rgb, sigma = TN.ngp_apply(tp, tcfg.expert, tst.expert_aabbs[1],
                              torch.tensor(x).reshape(20, 25, 3),
                              torch.tensor(d).reshape(20, 25, 3))
    assert rgb.shape == (20, 25, 3) and sigma.shape == (20, 25)


@pytest.mark.parametrize("margin", [1.1, 1.0])
def test_container_apply_and_routing_match_jax(margin):
    cfg, st, params, _, tcfg, tst, tparams = _setup(margin=margin)
    x, d = _pts(seed=1)
    _close(TCo.routing_weights(tst, tcfg, torch.tensor(x)),
           JCo.routing_weights(st, cfg, jnp.asarray(x)), 1e-6)
    want = JCo.container_apply(params, cfg, st, jnp.asarray(x),
                               jnp.asarray(d))
    got = TCo.container_apply(tparams, tcfg, tst, torch.tensor(x),
                              torch.tensor(d))
    _close(got[0], want[0])
    _close(got[1], want[1])
    want1 = JCo.container_apply(params, cfg, st, jnp.asarray(x),
                                jnp.asarray(d), active_expert=1)
    got1 = TCo.container_apply(tparams, tcfg, tst, torch.tensor(x),
                               torch.tensor(d), active_expert=1)
    _close(got1[0], want1[0])
    _close(got1[1], want1[1])


def test_background_color_matches_jax():
    cfg, st, params, _, tcfg, tst, tparams = _setup()
    _, d = _pts(64, seed=2)
    _close(TCo.background_color(tparams, tcfg, torch.tensor(d)),
           JCo.background_color(params, cfg, jnp.asarray(d)), 1e-6)
    assert TCo.container_bg_fn(tparams, tcfg) is not None


def test_interop_round_trip_and_port_init():
    _, _, _, np_params, tcfg, _, tparams = _setup()
    back = interop.tree_to_numpy(tparams)
    flat_a = jax.tree_util.tree_leaves(np_params)
    flat_b = jax.tree_util.tree_leaves(back)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    # the JAX init, the numpy params and the port's own init share one
    # structure and shapes
    cfg = _setup()[0]
    jax_shapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape),
        jax.eval_shape(lambda k: JCo.init_container_params(k, cfg),
                       jax.random.PRNGKey(0)))
    own = TCo.init_container_params(tcfg, seed=0, device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), np_params)
    assert shapes == jax_shapes
    own_shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                        interop.tree_to_numpy(own))
    assert shapes == own_shapes
    again = TCo.init_container_params(tcfg, seed=0, device="cpu")
    assert torch.equal(own["experts"]["planes_enc"]["planes"][0],
                       again["experts"]["planes_enc"]["planes"][0])


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        TN.NGPConfig(dir_encoding="frequency")
    with pytest.raises(NotImplementedError):
        TCo.ContainerConfig(num_experts=2, nerf_variant="vanilla")
    # bucketed routing and second-order MAML are ported (MAML's parity is
    # in tests/test_torch_maml.py): its step builds without raising
    from nerfsys_tpu_torch.pipelines.offline.meta_core import MetaConfig
    from nerfsys_tpu_torch.pipelines.offline.meta_train_step import (
        make_train_step,
    )
    from nerfsys_tpu_torch.utils.optim import OptimConfig, build_optimizer

    _, _, _, _, tcfg, _, tparams = _setup()
    step = make_train_step(MetaConfig(algo="maml"), tcfg, build_optimizer(
        OptimConfig(), TCo.param_group_labels(tparams)))
    assert callable(step)
