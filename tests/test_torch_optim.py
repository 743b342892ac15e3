"""Port parity of the optimizer (utils/optim) against the reference's optax
chain, and of the optimizer-state carry-over from a JAX run.

A small container-shaped params tree and its group labels come from numpy;
the same gradients (scaled so that the global-norm clip triggers in some
steps and not in others) go through optax (`build_optimizer` of the JAX
package) and the port for 3 updates. Params, moments and counts must agree
to 1e-6 relative: the only differences are the order of the global-norm
sum and the last ulp of pow.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfsys_tpu.models import container as JCo
from nerfsys_tpu.utils import optim as JO
from nerfsys_tpu_torch.models import container as TCo
from nerfsys_tpu_torch.utils import interop
from nerfsys_tpu_torch.utils import optim as TO
from nerfsys_tpu_torch.utils.tree import tree_leaves, tree_map


def _params(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {
        "experts": {
            "planes_enc": {"planes": [f(2, 3, 16, 2), f(2, 3, 64, 2)],
                           "lines": [f(2, 3, 4, 2), f(2, 3, 8, 2)]},
            "sigma_trunk": [{"w": f(2, 12, 8), "b": f(2, 8)}],
            "sigma_head": {"w": f(2, 8, 1), "b": f(2, 1)},
            "geo_head": {"w": f(2, 8, 3), "b": f(2, 3)},
            "color_mlp": [{"w": f(2, 19, 8), "b": f(2, 8)},
                          {"w": f(2, 8, 3), "b": f(2, 3)}],
        },
        "bg": {"l0": {"w": f(16, 4), "b": f(4)},
               "l1": {"w": f(4, 3), "b": f(3)}},
    }


def _grads(params, step):
    rng = np.random.default_rng(100 + step)
    # step 0: tiny (no clip), steps 1, 2: large (clipped)
    scale = 1e-3 if step == 0 else 3.0
    return jax.tree_util.tree_map(
        lambda p: (rng.normal(size=p.shape) * scale).astype(np.float32),
        params)


def _close(got, want, rtol=1e-6):
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=1e-7)


@pytest.mark.parametrize("kw", [
    dict(),  # adam, schedule on, clip 1.0: the bench configuration
    dict(weight_decay=1e-2),  # L2 before the moments
    dict(optimizer="adamw", weight_decay=1e-2, use_scheduler=False),
    dict(optimizer="sgd", weight_decay=1e-2, grad_clip=None),
])
def test_optimizer_matches_optax_over_three_updates(kw):
    np_params = _params()
    jcfg = JO.OptimConfig(outer_steps=50, **kw)
    tcfg = interop.optim_config_from_jax(jcfg)
    assert tcfg == TO.OptimConfig(outer_steps=50, **kw)
    jlabels = JCo.param_group_labels(np_params)
    tlabels = TCo.param_group_labels(np_params)
    assert jax.tree_util.tree_leaves(jlabels) == tree_leaves(tlabels)
    tx = JO.build_optimizer(jcfg, jlabels)
    opt = TO.build_optimizer(tcfg, tlabels)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    js = tx.init(jp)
    tp = interop.tree_to_torch(np_params, "cpu")
    ts = opt.init(tp)
    for step in range(3):
        g = _grads(np_params, step)
        upd, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tu, ts = opt.update(interop.tree_to_torch(g, "cpu"), ts, tp)
        tp = TO.apply_updates(tp, tu)
        _close(tp, jp)
    assert {int(c) for c in ts["count"].values()} == {3}
    # and the carried-over state continues identically
    ts2 = interop.opt_state_from_jax(
        jax.tree_util.tree_map(np.asarray, js), "cpu")
    for key in ts:
        if key != "count":
            _close(ts[key], ts2[key])
    assert {int(c) for c in ts2["count"].values()} == {3}


def test_global_norm_and_clip_trigger():
    g = {"a": torch.tensor([3.0, 4.0]), "b": [torch.tensor([0.0])]}
    assert float(TO.global_norm(g)) == 5.0
    opt = TO.build_optimizer(
        TO.OptimConfig(optimizer="sgd", momentum=0.0, lr=1.0, encoding_lr=1.0,
                       sigma_lr=1.0, color_lr=1.0, bg_lr=1.0,
                       use_scheduler=False, grad_clip=1.0),
        {"a": "sigma", "b": ["color"]})
    params = tree_map(torch.zeros_like, g)
    upd, _ = opt.update(g, opt.init(params), params)
    np.testing.assert_allclose(upd["a"].numpy(), [-0.6, -0.8], rtol=1e-6)
    with pytest.raises(ValueError):
        TO.build_optimizer(TO.OptimConfig(optimizer="lion"), {})


def test_opt_state_from_jax_after_one_step_resumes():
    """One optax step, then the state moves to the port, which takes the
    next step: the same params as optax's second step."""
    np_params = _params(seed=1)
    jcfg = JO.OptimConfig(outer_steps=20)
    labels = JCo.param_group_labels(np_params)
    tx = JO.build_optimizer(jcfg, labels)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    js = tx.init(jp)
    g0, g1 = _grads(np_params, 0), _grads(np_params, 1)
    upd, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g0), js, jp)
    jp = optax.apply_updates(jp, upd)
    ts = interop.opt_state_from_jax(jax.tree_util.tree_map(np.asarray, js),
                                    "cpu")
    assert set(ts["count"]) == {"encoding", "sigma", "color", "background"}
    assert all(int(c) == 1 for c in ts["count"].values())
    tp = interop.tree_to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    opt = TO.build_optimizer(interop.optim_config_from_jax(jcfg),
                             TCo.param_group_labels(np_params))
    tu, ts = opt.update(interop.tree_to_torch(g1, "cpu"), ts, tp)
    tp = TO.apply_updates(tp, tu)
    upd, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g1), js, jp)
    _close(tp, optax.apply_updates(jp, upd))
    with pytest.raises(ValueError):
        interop.opt_state_from_jax({"nothing": np.zeros(1)}, "cpu")
