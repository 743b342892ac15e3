"""Port parity of one FoMAML outer step through the hash-grid experts
(make_train_step: task_adapt, the hash table's gradient through HashEncode,
the query loss, bench.py's per-group Adam) against the JAX package run
eagerly, on the CPU.

The K=2 hash container, its occupancy state (R=16, L=2, soft mode) and an
episode (B=2 tasks per region, 32 support and 32 query rays) come from
numpy seeds (`_setup` of tests/test_torch_hash.py); 2 inner steps, 8
samples, 32 probes, randomized=False so that both sides see the same
samples. JAX runs with jit disabled: jitted XLA on the CPU fuses
multiply-adds and moves probe and hash cells. Its first step compiles
each eager op (about a minute on one core), hence a file of its own.

Tolerances: metrics 1e-5 relative; gradients 1e-4 of each leaf's max (the
inner loop carries float32 rounding of the encoder's corner sums and the
table scatter through two SGD steps and the MLPs); params 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from nerfsys_tpu.models import container as JCo
from nerfsys_tpu.pipelines.offline import meta_core as JM
from nerfsys_tpu.pipelines.offline import meta_train_step as JS
from nerfsys_tpu.utils import optim as JO
from nerfsys_tpu_torch.models import container as TCo
from nerfsys_tpu_torch.pipelines.offline import meta_train_step as TS
from nerfsys_tpu_torch.utils import interop
from nerfsys_tpu_torch.utils import optim as TO
from nerfsys_tpu_torch.utils.tree import tree_leaves
from test_torch_hash import _max_rel, _setup
from test_torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse)


class _Recording:
    """Records the gradients each step hands the optimizer."""

    def __init__(self, opt):
        self.opt, self.grads = opt, []

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params=None):
        self.grads.append(grads)
        return self.opt.update(grads, state, params)


def _batch(K=2, B=2, S=32, Q=32, seed=0):
    rng = np.random.default_rng(seed)

    def rays(n):
        o = rng.normal(size=(K, B, n, 3)).astype(np.float32) * 0.3
        d = rng.normal(size=(K, B, n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        nf = np.tile(np.array([0.1, 2.5], np.float32), (K, B, n, 1))
        return np.concatenate([o, d, nf], -1)

    return {"support_rays": rays(S),
            "support_rgbs": rng.uniform(size=(K, B, S, 3)).astype(np.float32),
            "query_rays": rays(Q),
            "query_rgbs": rng.uniform(size=(K, B, Q, 3)).astype(np.float32),
            "valid": np.ones((K, B), np.float32)}


def test_fomaml_step_hash_matches_eager_jax():
    """One FoMAML outer step through make_train_step (2 inner steps, 8
    soft-occupancy samples, bench.py's optimizer), both sides eager:
    metrics 1e-5 relative, each leaf's gradient within 1e-4 of its max
    (the hash table's included: the scatter of 7c's plain version), and
    the updated params."""
    cfg, tcfg, (jp, jst, jocc), (tp, tst, tocc), params, *_ = _setup(
        seed=2, sigma_bias=0.5)
    batch = _batch()
    meta = JM.MetaConfig(algo="fomaml", inner_iter=2, inner_lr=0.015,
                         ray_samples=8, randomized=False, occ_importance=True,
                         occ_hard_mask=False, occ_probes=32)
    jcfg = JO.OptimConfig(outer_steps=100)
    tx = _Recording(JO.build_optimizer(jcfg, JCo.param_group_labels(params)))
    opt = _Recording(TO.build_optimizer(interop.optim_config_from_jax(jcfg),
                                        TCo.param_group_labels(params)))
    with jax.disable_jit():
        jnew, _, jm = JS.make_train_step(meta, cfg, tx)(
            jp, tx.init(jp), jst, jax.tree_util.tree_map(jnp.asarray, batch),
            jax.random.PRNGKey(0), jocc)
    tnew, _, tm = TS.make_train_step(interop.meta_config_from_jax(meta),
                                     tcfg, opt)(
        tp, opt.init(tp), tst, interop.tree_to_torch(batch, "cpu"),
        torch.Generator(), tocc)
    for k in ("loss_in", "loss_out", "loss_out_meta", "region_loss_out"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-5, err_msg=k)
    g_leaves = tree_leaves(opt.grads[0])
    w_leaves = jax.tree_util.tree_leaves(tx.grads[0])
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert _max_rel(g.numpy(), w) <= 1e-4
        assert float(g.abs().max()) > 0
    table_grad = opt.grads[0]["experts"]["hash_table"]
    assert int((table_grad != 0).sum()) > 1000
    for a, b in zip(tree_leaves(tnew), jax.tree_util.tree_leaves(jnew)):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= 1e-5
