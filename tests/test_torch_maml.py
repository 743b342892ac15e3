"""Port parity of second-order MAML (`MetaConfig(algo="maml")`,
`--algo maml`): the inner loop differentiated through itself, so every
kernel's backward on the training path is differentiated again (the
compositor's 4'', the plane encoder's 5'' and the hash encoder's 7c'';
their own parity is in tests/test_torch_maml_ops.py).

The setup is tests/test_torch_train.py's (K=2 planes experts, L=2 base 8
F=4, hidden 16, the light backward as bench.py trains; soft importance
occupancy R=16 L=2; B=2 tasks of 64 support and 32 query rays, 2 inner
steps, 8 samples, randomized=False so that both sides see the same
samples). JAX runs with jit disabled, as there. The JAX MAML reference
(eager second-order autodiff through 2 inner steps) costs about a minute
and a half on one core, so the module computes it once (a module fixture)
and the checks share it.

Tolerances: losses 1e-5 relative; gradients 1e-4 of each leaf's max, as
tests/test_torch_train.py holds the FoMAML step (measured <= 6.9e-6 here:
float32 rounding of the reverse sums carried through two SGD steps and
differentiated again), well below the second-order term itself (the MAML
and FoMAML gradients differ by 5e-4 to 9e-2 of each leaf's max at this
size), and below the card's 2^-8 gate of the MAML step. The two outer
steps against JAX's make_train_step are in tests/test_torch_maml_step.py
(a second eager JAX reference, a file of its own so that the workers
share the two); the port-only checks of the MAML step and the runner are
in tests/test_torch_maml_paths.py.
"""
import jax
import numpy as np
import pytest
import torch

from nerfsys_tpu.pipelines.offline import meta_core as JM
from nerfsys_tpu_torch.pipelines.offline import meta_core as TM
from nerfsys_tpu_torch.utils import interop
from nerfsys_tpu_torch.utils.tree import tree_leaves, tree_map
from test_torch_train import _close_rel, _meta, _setup, _sides

GRAD_TOL = 1e-4  # of each leaf's max


def _outer_grads_jax(meta, cfg, jp, jst, jb, jocc, k):
    """jax.grad of expert k's query loss after its inner loop on task 0."""

    def outer(p):
        pk = jax.tree_util.tree_map(lambda a: a[k], p["experts"])
        fast, _ = JM.task_adapt(
            meta, cfg, pk, jst.expert_aabbs[k], p["bg"],
            jb["support_rays"][k, 0], jb["support_rgbs"][k, 0],
            jax.random.PRNGKey(0), occ_binary=jocc["binary"][k],
            occ_values=jocc["occs"][k])
        ql, _ = JM.query_loss(
            meta, cfg, fast, jst.expert_aabbs[k], p["bg"],
            jb["query_rays"][k, 0], jb["query_rgbs"][k, 0],
            occ_binary=jocc["binary"][k], occ_values=jocc["occs"][k])
        return ql

    with jax.disable_jit():
        return jax.value_and_grad(outer)(jp)


def _outer_grads_port(meta, tcfg, tp, tst, tb, tocc, k):
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), tp)
    pk = tree_map(lambda t: t[k], leaves["experts"])
    grid = (tocc["occs"][k:k + 1], tocc["binary"][k:k + 1],
            tst.expert_aabbs[k:k + 1])
    fast, _ = TM.task_adapt(
        meta, tcfg, pk, tst.expert_aabbs[k], leaves["bg"],
        tb["support_rays"][k, 0], tb["support_rgbs"][k, 0],
        occ_grid=grid)
    ql, _ = TM.query_loss(meta, tcfg, fast, tst.expert_aabbs[k],
                          leaves["bg"], tb["query_rays"][k, 0],
                          tb["query_rgbs"][k, 0], occ_grid=grid)
    ql.backward()
    return ql.detach(), tree_map(
        lambda t: torch.zeros_like(t) if t.grad is None else t.grad, leaves)


@pytest.fixture(scope="module")
def adapt_pair():
    """Expert 1's second-order outer gradient on both sides, and the
    port's first-order one."""
    cfg, params, statics, occ, batch = _setup()
    (jp, jst, jocc, jb), (tcfg, tp, tst, tocc, tb) = _sides(
        cfg, params, statics, occ, batch)
    jmeta = _meta(algo="maml")
    jl, jg = _outer_grads_jax(jmeta, cfg, jp, jst, jb, jocc, 1)
    tmeta = interop.meta_config_from_jax(jmeta)
    tl, tg = _outer_grads_port(tmeta, tcfg, tp, tst, tb, tocc, 1)
    fl, fg = _outer_grads_port(interop.meta_config_from_jax(_meta()), tcfg,
                               tp, tst, tb, tocc, 1)
    return (jl, jg), (tl, tg), (fl, fg)


def test_task_adapt_second_order_matches_jax(adapt_pair):
    (jl, jg), (tl, tg), _ = adapt_pair
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _close_rel(tg, jg, GRAD_TOL)
    # the expert's tables, MLPs and the background all get gradients
    assert all(float(g.abs().max()) > 0
               for g in tree_leaves(tg["experts"]) + tree_leaves(tg["bg"]))


def test_task_adapt_second_order_differs_from_first_order(adapt_pair):
    """The same query loss (the inner loop's values are the same), other
    gradients: the second-order term moves every expert leaf."""
    _, (tl, tg), (fl, fg) = adapt_pair
    assert float(tl) == float(fl)
    for a, b in zip(tree_leaves(tg["experts"]), tree_leaves(fg["experts"])):
        a, b = a[1], b[1]  # expert 1 adapted
        assert float((a - b).abs().max()) > 1e-4 * float(b.abs().max())
    # the background is trained by the query loss alone: no second order
    for a, b in zip(tree_leaves(tg["bg"]), tree_leaves(fg["bg"])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-8)

