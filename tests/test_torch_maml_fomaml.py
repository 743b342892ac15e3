"""Second-order MAML against first-order MAML in the port: from the same
params and draws, `make_train_step(MetaConfig(algo="maml"))` and the
FoMAML step agree on the meta loss (the inner loop's values are the same)
and their expert gradients differ by the second-order term, as the JAX
package's tests/test_meta.py holds its own. The port alone: the two MAML
steps against the JAX package are in tests/test_torch_maml_step.py.

The setup is tests/test_torch_train.py's (`_setup(seed=1)`, one task
padded out), as there.
"""
import pytest
import torch

from nerfsys_tpu_torch.models import container as TCo
from nerfsys_tpu_torch.pipelines.offline import meta_train_step as TS
from nerfsys_tpu_torch.utils import interop
from nerfsys_tpu_torch.utils import optim as TO
from nerfsys_tpu_torch.utils.tree import tree_leaves
from test_torch_train import _meta, _Recording, _setup, _sides
from test_torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse)


@pytest.fixture(scope="module")
def maml_and_fomaml():
    """(metrics, gradients) of the port's first MAML step and of its FoMAML
    step from the same params and draws."""
    cfg, params, statics, occ, batch = _setup(seed=1)
    batch["valid"][1, 1] = 0.0
    _, (tcfg, tp, tst, tocc, tb) = _sides(cfg, params, statics, occ, batch)
    out = []
    for algo in ("maml", "fomaml"):
        opt = _Recording(TO.build_optimizer(TO.OptimConfig(outer_steps=100),
                                            TCo.param_group_labels(tp)))
        _, _, m = TS.make_train_step(
            interop.meta_config_from_jax(_meta(algo=algo)), tcfg, opt)(
            tp, opt.init(tp), tst, tb, torch.Generator(), tocc)
        out.append((m, opt.grads[0]))
    return out


def test_maml_step_gradient_differs_from_fomaml(maml_and_fomaml):
    """The same meta loss; every gradient finite; the expert gradients
    apart by more than 1e-2 of a leaf's max somewhere."""
    (mm, gm), (mf, gf) = maml_and_fomaml
    assert float(mm["loss_out_meta"]) == pytest.approx(
        float(mf["loss_out_meta"]), rel=1e-6)
    ga, gb = tree_leaves(gm["experts"]), tree_leaves(gf["experts"])
    assert all(bool(torch.isfinite(g).all()) for g in ga + gb)
    assert not all(torch.allclose(a, b) for a, b in zip(ga, gb))
    w = [float((a - b).abs().max()) / float(b.abs().max())
         for a, b in zip(ga, gb)]
    assert max(w) > 1e-2


def test_maml_step_background_gradient_is_first_order(maml_and_fomaml):
    """The background is trained by the query loss alone (its inner-loop
    copy is detached), so its gradient takes no second-order term."""
    (_, gm), (_, gf) = maml_and_fomaml
    for a, b in zip(tree_leaves(gm["bg"]), tree_leaves(gf["bg"])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-8)
