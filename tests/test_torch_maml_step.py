"""Port parity of second-order MAML's outer step: two steps of
`make_train_step(MetaConfig(algo="maml"))` with bench.py's optimizer
(Adam per group, decay, clip 1.0; one task padded out) against the JAX
package's. The MAML step against the FoMAML step is in
tests/test_torch_maml_fomaml.py (the port alone).

The setup is tests/test_torch_train.py's (`_setup(seed=1)`: K=2 planes
experts, L=2 base 8 F=4, hidden 16, the light backward; soft importance
occupancy R=16 L=2; B=2 tasks of 64 support and 32 query rays, 2 inner
steps, 8 samples, randomized=False). JAX runs with jit disabled; its two
MAML steps (eager second-order autodiff through the inner loops of 2
tasks x 2 experts) are computed once for the module. Nearly all of their
time is eager JAX compiling each new primitive signature once (about
1,700 in the first step); the second step reuses them and takes about a
tenth of the first.

Tolerances: losses 1e-5 relative, gradients 1e-4 of each leaf's max (as
tests/test_torch_maml.py), the updated params 1e-5 (Adam moves each
weight by about lr * sign(g)).
"""
import jax
import numpy as np
import pytest
import torch

from nerfsys_tpu.models import container as JCo
from nerfsys_tpu.pipelines.offline import meta_train_step as JS
from nerfsys_tpu.utils import optim as JO
from nerfsys_tpu_torch.models import container as TCo
from nerfsys_tpu_torch.pipelines.offline import meta_train_step as TS
from nerfsys_tpu_torch.utils import interop
from nerfsys_tpu_torch.utils import optim as TO
from nerfsys_tpu_torch.utils.tree import tree_leaves
from test_torch_train import (
    _close_rel,
    _meta,
    _metrics_close,
    _Recording,
    _setup,
    _sides,
)

GRAD_TOL = 1e-4  # of each leaf's max


@pytest.fixture(scope="module")
def step_pair():
    """Two MAML outer steps with bench.py's optimizer on both sides (one
    task padded out)."""
    cfg, params, statics, occ, batch = _setup(seed=1)
    batch["valid"][1, 1] = 0.0
    jmeta = _meta(algo="maml")
    jcfg = JO.OptimConfig(outer_steps=100)
    tx = _Recording(JO.build_optimizer(jcfg, JCo.param_group_labels(params)))
    opt = _Recording(TO.build_optimizer(interop.optim_config_from_jax(jcfg),
                                        TCo.param_group_labels(params)))
    (jp, jst, jocc, jb), (tcfg, tp, tst, tocc, tb) = _sides(
        cfg, params, statics, occ, batch)
    jstep = JS.make_train_step(jmeta, cfg, tx)
    tmeta = interop.meta_config_from_jax(jmeta)
    assert tmeta.algo == "maml" and not tmeta.first_order
    tstep = TS.make_train_step(tmeta, tcfg, opt)
    js, ts = tx.init(jp), opt.init(tp)
    steps = []
    for _ in range(2):
        with jax.disable_jit():
            jp, js, jm = jstep(jp, js, jst, jb, jax.random.PRNGKey(0), jocc)
        tp, ts, tm = tstep(tp, ts, tst, tb, torch.Generator(), tocc)
        steps.append((jm, tm, jp, tp))
    return steps, tx.grads, opt.grads, ts


@pytest.mark.parametrize("i", [0, 1])
def test_maml_steps_match_jax(step_pair, i):
    """Each of two outer steps: metrics, the gradients handed to Adam,
    the updated params."""
    steps, jgrads, tgrads, ts = step_pair
    jm, tm, jp, tp = steps[i]
    _metrics_close(tm, jm)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    assert float(tm["skipped_nonfinite"]) == 0.0
    _close_rel(tgrads[i], jgrads[i], GRAD_TOL)
    assert all(float(g.abs().max()) > 0 for g in tree_leaves(tgrads[i]))
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= 1e-5
    assert {int(c) for c in ts["count"].values()} == {2}

