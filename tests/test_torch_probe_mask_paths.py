"""Port parity of `occ_probe_mask` (the hard mask from the probes'
interval bits) in meta-training, against the JAX package on the CPU, on
the same numpy params, grids and draws (JAX with jit disabled: jitted XLA
on the CPU contracts multiply-adds and can move a probe's cell): the
FoMAML outer step (tests/test_torch_train.py's `_setup`: K=2 planes
experts, occupancy R=16 L=2; one task an expert, one inner step, 8
samples, 32 probes, randomized=False), metrics 1e-5 relative and
gradients 1e-4 of each leaf's max, as tests/test_torch_hard_mask_train.py
holds the point-exact step.

The adapt step with the flag: tests/test_torch_probe_mask_adapt.py; the
renderers: tests/test_torch_probe_mask_renders.py (each eager-JAX file
on its own, so that the test run's workers share them).
"""
import jax
import numpy as np
import torch
from test_torch_train import (
    _close_rel,
    _meta,
    _metrics_close,
    _Recording,
    _setup,
    _sides,
)

from nerfsys_tpu.models import container as JCo
from nerfsys_tpu.pipelines.offline import meta_train_step as JS
from nerfsys_tpu.utils import optim as JOpt
from nerfsys_tpu_torch.models import container as TCo
from nerfsys_tpu_torch.pipelines.offline import meta_train_step as TS
from nerfsys_tpu_torch.utils import interop
from nerfsys_tpu_torch.utils import optim as TOpt
from nerfsys_tpu_torch.utils.tree import tree_leaves
from test_torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse)


def test_fomaml_step_with_probe_masks_matches_jax():
    cfg, params, statics, occ, batch = _setup()
    batch = {k: np.ascontiguousarray(v[:, :1]) for k, v in batch.items()}
    meta = _meta(occ_hard_mask=True, occ_probe_mask=True, inner_iter=1)
    jcfg = JOpt.OptimConfig(outer_steps=100)
    tx = _Recording(JOpt.build_optimizer(jcfg, JCo.param_group_labels(params)))
    opt = _Recording(TOpt.build_optimizer(
        interop.optim_config_from_jax(jcfg), TCo.param_group_labels(params)))
    (jp, jst, jocc, jb), (tcfg, tp, tst, tocc, tb) = _sides(
        cfg, params, statics, occ, batch)
    tmeta = interop.meta_config_from_jax(meta)
    assert tmeta.occ_probe_mask and tmeta.occ_hard_mask
    with jax.disable_jit():
        jp2, _, jm = JS.make_train_step(meta, cfg, tx)(
            jp, tx.init(jp), jst, jb, jax.random.PRNGKey(0), jocc)
    tp2, _, tm = TS.make_train_step(tmeta, tcfg, opt)(
        tp, opt.init(tp), tst, tb, torch.Generator(), tocc)
    _metrics_close(tm, jm)
    _close_rel(opt.grads[0], tx.grads[0], 1e-4)
    for a, b in zip(tree_leaves(tp2), jax.tree_util.tree_leaves(jp2)):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= 1e-5
