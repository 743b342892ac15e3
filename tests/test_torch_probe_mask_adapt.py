"""Port parity of `occ_probe_mask` (the hard mask from the probes'
interval bits) in test-time adaptation, against the JAX package on the
CPU: one adapt step (tests/test_torch_train.py's `_setup`, hard mask,
importance, 8 samples) from the same numpy params, grids and draws
(tests/test_torch_adapt.py's: jax.random.uniform patched to return a
numpy jitter from which the port forms its targets), JAX with jit
disabled; loss 1e-5 relative, gradients 1e-4 of each leaf's max, the new
params within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_adapt import _draws
from test_torch_train import _close_rel, _Recording, _setup, _sides

from nerfsys_tpu.models import container as JCo
from nerfsys_tpu.pipelines.online import runtime_adapt as JR
from nerfsys_tpu.utils import optim as JOpt
from nerfsys_tpu_torch.models import container as TCo
from nerfsys_tpu_torch.pipelines.online import runtime_adapt as TR
from nerfsys_tpu_torch.utils import interop
from nerfsys_tpu_torch.utils import optim as TOpt
from nerfsys_tpu_torch.utils.tree import tree_leaves


def test_adapt_step_with_probe_masks_matches_jax(monkeypatch):
    cfg, params, statics, occ, batch = _setup(seed=2)
    rays = batch["support_rays"][0, 0]
    rgbs = batch["support_rgbs"][0, 0]
    S = 8
    kw = dict(ray_samples=S, color_space="srgb", bg_policy="random",
              occ_importance=True, occ_hard_mask=True, occ_probe_mask=True)
    jcfg = JOpt.OptimConfig(use_scheduler=False)
    tx = _Recording(JOpt.build_optimizer(jcfg,
                                         JCo.param_group_labels(params)))
    opt = _Recording(TOpt.build_optimizer(
        interop.optim_config_from_jax(jcfg), TCo.param_group_labels(params)))
    (jp, jst, jocc, _), (tcfg, tp, tst, tocc, _) = _sides(
        cfg, params, statics, occ, {})
    calls = _draws(monkeypatch, rays.shape[0], S)
    with jax.disable_jit():
        jp2, _, jloss = JR.make_adapt_step(cfg, tx, **kw)(
            jp, tx.init(jp), jst, jnp.asarray(rays), jnp.asarray(rgbs),
            jax.random.PRNGKey(0), jocc)
    tp2, _, tloss = TR.make_adapt_step(tcfg, opt, **kw)(
        tp, opt.init(tp), tst, rays, rgbs, torch.Generator(), tocc)
    assert calls == ["jax", "torch"]
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _close_rel(opt.grads[0], tx.grads[0], 1e-4)
    for a, b in zip(tree_leaves(tp2), jax.tree_util.tree_leaves(jp2)):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= 1e-5
