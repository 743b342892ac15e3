"""Port parity of hard-mask training (`MetaConfig()`'s default
occ_hard_mask=True): the single-field occupancy render with the hard mask
and its gradients, and a FoMAML outer step, against the JAX package on
the CPU.

Params (K=2 experts, planes L=2 base 8 F=4, hidden 16, light backward),
the occupancy state (R=16, L=2, about 40% occupied, ready) and the
episode come from numpy seeds (tests/test_torch_train.py's `_setup`),
with bench.py's meta configuration at a small size (8 samples, 32
probes, randomized=False so that both sides see the same samples; one
inner step in the outer step held to JAX, whose eager step costs a
minute on one core) and the hard mask on: the probe takes ray_floor 0, the field's
sigma is zeroed where the expert's binary grid is empty at the sample
points (one grid query a sample) and on rays whose probes found nothing.
JAX runs with jit disabled (jitted XLA on the CPU contracts multiply-adds
and moves probe and grid cells).

Tolerances: the render's outputs within 1e-5; its gradients within 1e-4
of each leaf's max; the step's losses 1e-5 relative and its gradients
1e-4 of each leaf's max, as tests/test_torch_train.py holds the soft
step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsys_tpu.models import container as JCo
from nerfsys_tpu.ops import occupancy as JO
from nerfsys_tpu.pipelines.offline import meta_core as JM
from nerfsys_tpu.pipelines.offline import meta_train_step as JS
from nerfsys_tpu.utils import optim as JOpt
from nerfsys_tpu_torch.models import container as TCo
from nerfsys_tpu_torch.ops import occupancy as TO
from nerfsys_tpu_torch.pipelines.offline import meta_core as TM
from nerfsys_tpu_torch.pipelines.offline import meta_train_step as TS
from nerfsys_tpu_torch.utils import interop
from nerfsys_tpu_torch.utils import optim as TOpt
from nerfsys_tpu_torch.utils.tree import tree_leaves, tree_map
from test_torch_train import (
    _close_rel,
    _meta,
    _metrics_close,
    _Recording,
    _setup,
    _sides,
)
from test_torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse)


def _render_pair(importance, k=1, cdf=False, probe_mask=False):
    """One expert's hard-mask render of its support rays on both sides ->
    (JAX outputs and gradients, the port's); probe_mask: the mask from the
    probes' interval bits."""
    cfg, params, statics, occ, batch = _setup()
    (jp, jst, jocc, jb), (tcfg, tp, tst, tocc, tb) = _sides(
        cfg, params, statics, occ, batch)
    rays_np = np.asarray(batch["support_rays"][k, 0])
    g = np.random.default_rng(5).normal(size=(rays_np.shape[0], 3))
    jpk = jax.tree_util.tree_map(lambda a: a[k], jp["experts"])
    jaabb = jst.expert_aabbs[k]
    japply, _ = JCo._expert_apply_fn(cfg)
    jbin, jval = jocc["binary"][k], jocc["occs"][k]
    kw = dict(randomized=False, n_probes=32, hard_mask=True, bg_policy="white",
              mask_from_probes=probe_mask)

    def jloss(pk):
        def field(x, d):
            return japply(pk, cfg.expert, jaabb, x, d)

        extra = {}
        if importance:
            extra = dict(
                value_fn=lambda x: JO.query_values(jval, jaabb, x),
                pair_fn=lambda x: JO.query_pair(jval, jbin, jaabb, x))
        out = JO.render_rays_occ_field(
            field, lambda x: JO.query_binary(jbin, jaabb, x),
            jnp.asarray(rays_np), 8, **kw, **extra)
        return jnp.sum(out[0] * g), out

    with jax.disable_jit():
        (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jpk)

    tpk = tree_map(lambda a: a[k].clone().requires_grad_(True),
                   tp["experts"])
    taabb = tst.expert_aabbs[k]
    tapply, _ = TCo._expert_apply_fn(tcfg)
    grid = (tocc["occs"][k:k + 1], tocc["binary"][k:k + 1],
            tst.expert_aabbs[k:k + 1])
    rays = torch.from_numpy(rays_np.copy())
    cdf_state = None
    if cdf:  # the inner loop's probe, hoisted out of the render
        cdf_state = TO.occupancy_probe_cdf(
            *grid, rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous(),
            rays[:, 6], rays[:, 7], 32, importance=importance,
            ray_floor=0.0)
    tout = TO.render_rays_occ_field(
        lambda x, d: tapply(tpk, tcfg.expert, taabb, x, d), grid, rays, 8,
        importance=importance, cdf_state=cdf_state, **kw)
    (tout[0] * torch.from_numpy(g).float()).sum().backward()
    tgrad = tree_map(lambda t: t.grad, tpk)
    return (jout, jgrad), (tout, tgrad)


@pytest.mark.parametrize("importance", [True, False])
def test_hard_mask_render_and_gradients_match_jax(importance):
    (jout, jgrad), (tout, tgrad) = _render_pair(importance)
    for got, want in zip(tout, jout):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5)
    _close_rel(tgrad, jgrad, 1e-4)
    # the mask zeroed samples: some weights vanish where the soft render's
    # would not
    weights = tout[2].detach()
    assert float((weights == 0).float().mean()) > 0.05


def test_hard_mask_render_with_a_hoisted_probe():
    """The inner loop probes once per task (ray_floor 0) and hands the cdf
    to the render: the same outputs as probing inside it."""
    (jout, _), (tout, _) = _render_pair(True, cdf=True)
    for got, want in zip(tout, jout):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5)


def test_hard_mask_fomaml_step_matches_jax():
    """One outer step with the default hard mask and bench.py's optimizer:
    metrics, the gradients handed to the optimizer and the new params."""
    cfg, params, statics, occ, batch = _setup()
    meta = _meta(occ_hard_mask=True, inner_iter=1)
    assert JM.MetaConfig().occ_hard_mask and TM.MetaConfig().occ_hard_mask
    jcfg = JOpt.OptimConfig(outer_steps=100)
    tx = _Recording(JOpt.build_optimizer(jcfg, JCo.param_group_labels(params)))
    opt = _Recording(TOpt.build_optimizer(
        interop.optim_config_from_jax(jcfg), TCo.param_group_labels(params)))
    (jp, jst, jocc, jb), (tcfg, tp, tst, tocc, tb) = _sides(
        cfg, params, statics, occ, batch)
    tmeta = interop.meta_config_from_jax(meta)
    assert tmeta.occ_hard_mask
    with jax.disable_jit():
        jp2, _, jm = JS.make_train_step(meta, cfg, tx)(
            jp, tx.init(jp), jst, jb, jax.random.PRNGKey(0), jocc)
    tp2, _, tm = TS.make_train_step(tmeta, tcfg, opt)(
        tp, opt.init(tp), tst, tb, torch.Generator(), tocc)
    _metrics_close(tm, jm)
    assert float(tm["skipped_nonfinite"]) == 0.0
    _close_rel(opt.grads[0], tx.grads[0], 1e-4)
    assert all(float(g.abs().max()) > 0 for g in tree_leaves(opt.grads[0]))
    for a, b in zip(tree_leaves(tp2), jax.tree_util.tree_leaves(jp2)):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= 1e-5
    # the hard mask changes the step: the soft step's loss differs
    soft = TS.make_train_step(interop.meta_config_from_jax(
        _meta(occ_hard_mask=False, inner_iter=1)), tcfg, opt)(
        tp, opt.init(tp), tst, tb, torch.Generator(), tocc)[2]
    assert float(soft["loss_out"]) != pytest.approx(float(tm["loss_out"]),
                                                    rel=1e-4)


def test_hard_mask_step_plain_path_matches_kernel_path():
    """make_train_step(use_kernels=False), the card's reference for the
    kernel path, takes the same randomized hard-mask step."""
    cfg, params, statics, occ, batch = _setup(seed=4)
    _, (tcfg, tp, tst, tocc, tb) = _sides(cfg, params, statics, occ, batch)
    meta = interop.meta_config_from_jax(_meta(randomized=True,
                                              occ_hard_mask=True))
    out = []
    for use_kernels in (True, False):
        opt = _Recording(TOpt.build_optimizer(TOpt.OptimConfig(),
                                              TCo.param_group_labels(tp)))
        _, _, m = TS.make_train_step(meta, tcfg, opt,
                                     use_kernels=use_kernels)(
            tp, opt.init(tp), tst, tb, torch.Generator().manual_seed(0),
            tocc)
        out.append((float(m["loss_out_meta"]), tree_leaves(opt.grads[0])))
    (lk, gk), (lp, gp) = out
    assert lk == pytest.approx(lp, rel=1e-6)
    for a, b in zip(gk, gp):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


@pytest.mark.parametrize("importance", [True, False])
def test_probe_mask_render_and_gradients_match_jax(importance):
    """The hard mask from the probes' interval bits (no point query):
    outputs and gradients against JAX's (its conservative acc:
    tests/test_torch_probe_mask.py)."""
    (jout, jgrad), (tout, tgrad) = _render_pair(importance, probe_mask=True)
    for got, want in zip(tout, jout):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5)
    _close_rel(tgrad, jgrad, 1e-4)
