"""Port parity of the training slice: task_adapt, the fomaml and reptile
outer steps and the eval step, against the JAX package run eagerly.

Params (K=2 experts, planes L=2 base 8 F=4, hidden 16, light backward
pos_grad=False as bench.py trains), the occupancy state (R=16, L=2, about
40% occupied, ready) and an episode (B=2 tasks per region, 64 support and
32 query rays, near/far as bench.py draws them) come from numpy seeds. The
meta configuration is bench.py's soft-occupancy one at a small size
(2 inner steps, 8 samples, 32 probes) with randomized=False, so that both
sides see the same samples. JAX runs with jit disabled: jitted XLA on the
CPU fuses multiply-adds and moves probe cells.

Tolerances: losses 1e-5 relative; gradients 1e-4 of each leaf's max (the
inner loop feeds float32 rounding differences of the reverse sums through
two SGD steps and the MLPs). The step with bfloat16 MLPs (--use_amp) has
its own, stated in its test.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfsys_tpu.models import container as JCo
from nerfsys_tpu.models import ngp as JN
from nerfsys_tpu.ops.planes import PlaneEncodingConfig
from nerfsys_tpu.pipelines.offline import meta_core as JM
from nerfsys_tpu.pipelines.offline import meta_train_step as JS
from nerfsys_tpu.utils import optim as JO
from nerfsys_tpu_torch.models import container as TCo
from nerfsys_tpu_torch.pipelines.offline import meta_core as TM
from nerfsys_tpu_torch.pipelines.offline import meta_train_step as TS
from nerfsys_tpu_torch.utils import interop
from nerfsys_tpu_torch.utils import optim as TO
from nerfsys_tpu_torch.utils.tree import tree_leaves, tree_map

K, B, S, Q = 2, 2, 64, 32


def _lin(rng, i, o, lead):
    s = 1.0 / np.sqrt(i)
    return {"w": rng.uniform(-s, s, (*lead, i, o)).astype(np.float32),
            "b": rng.uniform(-s, s, (*lead, o)).astype(np.float32)}


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    expert = JN.NGPConfig(
        hidden=16, sigma_depth=2, color_hidden=16, color_depth=2,
        geo_feat_dim=7, xyz_encoding="planes",
        planes=PlaneEncodingConfig(levels=2, base_res=8, growth=2.0,
                                   features=4, matmul_bwd=True,
                                   pos_grad=False, bwd_chunk=512))
    cfg = JCo.ContainerConfig(num_experts=K, expert=expert,
                              boundary_margin=1.1, bg_hidden=8)
    lead = (K,)
    experts = {
        "planes_enc": {
            "planes": [rng.normal(0, 0.5, (K, 3, R * R, 4)).astype(np.float32)
                       for R in (8, 16)],
            "lines": [rng.normal(1, 0.1, (K, 3, R, 4)).astype(np.float32)
                      for R in (8, 16)]},
        "sigma_trunk": [_lin(rng, 24, 16, lead), _lin(rng, 16, 16, lead)],
        "sigma_head": _lin(rng, 16, 1, lead),
        "geo_head": _lin(rng, 16, 7, lead),
        "color_mlp": [_lin(rng, 23, 16, lead), _lin(rng, 16, 16, lead),
                      _lin(rng, 16, 3, lead)],
    }
    experts["sigma_head"]["b"][:] = 0.5  # dense enough to be opaque
    params = {"experts": experts,
              "bg": {"l0": _lin(rng, 16, 8, ()), "l1": _lin(rng, 8, 3, ())}}
    cents = np.array([[0.0, -0.5, 0.0], [0.0, 0.5, 0.0]], np.float32)
    boxes = np.stack([np.stack([c - 1.2, c + 1.2]) for c in cents])
    gbox = np.array([[-2.0] * 3, [2.0] * 3], np.float32)
    binary = rng.uniform(size=(K, 2, 16, 16, 16)) < 0.4
    occ = {"binary": binary, "num_updates": np.int32(10),
           "occs": np.where(binary, rng.uniform(size=binary.shape),
                            0.0).astype(np.float32)}

    def rays(n):
        o = rng.normal(size=(K, B, n, 3)).astype(np.float32) * 0.3
        d = rng.normal(size=(K, B, n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        nf = np.tile(np.array([0.1, 2.5], np.float32), (K, B, n, 1))
        return np.concatenate([o, d, nf], -1)

    batch = {"support_rays": rays(S),
             "support_rgbs": rng.uniform(size=(K, B, S, 3)).astype(
                 np.float32),
             "query_rays": rays(Q),
             "query_rgbs": rng.uniform(size=(K, B, Q, 3)).astype(np.float32),
             "valid": np.ones((K, B), np.float32)}
    statics = SimpleNamespace(centroids=cents, expert_aabbs=boxes,
                              global_aabb=gbox)
    return cfg, params, statics, occ, batch


def _meta(**kw):
    base = dict(algo="fomaml", inner_iter=2, inner_lr=0.015, ray_samples=8,
                randomized=False, occ_importance=True, occ_hard_mask=False,
                occ_probes=32)
    base.update(kw)
    return JM.MetaConfig(**base)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _sides(cfg, params, statics, occ, batch):
    jst = JCo.ContainerStatics(*(jnp.asarray(getattr(statics, k)) for k in
                                 ("centroids", "expert_aabbs", "global_aabb")))
    port = (interop.container_config_from_jax(cfg),
            interop.container_params_from_jax(params, "cpu"),
            interop.statics_from_jax(statics, "cpu"),
            interop.occ_state_from_jax(occ, "cpu"),
            interop.tree_to_torch(batch, "cpu"))
    return (_jax(params), jst, _jax(occ), _jax(batch)), port


def _close_rel(got, want, tol):
    """Leaf by leaf: max |got - want| <= tol * max |want|."""
    g_leaves, w_leaves = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        g = g.detach().numpy() if torch.is_tensor(g) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= tol * scale, (
            float(np.abs(g - w).max()), scale)


def _metrics_close(tm, jm, keys=("loss_in", "loss_out", "loss_out_meta",
                                 "region_loss_in", "region_loss_out",
                                 "psnr_out")):
    for k in keys:
        np.testing.assert_allclose(tm[k].detach().numpy(), np.asarray(jm[k]),
                                   rtol=1e-5, atol=0, err_msg=k)


class _Recording:
    """Wraps an optimizer (optax's or the port's) and records the gradients
    each step hands it, so that a step's gradients are compared before
    Adam amplifies their rounding."""

    def __init__(self, opt):
        self.opt, self.grads = opt, []

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params=None):
        self.grads.append(grads)
        return self.opt.update(grads, state, params)


def test_task_adapt_matches_jax():
    cfg, params, statics, occ, batch = _setup()
    (jp, jst, jocc, jb), (tcfg, tp, tst, tocc, tb) = _sides(
        cfg, params, statics, occ, batch)
    meta = _meta()
    k = 1
    with jax.disable_jit():
        jfast, jl = JM.task_adapt(
            meta, cfg, jax.tree_util.tree_map(lambda a: a[k], jp["experts"]),
            jst.expert_aabbs[k], jp["bg"], jb["support_rays"][k, 0],
            jb["support_rgbs"][k, 0], jax.random.PRNGKey(0),
            occ_binary=jocc["binary"][k], occ_values=jocc["occs"][k])
    tfast, tl = TM.task_adapt(
        interop.meta_config_from_jax(meta), tcfg,
        tree_map(lambda a: a[k], tp["experts"]), tst.expert_aabbs[k],
        tp["bg"], tb["support_rays"][k, 0], tb["support_rgbs"][k, 0],
        occ_grid=(tocc["occs"][k:k + 1], tocc["binary"][k:k + 1],
                  tst.expert_aabbs[k:k + 1]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    assert float(tl[1]) < float(tl[0])  # the inner SGD lowers the loss
    _close_rel(tfast, jfast, 1e-4)


def test_fomaml_steps_match_jax():
    """Two outer steps with bench.py's optimizer (Adam per group, decay,
    clip 1.0), one task padded out: metrics, each step's gradients and the
    updated params."""
    cfg, params, statics, occ, batch = _setup()
    batch["valid"][1, 1] = 0.0  # a padded task: masked out of everything
    meta = _meta()
    jcfg = JO.OptimConfig(outer_steps=100)
    tx = _Recording(JO.build_optimizer(jcfg, JCo.param_group_labels(params)))
    opt = _Recording(TO.build_optimizer(interop.optim_config_from_jax(jcfg),
                                        TCo.param_group_labels(params)))
    (jp, jst, jocc, jb), (tcfg, tp, tst, tocc, tb) = _sides(
        cfg, params, statics, occ, batch)
    jstep = JS.make_train_step(meta, cfg, tx)
    tstep = TS.make_train_step(interop.meta_config_from_jax(meta), tcfg, opt)
    js, ts = tx.init(jp), opt.init(tp)
    for i in range(2):
        with jax.disable_jit():
            jp, js, jm = jstep(jp, js, jst, jb, jax.random.PRNGKey(0), jocc)
        tp, ts, tm = tstep(tp, ts, tst, tb, torch.Generator(), tocc)
        _metrics_close(tm, jm)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert float(tm["skipped_nonfinite"]) == 0.0
        _close_rel(opt.grads[i], tx.grads[i], 1e-4)
        # gradients reached the tables, every MLP and the background
        assert all(float(g.abs().max()) > 0
                   for g in tree_leaves(opt.grads[i]))
        # Adam moves each weight by about lr * sign(g), whatever the size
        # of g: the params agree to 1e-3 of the largest group lr (1e-2)
        for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= 1e-5
    assert {int(c) for c in ts["count"].values()} == {2}


def test_fomaml_step_with_bf16_mlps_matches_jax():
    """One outer step with --use_amp (NGPConfig.use_bf16: bfloat16 MLPs),
    eager on both sides. Metrics within 1e-5 relative (measured equal: the
    forward casts the fast weights to bfloat16, which absorbs the inner
    steps' float32 differences); gradients within 2^-7 of each leaf's max
    (measured <= 5.4e-3 on the biases, 2.3e-3 on a weight, tables 9.6e-5,
    other weights equal): JAX on the CPU sums each bias's bfloat16
    cotangent in bfloat16 (`lax.reduce`), PyTorch in float32, and the
    inner SGD carries that into the query's gradients; grad_norm within
    2e-3 relative (measured 1.1e-3); params after Adam within 1e-4
    (measured 5.4e-5)."""
    import dataclasses

    cfg, params, statics, occ, batch = _setup()
    cfg = dataclasses.replace(cfg, expert=dataclasses.replace(
        cfg.expert, use_bf16=True))
    meta = _meta()
    jcfg = JO.OptimConfig(outer_steps=100)
    tx = _Recording(JO.build_optimizer(jcfg, JCo.param_group_labels(params)))
    opt = _Recording(TO.build_optimizer(interop.optim_config_from_jax(jcfg),
                                        TCo.param_group_labels(params)))
    (jp, jst, jocc, jb), (tcfg, tp, tst, tocc, tb) = _sides(
        cfg, params, statics, occ, batch)
    assert tcfg.expert.use_bf16
    with jax.disable_jit():
        jp, _, jm = JS.make_train_step(meta, cfg, tx)(
            jp, tx.init(jp), jst, jb, jax.random.PRNGKey(0), jocc)
    tp, _, tm = TS.make_train_step(interop.meta_config_from_jax(meta), tcfg,
                                   opt)(tp, opt.init(tp), tst, tb,
                                        torch.Generator(), tocc)
    _metrics_close(tm, jm)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=2e-3)
    _close_rel(opt.grads[0], tx.grads[0], 2.0 ** -7)
    assert all(float(g.abs().max()) > 0 for g in tree_leaves(opt.grads[0]))
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= 1e-4


def test_train_step_plain_path_matches_kernel_path():
    """make_train_step(use_kernels=False), the card's reference for the
    kernel path, takes the same randomized step as the kernel wrappers (on
    CPU tensors their plain versions, behind the autograd Functions)."""
    cfg, params, statics, occ, batch = _setup(seed=4)
    _, (tcfg, tp, tst, tocc, tb) = _sides(cfg, params, statics, occ, batch)
    meta = interop.meta_config_from_jax(_meta(randomized=True))
    out = []
    for use_kernels in (True, False):
        opt = _Recording(TO.build_optimizer(TO.OptimConfig(),
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
    assert all(float(g.abs().max()) > 0 for g in gk)


def test_reptile_step_matches_jax():
    cfg, params, statics, occ, batch = _setup(seed=2)
    meta = _meta(algo="reptile", reptile_lr=0.5)
    (jp, jst, jocc, jb), (tcfg, tp, tst, tocc, tb) = _sides(
        cfg, params, statics, occ, batch)
    tx = optax.identity()
    with jax.disable_jit():
        jparams, _, jm = JS.make_train_step(meta, cfg, tx)(
            jp, tx.init(jp), jst, jb, jax.random.PRNGKey(0), jocc)
    state = {}
    tparams, tstate, tm = TS.make_train_step(
        interop.meta_config_from_jax(meta), tcfg, None)(
            tp, state, tst, tb, torch.Generator(), tocc)
    assert tstate is state  # reptile leaves the optimizer alone
    _metrics_close(tm, jm)
    assert float(tm["grad_norm"]) == 0.0
    _close_rel(tparams, jparams, 1e-4)


@pytest.mark.parametrize("tto", [0, 2])
def test_eval_step_matches_jax(tto):
    cfg, params, statics, occ, batch = _setup(seed=3)
    meta = _meta()
    (jp, jst, jocc, jb), (tcfg, tp, tst, tocc, tb) = _sides(
        cfg, params, statics, occ, batch)
    with jax.disable_jit():
        jm = JS.make_eval_step(meta, cfg, tto)(jp, jst, jb,
                                               jax.random.PRNGKey(0), jocc)
    tm = TS.make_eval_step(interop.meta_config_from_jax(meta), tcfg, tto)(
        tp, tst, tb, torch.Generator(), tocc)
    _metrics_close(tm, jm, ("loss_in", "loss_out", "region_loss_out",
                            "psnr_out"))


def test_nonfinite_step_keeps_params_and_state():
    cfg, params, statics, occ, batch = _setup()
    batch["query_rgbs"][0, 0, 0, 0] = np.nan
    _, (tcfg, tp, tst, tocc, tb) = _sides(cfg, params, statics, occ, batch)
    meta = interop.meta_config_from_jax(_meta(inner_iter=1))
    opt = TO.build_optimizer(TO.OptimConfig(), TCo.param_group_labels(tp))
    state = opt.init(tp)
    new_p, new_s, m = TS.make_train_step(meta, tcfg, opt)(
        tp, state, tst, tb, torch.Generator(), tocc)
    assert float(m["skipped_nonfinite"]) == 1.0
    assert float(m["grad_norm"]) == 0.0
    assert new_s is state
    for a, b in zip(tree_leaves(new_p), tree_leaves(tp)):
        assert torch.equal(a, b)


def test_maml_and_unported_modes_raise():
    cfg, params, statics, occ, batch = _setup()
    tcfg = interop.container_config_from_jax(cfg)
    assert tcfg.expert.planes.pos_grad is False
    # second-order MAML is ported (tests/test_torch_maml.py,
    # tests/test_torch_maml_step.py); an unknown algo still raises
    with pytest.raises(ValueError):
        TM.MetaConfig(algo="sgd")
    # the hard mask and its probe-bit form are ported (held to JAX in
    # tests/test_torch_hard_mask_train.py and
    # tests/test_torch_probe_mask_paths.py): the probe-bit step runs
    meta = interop.meta_config_from_jax(_meta(occ_hard_mask=True,
                                              occ_probe_mask=True))
    assert meta.occ_importance and meta.ray_samples == 8
    assert meta.occ_probe_mask
    _, (tcfg, tp, tst, tocc, tb) = _sides(cfg, params, statics, occ, batch)
    opt = TO.build_optimizer(TO.OptimConfig(), TCo.param_group_labels(tp))
    _, _, m = TS.make_train_step(meta, tcfg, opt)(
        tp, opt.init(tp), tst, tb, torch.Generator(), tocc)
    assert np.isfinite(float(m["loss_out"]))
    assert float(m["skipped_nonfinite"]) == 0.0


def test_reptile_update_matches_jax():
    """The standalone reptile rule, with a padded task whose fast weights
    are NaN: select-then-sum keeps it out."""
    rng = np.random.default_rng(9)
    base = {"w": rng.normal(size=(2, 3, 4)).astype(np.float32),
            "b": [rng.normal(size=(2, 5)).astype(np.float32)]}
    fast = jax.tree_util.tree_map(
        lambda a: (a[:, None] + rng.normal(size=(2, 3) + a.shape[1:]))
        .astype(np.float32), base)
    fast["w"][1, 2] = np.nan
    valid = np.array([[1, 1, 1], [1, 1, 0]], np.float32)
    want = JM.reptile_update(_jax(base), _jax(fast), jnp.asarray(valid), 0.3)
    got = TM.reptile_update(interop.tree_to_torch(base, "cpu"),
                            interop.tree_to_torch(fast, "cpu"),
                            torch.tensor(valid), 0.3)
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(got))
    _close_rel(got, want, 1e-6)
