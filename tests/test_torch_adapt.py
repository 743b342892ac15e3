"""Port parity of test-time adaptation: `EpochBatchSampler`,
`runtime_adapt` and `make_adapt_step`, against the JAX package.

The adapt step runs on test_torch_train.py's small container (K=2 planes
experts L=2 base 8 F=4, hidden 16, a learned background) with its
occupancy state (R=16, L=2, about 40% occupied, ready) and 64 support rays
of its episode: one Adam step of the whole routed container, randomized,
importance sampling from the union probe CDF, in the soft mode and under
the hard mask. Both sides take the same draws: the test replaces the one
function on each side that makes them (`jax.random.uniform` on the JAX
side, `ops.occupancy._sample_targets` on the port's) by the same jittered
targets from a numpy seed. JAX runs with jit disabled, as
test_torch_train.py explains.

Tolerances: the loss 1e-5 relative, the gradients 1e-4 of each leaf's max
(as test_torch_train.py holds a step), the params after Adam within 1e-5.
The samplers' batches and the adapt loop's schedule are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _close_rel, _Recording, _setup, _sides

from nerfsys_tpu.data import loaders as JL
from nerfsys_tpu.models import container as JCo
from nerfsys_tpu.pipelines.online import runtime_adapt as JRA
from nerfsys_tpu.utils import optim as JO
from nerfsys_tpu_torch.data import loaders as TL
from nerfsys_tpu_torch.models import container as TCo
from nerfsys_tpu_torch.ops import occupancy as TOC
from nerfsys_tpu_torch.pipelines.online import runtime_adapt as TRA
from nerfsys_tpu_torch.utils import interop
from nerfsys_tpu_torch.utils import optim as TO
from nerfsys_tpu_torch.utils.tree import tree_leaves
from test_torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse)


class _Rays:
    """A RamRaysDataset's arrays, from a numpy seed."""

    def __init__(self, n, seed=0):
        rng = np.random.default_rng(seed)
        self.rays = rng.normal(size=(n, 8)).astype(np.float32)
        self.rgbs = rng.uniform(size=(n, 3)).astype(np.float32)
        self.img_indices = rng.integers(0, 5, n).astype(np.int32)

    def __len__(self):
        return self.rays.shape[0]


@pytest.mark.parametrize("n,batch", [(10, 4), (12, 4), (3, 8), (1000, 97)])
def test_epoch_batch_sampler_matches_jax(n, batch):
    ds = _Rays(n)
    j = JL.EpochBatchSampler(ds, batch, seed=3)
    t = TL.EpochBatchSampler(ds, batch, seed=3)
    for _ in range(3):  # successive epochs draw new permutations
        jb, tb = list(j), list(t)
        assert len(jb) == len(tb) == -(-n // batch)
        for a, b in zip(jb, tb):
            assert set(a) == set(b)
            for k in a:
                # wrap-around pads to `batch` rows when n >= batch / 2
                # (the reference pads from one permutation only)
                assert a[k].shape[0] == min(batch, n + n * (n < batch))
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("steps", [None, 2, 3, 7])
def test_runtime_adapt_counts_steps_and_restarts_like_jax(steps):
    """The same batches in the same order on both sides: one pass for
    steps=None, else exactly `steps` updates, the loader restarted."""
    ds = _Rays(10)
    seen = {"jax": [], "torch": []}

    def fake_step(side):
        def step(p, o, statics, rays, rgbs, key_or_gen):
            seen[side].append(rays[:, 0].copy())
            return p + 1, o, float(p)
        return step

    jout = JRA.runtime_adapt(params=0, opt_state=None,
                             adapt_step=fake_step("jax"), statics=None,
                             data_loader=JL.EpochBatchSampler(ds, 4, seed=1),
                             steps=steps)
    tout = TRA.runtime_adapt(params=0, opt_state=None,
                             adapt_step=fake_step("torch"), statics=None,
                             data_loader=TL.EpochBatchSampler(ds, 4, seed=1),
                             steps=steps, generator=torch.Generator())
    want = 3 if steps is None else steps
    assert jout["steps"] == tout["steps"] == want
    assert jout["params"] == tout["params"] == want
    assert jout["loss"] == tout["loss"] == want - 1
    assert len(seen["torch"]) == want
    for a, b in zip(seen["jax"], seen["torch"]):
        np.testing.assert_array_equal(a, b)


def test_runtime_adapt_on_an_empty_loader():
    out = TRA.runtime_adapt(params=0, opt_state=None, adapt_step=None,
                            statics=None, data_loader=[], steps=None,
                            generator=torch.Generator())
    assert out["steps"] == 0 and out["params"] == 0


def _draws(monkeypatch, n, s, seed=0):
    """The same jitter U (n, s) on both sides: jax.random.uniform returns
    it, and the port's sampler targets are formed from it as JAX forms
    them (ops/occupancy.py:sample_tvals_from_cdf)."""
    U = np.random.default_rng(seed).uniform(size=(n, s)).astype(np.float32)
    calls = []

    def uniform(key, shape=(), dtype=jnp.float32, *a, **k):
        assert tuple(shape) == U.shape, shape
        calls.append("jax")
        return jnp.asarray(U, dtype)

    def targets(N, S, device, generator, randomized):
        assert randomized and (N, S) == U.shape
        calls.append("torch")
        u = (torch.arange(S, dtype=torch.float32) + 0.5) / S
        jit = (torch.from_numpy(U) - 0.5) / S
        return torch.clamp(u + jit, 0.0, 1.0 - 1e-6)

    monkeypatch.setattr(jax.random, "uniform", uniform)
    monkeypatch.setattr(TOC, "_sample_targets", targets)
    return calls


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard_mask"])
def test_adapt_step_matches_jax(monkeypatch, hard):
    cfg, params, statics, occ, batch = _setup(seed=2)
    rays = batch["support_rays"][0, 0]
    rgbs = batch["support_rgbs"][0, 0]
    S = 8
    kw = dict(ray_samples=S, color_space="srgb", bg_policy="random",
              occ_importance=True, occ_hard_mask=hard)
    jcfg = JO.OptimConfig(use_scheduler=False)
    tx = _Recording(JO.build_optimizer(jcfg, JCo.param_group_labels(params)))
    opt = _Recording(TO.build_optimizer(interop.optim_config_from_jax(jcfg),
                                        TCo.param_group_labels(params)))
    (jp, jst, jocc, _), (tcfg, tp, tst, tocc, _) = _sides(
        cfg, params, statics, occ, {})
    calls = _draws(monkeypatch, rays.shape[0], S)
    with jax.disable_jit():
        jstep = JRA.make_adapt_step(cfg, tx, **kw)
        jp2, _, jloss = jstep(jp, tx.init(jp), jst, jnp.asarray(rays),
                              jnp.asarray(rgbs), jax.random.PRNGKey(0), jocc)
    tstep = TRA.make_adapt_step(tcfg, opt, **kw)
    ts0 = opt.init(tp)
    tp2, ts, tloss = tstep(tp, ts0, tst, rays, rgbs, torch.Generator(), tocc)
    assert calls == ["jax", "torch"]
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _close_rel(opt.grads[0], tx.grads[0], 1e-4)
    # every leaf got a gradient: the tables, every MLP, the background
    assert all(float(g.abs().max()) > 0 for g in tree_leaves(opt.grads[0]))
    for a, b in zip(tree_leaves(tp2), jax.tree_util.tree_leaves(jp2)):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= 1e-5
    assert {int(c) for c in ts["count"].values()} == {1}
    # the step returns new tensors: the caller's params are untouched
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_adapt_step_plain_path_matches_kernel_path():
    """make_adapt_step(use_kernels=False), the card's reference for the
    kernel path, takes the same randomized step (on CPU tensors the kernel
    wrappers run their plain versions)."""
    cfg, params, statics, occ, batch = _setup(seed=5)
    _, (tcfg, tp, tst, tocc, _) = _sides(cfg, params, statics, occ, {})
    out = []
    for use_kernels in (True, False):
        opt = TO.build_optimizer(TO.OptimConfig(use_scheduler=False),
                                 TCo.param_group_labels(tp))
        step = TRA.make_adapt_step(tcfg, opt, ray_samples=8,
                                   occ_importance=True, occ_hard_mask=False,
                                   use_kernels=use_kernels)
        p, _, loss = step(tp, opt.init(tp), tst, batch["support_rays"][0, 0],
                          batch["support_rgbs"][0, 0],
                          torch.Generator().manual_seed(0), tocc)
        out.append((float(loss), tree_leaves(p)))
    (lk, pk), (lp, pp) = out
    assert lk == pytest.approx(lp, rel=1e-6)
    for a, b in zip(pk, pp):
        assert float((a - b).abs().max()) <= 1e-6


def test_adapt_step_stratified_until_the_grid_is_ready_and_refusals(
        monkeypatch):
    """A grid that is not ready yet renders stratified (no probe), as the
    reference's lax.cond does, with or without the probe-bit mask (which
    then has nothing to mask: the same step); FIM adaptation raises."""
    cfg, params, statics, occ, batch = _setup(seed=6)
    occ["num_updates"] = np.int32(0)
    occ["ready_after"] = np.int32(5)
    _, (tcfg, tp, tst, tocc, _) = _sides(cfg, params, statics, occ, {})
    opt = TO.build_optimizer(TO.OptimConfig(), TCo.param_group_labels(tp))
    probes = []
    monkeypatch.setattr(TRA, "occupancy_probe_cdf",
                        lambda *a, **k: probes.append(1))
    step = TRA.make_adapt_step(tcfg, opt, ray_samples=8, occ_importance=True)
    _, _, loss = step(tp, opt.init(tp), tst, batch["support_rays"][0, 0],
                      batch["support_rgbs"][0, 0],
                      torch.Generator().manual_seed(0), tocc)
    assert probes == [] and np.isfinite(float(loss))
    bits = TRA.make_adapt_step(tcfg, opt, ray_samples=8, occ_importance=True,
                               occ_probe_mask=True)
    _, _, loss_bits = bits(tp, opt.init(tp), tst,
                           batch["support_rays"][0, 0],
                           batch["support_rgbs"][0, 0],
                           torch.Generator().manual_seed(0), tocc)
    assert probes == [] and float(loss_bits) == float(loss)
    with pytest.raises(NotImplementedError, match="item 7"):
        TRA.runtime_evaluate(params=tp, cfg=tcfg, statics=tst, optimizer=opt,
                             test_metadata=[], tto_steps=1, fim_cfg=object())
