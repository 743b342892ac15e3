"""Port-only checks of second-order MAML (`MetaConfig(algo="maml")`,
`--algo maml`): the step through the kernel wrappers against the plain
path, MAML without an outer gradient, and the runner's train op with
`--algo maml` on the CPU. The parity with the JAX package is in
tests/test_torch_maml.py (task_adapt) and tests/test_torch_maml_step.py
(two outer steps).

The setup is tests/test_torch_train.py's (K=2 planes experts, L=2 base 8
F=4, hidden 16, the light backward; soft importance occupancy R=16 L=2;
B=2 tasks of 64 support and 32 query rays, 2 inner steps, 8 samples).
"""
import json
from pathlib import Path

import pytest
import torch

from test_dataprep_e2e import colmap_scene  # noqa: F401  (fixture)
from test_torch_runner import SMALL, _scene_args, data_root  # noqa: F401

from nerfsys_tpu_torch.models import container as TCo
from nerfsys_tpu_torch.pipelines.offline import meta_core as TM
from nerfsys_tpu_torch.pipelines.offline import meta_train_step as TS
from nerfsys_tpu_torch.utils import interop
from nerfsys_tpu_torch.utils import optim as TO
from nerfsys_tpu_torch.utils.tree import tree_leaves, tree_map
from test_torch_train import _meta, _Recording, _setup, _sides


def test_maml_plain_path_matches_kernel_path():
    """make_train_step(use_kernels=False), the card's reference for the
    MAML step, against the kernel wrappers' path (on CPU tensors the plain
    versions behind the autograd Functions, 4'' / 5'' included): the same
    randomized step."""
    cfg, params, statics, occ, batch = _setup(seed=4)
    _, (tcfg, tp, tst, tocc, tb) = _sides(cfg, params, statics, occ, batch)
    meta = interop.meta_config_from_jax(_meta(algo="maml", randomized=True,
                                              inner_iter=1))
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
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_maml_without_an_outer_gradient_takes_no_second_order():
    """Without an outer gradient (eval, no_grad) MAML's task_adapt returns
    detached values; a MAML step with inner_iter 0 equals the FoMAML
    step's gradient (nothing to differentiate through)."""
    cfg, params, statics, occ, batch = _setup(seed=2)
    _, (tcfg, tp, tst, tocc, tb) = _sides(cfg, params, statics, occ, batch)
    meta = interop.meta_config_from_jax(_meta(algo="maml"))
    pk = tree_map(lambda t: t[0], tp["experts"])
    grid = (tocc["occs"][0:1], tocc["binary"][0:1], tst.expert_aabbs[0:1])
    with torch.no_grad():
        fast, losses = TM.task_adapt(
            meta, tcfg, pk, tst.expert_aabbs[0], tp["bg"],
            tb["support_rays"][0, 0], tb["support_rgbs"][0, 0],
            occ_grid=grid)
    assert not any(t.requires_grad for t in tree_leaves(fast))
    assert losses.shape == (2,) and float(losses[1]) < float(losses[0])
    grads = []
    for algo in ("maml", "fomaml"):
        opt = _Recording(TO.build_optimizer(TO.OptimConfig(),
                                            TCo.param_group_labels(tp)))
        TS.make_train_step(
            interop.meta_config_from_jax(_meta(algo=algo, inner_iter=0)),
            tcfg, opt)(tp, opt.init(tp), tst, tb, torch.Generator(), tocc)
        grads.append(tree_leaves(opt.grads[0]))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_runner_trains_maml_on_the_cpu(data_root, tmp_path, monkeypatch):
    """`runner.main --op train --algo maml --device cpu`: two steps of
    configs/train.json's model at test widths on the prepared scene, the
    losses finite and the params moved from their initial values."""
    from nerfsys_tpu_torch import runner as TR
    from nerfsys_tpu_torch.utils import checkpoint as ckpt

    monkeypatch.chdir(tmp_path)
    repo = Path(__file__).resolve().parent.parent
    ctx = TR.main(["--op", "train", "--configPath",
                   str(repo / "configs" / "train.json"), "--device", "cpu",
                   *_scene_args(data_root), *SMALL, "--outer_steps", "2",
                   "--save_step", "2", "--xyz_encoding", "planes",
                   "--algo", "maml", "--fname", "maml_run"])
    run = Path(ctx["run_dir"])
    assert TR.meta_config_from_args(ctx["P"]).algo == "maml"
    state = json.loads((run / "last.state.json").read_text())
    assert state["step"] == 2
    assert json.loads((run / "last.config.json").read_text())["algo"] == \
        "maml"
    params, _, _ = ckpt.load_checkpoint(run, "last", ctx["params"])
    init = TR.build_context(ctx["P"], "train")["params"]
    moved = [float((a - b).abs().max()) > 0
             for a, b in zip(tree_leaves(params), tree_leaves(init))]
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(params))
    assert any(moved)
