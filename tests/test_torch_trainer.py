"""Port parity of the outer training loop (`meta_trainer`) and of the
checkpoint layer, against the JAX package.

The loop runs beside the JAX package's on the same list of episode batches
at test_torch_train.py's small size (K=2 planes experts L=2 base 8 F=4,
hidden 16, B=1 task of 64 + 32 rays, 1 inner step, 8 samples, soft
importance occupancy on a ready R=16 L=2 grid, randomized=False so both
sides take the same samples), JAX's params carried across by `interop`,
the JAX side eager (jit off, as test_torch_train.py explains). 3 steps
with an eval every 2 and a save every 2.

Tolerances: final params within 1e-4 of each leaf's max (three Adam steps
of float32 rounding differences), `best` within 1e-5 relative, the same
checkpoint tags. Round trips are bit for bit.
"""
import json

import jax
import numpy as np
import pytest
import torch

from test_torch_train import _jax, _meta, _setup, _sides

from nerfsys_tpu.models import container as JCo
from nerfsys_tpu.pipelines.offline import meta_train_step as JS
from nerfsys_tpu.pipelines.offline import trainer as JT
from nerfsys_tpu.utils import optim as JO
from nerfsys_tpu_torch.models import container as TCo
from nerfsys_tpu_torch.pipelines.offline import meta_train_step as TS
from nerfsys_tpu_torch.pipelines.offline import trainer as TT
from nerfsys_tpu_torch.utils import checkpoint as ckpt
from nerfsys_tpu_torch.utils import interop
from nerfsys_tpu_torch.utils import optim as TO
from nerfsys_tpu_torch.utils.tree import tree_leaves, tree_map
from test_torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse)

STEPS = 3


def _batches(n=STEPS + 2):
    """n episode batches (numpy, B=1 task a region) from the seeds of
    test_torch_train; the second has a padded task."""
    out = []
    for s in range(n):
        batch = {k: v[:, :1] for k, v in _setup(seed=10 + s)[4].items()}
        if s == 1:
            batch["valid"][1, 0] = 0.0
        out.append(batch)
    return out


def _port_side(cfg, params, statics, occ, opt_cfg):
    _, (tcfg, tp, tst, tocc, _) = _sides(cfg, params, statics, occ, {})
    opt = TO.build_optimizer(interop.optim_config_from_jax(opt_cfg),
                             TCo.param_group_labels(tp))
    meta = interop.meta_config_from_jax(_meta(inner_iter=1))
    return (tcfg, tp, tst, tocc, opt, TS.make_train_step(meta, tcfg, opt),
            TS.make_eval_step(meta, tcfg, 1))


def _tags(run_dir):
    return sorted(p.name for p in run_dir.iterdir() if p.name != "log.txt")


def test_meta_trainer_matches_jax(tmp_path):
    cfg, params, statics, occ, _ = _setup()
    batches = _batches()
    opt_cfg = JO.OptimConfig(outer_steps=100)
    tx = JO.build_optimizer(opt_cfg, JCo.param_group_labels(params))
    (jp, jst, jocc, _), _ = _sides(cfg, params, statics, occ, {})
    kw = dict(config={"run": "parity"}, outer_steps=STEPS, eval_every=2,
              save_every=2, seed=0)
    with jax.disable_jit():
        jparams, jopt, jbest = JT.meta_trainer(
            params=jp, opt_state=tx.init(jp),
            train_step=JS.make_train_step(_meta(inner_iter=1), cfg, tx),
            eval_step=JS.make_eval_step(_meta(inner_iter=1), cfg, 1),
            statics=jst,
            train_loader=[_jax(b) for b in batches[:STEPS]],
            eval_loader=[_jax(b) for b in batches[STEPS:]],
            run_dir=tmp_path / "jax", occ_state=jocc, **kw)

    tcfg, tp, tst, tocc, opt, tstep, teval = _port_side(cfg, params,
                                                        statics, occ,
                                                        opt_cfg)
    tparams, topt, tbest = TT.meta_trainer(
        params=tp, opt_state=opt.init(tp), train_step=tstep,
        eval_step=teval, statics=tst,
        train_loader=[interop.tree_to_torch(b, "cpu")
                      for b in batches[:STEPS]],
        eval_loader=[interop.tree_to_torch(b, "cpu")
                     for b in batches[STEPS:]],
        run_dir=tmp_path / "port", occ_state=tocc, **kw)

    assert np.isfinite(tbest) and tbest > 0
    assert tbest == pytest.approx(jbest, rel=1e-5)
    for a, b in zip(tree_leaves(tparams), jax.tree_util.tree_leaves(jparams)):
        b = np.asarray(b)
        err = float(np.abs(a.numpy() - b).max())
        assert err <= 1e-4 * max(float(np.abs(b).max()), 1e-30), err
    assert {int(c) for c in topt["count"].values()} == {STEPS}
    assert _tags(tmp_path / "port") == _tags(tmp_path / "jax") == sorted(
        f"{t}.{e}" for t in ("best", "last", "step2")
        for e in ("model", "optim", "config.json", "state.json", "occ"))
    for tag in ("best", "last", "step2"):
        got = json.loads((tmp_path / "port" / f"{tag}.state.json").read_text())
        want = json.loads((tmp_path / "jax" / f"{tag}.state.json").read_text())
        assert got["step"] == want["step"] and got["is_best"] == want[
            "is_best"]
        assert got["best"] == pytest.approx(want["best"], rel=1e-5)
    saved, _, state = ckpt.load_checkpoint(tmp_path / "port", "last", tp)
    assert state["step"] == STEPS
    for a, b in zip(tree_leaves(saved), tree_leaves(tparams)):
        assert torch.equal(a, b)


def _small_loop(tmp_path, metric_lag=1, outer_steps=2, occ_update_fn=None,
                occ=None, **kw):
    cfg, params, statics, occ0, _ = _setup()
    opt_cfg = JO.OptimConfig(outer_steps=100)
    tcfg, tp, tst, tocc, opt, tstep, _ = _port_side(cfg, params, statics,
                                                    occ0, opt_cfg)
    calls = []

    def step(p, s, st, b, g, o=None):
        calls.append({"params": p, "opt": s, "occ": o})
        return tstep(p, s, st, b, g, o)

    batches = [interop.tree_to_torch(b, "cpu") for b in _batches(3)]
    out = TT.meta_trainer(
        params=tp, opt_state=opt.init(tp), train_step=step, eval_step=None,
        statics=tst, train_loader=batches, outer_steps=outer_steps,
        run_dir=tmp_path, occ_state=tocc if occ is None else occ,
        occ_update_fn=occ_update_fn, metric_lag=metric_lag, **kw)
    return out, calls, tp


def test_metric_lag_gives_the_same_params(tmp_path):
    (p0, s0, _), _, _ = _small_loop(tmp_path / "a", metric_lag=0)
    (p1, s1, _), _, _ = _small_loop(tmp_path / "b", metric_lag=1)
    for a, b in zip(tree_leaves((p0, s0)), tree_leaves((p1, s1))):
        assert torch.equal(a, b)


def test_resume_restores_step_best_params_adam_and_grids(tmp_path):
    """A run stopped at step 2 (its `last`) resumes in the same run dir:
    the first step of the resumed run gets the saved params, optimizer
    state (Adam counts 2) and grids, and the loop continues at step 2."""
    (p2, s2, _), _, _ = _small_loop(tmp_path)
    occ_saved = ckpt.load_aux_state(tmp_path, "occ", _sides(
        *_setup()[:4], {})[1][3])
    blank = {k: torch.zeros_like(v) for k, v in occ_saved.items()}
    (p3, s3, _), calls, tp = _small_loop(tmp_path, outer_steps=3,
                                         best=-1.0, occ=blank)
    assert len(calls) == 1  # only step 2 ran
    first = calls[0]
    for a, b in zip(tree_leaves(first["params"]), tree_leaves(p2)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(first["opt"]), tree_leaves(s2)):
        assert torch.equal(a, b)
    assert {int(c) for c in first["opt"]["count"].values()} == {2}
    assert {int(c) for c in s3["count"].values()} == {3}
    assert bool(occ_saved["binary"].any())
    for k in occ_saved:
        assert torch.equal(first["occ"][k], occ_saved[k])
    assert json.loads((tmp_path / "last.state.json").read_text())[
        "step"] == 3


def _stub_steps(lib):
    """Train / eval steps that leave the params alone (JAX or torch)."""
    zero = (lambda: np.float32(0.5)) if lib == "jax" else (
        lambda: torch.tensor(0.5))

    def aux():
        return {"loss_in": zero(), "loss_out": zero(), "psnr_out": zero(),
                "region_loss_out": np.zeros(2, np.float32),
                "region_psnr_out": np.zeros(2, np.float32)} if lib == "jax" \
            else {"loss_in": zero(), "loss_out": zero(), "psnr_out": zero(),
                  "region_loss_out": torch.zeros(2),
                  "region_psnr_out": torch.zeros(2)}

    def train_step(p, s, st, b, key, occ=None):
        return p, s, aux()

    return train_step


_JAX_UPDATE = {}


@pytest.mark.parametrize("steps", [3, 6])
def test_occupancy_update_cadence_matches_jax(steps):
    """num_updates after N loop steps with the real update functions
    (warmup 4, every 2 steps: full updates at 0 and 2, a subset at 4)."""
    from nerfsys_tpu.models import occupancy as JMO
    from nerfsys_tpu.ops import occupancy as JOc
    from nerfsys_tpu_torch.models import occupancy as TMO

    cfg, params, statics, occ, _ = _setup()
    (jp, jst, _, _), (tcfg, tp, tst, _, _) = _sides(cfg, params, statics,
                                                    occ, {})
    jocfg = JOc.OccGridConfig(resolution=8, levels=1, warmup_steps=4,
                              update_interval=2)
    if not _JAX_UPDATE:  # one jit compile for every case
        _JAX_UPDATE["fn"] = JMO.make_occ_update_fn(cfg, jocfg)
    tocfg = interop.occ_grid_config_from_jax(jocfg)
    jocc = JOc.init_occ_state(jocfg, 2)
    tocc = interop.occ_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jocc), "cpu")
    batches = [{}] * steps
    out = {}

    def jupd(state, p, st, step, key):
        new = _JAX_UPDATE["fn"](state, p, st, step, key)
        out.setdefault("jax", []).append(int(new["num_updates"]))
        return new

    def tupd(state, p, st, step, gen):
        new = TMO.make_occ_update_fn(tcfg, tocfg)(state, p, st, step, gen)
        out.setdefault("port", []).append(int(new["num_updates"]))
        return new

    JT.meta_trainer(params=jp, opt_state=None,
                    train_step=_stub_steps("jax"), eval_step=None,
                    statics=jst, train_loader=batches, outer_steps=steps,
                    occ_state=jocc, occ_update_fn=jupd)
    TT.meta_trainer(params=tp, opt_state=None,
                    train_step=_stub_steps("torch"), eval_step=None,
                    statics=tst, train_loader=batches, outer_steps=steps,
                    occ_state=tocc, occ_update_fn=tupd)
    assert out["port"] == out["jax"]
    assert out["port"][-1] == (steps + 1) // 2


def _trees():
    cfg, params, statics, occ, _ = _setup()
    _, (tcfg, tp, tst, tocc, _) = _sides(cfg, params, statics, occ, {})
    opt = TO.build_optimizer(TO.OptimConfig(), TCo.param_group_labels(tp))
    state = opt.init(tp)
    state = {**state, "mu": tree_map(lambda t: t + 0.25, state["mu"])}
    return tp, state, tocc


def test_checkpoint_and_aux_round_trips_are_bit_equal(tmp_path):
    params, state, occ = _trees()
    cfg = {"seed": 3, "name": "x"}
    ckpt.save_checkpoint(tmp_path, "step7", params, state, cfg, 7, 12.5)
    ckpt.save_aux_state(tmp_path, "step7", "occ", occ)
    tpl_p = tree_map(torch.zeros_like, params)
    tpl_s = tree_map(torch.zeros_like, state)
    got_p, got_s, st = ckpt.load_checkpoint(tmp_path, "step7", tpl_p, tpl_s)
    assert st == {"step": 7, "best": 12.5, "is_best": False}
    for a, b in zip(tree_leaves((got_p, got_s)), tree_leaves((params,
                                                              state))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert json.loads((tmp_path / "step7.config.json").read_text()) == cfg
    assert ckpt.latest_step_tag(tmp_path) == "step7"
    got_o = ckpt.load_aux_state(tmp_path, "occ", tree_map(torch.zeros_like,
                                                          occ))
    for k in occ:
        assert got_o[k].dtype == occ[k].dtype and torch.equal(got_o[k],
                                                              occ[k])
    # is_resume falls back to the latest step tag when 'last' is absent
    p, s, st = ckpt.is_resume(tmp_path, tpl_p, tpl_s)
    assert st["step"] == 7 and torch.equal(tree_leaves(p)[0],
                                           tree_leaves(params)[0])
    # a template of another shape is refused; is_resume warns, gives None
    bad = tree_map(lambda t: torch.zeros(t.numel() + 1), params)
    with pytest.raises(ValueError, match="template"):
        ckpt.load_checkpoint(tmp_path, "step7", bad)
    assert ckpt.is_resume(tmp_path, bad) is None
    run = tmp_path / "runs" / "r1"
    ckpt.save_checkpoint(run, "last", params)
    assert ckpt.resolve_checkpoint_dir(tmp_path / "runs") == run


def test_aux_state_key_merge_fallback(tmp_path, capsys):
    """A state saved before a leaf existed restores by key; a shape change
    gives None."""
    _, _, occ = _trees()
    old = {k: v for k, v in occ.items() if k != "ready_after"}
    ckpt.save_aux_state(tmp_path, "last", "occ", old)
    tpl = {**tree_map(torch.zeros_like, occ),
           "ready_after": torch.tensor(5, dtype=torch.int32)}
    got = ckpt.load_aux_state(tmp_path, "occ", tpl)
    assert "merged by key" in capsys.readouterr().out
    assert int(got["ready_after"]) == 5
    for k in old:
        assert torch.equal(got[k], old[k])
    bigger = {**tpl, "occs": torch.zeros(3, *occ["occs"].shape[1:])}
    assert ckpt.load_aux_state(tmp_path, "occ", bigger) is None
    assert ckpt.load_aux_state(tmp_path, "absent", tpl) is None


def test_a_jax_checkpoint_raises(tmp_path):
    """The JAX package's flax msgpack files: params and grids are read bit
    for bit (the eval op's path); its optax optimizer state, which the
    port does not read, raises, never misread, and a resume gives None."""
    from nerfsys_tpu.utils import checkpoint as JC

    cfg, params, statics, occ, _ = _setup()
    (jp, _, jocc, _), (_, tp, _, tocc, _) = _sides(cfg, params, statics,
                                                   occ, {})
    tx = JO.build_optimizer(JO.OptimConfig(), JCo.param_group_labels(params))
    JC.save_checkpoint(tmp_path, "last", jp, tx.init(jp), {}, 3, 1.0)
    JC.save_aux_state(tmp_path, "last", "occ", jocc)
    got, _, state = ckpt.load_checkpoint(tmp_path, "last", tp)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(tp)))
    assert state["step"] == 3
    opt = TO.build_optimizer(TO.OptimConfig(), TCo.param_group_labels(tp))
    with pytest.raises(ValueError, match="opt_state"):
        ckpt.load_checkpoint(tmp_path, "last", tp, opt.init(tp))
    assert ckpt.is_resume(tmp_path, tp, opt.init(tp)) is None
    got_occ = ckpt.load_aux_state(tmp_path, "occ", tocc)
    assert all(torch.equal(got_occ[k], tocc[k]) for k in tocc)


def test_trace_window_writes_a_torch_profiler_trace(tmp_path):
    _small_loop(tmp_path, trace_steps=1)
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


@pytest.mark.parametrize("fixed", [False, True])
def test_eval_batches_and_fixed_eval(fixed, tmp_path):
    """eval_batches episode batches an eval point; fixed_eval pins them
    and reseeds the eval draws from seed + 7919 at every eval."""
    seen = []

    def eval_step(p, st, batch, gen):
        seen.append((batch["id"], gen.initial_seed()))
        return {"psnr_out": torch.tensor(float(batch["id"]))}

    evals = [{"id": i} for i in range(10)]
    _, _, best = TT.meta_trainer(
        params={"w": torch.zeros(2)}, opt_state=None,
        train_step=_stub_steps("torch"), eval_step=eval_step, statics=None,
        train_loader=[{}] * 4, eval_loader=evals, outer_steps=4,
        eval_every=2, eval_batches=2, fixed_eval=fixed, seed=5,
        run_dir=tmp_path)
    ids = [i for i, _ in seen]
    if fixed:
        assert ids == [0, 1, 0, 1] and best == 0.5
        assert {s for _, s in seen} == {5 + 7919}
    else:
        assert ids == [0, 1, 2, 3] and best == 2.5
        assert {s for _, s in seen} == {5}
    state = json.loads((tmp_path / "best.state.json").read_text())
    assert state["best"] == best and state["is_best"]
