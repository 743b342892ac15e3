"""Port parity of the occupancy grid's lifecycle: cell centres, dilation,
the camera premark, the EMA update (warmup and the strided subset) and its
interval, against the JAX package on the CPU; and the config's import.

Params (K=2 experts, planes L=2 base 8 F=4, hidden 16) and the occupancy
state (R=16, L=2) come from numpy seeds (tests/test_torch_train.py's
`_setup`). The JAX side runs eagerly (`jax.disable_jit()`: jitted XLA on
the CPU contracts multiply-adds, which moves the planes' cell selection).
The update's random draws are JAX's own: `jax.random.split(key)`, the
jitter `uniform(k1, (L, M, 3))` and the phase `randint(k2, (), 0, m)`,
handed to the port's update as tensors.

Tolerances: cell centres and step sizes within 1e-6;
dilation and the premark exactly; the updated EMA values within 1e-5 of
their max (the field's float32 sums in another order), the binary field
exactly except cells within 1e-5 of the threshold (the mean of the
visible values is a sum of 16,384 terms in another order), which are
listed and must be few.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsys_tpu.models import container as JCo
from nerfsys_tpu.models import occupancy as JMO
from nerfsys_tpu.ops import occupancy as J
from nerfsys_tpu_torch.models import container as TCo
from nerfsys_tpu_torch.models import occupancy as TMO
from nerfsys_tpu_torch.ops import occupancy as T
from nerfsys_tpu_torch.utils import interop
from test_torch_train import _setup, _sides
from test_torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse)

R, L = 16, 2
CFG = dict(resolution=R, levels=L, warmup_steps=32, update_interval=4)


def _cfgs(**kw):
    j = J.OccGridConfig(**{**CFG, **kw})
    return j, interop.occ_grid_config_from_jax(j)


def _cameras(n=8, radius=3.0, side=32):
    """A ring of n cameras around the origin at z = 1, each looking at
    the origin (RUB: the camera's -z axis points at it)."""
    c2ws = []
    for a in np.linspace(0, 2 * np.pi, n, endpoint=False):
        eye = np.array([radius * np.cos(a), radius * np.sin(a), 1.0])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        c2ws.append(np.stack([right, up, -fwd, eye], 1))
    c2ws = np.asarray(c2ws, np.float32)
    intr = np.tile([side * 1.5, side * 1.5, side / 2, side / 2],
                   (n, 1)).astype(np.float32)
    wh = np.tile([side, side], (n, 1)).astype(np.float32)
    return c2ws, intr, wh


def _t(a):
    return torch.from_numpy(np.array(a))


def test_cell_centers_match_jax():
    jc, tc = _cfgs()
    aabb = np.array([[-1.0, -2.0, 0.5], [1.5, 0.0, 2.0]], np.float32)
    want = np.asarray(J.cell_centers(jnp.asarray(aabb), jc))
    got = T.cell_centers(_t(aabb), tc).numpy()
    assert got.shape == (L, R ** 3, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("passes", [1, 2])
def test_dilate_binary_matches_jax(passes):
    b = np.random.default_rng(passes).uniform(size=(L, R, R, R)) < 0.02
    want = np.asarray(J.dilate_binary(jnp.asarray(b), passes))
    got = T.dilate_binary(_t(b), passes).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() > b.sum()


def test_mark_invisible_and_premark_match_jax():
    cfg, params, statics, occ, _ = _setup()
    (_, jst, jocc, _), (_, _, tst, tocc, _) = _sides(cfg, params, statics,
                                                      occ, {})
    jc, tc = _cfgs()
    c2ws, intr, wh = _cameras()
    with jax.disable_jit():
        want = JMO.premark_invisible_expert_cells(
            jocc, jst, jc, jnp.asarray(c2ws), jnp.asarray(intr),
            jnp.asarray(wh), near=0.1)
        one = J.mark_invisible_cells(jst.expert_aabbs[1], jc,
                                     jnp.asarray(c2ws), jnp.asarray(intr),
                                     jnp.asarray(wh))
    got = TMO.premark_invisible_expert_cells(tocc, tst, tc, _t(c2ws),
                                             _t(intr), _t(wh), near=0.1)
    np.testing.assert_array_equal(got["occs"].numpy(),
                                  np.asarray(want["occs"]))
    assert not got["binary"].any()
    assert int(got["num_updates"]) == int(tocc["num_updates"])
    share = float((got["occs"] < 0).float().mean())
    assert 0.05 < share < 0.95  # both visible and invisible cells
    np.testing.assert_array_equal(
        T.mark_invisible_cells(tst.expert_aabbs[1], tc, _t(c2ws), _t(intr),
                               _t(wh)).numpy(), np.asarray(one))


def test_expert_render_step_sizes_match_jax():
    cfg, params, statics, occ, _ = _setup()
    (_, jst, _, _), (_, _, tst, _, _) = _sides(cfg, params, statics, occ, {})
    want = np.asarray(JMO.expert_render_step_sizes(jst))
    got = TMO.expert_render_step_sizes(tst).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _update_pair(warmup, seed=0, dilate=0, fraction=0.5):
    """One expert's update through JAX's update_occ_grid and the port's
    with JAX's draws; the state holds earlier EMA values and premarked
    (-1) cells."""
    cfg, params, statics, occ, _ = _setup()
    (jp, jst, _, _), (tcfg, tp, tst, _, _) = _sides(cfg, params, statics,
                                                    occ, {})
    jc, tc = _cfgs(dilate=dilate, sample_fraction=fraction)
    rng = np.random.default_rng(seed)
    occs = rng.uniform(0.0, 0.02, (L, R, R, R)).astype(np.float32)
    occs[rng.uniform(size=occs.shape) < 0.1] = -1.0
    state = {"occs": occs, "binary": occs > 0.01}
    k = 1
    step = float(JMO.expert_render_step_sizes(jst)[k])
    _, jdensity = JCo._expert_apply_fn(cfg)
    _, tdensity = TCo._expert_apply_fn(tcfg)
    jpk = jax.tree_util.tree_map(lambda a: a[k], jp["experts"])
    tpk = TCo._expert_params(tp, k)
    key = jax.random.PRNGKey(seed + 3)
    n_cells = R ** 3
    m = T._subset_stride(tc)
    n_eval = n_cells if warmup else -(-n_cells // m)
    with jax.disable_jit():
        k1, k2 = jax.random.split(key)
        jitter = np.asarray(jax.random.uniform(k1, (L, n_eval, 3)))
        phase = int(jax.random.randint(k2, (), 0, m))
        want = J.update_occ_grid(
            {kk: jnp.asarray(v) for kk, v in state.items()},
            jst.expert_aabbs[k], lambda x: jdensity(jpk, cfg.expert,
                                                    jst.expert_aabbs[k], x),
            step, jc, key, jnp.asarray(warmup))
    got = T._update_occ_grid(
        {kk: _t(v) for kk, v in state.items()}, tst.expert_aabbs[k],
        lambda x: tdensity(tpk, tcfg.expert, tst.expert_aabbs[k], x), step,
        tc, warmup, _t(jitter), phase)
    return state, want, got, tc


def _binary_equal_but_ties(state, got, want, tc):
    occs = got["occs"].numpy()
    vis = state["occs"] >= 0
    thre = min(tc.occ_thre, float(np.where(vis, occs, 0).sum() / vis.sum()))
    differ = got["binary"].numpy() != np.asarray(want["binary"])
    ties = np.abs(occs - thre) <= 1e-5 * max(abs(thre), 1e-12)
    if not tc.dilate:
        assert not (differ & ~ties).any()
    assert ties.sum() <= 1e-3 * ties.size
    return int(differ.sum())


@pytest.mark.parametrize("warmup", [True, False])
def test_update_occ_grid_matches_jax_with_its_draws(warmup):
    state, want, got, tc = _update_pair(warmup)
    w = np.asarray(want["occs"])
    np.testing.assert_allclose(got["occs"].numpy(), w, rtol=0,
                               atol=1e-5 * np.abs(w).max())
    _binary_equal_but_ties(state, got, want, tc)
    changed = got["occs"].numpy() != state["occs"]
    if warmup:
        assert changed[state["occs"] >= 0].mean() > 0.5
    else:
        # about half the cells: one residue class of the stride at both
        # levels
        assert 0.2 < changed.mean() < 0.55
        flat = changed.reshape(L, -1)
        residues = {int(i) % T._subset_stride(tc)
                    for lv in range(L) for i in np.nonzero(flat[lv])[0]}
        assert len(residues) == 1


def test_update_preserves_invisible_cells_and_dilates():
    state, want, got, tc = _update_pair(False, seed=1, dilate=1,
                                        fraction=0.25)
    inv = state["occs"] < 0
    assert (got["occs"].numpy()[inv] == -1.0).all()
    w = np.asarray(want["occs"])
    np.testing.assert_allclose(got["occs"].numpy(), w, rtol=0,
                               atol=1e-5 * np.abs(w).max())
    assert _binary_equal_but_ties(state, got, want, tc) <= 1e-3 * inv.size
    # the dilated field holds the cells above the threshold and more
    occs = got["occs"].numpy()
    vis = ~inv
    thre = min(tc.occ_thre, float(np.where(vis, occs, 0).sum() / vis.sum()))
    above = (occs > thre) & vis
    binary = got["binary"].numpy()
    assert (binary | above == binary).all() and binary.sum() > above.sum()


def test_update_draws_come_from_the_generator():
    """update_occ_grid draws its jitter and phase from the generator: the
    same seed gives the same grid, another seed another subset."""
    cfg, params, statics, occ, _ = _setup()
    _, (tcfg, tp, tst, tocc, _) = _sides(cfg, params, statics, occ, {})
    _, tc = _cfgs()
    _, tdensity = TCo._expert_apply_fn(tcfg)
    tpk = TCo._expert_params(tp, 0)

    def run(seed):
        state = {"occs": tocc["occs"][0].clone() * 0.01,
                 "binary": tocc["binary"][0].clone()}
        return T.update_occ_grid(
            state, tst.expert_aabbs[0],
            lambda x: tdensity(tpk, tcfg.expert, tst.expert_aabbs[0], x),
            0.01, tc, torch.Generator().manual_seed(seed), warmup=False)

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a["occs"], b["occs"])
    assert not torch.equal(a["occs"], c["occs"])


def test_make_occ_update_fn_interval_and_count():
    cfg, params, statics, occ, _ = _setup()
    _, (tcfg, tp, tst, tocc, _) = _sides(cfg, params, statics, occ, {})
    _, tc = _cfgs()
    fn = TMO.make_occ_update_fn(tcfg, tc)
    same = fn(tocc, tp, tst, 3, torch.Generator().manual_seed(0))
    assert same is tocc
    out = fn(tocc, tp, tst, 4, torch.Generator().manual_seed(0))
    assert int(out["num_updates"]) == int(tocc["num_updates"]) + 1
    assert out["occs"].shape == tocc["occs"].shape
    assert out["binary"].dtype == torch.bool
    # expert by expert from the same generator: update_occ_grid's draws
    gen = torch.Generator().manual_seed(0)
    steps = TMO.expert_render_step_sizes(tst)
    _, dens = TCo._expert_apply_fn(tcfg)
    for k in range(2):
        pk = TCo._expert_params(tp, k)
        want = T.update_occ_grid(
            {"occs": tocc["occs"][k], "binary": tocc["binary"][k]},
            tst.expert_aabbs[k],
            lambda x: dens(pk, tcfg.expert, tst.expert_aabbs[k], x)
            * steps[k], 1.0, tc, gen, warmup=True)
        assert torch.equal(out["occs"][k], want["occs"])
        assert torch.equal(out["binary"][k], want["binary"])
    # after warmup the subset update touches about half the cells
    late = fn(out, tp, tst, 40, torch.Generator().manual_seed(1))
    moved = (late["occs"] != out["occs"]).float().mean()
    assert 0.2 < float(moved) < 0.55
    plain = TMO.make_occ_update_fn(tcfg, tc, use_kernels=False)(
        out, tp, tst, 40, torch.Generator().manual_seed(1))
    assert torch.equal(plain["occs"], late["occs"])


def test_occ_grid_config_interop():
    """Every key the grid and its update read is carried across, the
    defaults agree, and the reference's unread keys are the dropped ones."""
    jf = {f.name: f.default for f in dataclasses.fields(J.OccGridConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(T.OccGridConfig)}
    dropped = interop.DROPPED_KEYS["OccGridConfig"]
    assert set(jf) - set(tf) == set(dropped)
    assert tf == {k: v for k, v in jf.items() if k not in dropped}
    j = J.OccGridConfig(resolution=32, levels=3, ema_decay=0.9,
                        occ_thre=0.02, warmup_steps=64, update_interval=8,
                        sample_fraction=0.25, dilate=2)
    got = interop.occ_grid_config_from_jax(j)
    assert dataclasses.asdict(got) == {
        k: v for k, v in dataclasses.asdict(j).items() if k not in dropped}


@pytest.mark.parametrize("key,value", [
    ("alpha_thre", 0.003), ("alpha_thre_start", 0.001),
    ("alpha_thre_end", 0.02), ("cosine_anneal", False), ("cone_angle", 0.0)])
def test_occ_grid_config_drops_unread_keys(key, value):
    """A reference config with an unread key off its default imports to
    the same port config as the default does."""
    assert key in interop.DROPPED_KEYS["OccGridConfig"]
    got = interop.occ_grid_config_from_jax(
        J.OccGridConfig(resolution=32, **{key: value}))
    assert got == interop.occ_grid_config_from_jax(
        J.OccGridConfig(resolution=32))
    assert not hasattr(got, key)
